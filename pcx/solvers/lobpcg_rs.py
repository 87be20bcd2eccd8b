"""Pair-layout ("real-split") LOBPCG softlock — the accelerator production
solver.

Identical algorithm to :func:`pcx.solvers.lobpcg.lobpcg_sep` (fixed-shape
soft locking, SVQB-with-dropping orthonormalization, f64-accumulated
Rayleigh-Ritz, NaN/stagnation/floor guards), but every big block is carried
as a PAIR ``(re, im)`` of f32 arrays instead of a complex64 array.

On pairs the Gram and update GEMMs are real dot_generals that read the
operands directly (stated at HIGHEST precision, so f32 products over the
grid dimension never drop to TF32), with f64 accumulation across chunks,
and all elementwise complex arithmetic is explicit real arithmetic that
XLA fuses like the complex lowering would.

The operator/preconditioner callables receive and return pairs shaped like
``x0`` (see pcx.operators.rs for the pair Maxwell operator).  The reference
algorithm remains lobpcg_sep_softlock, paper_2/lobpcg.py:325-492.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from pcx.config import MAXITER, TOL
from pcx.solvers import rayleigh_ritz as rr
from pcx.solvers.lobpcg import SolveResult, Status

Pair = Tuple[jnp.ndarray, jnp.ndarray]


def _axpy(a, x: Pair, y: Pair) -> Pair:
    """a*x + y with REAL per-column coefficients a (broadcast shape)."""
    return (a * x[0] + y[0], a * x[1] + y[1])


_divisor_chunk = rr.divisor_chunk  # now the gram_f64_p default (chunk=0)


def rs_solver_parts(
    h_func: Callable[[Pair], Pair],
    p_func: Callable[[Pair], Pair],
    shape: Tuple[int, ...],
    rdtype,
    nev: int,
    *,
    shift: float = 0.0,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 2,
    refresh_every: int = 5,
    floor_patience: int = 9,
    reduce_axis=None,
    use_p: bool = True,
    rr_gram: str = "xla",
    rr_mirror: bool = False,
    w_cap: int = None,
    col_patience: int = 0,
    lam_tol: float = 0.0,
    lam_patience: int = 3,
    lam_res_tol: float = 1e-3,
):
    """Factory for the pair-layout LOBPCG as three composable traced parts:

    ``init(x0) -> state``        orthonormalize + Ritz-rotate the start block
    ``run_to(state, it_stop)``   iterate until termination OR ``it >= it_stop``
    ``finalize(state)``          SolveResult (RUNNING mapped to MAXITER)

    ``shape`` is the block shape of x0 (e.g. ``(m, 3, N, N, N)``) and
    ``rdtype`` its real dtype; both must be static.

    Why parts instead of one function: a host trampoline jits ``run_to``
    once with a dynamic ``it_stop`` and re-enters it with the
    device-resident state every ``segment_iters`` iterations, so host-side
    controls (the warm-start doom check, warm_maxiter, w_cap bucket
    re-entry) run between segments without a recompile.
    ``lobpcg_sep_rs`` composes the same parts into the single-program form,
    so CPU tests pin both paths to identical semantics.

    ``w_cap`` (static, default ``m``) caps the physical width of the W and
    P blocks: each iteration the ACTIVE (unconverged, ``res > tol``)
    columns are compacted to the front of a ``(w_cap, D)`` block via a
    stable argsort gather, so the operator apply, orthonormalizations and
    Rayleigh-Ritz all run at width ``m + 2*w_cap`` instead of ``3m``.
    This recovers the FLOP savings of the reference's dynamic column
    compaction (paper_2/lobpcg.py:429-437, ``n_loc = m + 2*n_act``) under
    XLA's static shapes: the host trampoline re-enters ``run_to`` with a
    smaller-``w_cap`` trace once enough columns lock (state pytree shapes
    are w_cap-independent, so the device-resident state carries over).  If
    more than ``w_cap`` columns are active (e.g. a locked column regresses
    mid-segment), the overflow columns simply get no W/P direction this
    iteration — they stay in X, stay monitored, and the next segment
    boundary re-expands the bucket.  At ``w_cap == m`` no gather is
    emitted and the trace is identical to ``w_cap=None``.

    ``col_patience`` (static, default 0 = off) enables PER-COLUMN floor
    locking: a column whose own residual has not improved by 5% for
    ``col_patience`` iterations while sitting at its scale-aware
    attainable floor (or for ``4*col_patience+4`` iterations
    unconditionally) is treated as locked — it gets no W/P direction but
    stays in X, in the Rayleigh-Ritz basis, and monitored (a 3x residual
    regression reactivates it).  This matters because at production c64
    tolerances no column ever reaches ``res < tol`` (solves end in
    FLOOR), so the reference's tol-based soft locking
    (paper_2/lobpcg.py:429-437) never engages; the attainable-floor
    criterion is the c64 analog that actually fires.  Combined with
    ``w_cap`` it converts locked columns into real FLOP savings.

    ``lam_tol`` (static, default 0 = off) enables RITZ-MOVEMENT stopping:
    the solve ends (Status.FLOOR) once the max movement of the first
    ``nev`` Ritz values — relative to ``max(|theta|, 1)``, i.e. ABSOLUTE
    for sub-unit eigenvalues (the penalized spectrum sits O(1)+ under the
    relaxation shift, and the c64 Ritz jitter band the threshold is tuned
    against is itself absolute at that scale) — stays below ``lam_tol``
    for ``lam_patience`` consecutive iterations.  Rationale: the deliverable tolerance is on
    FREQUENCIES, and for Rayleigh quotients the eigenvalue error is
    O(residual^2 / gap) — Ritz values stabilize many iterations before the
    residual reaches its c64 floor (validation ~1e-6 vs the 1e-3 physical
    gate), so residual-based floor detection alone pays a
    pure tail.  At ``lam_tol = 1e-7`` the worst-case drift left on the
    table over even 100 forgone iterations is ~1e-5 relative — an order
    below the gate.

    ``lam_res_tol``: residual admissibility cap on the HEURISTIC stops
    (the lam_tol stop and the hard-patience floor; the scale-aware-gated
    floor is untouched).  Ritz stillness is NOT sufficient near a tight
    band cluster: a warm-started solve parked in a subspace that misses
    one direction of a near-degenerate doublet has near-zero Ritz
    movement with O(splitting) residuals, and the downstream spurious
    gate cannot see it (the mixed mode's penalized and recomputed
    quotients agree with each other — bcc_sg N=120, round-3, 40/91
    k-points up to 9e-3 off with validations passing).  A heuristic stop
    is admissible only when every tracked column satisfies
    ``res_i < lam_res_tol * 4 pi * sqrt(max(|theta_i|, 1))`` — i.e. the
    linear eigenvalue-error bound |theta - lambda| <= ||r|| keeps the
    frequency error below ~lam_res_tol.  Stalled-but-inadmissible solves
    run to MAXITER and are rejected by the band-sweep's frequency-error-
    bound gate (bandgap._accept), which cold-retries them.
    """
    if rr_gram not in ("xla", "xla9"):
        raise ValueError(f"unknown rr_gram {rr_gram!r}")
    if lam_tol > 0.0 and lam_patience < 1:
        raise ValueError("lam_patience must be >= 1 (the stillness counter "
                         "starts at 0, so 0 would stop unconditionally)")
    m = shape[0]
    wc = m if w_cap is None else max(1, min(int(w_cap), m))
    rdtype = jnp.dtype(rdtype)
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    dim = 1
    for d in shape[1:]:
        dim *= d
    noise_floor = 30.0 * (dim ** 0.5) * float(jnp.finfo(rdtype).eps)

    if shift != 0.0:
        h_in = h_func
        sh = jnp.asarray(shift, rdtype)
        h_func = lambda v: _axpy(sh, v, h_in(v))

    # Width-generic (the W/P blocks run at width wc <= m under w_cap).
    def flat(a: Pair) -> Pair:
        return (a[0].reshape(a[0].shape[0], -1),
                a[1].reshape(a[1].shape[0], -1))

    def unflat(a: Pair) -> Pair:
        return (a[0].reshape((-1,) + shape[1:]),
                a[1].reshape((-1,) + shape[1:]))

    ones_m = jnp.ones((m,), rdtype)
    rr_split = rr.split_for(rdtype)

    def init(x0: Pair) -> dict:
        # ---- initialization: orthonormalize + Ritz-rotate ------------------
        x = x0
        n0 = rr.colnorms_p(flat(x), axis_name=reduce_axis)
        x = rr.scale_cols_p(x, 1.0 / jnp.maximum(n0, tiny))
        xf, _, keep0 = rr.masked_svqb_drop_p(flat(x), ones_m, noise_floor,
                                             axis_name=reduce_axis, passes=1)
        hxf = flat(h_func(unflat(xf)))
        t_re, t_im = rr.gram_f64_p(xf, hxf, axis_name=reduce_axis)
        # Rank-deficient starts (e.g. duplicated warm/coarse columns): the
        # dropped columns are zero, so their zero Gram rows would place a
        # phantom theta=0 BELOW the HPD spectrum and silently shift every
        # returned band.  Decouple them ABOVE the spectrum instead, and
        # carry the keep mask as state["x_ok"] so the first step() RR also
        # decouples the zero columns — its window logic then returns only
        # genuine pairs and the refilled X is full rank (self-healing).
        keep64 = (keep0[:, None] * keep0[None, :]).astype(jnp.float64)
        t_re = 0.5 * (t_re + t_re.T) * keep64
        t_im = 0.5 * (t_im - t_im.T) * keep64
        dead0 = jnp.sqrt(jnp.sum(t_re ** 2) + jnp.sum(t_im ** 2)) + 1.0
        t_re = t_re + dead0 * jnp.diag(1.0 - keep0.astype(jnp.float64))
        theta0, v_re, v_im = rr.eigh_f64_embedding(t_re, t_im,
                                                   split=rr_split)
        km = keep0[:, None].astype(rdtype)
        c0 = (v_re.astype(rdtype) * km, v_im.astype(rdtype) * km)
        xf2 = rr.mix_pair(c0, xf)
        hxf2 = rr.mix_pair(c0, hxf)
        lambdas0 = theta0.astype(rdtype)

        zeros_f = (jnp.zeros_like(xf2[0]), jnp.zeros_like(xf2[1]))
        return dict(
            it=jnp.asarray(0, jnp.int32),
            it_stop=jnp.asarray(maxiter, jnp.int32),
            status=jnp.asarray(Status.RUNNING, jnp.int32),
            lambdas=lambdas0,
            x=xf2, hx=hxf2, p=zeros_f, hp=zeros_f,
            res_his=jnp.full((maxiter,), jnp.nan, rdtype),
            best_res=jnp.asarray(jnp.inf, rdtype),
            best_it=jnp.asarray(0, jnp.int32),
            # Per-column residuals + floor-lock bookkeeping; n_act is the
            # trampoline's bucket-selection signal (host reads one int32).
            res=jnp.full((m,), jnp.inf, rdtype),
            best_res_c=jnp.full((m,), jnp.inf, rdtype),
            best_it_c=jnp.zeros((m,), jnp.int32),
            n_act=jnp.asarray(m, jnp.int32),
            # consecutive iterations with max relative Ritz movement of the
            # first nev columns below lam_tol (lam_tol > 0 only)
            lam_still=jnp.asarray(0, jnp.int32),
            # valid-column mask of X in SORTED position: the +dead0
            # decoupling sorts phantom columns last, so the zero columns
            # occupy the trailing positions regardless of which INPUT
            # columns were dropped (refilled by the next RR window)
            x_ok=(jnp.arange(m) < jnp.sum(keep0)).astype(rdtype),
        )

    def cond_fun(s):
        return ((s["status"] == Status.RUNNING) & (s["it"] < maxiter)
                & (s["it"] < s["it_stop"]))

    def body_fun(s):
        it = s["it"]
        do_refresh = ((refresh_every > 0) & (it > 0)
                      & (jnp.mod(it, refresh_every) == 0))
        hx_cur = lax.cond(do_refresh,
                          lambda: flat(h_func(unflat(s["x"]))),
                          lambda: s["hx"])
        hp_cur = lax.cond(do_refresh,
                          lambda: flat(h_func(unflat(s["p"]))),
                          lambda: s["hp"])

        lam_col = s["lambdas"][:, None]
        r = (lam_col * s["x"][0] - hx_cur[0],
             lam_col * s["x"][1] - hx_cur[1])
        res = rr.colnorms_p(r, axis_name=reduce_axis)
        res_max = jnp.max(res[:nev])
        res_nev = jnp.linalg.norm(res[:nev])
        res_his = s["res_his"].at[it].set(res_nev)
        first_rec = res_his[1]

        # 5% improvement threshold: oscillation-proof at the c64 floor
        # (see lobpcg.lobpcg_sep for the measured rationale).
        improved = res_max < s["best_res"] * 0.95
        best_res = jnp.where(improved, res_max, s["best_res"])
        best_it = jnp.where(improved, it, s["best_it"])
        # Scale-aware admissibility gate (see lobpcg.lobpcg_sep): FLOOR only
        # when the residual is plausibly at the dtype's attainable level.
        floor_gate = (10.0 * noise_floor / 30.0
                      * jnp.maximum(jnp.max(jnp.abs(s["lambdas"])), 1.0))
        # NOTE: no `res_max < first_rec` term — a WARM start (previous
        # k-point's eigenvectors) begins already at the attainable floor,
        # so an improvement-over-start requirement can never fire and the
        # solve would burn maxiter (observed on the N=120 sweep at
        # X-points).  The absolute scale-aware gate suffices: random
        # starts have res >> floor_gate for the first few dozen iters.
        floored = ((floor_patience > 0) & (it - best_it > floor_patience)
                   & (it > 3) & (res_max < floor_gate))
        # Hard-patience floor: 4x the window with NO absolute gate.  If no
        # 5% best-residual improvement happened for ~40 iterations the
        # iterate is at its attainable accuracy regardless of where the
        # scale estimate says the floor should be (warm starts on the R-M
        # leg measured 500-iter burns with the absolute gate alone).  Every
        # FLOOR result still passes the f64 recompute + spurious gate
        # before being recorded, so a premature exit cannot corrupt a
        # library — it is retried as a failure instead.
        # Heuristic-stop admissibility (factory docstring, lam_res_tol):
        # every tracked column's residual must bound its eigenvalue error
        # below ~lam_res_tol in frequency units, else stillness/stagnation
        # may just mean a stuck subspace missing a clustered direction.
        res_cap = (lam_res_tol * 4.0 * jnp.pi
                   * jnp.sqrt(jnp.maximum(jnp.abs(s["lambdas"][:nev]), 1.0)))
        res_cap_ok = jnp.all(res[:nev] < res_cap)
        floored = floored | ((floor_patience > 0) & (it > 3) & res_cap_ok
                             & (it - best_it > 4 * floor_patience + 4))
        if lam_tol > 0.0:
            # Ritz-movement stop (see factory docstring): the counter is
            # updated in step() from theta vs the previous lambdas; a NaN
            # or plateau-exit movement resets it, so lam_patience
            # consecutive still iterations means the tracked eigenvalues
            # are converged to lam_tol relative per iteration.
            floored = floored | ((it > 3) & res_cap_ok
                                 & (s["lam_still"] >= lam_patience))

        # --- per-column floor locking (col_patience > 0) -----------------
        improved_c = res < s["best_res_c"] * 0.95
        # a locked column drifting 3x above its best is reactivated by
        # restarting its patience window at the regressed level
        regressed_c = res > 3.0 * s["best_res_c"]
        best_res_c = jnp.where(improved_c | regressed_c, res,
                               s["best_res_c"])
        best_it_c = jnp.where(improved_c | regressed_c, it, s["best_it_c"])
        if col_patience > 0:
            col_gate = (10.0 * noise_floor / 30.0
                        * jnp.maximum(jnp.abs(s["lambdas"]), 1.0))
            col_floored = ((it - best_it_c > col_patience) & (it > 3)
                           & (res < col_gate))
            col_floored = col_floored | (
                (it > 3) & (it - best_it_c > 4 * col_patience + 4))
        else:
            col_floored = jnp.zeros((m,), bool)
        active_mask = (((res > tol) & ~col_floored).astype(rdtype)
                       if locking else ones_m)
        n_act = jnp.sum(active_mask).astype(jnp.int32)

        is_nan = jnp.isnan(res).any()
        converged = res_max < tol
        # Stagnation reference must also be warm-start-robust: only call
        # it divergence when the residual is meaningfully above BOTH the
        # starting level and the attainable floor.
        stagn_ref = jnp.maximum(first_rec, 10.0 * floor_gate)
        stagn = (
            ((it > maxstagniter) & ((res[0] > 1000.0) | (res[0] > stagn_ref)))
            | ((it > 2 * maxstagniter) & (res[0] > 50.0))
        )
        recovering = res_nev < res_his[maxstagniter // 2] * 0.1
        blowup = stagn & ~recovering

        status = jnp.where(
            is_nan, Status.NAN,
            jnp.where(converged, Status.CONVERGED,
                      jnp.where(blowup, Status.BLOWUP,
                                jnp.where(floored, Status.FLOOR,
                                          Status.RUNNING))),
        ).astype(jnp.int32)

        s = dict(s, hx=hx_cur, hp=hp_cur, best_res=best_res, best_it=best_it,
                 res=res, best_res_c=best_res_c, best_it_c=best_it_c,
                 n_act=n_act)

        def finish(_):
            return dict(s, it=it, status=status, res_his=res_his)

        def step(_):
            active = active_mask
            xf, hxf = s["x"], s["hx"]

            # w_cap compaction: gather the wc highest-residual ACTIVE
            # columns of the residual/P blocks; overflow/locked columns get
            # no W/P direction this iteration but stay in X and monitored.
            # Residual priority (not index order): with a fixed int cap and
            # n_act > wc, stable index order would starve the same trailing
            # active columns forever — under residual order a starved
            # column's stuck-high residual reclaims a slot next iteration.
            if wc < m:
                idx = jnp.argsort(-(active * res), stable=True)[:wc]
                sel = active[idx]
                gather = lambda pr: (pr[0][idx], pr[1][idx])
            else:
                sel = active
                gather = lambda pr: pr
            acol = sel[:, None]

            rw = gather(r)
            wf = flat(p_func(unflat((acol * rw[0], acol * rw[1]))))
            wn = rr.colnorms_p(wf, axis_name=reduce_axis)
            wf = rr.scale_cols_p(wf, 1.0 / jnp.maximum(wn, tiny))
            wf, _, w_ok = rr.masked_svqb_drop_p(
                wf, sel, noise_floor, against=(xf,),
                axis_name=reduce_axis, passes=ortho_passes)
            hwf = flat(h_func(unflat(wf)))

            p_act = sel * (it > 0) * (1.0 if use_p else 0.0)
            pc = p_act[:, None]
            pf_g, hpf_g = gather(s["p"]), gather(s["hp"])
            pf = (pc * pf_g[0], pc * pf_g[1])
            hpf = (pc * hpf_g[0], pc * hpf_g[1])
            pn = rr.colnorms_p(pf, axis_name=reduce_axis)
            inv_pn = (1.0 / jnp.maximum(pn, tiny))[:, None]
            pf = (inv_pn * pf[0], inv_pn * pf[1])
            hpf = (inv_pn * hpf[0], inv_pn * hpf[1])
            pf, hpf, p_ok = rr.masked_svqb_drop_p(
                pf, p_act, noise_floor, hblock=hpf,
                against=(xf, wf), h_against=(hxf, hwf),
                axis_name=reduce_axis, passes=ortho_passes)

            basis_mask = jnp.concatenate((s["x_ok"], w_ok, p_ok))
            if rr_gram == "xla9":
                # Concat-free Rayleigh-Ritz Gram: 9 (m, m) block Grams
                # instead of one stacked (3m, D) call.  Same
                # f64-accumulated semantics; trades 9 dispatches for NOT
                # materializing the [X|W|P] concatenations — at N=150 the
                # two stacked concats are four 1.8 GB HBM temps, the
                # difference between fitting in device memory or not at
                # N=150.
                bases, hbases = (xf, wf, pf), (hxf, hwf, hpf)
                # rr_mirror=True computes only the 6 upper blocks and
                # mirrors the 3 lower ones (G[j][i] = G[i][j]^H) — 1/3
                # less HBM traffic, but the two triangles are NOT equal in
                # finite precision (stored-HX drift), and averaging them
                # via the symmetrization below buys ~a decimal of omega
                # accuracy (same policy as lobpcg.py rr_mirror, default
                # off).  Default computes all 9.
                g = [[None] * 3 for _ in range(3)]
                for i in range(3):
                    for j in range(3):
                        if rr_mirror and j < i:
                            re_u, im_u = g[j][i]
                            g[i][j] = (re_u.T, -im_u.T)
                        else:
                            g[i][j] = rr.gram_f64_p(bases[i], hbases[j],
                                                    axis_name=reduce_axis)
                t_re = jnp.block([[g[i][j][0] for j in range(3)]
                                  for i in range(3)])
                t_im = jnp.block([[g[i][j][1] for j in range(3)]
                                  for i in range(3)])
            sf = hsf = None
            if rr_gram == "xla":
                # ONE stacked (3m, D) x (3m, D) Gram instead of 9 (m, m)
                # calls: same FLOPs, 1/9 the dispatches, and 3x wider
                # GEMMs.
                sf = (jnp.concatenate((xf[0], wf[0], pf[0])),
                      jnp.concatenate((xf[1], wf[1], pf[1])))
                hsf = (jnp.concatenate((hxf[0], hwf[0], hpf[0])),
                       jnp.concatenate((hxf[1], hwf[1], hpf[1])))
                t_re, t_im = rr.gram_f64_p(sf, hsf, axis_name=reduce_axis)
            keep64 = (basis_mask[:, None] * basis_mask[None, :]).astype(
                jnp.float64)
            t_re = 0.5 * (t_re + t_re.T) * keep64
            t_im = 0.5 * (t_im - t_im.T) * keep64
            dead_val = jnp.sqrt(jnp.sum(t_re ** 2) + jnp.sum(t_im ** 2)) + 1.0
            t_re = t_re - dead_val * jnp.diag(1.0 - basis_mask).astype(
                jnp.float64)
            theta_all, v_re, v_im = rr.eigh_f64_embedding(t_re, t_im,
                                                          split=rr_split)
            theta_all = theta_all.astype(rdtype)
            bm = basis_mask[:, None].astype(rdtype)
            c_all = (v_re.astype(rdtype) * bm, v_im.astype(rdtype) * bm)

            nb = m + 2 * wc
            valid = jnp.sum(basis_mask)
            n_dead = (nb - valid).astype(jnp.int32)
            # Window entries are genuine except when fewer than m basis
            # columns survived (then the clamped slice re-admits dead
            # entries at its bottom); mark those so the next RR masks them.
            x_ok_new = (jnp.arange(m) >= jnp.maximum(0.0, m - valid)
                        ).astype(rdtype)
            theta = lax.dynamic_slice(theta_all, (n_dead,), (m,))
            c_re = lax.dynamic_slice(c_all[0], (jnp.int32(0), n_dead),
                                     (nb, m))
            c_im = lax.dynamic_slice(c_all[1], (jnp.int32(0), n_dead),
                                     (nb, m))

            if sf is not None:
                # Reuse the Gram's stacked [X|W|P] concatenations for the
                # update mixes: x_new = c^T S (the full coefficient block —
                # equals cx X + cw W + cp P) and p_new = c[m:]^T S[m:], as
                # 4 wide GEMMs instead of 12 m-row ones (fewer dispatches;
                # traffic identical — S is re-read either way).
                c_tail = (c_re[m:], c_im[m:])
                s_tail = (sf[0][m:], sf[1][m:])
                hs_tail = (hsf[0][m:], hsf[1][m:])
                p_new = rr.mix_pair(c_tail, s_tail)
                hp_new = rr.mix_pair(c_tail, hs_tail)
                x_new = rr.mix_pair((c_re, c_im), sf)
                hx_new = rr.mix_pair((c_re, c_im), hsf)
            else:
                cx = (c_re[:m], c_im[:m])
                cw = (c_re[m:m + wc], c_im[m:m + wc])
                cp = (c_re[m + wc:], c_im[m + wc:])

                pw = rr.mix_pair(cw, wf)
                pp = rr.mix_pair(cp, pf)
                p_new = (pw[0] + pp[0], pw[1] + pp[1])
                hw = rr.mix_pair(cw, hwf)
                hp2 = rr.mix_pair(cp, hpf)
                hp_new = (hw[0] + hp2[0], hw[1] + hp2[1])
                xc = rr.mix_pair(cx, xf)
                x_new = (xc[0] + p_new[0], xc[1] + p_new[1])
                hxc = rr.mix_pair(cx, hxf)
                hx_new = (hxc[0] + hp_new[0], hxc[1] + hp_new[1])

            nan_rr = jnp.isnan(theta).any()
            new_status = jnp.where(nan_rr, Status.NAN,
                                   Status.RUNNING).astype(jnp.int32)
            if lam_tol > 0.0:
                # NaN movement compares False -> counter resets (safe).
                move = jnp.max(jnp.abs(theta[:nev] - s["lambdas"][:nev])
                               / jnp.maximum(jnp.abs(theta[:nev]), 1.0))
                lam_still = jnp.where(move < lam_tol,
                                      s["lam_still"] + 1,
                                      0).astype(jnp.int32)
            else:
                lam_still = s["lam_still"]
            return dict(
                it=it + 1, it_stop=s["it_stop"], status=new_status,
                lambdas=theta,
                x=x_new, hx=hx_new, p=p_new, hp=hp_new,
                res_his=res_his, best_res=best_res, best_it=best_it,
                res=res, best_res_c=best_res_c, best_it_c=best_it_c,
                n_act=n_act, lam_still=lam_still, x_ok=x_ok_new,
            )

        return lax.cond(status != Status.RUNNING, finish, step, None)

    def run_to(state: dict, it_stop) -> dict:
        state = dict(state, it_stop=jnp.asarray(it_stop, jnp.int32))
        return lax.while_loop(cond_fun, body_fun, state)

    def finalize(state: dict) -> SolveResult:
        status = jnp.where(state["status"] == Status.RUNNING,
                           Status.MAXITER, state["status"]).astype(jnp.int32)
        return SolveResult(
            lambdas=state["lambdas"] - jnp.asarray(shift, rdtype),
            x=unflat(state["x"]),
            iterations=state["it"],
            status=status,
            res_history=state["res_his"],
        )

    return init, run_to, finalize


def lobpcg_sep_rs(
    h_func: Callable[[Pair], Pair],
    p_func: Callable[[Pair], Pair],
    x0: Pair,
    nev: int,
    *,
    shift: float = 0.0,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 2,
    refresh_every: int = 5,
    floor_patience: int = 9,
    reduce_axis=None,
    use_p: bool = True,
    rr_gram: str = "xla",
    w_cap: int = None,
    col_patience: int = 0,
    lam_tol: float = 0.0,
    lam_patience: int = 3,
    lam_res_tol: float = 1e-3,
    rr_mirror: bool = False,
) -> SolveResult:
    """LOBPCG on pair blocks; returns SolveResult with ``x`` as a pair.

    Single-program composition of :func:`rs_solver_parts` (init -> full
    while_loop -> finalize), used by the one-shot and batched programs.

    ``rr_gram``: "xla" computes the stacked 3m-wide Rayleigh-Ritz Gram via
    dot_general (chunked f64 accumulation); "xla9" computes the nine (m, m)
    block Grams without materializing the stacked bases.
    """
    init, run_to, finalize = rs_solver_parts(
        h_func, p_func, x0[0].shape, x0[0].dtype, nev,
        shift=shift, tol=tol, maxiter=maxiter, locking=locking,
        maxstagniter=maxstagniter, ortho_passes=ortho_passes,
        refresh_every=refresh_every, floor_patience=floor_patience,
        reduce_axis=reduce_axis, use_p=use_p, rr_gram=rr_gram,
        rr_mirror=rr_mirror, w_cap=w_cap,
        col_patience=col_patience, lam_tol=lam_tol,
        lam_patience=lam_patience, lam_res_tol=lam_res_tol)
    return finalize(run_to(init(x0), maxiter))

# ---------------------------------------------------------------------------
# Pair-layout GENERALIZED eigensolver family.
#
# The all-real pair twin of the complex lobpcg_gep (pcx.solvers.lobpcg),
# built from the same toolbox as the production softlock solver above
# (gram_f64_p pair Grams, mix_pair updates, pencil_f64_embedding
# small-pencil solve).  Reference: lobpcg_gep_softlock,
# paper_2/lobpcg.py:688-838; max mode paper_2/lobpcg.py:196-323;
# descent_gep paper_2/lobpcg.py:976-1100.
# ---------------------------------------------------------------------------


def lobpcg_gep_rs(
    h_func: Callable[[Pair], Pair],
    m_func: Callable[[Pair], Pair],
    p_func: Callable[[Pair], Pair],
    x0: Pair,
    nev: int,
    *,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    use_p: bool = True,
    floor_patience: int = 10,
) -> SolveResult:
    """LOBPCG for H x = lambda M x (M HPD) on pair blocks.

    Same algorithm as :func:`pcx.solvers.lobpcg.lobpcg_gep` (M-inner
    Rayleigh-Ritz, residual R = lambda*MX - HX, fixed-shape soft locking
    with phantom decoupling, dead-column compaction by dynamic slice), but
    every block is a ``(re, im)`` real pair and the small pencil solves in
    the f64 real *-algebra embedding — no complex value exists anywhere
    inside the while_loop.  Returns ``SolveResult`` with ``x`` as a pair.

    ``floor_patience``: stop with Status.FLOOR once the tracked residual
    has not improved 5% for this many iterations (0 disables).  At f32 the
    GEP's noisy Gram turns nearly-dependent once W hits the noise floor
    and the pencil then breeds below-spectrum phantoms — the COMPLEX
    lobpcg_gep at c64 measurably corrupts its converged eigenvalues after
    ~iteration 25 on CPU (relerr 1.8e-3 at it=10 -> 17 at it=30);
    stopping at the attainable floor returns the accurate
    values the iteration already had.
    """
    from pcx.operators import rs as rs_mod

    m = x0[0].shape[0]
    rdtype = x0[0].dtype
    f64 = jnp.float64
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    shape = x0[0].shape

    def flat(a: Pair) -> Pair:
        return (a[0].reshape(m, -1), a[1].reshape(m, -1))

    def unflat(a: Pair) -> Pair:
        return (a[0].reshape(shape), a[1].reshape(shape))

    def scale(a: Pair, s) -> Pair:   # s real (p,) broadcast over columns
        sc = s[:, None].astype(rdtype)
        return (a[0] * sc, a[1] * sc)

    def cat(*ps: Pair) -> Pair:
        return (jnp.concatenate([p[0] for p in ps], axis=0),
                jnp.concatenate([p[1] for p in ps], axis=0))

    def gram_herm(x: Pair, y: Pair):
        re, im = rr.gram_f64_p(x, y)
        return 0.5 * (re + re.T), 0.5 * (im - im.T)

    x = flat(x0)
    if normalize:
        n0 = rr.colnorms_p(x)
        x = scale(x, 1.0 / jnp.maximum(n0, tiny))
    hx = flat(h_func(unflat(x)))
    mx = flat(m_func(unflat(x)))
    g = gram_herm(x, mx)
    gh = gram_herm(x, hx)
    # Dtype-aware degeneracy split (rr.split_for rationale): f32 iterates
    # put ~eps_f32 noise in the Gram entries, and the graded perturbation
    # must dominate it for deterministic pair extraction.
    split = float(rr.split_for(rdtype))
    theta0, c0 = rs_mod.pencil_f64_embedding(gh, g, split=split)
    c0r = (c0[0].astype(rdtype), c0[1].astype(rdtype))
    x = rr.mix_pair(c0r, x)
    hx = rr.mix_pair(c0r, hx)
    mx = rr.mix_pair(c0r, mx)

    zeros = (jnp.zeros_like(x[0]), jnp.zeros_like(x[1]))
    ones_m = jnp.ones((m,), rdtype)

    state0 = dict(
        it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        lambdas=theta0.astype(rdtype),
        x=x, hx=hx, mx=mx, p=zeros, hp=zeros, mp=zeros,
        res_his=jnp.full((maxiter,), jnp.nan, rdtype),
        best_res=jnp.asarray(jnp.inf, rdtype),
        best_it=jnp.asarray(0, jnp.int32),
        best_lambdas=theta0.astype(rdtype),
    )

    def cond_fun(s):
        return (s["status"] == Status.RUNNING) & (s["it"] < maxiter)

    def body_fun(s):
        it = s["it"]
        lam = s["lambdas"][:, None]
        r = (lam * s["mx"][0] - s["hx"][0], lam * s["mx"][1] - s["hx"][1])
        # Per-column RELATIVE residual (columns are M-orthonormal, so the
        # 2-norms carry the pencil's scale — see lobpcg_gep's rationale).
        res = rr.colnorms_p(r) / jnp.maximum(rr.colnorms_p(s["x"]), tiny)
        res_nev = jnp.linalg.norm(res[:nev])
        res_his = s["res_his"].at[it].set(res_nev)
        res_max = jnp.max(res[:nev])
        improved = res_max < s["best_res"] * 0.95
        best_res = jnp.where(improved, res_max, s["best_res"])
        best_it = jnp.where(improved, it, s["best_it"])
        best_lambdas = jnp.where(improved, s["lambdas"], s["best_lambdas"])
        floored = ((floor_patience > 0) & (it > 3)
                   & (it - best_it > floor_patience))
        is_nan = jnp.isnan(res).any()
        converged = res_max < tol
        status = jnp.where(is_nan, Status.NAN,
                           jnp.where(converged, Status.CONVERGED,
                                     jnp.where(floored, Status.FLOOR,
                                               Status.RUNNING))
                           ).astype(jnp.int32)

        def finish(_):
            return dict(s, it=it, status=status, res_his=res_his,
                        best_res=best_res, best_it=best_it,
                        best_lambdas=best_lambdas)

        def step(_):
            active = (res > tol).astype(rdtype) if locking else ones_m
            w = p_func(unflat(scale(r, active)))
            w = scale(flat(w), active)
            if normalize:
                wn = rr.colnorms_p(w)
                w = scale(w, 1.0 / jnp.maximum(wn, tiny))
            hw = flat(h_func(unflat(w)))
            mw = flat(m_func(unflat(w)))
            p_act = active * (it > 0).astype(rdtype) \
                * (1.0 if use_p else 0.0)
            p = scale(s["p"], p_act)
            hp = scale(s["hp"], p_act)
            mp = scale(s["mp"], p_act)

            s_all = cat(s["x"], w, p)
            hs_all = cat(s["hx"], hw, hp)
            ms_all = cat(s["mx"], mw, mp)
            basis_mask = jnp.concatenate((ones_m, active, p_act))
            keep = (basis_mask[:, None] * basis_mask[None, :]).astype(f64)
            dead = (1.0 - basis_mask).astype(f64)

            g_re, g_im = gram_herm(s_all, ms_all)
            g_re = g_re * keep + jnp.diag(dead)
            g_im = g_im * keep
            gh_re, gh_im = gram_herm(s_all, hs_all)
            gh_re, gh_im = gh_re * keep, gh_im * keep
            dead_val = jnp.sqrt(jnp.sum(gh_re**2 + gh_im**2)) + 1.0
            gh_re = gh_re - dead_val * jnp.diag(dead)

            theta_all, c_all = rs_mod.pencil_f64_embedding(
                (gh_re, gh_im), (g_re, g_im), split=split)
            n_dead = (3 * m - jnp.sum(basis_mask)).astype(jnp.int32)
            # Dead-column compaction: the dead columns sort first.
            theta = lax.dynamic_slice(theta_all, (n_dead,), (m,))
            bm = basis_mask.astype(f64)[:, None]
            zero = jnp.int32(0)
            c_re = lax.dynamic_slice(c_all[0], (zero, n_dead), (3 * m, m)) * bm
            c_im = lax.dynamic_slice(c_all[1], (zero, n_dead), (3 * m, m)) * bm
            cxr, cwr, cpr = c_re[:m], c_re[m:2 * m], c_re[2 * m:]
            cxi, cwi, cpi = c_im[:m], c_im[m:2 * m], c_im[2 * m:]
            cx = (cxr.astype(rdtype), cxi.astype(rdtype))
            cw = (cwr.astype(rdtype), cwi.astype(rdtype))
            cp = (cpr.astype(rdtype), cpi.astype(rdtype))

            def upd(blocks: Pair):
                bx = (blocks[0][:m], blocks[1][:m])
                bw = (blocks[0][m:2 * m], blocks[1][m:2 * m])
                bp = (blocks[0][2 * m:], blocks[1][2 * m:])
                t_w = rr.mix_pair(cw, bw)
                t_p = rr.mix_pair(cp, bp)
                t_x = rr.mix_pair(cx, bx)
                pn = (t_w[0] + t_p[0], t_w[1] + t_p[1])
                xn = (t_x[0] + pn[0], t_x[1] + pn[1])
                return xn, pn

            x_new, p_new = upd(s_all)
            hx_new, hp_new = upd(hs_all)
            mx_new, mp_new = upd(ms_all)

            nan_rr = jnp.isnan(theta).any()
            new_status = jnp.where(nan_rr, Status.NAN,
                                   Status.RUNNING).astype(jnp.int32)
            return dict(
                s, it=it + 1, status=new_status,
                lambdas=theta.astype(rdtype),
                x=x_new, hx=hx_new, mx=mx_new,
                p=p_new, hp=hp_new, mp=mp_new,
                res_his=res_his, best_res=best_res, best_it=best_it,
                best_lambdas=best_lambdas,
            )

        return lax.cond(status != Status.RUNNING, finish, step, None)

    final = lax.while_loop(cond_fun, body_fun, state0)
    status = jnp.where(final["status"] == Status.RUNNING,
                       Status.MAXITER, final["status"]).astype(jnp.int32)
    # On a FLOOR/MAXITER stop report the BEST-seen Ritz values: past the
    # attainable floor the noisy-Gram pencil can corrupt the current
    # lambdas with below-spectrum phantoms (docstring) while the best
    # snapshot still holds the converged values.  CONVERGED keeps the
    # current (tightest) ones.
    lam_out = jnp.where(status == Status.CONVERGED,
                        final["lambdas"], final["best_lambdas"])
    return SolveResult(lam_out, unflat(final["x"]),
                       final["it"], status, final["res_his"])


def lobpcg_sep_max_rs(h_func, x0: Pair, nev: int, *, tol: float = TOL,
                      maxiter: int = MAXITER) -> SolveResult:
    """Largest eigenvalues of H on pairs via the inverse pencil
    I x = mu H x (pair twin of lobpcg_sep_max; reference
    paper_2/lobpcg.py:196-323)."""
    r = lobpcg_gep_rs(lambda v: v, h_func, lambda v: v, x0, nev,
                      tol=tol, maxiter=maxiter, locking=False)
    return r._replace(lambdas=1.0 / r.lambdas)


def descent_gep_rs(h_func, m_func, p_func, x0: Pair, nev: int,
                   **kw) -> SolveResult:
    """Two-term steepest descent for the generalized problem on pairs
    (pair twin of descent_gep; reference paper_2/lobpcg.py:976-1100)."""
    kw["use_p"] = False
    return lobpcg_gep_rs(h_func, m_func, p_func, x0, nev, **kw)
