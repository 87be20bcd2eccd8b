"""Blocked LOBPCG (Knyazev) with fixed-shape soft locking, under jax.jit.

Reference algorithm: lobpcg_sep_softlock, paper_2/lobpcg.py:325-492 — the
recommended solver.  Redesign choices:

* the whole iteration is a ``lax.while_loop`` inside one ``jit``: no
  host round-trips, no recompiles across iterations or k-points;
* soft locking is mask-based: converged residual/P columns are zeroed and
  excluded from the Rayleigh-Ritz via phantom coordinates (decoupled Ritz
  value -1, sliced off below the physical window) instead of the
  reference's dynamic column compaction (lobpcg.py:429-437) — same
  subspace, static shapes;
* W and P columns are re-normalized each iteration (not in the reference);
  this keeps the Gram matrix well-conditioned so the Cholesky-based RR is
  stable in complex64 — the key to the fast single-precision path;
* NaN / stagnation / blow-up guards (reference lobpcg.py:404-415) are traced
  ``lax`` conditionals that set a status code instead of raising.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pcx.config import MAXITER, TOL
from pcx.solvers import rayleigh_ritz as rr_mod
from pcx.utils import norms, real_dtype


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    MAXITER = 2
    NAN = 3
    BLOWUP = 4
    # Residuals stopped improving at the single-precision noise floor of the
    # operator apply (~eps * max|symbol|): the best attainable point.  The
    # caller's spurious-eigenvalue validation decides acceptability.
    FLOOR = 5


class SolveResult(NamedTuple):
    lambdas: jnp.ndarray        # (m,) Ritz values (shift removed)
    x: jnp.ndarray              # (m, ...) Ritz vectors
    iterations: jnp.ndarray     # scalar int
    status: jnp.ndarray         # scalar int (Status)
    res_history: jnp.ndarray    # (maxiter,) norm of res[:nev], nan-padded


class _State(NamedTuple):
    it: jnp.ndarray
    status: jnp.ndarray
    lambdas: jnp.ndarray
    x: jnp.ndarray
    hx: jnp.ndarray
    p: jnp.ndarray
    hp: jnp.ndarray
    res_his: jnp.ndarray
    best_res: jnp.ndarray
    best_it: jnp.ndarray


def _col_normalize(block: jnp.ndarray, eps: float, axis_name=None):
    n = norms(block, axis_name=axis_name)
    scale = 1.0 / jnp.maximum(n, eps)
    shape = (-1,) + (1,) * (block.ndim - 1)
    return block * scale.reshape(shape).astype(block.dtype), n


def lobpcg_sep(
    h_func: Callable,
    p_func: Callable,
    x0: jnp.ndarray,
    nev: int,
    *,
    shift: float = 0.0,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    maxstagniter: int = 50,
    ortho_passes: int = 1,
    rr_mode: str = "auto",
    refresh_every: int = 10,
    floor_patience: int = 9,
    reduce_axis=None,
    use_p: bool = True,
    rr_mirror: bool = False,
    ortho: str = "svqb",
) -> SolveResult:
    """LOBPCG for the standard Hermitian eigenproblem H x = lambda x.

    h_func / p_func operate on blocks shaped like ``x0`` = (m, ...).
    Traceable: wrap in jax.jit (h_func/p_func must be traceable closures).
    ``locking=False`` reproduces the reference's nolock variant
    (paper_2/lobpcg.py:76-193).
    """
    m = x0.shape[0]
    cdtype = x0.dtype
    rdtype = real_dtype(cdtype)
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    jitter = 100.0 * float(jnp.finfo(rdtype).eps)
    dim = 1
    for d in x0.shape[1:]:
        dim *= d
    noise_floor = 30.0 * (dim ** 0.5) * float(jnp.finfo(rdtype).eps)
    bshape = (-1,) + (1,) * (x0.ndim - 1)

    if shift != 0.0:
        h_in = h_func
        h_func = lambda v: h_in(v) + jnp.asarray(shift, cdtype) * v

    def flat(a):
        return a.reshape(3 * m, -1) if a.shape[0] == 3 * m else a.reshape(a.shape[0], -1)

    # ------------------------------------------------------------------
    # Initialization: Ritz-rotate the start block (the reference computes
    # initial Ritz values without rotating, lobpcg.py:378-381; rotating is
    # strictly better and changes nothing after iteration 1).
    # ------------------------------------------------------------------
    use_f64_rr = (rr_mode in ("f64", "fast")) or (
        rr_mode == "auto" and cdtype == jnp.complex64)
    ones_m = jnp.ones((m,), rdtype)

    x = x0
    if normalize:
        x, _ = _col_normalize(x, tiny, axis_name=reduce_axis)
    if use_f64_rr:
        # f64 RR path: no complex cholesky/eigh — Loewdin orthonormalize
        # then diagonalize the projected operator via the f64 real embedding.
        xf, _ = rr_mod.masked_loewdin(flat(x), ones_m, jitter,
                                      axis_name=reduce_axis)
        hxf = flat(h_func(xf.reshape(x.shape)))
        t_re, t_im = rr_mod.gram_f64(xf, hxf, axis_name=reduce_axis)
        theta0, v_re, v_im = rr_mod.eigh_f64_embedding(
            0.5 * (t_re + t_re.T), 0.5 * (t_im - t_im.T),
            split=rr_mod.split_for(rdtype))
        c0 = jax.lax.complex(v_re.astype(rdtype),
                             v_im.astype(rdtype)).astype(cdtype)
        x = rr_mod.mix(c0, xf).reshape(x.shape)
        hx = rr_mod.mix(c0, hxf).reshape(x.shape)
        lambdas0 = theta0.astype(rdtype)
    else:
        hx = h_func(x)
        theta0, c0 = rr_mod.rayleigh_ritz(flat(x), flat(hx))
        x = rr_mod.mix(c0, flat(x)).reshape(x.shape)
        hx = rr_mod.mix(c0, flat(hx)).reshape(x.shape)
        lambdas0 = theta0.real.astype(rdtype)

    zeros_block = jnp.zeros_like(x)
    state0 = _State(
        it=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(Status.RUNNING, jnp.int32),
        lambdas=lambdas0,
        x=x, hx=hx, p=zeros_block, hp=zeros_block,
        res_his=jnp.full((maxiter,), jnp.nan, rdtype),
        best_res=jnp.asarray(jnp.inf, rdtype),
        best_it=jnp.asarray(0, jnp.int32),
    )

    def cond_fun(s: _State):
        return (s.status == Status.RUNNING) & (s.it < maxiter)

    def body_fun(s: _State):
        it = s.it
        # Periodic HX/HP refresh: the recombination update (gemms)
        # accumulates rounding drift between HX and H(X) (and HP vs H(P));
        # in complex64 the drift feeds back into the projected pencil, which
        # then admits below-spectrum phantom Ritz values and can destabilize
        # the iteration (observed at N=120, ||H|| ~ 1e5).  Two extra
        # operator applies every `refresh_every` iterations pin both down.
        do_refresh = ((refresh_every > 0) & (it > 0)
                      & (jnp.mod(it, refresh_every) == 0))
        hx_cur = lax.cond(do_refresh, lambda: h_func(s.x), lambda: s.hx)
        hp_cur = lax.cond(do_refresh, lambda: h_func(s.p), lambda: s.hp)
        s = s._replace(hp=hp_cur)

        # Residual R = lambda*X - HX (reference stores it in the W slot,
        # lobpcg.py:394-395).
        r = s.lambdas.reshape(bshape).astype(cdtype) * s.x - hx_cur
        res = norms(r, axis_name=reduce_axis)
        res_max = jnp.max(res[:nev])
        res_nev = jnp.linalg.norm(res[:nev])
        res_his = s.res_his.at[it].set(res_nev)

        first_rec = res_his[1]

        # Noise-floor detection: no meaningful best-residual improvement for
        # `floor_patience` iterations => the iterate is at the attainable
        # accuracy of this dtype.  (Reference has no analog: f64 always
        # reaches tol; complex64 needs this.)  The 5% improvement
        # threshold is oscillation-proof at the floor, where HX-drift makes
        # the residual wobble by ~2x with ~4% downward noise creep (measured
        # res histories, N=32/48 c64); mid-convergence improvements are
        # 20-30%/iteration, far above it.
        improved = res_max < s.best_res * 0.95
        best_res = jnp.where(improved, res_max, s.best_res)
        best_it = jnp.where(improved, it, s.best_it)
        # FLOOR is only admissible when the residual is plausibly AT the
        # dtype's attainable level (~eps*sqrt(D)*||T||; measured ~2.3x that
        # at N=32/48 c64) — otherwise slow tail convergence (<5% per
        # patience window, e.g. unpreconditioned f64 problems) would be
        # misclassified as a floor.
        floor_gate = (10.0 * noise_floor / 30.0
                      * jnp.maximum(jnp.max(jnp.abs(s.lambdas)), 1.0))
        # No `res_max < first_rec` term: warm starts begin AT the floor,
        # so improvement-over-start can never hold (see lobpcg_rs.py).
        floored = ((floor_patience > 0) & (it - best_it > floor_patience)
                   & (it > 3) & (res_max < floor_gate))
        # Hard-patience floor (see lobpcg_rs.py): 4x window, no absolute
        # gate — downstream f64 validation decides acceptance.
        floored = floored | ((floor_patience > 0) & (it > 3)
                             & (it - best_it > 4 * floor_patience + 4))

        is_nan = jnp.isnan(res).any()
        converged = res_max < tol
        # Stagnation / blow-up guard (reference: lobpcg.py:408-415),
        # referenced to max(start level, 10x attainable floor) so a warm
        # start hovering at the floor is not misread as divergence.
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

        s = s._replace(hx=hx_cur, best_res=best_res, best_it=best_it)

        def finish(_):
            return s._replace(it=it, status=status, res_his=res_his)

        def step(_):
            if locking:
                active = (res > tol).astype(rdtype)
            else:
                active = ones_m
            amask = active.reshape(bshape).astype(cdtype)
            xf, hxf = flat(s.x), flat(s.hx)

            # Precondition the active residuals (reference: lobpcg.py:442),
            # then build an ORTHONORMAL [X | W | P] basis: W projected off X
            # and Cholesky-QR'd; P projected off X and W and Cholesky-QR'd
            # (HP transformed consistently, no extra operator applies).
            # The reference iterates on a raw basis and factors the Gram in
            # the RR (orthogonalization.py:140-154); the orthonormal-basis
            # form is what makes complex64 stable.
            # W: preconditioned residuals, MGS-orthonormalized against X
            # and internally, with dependent-column dropping.  masked_mgs
            # guarantees every surviving column is exactly unit and
            # orthogonal — spurious below-spectrum Ritz values (the failure
            # mode of jitter-clamped factorizations on nearly dependent
            # blocks) are structurally impossible.
            # Orthonormalizer: SVQB-with-dropping (GEMM-bound, 2 passes) by
            # default; sequential masked MGS kept as an option (same drop
            # rule, ~5x more HBM traffic — see rayleigh_ritz.masked_svqb_drop).
            ortho_fn = (rr_mod.masked_svqb_drop if ortho == "svqb"
                        else rr_mod.masked_mgs)
            w = p_func(r * amask) * amask
            wf, _ = _col_normalize(flat(w), tiny, axis_name=reduce_axis)
            wf, _, w_ok = ortho_fn(
                wf, active, noise_floor, against=(xf,),
                axis_name=reduce_axis, passes=ortho_passes)
            hw = h_func(wf.reshape(s.x.shape))
            hwf = flat(hw)

            p_act = active * (it > 0) * (1.0 if use_p else 0.0)
            pcol = p_act[:, None].astype(cdtype)
            pf, hpf = flat(s.p) * pcol, flat(s.hp) * pcol
            pf, pn = _col_normalize(pf, tiny, axis_name=reduce_axis)
            hpf = hpf * (1.0 / jnp.maximum(pn, tiny))[:, None].astype(cdtype)
            pf, hpf, p_ok = ortho_fn(
                pf, p_act, noise_floor, hblock=hpf,
                against=(xf, wf), h_against=(hxf, hwf),
                axis_name=reduce_axis, passes=ortho_passes)

            basis_mask = jnp.concatenate((ones_m, w_ok, p_ok))
            blocks = (xf, wf, pf)
            hblocks = (hxf, hwf, hpf)

            # Rayleigh-Ritz on the orthonormal basis: plain eigh of S^H H S,
            # with dead coordinates decoupled at Ritz value -1 (sorts below
            # the positive spectrum of the shifted HPD operator).  T is
            # assembled from 3x3 (m, m) block Grams — no (3m, D) concat
            # copies of the full-length blocks (2x ~2 GB saved at N=120).
            keep = basis_mask[:, None] * basis_mask[None, :]
            if use_f64_rr:
                # f64-accumulated Gram + f64 real-embedding eigh on device:
                # the RR eigenvalue error drops from eps_f32*||T|| (too
                # coarse for the 1e-4 tolerance) to f64 level.  With
                # rr_mirror=True only the upper block triangle is computed
                # (6 of 9 block Grams, ~33% cheaper RR) at the cost of one
                # decimal of omega accuracy (hermitizing two independently
                # computed triangles averages rounding out); default keeps
                # the full 9 for accuracy.
                rows_re = [[None] * 3 for _ in range(3)]
                rows_im = [[None] * 3 for _ in range(3)]
                for i, bi in enumerate(blocks):
                    for j, hbj in enumerate(hblocks):
                        if rr_mirror and j < i:
                            continue
                        tre, tim = rr_mod.gram_f64(bi, hbj,
                                                   axis_name=reduce_axis)
                        rows_re[i][j] = tre
                        rows_im[i][j] = tim
                        if rr_mirror and j > i:
                            rows_re[j][i] = tre.T
                            rows_im[j][i] = -tim.T
                t_re = jnp.block(rows_re)
                t_im = jnp.block(rows_im)
                keep64 = keep.astype(jnp.float64)
                t_re = 0.5 * (t_re + t_re.T) * keep64
                t_im = 0.5 * (t_im - t_im.T) * keep64
                # Dead-coordinate sentinel STRICTLY below any possible Ritz
                # value (|Ritz| <= ||T||_F), so the physical window never
                # misaligns even when drift noise makes Ritz values negative
                # (a fixed -1 sentinel collapsed X once noise crossed it).
                dead_val = jnp.sqrt(jnp.sum(t_re**2) + jnp.sum(t_im**2)) + 1.0
                t_re = t_re - dead_val * jnp.diag(1.0 - basis_mask).astype(
                    jnp.float64)
                if rr_mode == "fast":
                    theta_all, v_re, v_im = rr_mod.eigh_embedding_refined(
                        t_re, t_im)
                else:
                    theta_all, v_re, v_im = rr_mod.eigh_f64_embedding(
                        t_re, t_im, split=rr_mod.split_for(rdtype))
                theta_all = theta_all.astype(rdtype)
                c_all = jax.lax.complex(
                    v_re.astype(rdtype), v_im.astype(rdtype)).astype(cdtype)
            else:
                t_mat = jnp.block([
                    [rr_mod.gram(bi, hbj, axis_name=reduce_axis)
                     for hbj in hblocks] for bi in blocks])
                t_mat = rr_mod.hermitize(t_mat) * keep
                dead_val = jnp.linalg.norm(t_mat) + 1.0
                t_mat = t_mat - dead_val * jnp.diag(1.0 - basis_mask).astype(
                    cdtype)
                theta_all, c_all = jnp.linalg.eigh(t_mat)
            n_dead = (3 * m - jnp.sum(basis_mask)).astype(jnp.int32)
            theta = lax.dynamic_slice(theta_all.real, (n_dead,), (m,))
            c = lax.dynamic_slice(c_all, (jnp.int32(0), n_dead), (3 * m, m))
            c = c * basis_mask[:, None].astype(cdtype)

            # Block update (reference: _sep_update_after_rr,
            # lobpcg.py:1248-1270): P_new from W,P parts; X_new = X C_x + P_new.
            c_x, c_w, c_p = c[:m], c[m:2 * m], c[2 * m:]
            p_new = rr_mod.mix(c_w, wf) + rr_mod.mix(c_p, pf)
            hp_new = rr_mod.mix(c_w, hwf) + rr_mod.mix(c_p, hpf)
            x_new = rr_mod.mix(c_x, xf) + p_new
            hx_new = rr_mod.mix(c_x, hxf) + hp_new

            nan_rr = jnp.isnan(theta).any()
            new_status = jnp.where(nan_rr, Status.NAN, Status.RUNNING).astype(jnp.int32)

            return _State(
                it=it + 1,
                status=new_status,
                lambdas=theta.astype(rdtype),
                x=x_new.reshape(s.x.shape),
                hx=hx_new.reshape(s.x.shape),
                p=p_new.reshape(s.x.shape),
                hp=hp_new.reshape(s.x.shape),
                res_his=res_his,
                best_res=best_res,
                best_it=best_it,
            )

        return lax.cond(status != Status.RUNNING, finish, step, None)

    final = lax.while_loop(cond_fun, body_fun, state0)
    status = jnp.where(final.status == Status.RUNNING,
                       Status.MAXITER, final.status).astype(jnp.int32)
    return SolveResult(
        lambdas=final.lambdas - shift,
        x=final.x,
        iterations=final.it,
        status=status,
        res_history=final.res_his,
    )


def lobpcg_sep_softlock(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Soft-locking variant (reference: lobpcg.py:325-492, RECOMMENDED)."""
    kw.setdefault("locking", True)
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def lobpcg_sep_nolock(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """No-locking variant (reference: lobpcg.py:76-193)."""
    kw["locking"] = False
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def descent_sep(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Two-term preconditioned steepest descent: the [X | W] iteration
    without the LOBPCG conjugate block (reference: descent_sep,
    paper_2/lobpcg.py:847-974).  Slower than LOBPCG; kept for the
    reference's ablation studies."""
    kw["use_p"] = False
    return lobpcg_sep(h_func, p_func, x0, nev, **kw)


def lobpcg_sep_mixedprecision(h_func, p_func, x0, nev, **kw) -> SolveResult:
    """Mixed precision: single-precision preconditioner, full-precision
    everything else (reference: lobpcg.py:494-629)."""
    cdtype = x0.dtype
    low = jnp.complex64

    def p_low(v):
        return p_func(v.astype(low)).astype(cdtype)

    return lobpcg_sep(h_func, p_low, x0, nev, **kw)


def lobpcg_sep_max(h_func, x0, nev, *, tol: float = TOL,
                   maxiter: int = MAXITER,
                   rr_pencil: str = "auto") -> SolveResult:
    """Largest eigenvalues of H via the inverse formulation x = mu H x
    (mu = 1/lambda smallest) — reference: lobpcg_sep_max_nolock,
    paper_2/lobpcg.py:196-323.

    Solved as the generalized problem I x = mu H x by LOBPCG on the pencil.
    """
    result = lobpcg_gep(
        h_func=lambda v: v,
        m_func=h_func,
        p_func=lambda v: v,
        x0=x0, nev=nev, tol=tol, maxiter=maxiter, locking=False,
        rr_pencil=rr_pencil,
    )
    return result._replace(lambdas=1.0 / result.lambdas)


def lobpcg_gep(
    h_func: Callable,
    m_func: Callable,
    p_func: Callable,
    x0: jnp.ndarray,
    nev: int,
    *,
    tol: float = TOL,
    maxiter: int = MAXITER,
    locking: bool = True,
    normalize: bool = True,
    use_p: bool = True,
    rr_pencil: str = "auto",
) -> SolveResult:
    """LOBPCG for the generalized problem H x = lambda M x (M HPD).

    Reference: lobpcg_gep_softlock, paper_2/lobpcg.py:688-838.
    Implementation mirrors lobpcg_sep with M-inner products in the
    Rayleigh-Ritz and residual R = lambda*MX - HX.

    ``rr_pencil``: small-pencil solver — "chol" (complex Cholesky,
    reference GEP_chol), "embedding" (f64 real *-algebra embedding; no
    complex Cholesky/triangular solves), or
    "auto" (embedding for complex64 inputs, chol otherwise).
    """
    m = x0.shape[0]
    cdtype = x0.dtype
    if rr_pencil == "auto":
        rr_pencil = ("embedding" if cdtype == jnp.complex64 else "chol")
    pencil = (rr_pencil if callable(rr_pencil)
              else {"embedding": rr_mod.eigh_pencil_embedding,
                    "whiten": rr_mod.eigh_pencil_whiten,
                    "chol": rr_mod.eigh_pencil}[rr_pencil])
    rdtype = real_dtype(cdtype)
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    bshape = (-1,) + (1,) * (x0.ndim - 1)

    def flat(a):
        return a.reshape(a.shape[0], -1)

    x = x0
    if normalize:
        x, _ = _col_normalize(x, tiny)
    hx, mx = h_func(x), m_func(x)
    g = rr_mod.hermitize(rr_mod.gram(flat(x), flat(mx)))
    gh = rr_mod.hermitize(rr_mod.gram(flat(x), flat(hx)))
    theta0, c0 = pencil(gh, g)
    x = rr_mod.mix(c0, flat(x)).reshape(x.shape)
    hx = rr_mod.mix(c0, flat(hx)).reshape(x.shape)
    mx = rr_mod.mix(c0, flat(mx)).reshape(x.shape)

    zeros_block = jnp.zeros_like(x)
    ones_m = jnp.ones((m,), rdtype)

    class _GState(NamedTuple):
        it: jnp.ndarray
        status: jnp.ndarray
        lambdas: jnp.ndarray
        x: jnp.ndarray
        hx: jnp.ndarray
        mx: jnp.ndarray
        p: jnp.ndarray
        hp: jnp.ndarray
        mp: jnp.ndarray
        res_his: jnp.ndarray

    state0 = _GState(
        jnp.asarray(0, jnp.int32), jnp.asarray(Status.RUNNING, jnp.int32),
        theta0.real.astype(rdtype), x, hx, mx,
        zeros_block, zeros_block, zeros_block,
        jnp.full((maxiter,), jnp.nan, rdtype),
    )

    def cond_fun(s):
        return (s.status == Status.RUNNING) & (s.it < maxiter)

    def body_fun(s):
        it = s.it
        r = s.lambdas.reshape(bshape).astype(cdtype) * s.mx - s.hx
        # Per-column RELATIVE residual: after the Rayleigh-Ritz mix the
        # columns are M-orthonormal, not 2-orthonormal, so their 2-norms
        # carry the pencil's scale.  In the inverse (max-eigenvalue)
        # formulation I x = mu H x that scale is ||x|| ~ 1/sqrt(lambda)
        # ~ 1e-3, and an ABSOLUTE test `norms(r) < tol` fires at the
        # first iteration while lambda_max is still 35% wrong (found by
        # the smoke's power-method cross-check).  Dividing by the column
        # norms makes the test scale-invariant; for the standard GEP use
        # (M = I + B/bmax, columns O(1)) it is numerically unchanged.
        res = norms(r) / jnp.maximum(norms(s.x), tiny)
        res_his = s.res_his.at[it].set(jnp.linalg.norm(res[:nev]))
        is_nan = jnp.isnan(res).any()
        converged = jnp.max(res[:nev]) < tol
        status = jnp.where(is_nan, Status.NAN,
                           jnp.where(converged, Status.CONVERGED,
                                     Status.RUNNING)).astype(jnp.int32)

        def finish(_):
            return s._replace(it=it, status=status, res_his=res_his)

        def step(_):
            active = (res > tol).astype(rdtype) if locking else ones_m
            amask = active.reshape(bshape).astype(cdtype)
            w = p_func(r * amask) * amask
            if normalize:
                w, _ = _col_normalize(w, tiny)
            hw, mw = h_func(w), m_func(w)
            p_act = active * (it > 0) * (1.0 if use_p else 0.0)
            pmask = p_act.reshape(bshape).astype(cdtype)
            p, hp, mp = s.p * pmask, s.hp * pmask, s.mp * pmask

            s_all = jnp.concatenate((s.x, w, p), axis=0)
            hs_all = jnp.concatenate((s.hx, hw, hp), axis=0)
            ms_all = jnp.concatenate((s.mx, mw, mp), axis=0)
            basis_mask = jnp.concatenate((ones_m, active, p_act))

            keep = basis_mask[:, None] * basis_mask[None, :]
            dead = (1.0 - basis_mask)
            g = rr_mod.hermitize(rr_mod.gram(flat(s_all), flat(ms_all))) * keep \
                + jnp.diag(dead).astype(cdtype)
            gh = rr_mod.hermitize(rr_mod.gram(flat(s_all), flat(hs_all))) * keep
            dead_val = jnp.linalg.norm(gh) + 1.0
            gh = gh - dead_val * jnp.diag(dead).astype(cdtype)
            theta_all, c_all = pencil(gh, g)
            n_dead = (3 * m - jnp.sum(basis_mask)).astype(jnp.int32)
            theta = lax.dynamic_slice(theta_all, (n_dead,), (m,)).real
            c = lax.dynamic_slice(c_all, (jnp.int32(0), n_dead), (3 * m, m))
            c = c * basis_mask[:, None]

            c_x, c_w, c_p = c[:m], c[m:2 * m], c[2 * m:]

            def upd(sf):
                pn = rr_mod.mix(c_w, sf[m:2 * m]) + rr_mod.mix(c_p, sf[2 * m:])
                xn = rr_mod.mix(c_x, sf[:m]) + pn
                return xn, pn

            x_new, p_new = upd(flat(s_all))
            hx_new, hp_new = upd(flat(hs_all))
            mx_new, mp_new = upd(flat(ms_all))

            nan_rr = jnp.isnan(theta).any()
            new_status = jnp.where(nan_rr, Status.NAN,
                                   Status.RUNNING).astype(jnp.int32)
            shp = s.x.shape
            return _GState(
                it + 1, new_status, theta.astype(rdtype),
                x_new.reshape(shp), hx_new.reshape(shp), mx_new.reshape(shp),
                p_new.reshape(shp), hp_new.reshape(shp), mp_new.reshape(shp),
                res_his,
            )

        return lax.cond(status != Status.RUNNING, finish, step, None)

    final = lax.while_loop(cond_fun, body_fun, state0)
    status = jnp.where(final.status == Status.RUNNING,
                       Status.MAXITER, final.status).astype(jnp.int32)
    return SolveResult(final.lambdas, final.x, final.it, status, final.res_his)


# ---------------------------------------------------------------------------
# Convenience wrapper for explicit matrices (reference: lobpcg_default,
# paper_2/lobpcg.py:28-61).
# ---------------------------------------------------------------------------

def lobpcg_default(a, nev: int = 20, rlx: int = 4, prec=None,
                   maxmin: str = "min", tol: float = TOL,
                   maxiter: int = MAXITER, seed: int = 0) -> SolveResult:
    """Smallest (or largest) eigenvalues of an explicit Hermitian operator.

    ``a`` is either a dense jnp matrix or a (function, size) tuple.
    """
    if isinstance(a, tuple):
        h_vec, n = a

        def h_func(block):                  # block (m, n) rows = vectors
            return jax.vmap(h_vec)(block)
    else:
        a = jnp.asarray(a)
        n = a.shape[0]
        # y_i = a @ block_i row-wise is Y = block @ a^T (full precision:
        # an f32 product at default precision may run in TF32 on a GPU).
        at = a.T

        def h_func(block):
            return jnp.matmul(block, at,
                              precision=jax.lax.Precision.HIGHEST
                              ).astype(block.dtype)

    p_func = (lambda v: v) if prec is None else prec
    dt = a.dtype if not isinstance(a, tuple) else jnp.complex128
    rdt = real_dtype(dt)
    # Host-side start block: x0 depends only on static shape/seed (the
    # reference draws it with numpy).
    import numpy as _np
    rng = _np.random.default_rng(seed)
    x0 = jnp.asarray(rng.uniform(size=(nev + rlx, n))
                     + 1j * rng.uniform(size=(nev + rlx, n))).astype(
                         jnp.promote_types(dt, jnp.complex64))
    if maxmin == "min":
        return lobpcg_sep_softlock(h_func, p_func, x0, nev, tol=tol,
                                   maxiter=maxiter)
    if maxmin == "max":
        return lobpcg_sep_max(h_func, x0, nev, tol=tol, maxiter=maxiter)
    raise ValueError("maxmin should be 'min' or 'max'.")


def descent_gep(h_func, m_func, p_func, x0, nev, **kw) -> SolveResult:
    """Two-term steepest descent for the generalized problem
    (reference: descent_gep, paper_2/lobpcg.py:976-1100)."""
    kw["use_p"] = False
    return lobpcg_gep(h_func, m_func, p_func, x0, nev, **kw)


def lobpcg_svd(a_func: Callable, at_func: Callable, x0: jnp.ndarray,
               nev: int, p_func=None, largest: bool = False,
               tol: float = TOL, maxiter: int = MAXITER) -> SolveResult:
    """Extreme singular triplets of a linear operator K via the Hermitian
    problem K^H K v = sigma^2 v.

    The reference ships an INCOMPLETE lobpcg4svd_sep (paper_2/lobpcg.py:
    1102-1242, uses undefined variables); this is the working equivalent:
    right singular vectors from LOBPCG on the normal operator, singular
    values as sqrt of its Ritz values.
    """
    h = lambda v: at_func(a_func(v))
    if largest:
        res = lobpcg_sep_max(h, x0, nev, tol=tol, maxiter=maxiter)
    else:
        res = lobpcg_sep_softlock(h, p_func or (lambda v: v), x0, nev,
                                  tol=tol, maxiter=maxiter)
    sig = jnp.sqrt(jnp.maximum(res.lambdas, 0.0))
    return res._replace(lambdas=sig)
