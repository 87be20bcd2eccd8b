"""Band-structure drivers: single-k-point solve and the full BZ sweep with
checkpoint/resume, warm starts, and failure containment.

Reference: eigen_1p (numerical_experiments.py:209-247) and bandgap
(numerical_experiments.py:313-496).  The LOBPCG solve is jitted ONCE per
(grid, block-width, dtype) with the k-dependent symbols as *arguments*, so
the entire sweep reuses one executable — no per-k-point recompilation (the
reference re-builds CUDA graphs per call).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import lru_cache, partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from pcx import boundary, lattices, stencils, validate
from pcx.config import (GAP, MAXITER, NEV, TOL, ProblemConfig, SCAL,
                        apply_chunk_for, block_width, device_policy,
                        set_relaxation)
from pcx.io import BandLibrary
from pcx.operators import dielectric as diel_mod
from pcx.operators import dft as dft_mod
from pcx.operators import maxwell
from pcx.operators import rs
from pcx.operators import symbols as sym
from pcx.operators.blocks import h_block
from pcx.solvers import lobpcg as lob
from pcx.solvers import lobpcg_rs as lob_rs
from pcx.solvers import rayleigh_ritz as rr
from pcx.utils import GREEN, RED, RESET, YELLOW, dots, norms, real_dtype


def _heartbeat():
    """Touch the liveness file named by PCX_HEARTBEAT (if set).

    Called after every completed solver segment (device round-trip), so a
    supervisor can distinguish "device actively iterating" from a hung
    worker — the checkpoint JSON only advances per k-POINT, which on a
    doomed/long solve can legitimately be many minutes apart, while
    segments complete within seconds; see pcx.supervisor heartbeat
    watchdog.
    """
    path = os.environ.get("PCX_HEARTBEAT")
    if not path:
        return
    try:
        with open(path, "a"):
            pass
        os.utime(path)
    except OSError:
        pass


@dataclasses.dataclass
class EigenResult:
    omega: np.ndarray            # penalized frequencies (nev,)
    omega_re: np.ndarray         # recomputed frequencies (nev,)
    lambdas: np.ndarray          # raw Ritz values (m,), shift removed
    x: jnp.ndarray               # Ritz vectors (m, 3, N, N, N)
    iterations: int
    wall_time: float
    status: int
    report: Optional[validate.ValidationReport]


def _chunked_rs(h_one, m, c):
    """Column-chunked rs operator apply (bounds the apply's HBM working
    set to ``c`` columns via lax.map).  Width-generic: under the solver's
    ``w_cap`` compaction the W block arrives at width < m, so the chunk
    is re-derived per (static) input width; non-divisible widths fall
    back to the largest divisor <= c."""
    if not (c and m > c):
        return h_one

    def h_func(v):
        w = v[0].shape[0]
        cw = max(d for d in range(1, min(c, w) + 1) if w % d == 0)
        if w <= cw:
            return h_one(v)
        vc = tuple(a.reshape((w // cw, cw) + a.shape[1:]) for a in v)
        out = jax.lax.map(h_one, vc)
        return tuple(a.reshape((w,) + a.shape[2:]) for a in out)

    return h_func


_RS_CORE = ("ortho_passes", "refresh_every", "floor_patience",
            "maxstagniter", "use_p", "rr_gram", "rr_mirror", "w_cap",
            "col_patience", "lam_tol", "lam_patience", "lam_res_tol")


def _filter_rs_opts(opts, *, strip_w_cap=False):
    """Validate solver_opts for the pair-layout solver; return the subset
    forwarded to rs_solver_parts/lobpcg_sep_rs.  Shared by the four rs
    entry paths so the supported list cannot drift; raises on unknown keys
    everywhere (silent drops hid typos)."""
    dropped = sorted(set(opts) - set(_RS_CORE))
    if dropped:
        raise ValueError(
            f"solver_opts {dropped} are not supported by the pair-layout "
            f"solver (solver_impl='rs'); pass solver_impl='complex' to "
            f"use them")
    rs_opts = {k: v for k, v in opts.items() if k in _RS_CORE}
    ow = rs_opts.get("w_cap")
    if ow is not None and not (ow == "auto" or
                               (isinstance(ow, int)
                                and not isinstance(ow, bool))):
        raise ValueError(f"solver_opts w_cap must be an int or 'auto', "
                         f"got {ow!r}")
    if strip_w_cap:
        rs_opts.pop("w_cap", None)
    elif ow == "auto":
        # adaptive buckets need the segmented trampoline; one-shot and
        # batched programs run full width
        rs_opts["w_cap"] = None
    return rs_opts


class KPointSolver:
    """Reusable jitted solver for one (config, dielectric) across k-points."""

    def __init__(self, cfg: ProblemConfig, dtype=jnp.complex128,
                 tol: float = TOL, maxiter: int = MAXITER,
                 solver: str = "softlock",
                 diel: Optional[diel_mod.DielectricOp] = None,
                 solver_opts: Optional[dict] = None,
                 real_boundary: Optional[bool] = None,
                 fft_mode: str = "auto", refine=None,
                 apply_chunk: Optional[int] = None,
                 solver_impl: str = "auto", x0_mode: str = "plane_wave",
                 segment_iters: Optional[int] = None):
        self.cfg = cfg
        self.dtype = dtype
        # Cold-start policy: "plane_wave" seeds with transverse plane waves
        # at the lowest vacuum frequencies (~1/3 fewer iterations than the
        # reference's uniform random start, maxwell.plane_wave_cols);
        # "random" matches the reference (num_exp.py:66); "coarse" (or
        # "coarse:<nc>", default nc = n//2) solves the same k-point on a
        # coarse grid and lifts the converged block by exact trigonometric
        # interpolation (dft.upsample_mat) — a two-grid start for the cold
        # points a warm-started sweep cannot cover (first point, retries,
        # single-point benchmarks).
        self._coarse_n = None
        if isinstance(x0_mode, str) and x0_mode.startswith("coarse"):
            _, _, nc = x0_mode.partition(":")
            self._coarse_n = int(nc) if nc else max(8, cfg.n // 2)
            if self._coarse_n >= cfg.n:
                raise ValueError(f"coarse grid {self._coarse_n} must be "
                                 f"smaller than n={cfg.n}")
            x0_mode = "coarse"
        if x0_mode not in ("plane_wave", "random", "coarse"):
            raise ValueError(f"unknown x0_mode {x0_mode!r}")
        self.x0_mode = x0_mode
        # Solver variant (reference eigen_1p's ``solver`` argument,
        # num_exp.py:209): dispatched in run_core; previously any unknown
        # name silently ran softlock.
        if solver not in ("softlock", "nolock", "mixed", "descent",
                          "davidson", "jd"):
            raise ValueError(f"unknown solver {solver!r}")
        self._solver_name = solver
        self._coarse_cache = None
        self._kshard_cache = {}  # (tag, mesh) -> shard_map'd batch callable
        self.policy = device_policy()
        # Column-chunked operator application: applying H over column
        # chunks inside a lax.map bounds the apply's block-sized
        # temporaries at chunk/m of the block for identical FLOPs.  None =
        # auto: on an accelerator, sized from the device's memory limit
        # (config.apply_chunk_for; N=120 fits unchunked on an 80 GB card).
        if apply_chunk is None:
            apply_chunk = 0
            if self.policy.accelerator:
                stats = jax.devices()[0].memory_stats() or {}
                apply_chunk = apply_chunk_for(
                    cfg.n, jnp.dtype(dtype).itemsize,
                    stats.get("bytes_limit"), m=block_width(cfg.nev))
        self.apply_chunk = int(apply_chunk)
        self.tol = tol
        self.maxiter = maxiter
        self.solver_opts = dict(solver_opts or {})
        # Warm-started solves that exceed this iteration count are cut off
        # (status MAXITER) instead of burning to ``maxiter``: healthy warm
        # solves take 13-50 iterations, while a warm chain that drifted
        # onto a spurious/mixed subspace shows slow tail "convergence"
        # that evades the FLOOR heuristics and costs minutes before the
        # acceptance gate rejects it anyway (measured: ~330 s per
        # rejection at N=120, ~5% of sc_flat1 k-points; the cold retry
        # then succeeds in ~20 s).  Enforced host-side on the segmented
        # (trampolined) path only — no recompile, just an earlier stop.
        self.warm_maxiter = int(self.solver_opts.pop("warm_maxiter", 150))
        # Doomed-warm-solve detection (segmented path, host-side): a warm
        # chain that drifted onto a spurious/mixed subspace shows slow
        # false convergence — the frequency-error bound of some tracked
        # column stays above the acceptance gate (~1e-3) while improving
        # <15% per segment.  Healthy warm solves finish in 13-50
        # iterations; a doomed one previously burned warm_maxiter=150
        # (and, crossing segment boundaries, triggered the first compile
        # of a w_cap bucket program mid-sweep).
        # The admissibility signal is the solver's own lam_res_tol cap
        # (lobpcg_rs: res_i < lam_res_tol*4*pi*sqrt(max(|lambda_i|,1))):
        # at the FIRST segment boundary a blatant violation (bound >
        # 10*doom_tol) bails immediately; from the second on, any
        # violation that stalled (<15% residual improvement over a whole
        # segment) bails.  The result surfaces as MAXITER and the sweep's
        # acceptance gate/cold retry takes over — net effect is the same
        # rejection ~70-110 iterations earlier.
        self.doom_check = bool(self.solver_opts.pop("doom_check", True))
        self.doom_tol = float(self.solver_opts.pop(
            "doom_tol", self.solver_opts.get("lam_res_tol", 1e-3)))
        self.last_doom = None  # (it, worst_bound) of the last doom bail
        self.locking = solver != "nolock"
        self.rdt = real_dtype(dtype)
        if jnp.dtype(dtype) == jnp.dtype(jnp.complex64):
            # c64 robustness defaults (large grids, ||H|| ~ 1e5+): a second
            # orthogonalization pass ("twice is enough") keeps the RR basis
            # orthonormal — single-pass MGS can leave noise-dominated columns
            # nearly parallel, and the identity-Gram RR then produces
            # below-spectrum phantom difference-eigenvalues; more frequent
            # HX/HP refreshes bound recombination drift.
            # passes = 1 eigh pass + (passes-1) Gram-NS refinements; the
            # Newton-refined embedding eigh leaves pass-1 output orthonormal
            # to ~e_vec*kappa, and one quadratic NS pass takes that to the
            # f32 noise floor.
            self.solver_opts.setdefault("ortho_passes", 2)
            # Each refresh recomputes HX and HP (2 extra operator applies =
            # ~+20% amortized at refresh_every=5); with the Newton-hardened
            # orthonormalization the recombination drift is low enough for a
            # longer period.  FLOOR patience past the best residual is pure
            # overhead at the c64 floor (validation sits ~1e-7, far below
            # the 1e-3 gate): 6 is ample with the scale-aware floor gate.
            self.solver_opts.setdefault("refresh_every", 8)
            self.solver_opts.setdefault("floor_patience", 6)
        # Real-boundary mode: complex data crosses every jit boundary as
        # (..., 2) real arrays (pcx.boundary).  Off by default — CPU and
        # GPU move complex buffers natively; tests use it to drive the
        # pair-layout solver through the encoded boundary.
        self.rb = bool(real_boundary)
        diel_op = diel if diel is not None else diel_mod.build(
            cfg.diel_type, cfg.n, cfg.lattice, eps_opt=cfg.eps_opt,
            k=cfg.k, dtype=dtype)
        self.diel = self._place(diel_op)
        self.ct = (lattices.ct_matrix(cfg.lattice) if cfg.lattice
                   else np.eye(3))
        self._sym_cache = {}
        # Solver implementation: the pair-layout ("real-split") solver is the
        # production path on accelerators — its Grams and updates run as
        # real GEMMs on split planes with f64-accumulated Rayleigh-Ritz (see
        # solvers.lobpcg_rs).  "complex" keeps the reference-shaped complex
        # solver (default on CPU, where tests exercise all variants).
        if solver_impl == "auto":
            solver_impl = "rs" if ((self.policy.accelerator or self.rb)
                                   and solver == "softlock") else "complex"
        if solver_impl == "rs" and solver not in ("softlock", "nolock",
                                                  "descent", "mixed",
                                                  "davidson", "jd"):
            raise ValueError(f"solver {solver!r} has no pair-layout "
                             f"implementation; pass solver_impl='complex'")
        if solver_impl == "rs" and solver == "descent":
            # descent_sep == softlock without the conjugate block
            # (reference descent_sep, paper_2/lobpcg.py:847-974); the pair
            # solver exposes this directly as use_p=False.
            self.solver_opts.setdefault("use_p", False)
        self.impl = solver_impl
        # FFT path of the complex solver: the backend's FFT (pocketfft on
        # CPU, cuFFT on the GPU) unless fft_mode="matmul" asks for the
        # explicit matmul DFT (operators/dft.py).  The pair solver always
        # uses the backend FFT (rs.fft3_p).
        if fft_mode not in ("auto", "matmul"):
            raise ValueError(f"unknown fft_mode {fft_mode!r}")
        if fft_mode == "matmul" and self.impl == "rs":
            raise ValueError("fft_mode='matmul' applies to the complex "
                             "solver only; the pair solver uses the FFT")
        # Twiddles in the ITERATE dtype: c128 runs on the matmul-DFT path
        # otherwise carry silently f32-truncated factors that cap apply
        # accuracy at ~1e-7.
        self.dft = (self._place(dft_mod.dft_mats(cfg.n, dtype=dtype))
                    if fft_mode == "matmul" else None)
        # f64 refine/validate path: eigenvalues of the c64-iterated subspace
        # are re-extracted by an f64 real-split Rayleigh-Ritz, and the
        # spurious gate measured with f64 quotients — limited by the
        # SUBSPACE, not by c64 apply noise.  Only (N,)-sized 1-D symbol
        # parts go to the device; the (3, N, N, N) symbols are rebuilt
        # there (rs.build_curl_p).
        # ``refine`` values: True/"f64" = f64 refine (most exact, ~13
        # chunked f64 operator applies per call); "light" =
        # working-precision refine (_refine_light_jit, one full-width apply
        # + f64-accumulated Grams, same 1e-3 spurious gate semantics, ~1
        # solver-iteration of cost); False = none.  Default: on for the
        # accelerator path.
        self.refine = (refine if refine is not None
                       else (self.rb or self.policy.accelerator))
        # Device-symbol mode (rs solver): the MAIN solve also rebuilds its
        # (3, N, N, N) symbols on device from the same 1-D parts — a sweep
        # then ships only (N,)-vectors + scalars per k-point instead of
        # ~140 MB of host-built symbols (reference rebuilds cheap per-k
        # symbols on device, num_exp.py:434-446).
        self.dev_sym = self.impl == "rs"
        # Segmented (trampolined) execution: bound every solve device
        # program to this many LOBPCG iterations, re-entering with the
        # device-resident state.  The host-side controls of a solve live at
        # the segment boundaries: the warm-start doom check, the
        # warm_maxiter cap and the w_cap bucket re-entry.  Auto: on for the
        # rs path on accelerators, off on CPU (tests pin the one-shot
        # trace; segment equivalence has its own test).  0 disables.
        if segment_iters is None:
            segment_iters = 40 if (self.dev_sym
                                   and self.policy.accelerator) else 0
        if solver in ("davidson", "jd") and self.impl == "rs":
            # The pair Davidson/JD twins carry a fixed-cap SUBSPACE, not
            # the lobpcg_rs state pytree — no trampoline; one-shot program.
            segment_iters = 0
        self.segment_iters = int(segment_iters)
        if self.refine or self.dev_sym:
            d1 = stencils.symbol_1d(cfg.n, cfg.k, 1, 1.0 / cfg.n) / cfg.scal
            d0 = stencils.symbol_1d(cfg.n, cfg.k, 0) / cfg.scal
            put = lambda a: jax.device_put(np.asarray(a, np.float64))
            self._f64 = dict(
                d1=(put(d1.real), put(d1.imag)),
                d0=(put(d0.real), put(d0.imag)),
                ct=put(lattices.ct_matrix(cfg.lattice) if cfg.lattice
                       else np.eye(3)))
        # k-independent symbol parts on the UNIT cell, built once (reference
        # computes d_fft, di_fft once per sweep, num_exp.py:352); the lattice
        # constant enters as a single 1/scal factor on the whole curl symbol.
        self._d, self._di = sym.curl_symbols(cfg.n, cfg.k, self.ct, scal=1.0)

    @lru_cache(maxsize=8)
    def _jitted(self, m: int):
        """The dielectric op is a jit ARGUMENT (a registered pytree), not a
        closure constant: constants would bloat the executable by the full
        mask arrays."""
        nev, tol, maxiter, locking = (self.cfg.nev, self.tol, self.maxiter,
                                      self.locking)
        opts = self.solver_opts

        chunk = self.apply_chunk
        impl = self.impl

        # round the chunk down to a divisor of m
        c = max((d for d in range(1, min(chunk, m) + 1) if m % d == 0),
                default=0) if chunk else 0

        def _chunked(h_one, pack, unpack):
            if not (c and m > c):
                return h_one

            def h_func(v):
                vc = pack(v)
                return unpack(jax.lax.map(h_one, vc))
            return h_func

        def run_core(d_a, b, inv, shift, x0, diel, dft):
            fusion_only = sorted(k for k in ("rr_gram",
                                             "w_cap", "col_patience",
                                             "lam_tol", "lam_patience",
                                             "lam_res_tol")
                                 if k in opts)
            if fusion_only:
                raise ValueError(
                    f"solver_opts {fusion_only} are pair-layout-solver "
                    f"options; they require solver_impl='rs' "
                    f"(real_boundary=True on CPU)")

            def h_one(v):
                return maxwell.ama_bb(v, d_a, b, diel, dft=dft) + shift * v

            h_func = _chunked(
                h_one,
                lambda v: v.reshape((m // c, c) + v.shape[1:]),
                lambda vc: vc.reshape((m,) + vc.shape[2:]))

            def p_func(v):
                return h_block(v, inv)

            name = self._solver_name
            if name in ("softlock", "nolock"):
                return lob.lobpcg_sep(h_func, p_func, x0, nev, tol=tol,
                                      maxiter=maxiter, locking=locking,
                                      **opts)
            if name == "mixed":
                return lob.lobpcg_sep_mixedprecision(
                    h_func, p_func, x0, nev, tol=tol, maxiter=maxiter,
                    **opts)
            if name == "descent":
                return lob.descent_sep(h_func, p_func, x0, nev, tol=tol,
                                       maxiter=maxiter, **opts)
            from pcx.solvers import davidson as dav
            fn = dav.davidson_sep if name == "davidson" else dav.jd_sep
            kw = {"subspace": opts["subspace"]} if "subspace" in opts else {}
            return fn(h_func, p_func, x0, nev, tol=tol, maxiter=maxiter,
                      **kw)

        def _run_rs_body(d_ap, b_diag, b_sd, inv_diag, inv_sd, shift, x0,
                         diel, dft):
            """Shared pair-layout solver body: symbols already as pairs of
            the iterate's real dtype."""
            x0p = (x0.real, x0.imag)
            rdt = x0.real.dtype

            def h_one(v):
                return rs.ama_bb_p(v, d_ap, b_diag, b_sd, diel, shift=shift)

            h_func = _chunked_rs(h_one, m, c)

            if self._solver_name == "mixed":
                # Mixed precision on pairs (reference lobpcg_sep_
                # mixedprecision, paper_2/lobpcg.py:494-629: low-precision
                # preconditioner, full-precision everything else).  The
                # accelerator iterate is already f32, so "low" is
                # bfloat16.
                lo = jnp.bfloat16
                inv_d_lo = inv_diag.astype(lo)
                inv_s_lo = (inv_sd[0].astype(lo), inv_sd[1].astype(lo))

                def p_func(v):
                    w = rs.h_block_p((v[0].astype(lo), v[1].astype(lo)),
                                     inv_d_lo, inv_s_lo)
                    return (w[0].astype(rdt), w[1].astype(rdt))
            else:
                def p_func(v):
                    return rs.h_block_p(v, inv_diag, inv_sd)

            if self._solver_name in ("davidson", "jd"):
                # pair Davidson/JD twins (fixed-cap subspace; one-shot
                # program — solve() disables the trampoline for these)
                from pcx.solvers import davidson as dav
                fn = (dav.davidson_sep if self._solver_name == "davidson"
                      else dav.jd_sep)
                kw = ({"subspace": opts["subspace"]}
                      if "subspace" in opts else {})
                res = fn(h_func, p_func, x0p, nev, tol=tol,
                         maxiter=maxiter, **kw)
                return res._replace(
                    x=jax.lax.complex(*res.x).astype(x0.dtype),
                    lambdas=res.lambdas.astype(rdt))
            rs_opts = _filter_rs_opts(opts)
            res = lob_rs.lobpcg_sep_rs(
                h_func, p_func, x0p, nev, tol=tol, maxiter=maxiter,
                locking=locking, **rs_opts)
            return res._replace(x=jax.lax.complex(*res.x).astype(x0.dtype),
                                lambdas=res.lambdas.astype(rdt))

        def run_core_rs(d_a, b, inv, shift, x0, diel, dft):
            """Pair-layout path with HOST-built symbols: split complex
            inputs once at entry."""
            return _run_rs_body((d_a.real, d_a.imag), b.diag,
                                (b.sdiag.real, b.sdiag.imag), inv.diag,
                                (inv.sdiag.real, inv.sdiag.imag),
                                shift, x0, diel, dft)

        def run_core_rs_dev(d1, d0, ct, alpha, pnt, shift, x0, diel, dft):
            """Pair-layout path with DEVICE-built symbols: rebuild the
            (3, N, N, N) curl/penalty/preconditioner symbols on device in
            f64 from (N,)-sized stencil parts, then cast to the iterate
            dtype.  One-time cost per solve (~elementwise on 3N^3)."""
            rdt = x0.real.dtype
            d_a64 = rs.build_curl_p(d1, d0, ct, alpha)
            b_diag64, b_sd64 = rs.penalty_p(d_a64, pnt)
            inv_diag64, inv_sd64 = rs.inverse_penalized_p(d_a64, pnt, shift)
            cast = lambda t: jax.tree_util.tree_map(
                lambda a: a.astype(rdt), t)
            return _run_rs_body(cast(d_a64), cast(b_diag64), cast(b_sd64),
                                cast(inv_diag64), cast(inv_sd64),
                                shift.astype(rdt), x0, diel, dft)

        def stats_core(d_a, diel, x, lambdas, dft):
            """Validation statistics of the leading nev modes against the
            UNPENALIZED operator: Rayleigh quotients + residual norms
            (feeds validate.recompute with no eager complex op)."""
            xs = x[:nev]
            ax = maxwell.ama(xs, d_a, diel, dft=dft)
            lam_re = (dots(xs, ax) / dots(xs, xs)).real
            bl = lambdas[:nev].astype(lam_re.dtype).reshape(
                (-1,) + (1,) * (xs.ndim - 1))
            r = ax - bl * xs
            return lam_re, norms(r)

        core = (run_core_rs_dev if (impl == "rs" and self.dev_sym)
                else run_core_rs if impl == "rs" else run_core)
        if self.rb:
            run = jax.jit(boundary.real_boundary(core))
            stats = jax.jit(boundary.real_boundary(stats_core))
        else:
            run, stats = jax.jit(core), jax.jit(stats_core)
        return run, stats

    def _rs_hp_builder(self, m: int, c: int):
        """Traced builder of the rs (h_func, p_func) pair from
        device-built symbols — exactly the run_core_rs_dev prologue in
        _jitted, shared by the segmented single and batched paths.  ``c``
        is the column-chunk divisor (0 = unchunked)."""

        def funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel):
            d_a64 = rs.build_curl_p(d1, d0, ct, alpha)
            b_diag64, b_sd64 = rs.penalty_p(d_a64, pnt)
            inv_diag64, inv_sd64 = rs.inverse_penalized_p(d_a64, pnt, shift)
            cast = lambda t: jax.tree_util.tree_map(
                lambda a: a.astype(rdt), t)
            d_ap, b_diag, b_sd = cast(d_a64), cast(b_diag64), cast(b_sd64)
            inv_diag, inv_sd = cast(inv_diag64), cast(inv_sd64)
            sh = shift.astype(rdt)

            def h_one(v):
                return rs.ama_bb_p(v, d_ap, b_diag, b_sd, diel, shift=sh)

            h_func = _chunked_rs(h_one, m, c)

            if self._solver_name == "mixed":
                # bf16 preconditioner (see _run_rs_body's mixed branch)
                lo = jnp.bfloat16
                inv_d_lo = inv_diag.astype(lo)
                inv_s_lo = (inv_sd[0].astype(lo), inv_sd[1].astype(lo))

                def p_func(v):
                    w = rs.h_block_p((v[0].astype(lo), v[1].astype(lo)),
                                     inv_d_lo, inv_s_lo)
                    return (w[0].astype(rdt), w[1].astype(rdt))
            else:
                def p_func(v):
                    return rs.h_block_p(v, inv_diag, inv_sd)

            return h_func, p_func

        return funcs

    @lru_cache(maxsize=16)
    def _jitted_seg(self, m: int, w_cap: Optional[int] = None):
        """Segmented (trampolined) rs solve: three jitted programs — init,
        bounded run, finalize — so the host can act between segments (doom
        check, warm_maxiter, w_cap buckets; see __init__ docnote on
        segment_iters).  The all-real solver state stays device-resident
        between segments; each re-entry ships only (N,)-sized symbol parts
        and scalars, and the host reads back just the (it, status) pair.
        Semantics are identical to the one-shot run (the segment boundary
        is an extra ``it < it_stop`` conjunct on the same while_loop;
        tests/test_lobpcg.py pins segmented == one-shot on CPU).

        ``w_cap`` re-traces the SAME state pytree with the W/P blocks
        physically capped at that width (solver_opts {"w_cap": "auto"}):
        solve() reads the state's active-column count each segment and
        re-enters through the matching bucket's run program.  jax.jit is
        lazy, so unused bucket programs cost nothing."""
        assert self.impl == "rs" and self.dev_sym
        nev, tol, maxiter, locking = (self.cfg.nev, self.tol, self.maxiter,
                                      self.locking)
        n = self.cfg.n
        opts = self.solver_opts
        rs_opts = _filter_rs_opts(opts, strip_w_cap=True)
        if w_cap is None:
            ow = opts.get("w_cap")
            w_cap = ow if isinstance(ow, int) else None

        chunk = self.apply_chunk
        c = max((d for d in range(1, min(chunk, m) + 1) if m % d == 0),
                default=0) if chunk else 0
        funcs = self._rs_hp_builder(m, c)

        def parts_for(funcs_out, rdt):
            h_func, p_func = funcs_out
            return lob_rs.rs_solver_parts(
                h_func, p_func, (m, 3, n, n, n), rdt, nev, tol=tol,
                maxiter=maxiter, locking=locking, w_cap=w_cap, **rs_opts)

        def init_core(d1, d0, ct, alpha, pnt, shift, x0, diel, dft):
            rdt = x0.real.dtype
            init, _, _ = parts_for(
                funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel), rdt)
            return init((x0.real, x0.imag))

        def run_core(d1, d0, ct, alpha, pnt, shift, state, diel, dft,
                     it_stop):
            rdt = state["x"][0].dtype
            _, run_to, _ = parts_for(
                funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel), rdt)
            return run_to(state, it_stop)

        def fin_core(state):
            rdt = state["x"][0].dtype
            xc = jax.lax.complex(state["x"][0], state["x"][1])
            xc = xc.reshape((m, 3, n, n, n)).astype(self.dtype)
            status = jnp.where(state["status"] == lob.Status.RUNNING,
                               lob.Status.MAXITER,
                               state["status"]).astype(jnp.int32)
            return lob.SolveResult(
                lambdas=state["lambdas"].astype(rdt), x=xc,
                iterations=state["it"], status=status,
                res_history=state["res_his"])

        wrap = boundary.real_boundary if self.rb else (lambda f: f)
        # Donating the state buffers into each segment keeps a single copy
        # of the ~2.6 GB (N=120) carry in HBM across re-entries.
        seg_init = jax.jit(wrap(init_core))
        seg_run = jax.jit(wrap(run_core), donate_argnums=(6,))
        seg_fin = jax.jit(wrap(fin_core))
        return seg_init, seg_run, seg_fin

    def _seg_sym_args(self, alpha):
        """The (d1, d0, ct, alpha, pnt, shift) argument tuple of the
        segmented programs for one k-point (dev_sym path only)."""
        (shift, _), pnt = set_relaxation(alpha)
        shift = float(shift) / self.cfg.scal**2
        f = self._f64
        return (f["d1"], f["d0"], f["ct"],
                jnp.asarray(np.asarray(alpha, np.float64)),
                jnp.asarray(np.float64(pnt)),
                jnp.asarray(np.float64(shift)))

    def precompile_buckets(self, alpha, seed: int = 0) -> int:
        """Eagerly compile every w_cap BUCKET variant of the segmented run
        program (solver_opts {"w_cap": "auto"}) by executing each with
        it_stop=0 — a no-op run that costs one compile and no iterations.

        Rationale: jax.jit is lazy, so the first LONG solve of a sweep
        that crosses a segment boundary into a never-entered bucket pays
        that bucket's compile MID-MEASUREMENT.  Calling this during an
        untimed warmup moves the compile where it belongs.  Returns the number of bucket programs
        compiled; no-op off the segmented dev_sym path.
        """
        if self.segment_iters <= 0 or not self.dev_sym:
            return 0
        if self.solver_opts.get("w_cap") != "auto":
            return 0
        m = self.block_width(alpha)
        sym_args = self._seg_sym_args(alpha)
        seg_init = self._jitted_seg(m)[0]
        x0 = self._x0_cold(alpha, m, seed)
        state = seg_init(*sym_args, x0, self.diel, self.dft)
        stop0 = jnp.asarray(0, jnp.int32)
        count = 0
        for b in sorted({max(1, m // 4), max(1, m // 2)}):
            if b >= m:
                continue
            run_b = self._jitted_seg(m, b)[1]
            # donate_argnums consumes `state`; the no-op run returns an
            # identical pytree, so chain it through.
            state = run_b(*sym_args, state, self.diel, self.dft, stop0)
            jax.block_until_ready(state["it"])
            count += 1
        return count

    @lru_cache(maxsize=8)
    def _refine_jit(self, m: int):
        """f64 pair Rayleigh-Ritz refinement + validation statistics of a
        c64-iterated block (see __init__ docnote).

        The f64 operator is applied to COLUMN CHUNKS inside fori_loops: a
        full (m, 3, N, N, N) complex128 apply and its temporaries would sit
        next to the solver's own state, while streaming 2 columns at a
        time keeps the refine's working set at a few column-sized buffers
        (the whole refine runs once per solve)."""
        from jax import lax

        nev, n = self.cfg.nev, self.cfg.n
        cw = 2 if m % 2 == 0 else 1
        nc = m // cw
        vw = 2 if nev % 2 == 0 else 1
        nv = nev // vw

        def core(d1, d0, ct, alpha, pnt, shift, x_ri, diel):
            d_a = rs.build_curl_p(d1, d0, ct, alpha)
            b_diag, b_sdiag = rs.penalty_p(d_a, pnt)
            f64 = jnp.float64

            def chunk(i, width):
                xc = lax.dynamic_slice_in_dim(x_ri, i * width, width, 0)
                return (xc[..., 0].astype(f64), xc[..., 1].astype(f64))

            flat = lambda pr, k: (pr[0].reshape(k, -1),
                                  pr[1].reshape(k, -1))

            # ---- projected pencil T = X^H (H+shift) X, G = X^H X --------
            def body_i(i, acc):
                t_re, t_im, g_re, g_im = acc
                xi = chunk(i, cw)
                hi = flat(rs.ama_bb_p(xi, d_a, b_diag, b_sdiag, diel,
                                      shift), cw)
                xif = flat(xi, cw)

                def body_j(j, acc2):
                    t_re, t_im, g_re, g_im = acc2
                    xj = flat(chunk(j, cw), cw)
                    tb = rs.gram_p(xj, hi)
                    gb = rs.gram_p(xj, xif)
                    upd = lambda a, blk: lax.dynamic_update_slice(
                        a, blk, (j * cw, i * cw))
                    return (upd(t_re, tb[0]), upd(t_im, tb[1]),
                            upd(g_re, gb[0]), upd(g_im, gb[1]))

                return lax.fori_loop(0, nc, body_j, (t_re, t_im, g_re, g_im))

            zeros = jnp.zeros((m, m), f64)
            t_re, t_im, g_re, g_im = lax.fori_loop(
                0, nc, body_i, (zeros, zeros, zeros, zeros))
            theta, c = rs.pencil_f64_embedding((t_re, t_im), (g_re, g_im))

            # ---- validation of the leading nev refined modes ------------
            lam = theta[:nev] - shift

            def body_oc(oc, acc):
                lam_re_all, res_all = acc

                def mix_acc(i, xr):
                    xi = flat(chunk(i, cw), cw)
                    cre = lax.dynamic_slice(c[0], (i * cw, oc * vw), (cw, vw))
                    cim = lax.dynamic_slice(c[1], (i * cw, oc * vw), (cw, vw))
                    y = rs.mix_p((cre, cim), xi)
                    return (xr[0] + y[0], xr[1] + y[1])

                zer = jnp.zeros((vw, 3 * n * n * n), f64)
                xr = lax.fori_loop(0, nc, mix_acc, (zer, zer))
                xg = (xr[0].reshape(vw, 3, n, n, n),
                      xr[1].reshape(vw, 3, n, n, n))
                ax = flat(rs.ama_p(xg, d_a, diel), vw)
                den = jnp.sum(xr[0] ** 2 + xr[1] ** 2, axis=1)
                num = jnp.sum(xr[0] * ax[0] + xr[1] * ax[1], axis=1)
                lam_oc = lax.dynamic_slice(lam, (oc * vw,), (vw,))[:, None]
                r_re = ax[0] - lam_oc * xr[0]
                r_im = ax[1] - lam_oc * xr[1]
                res = jnp.sqrt(jnp.sum(r_re ** 2 + r_im ** 2, axis=1)
                               / jnp.maximum(den, 1e-30))
                lam_re = num / jnp.maximum(den, 1e-30)
                return (lax.dynamic_update_slice(lam_re_all, lam_re,
                                                 (oc * vw,)),
                        lax.dynamic_update_slice(res_all, res, (oc * vw,)))

            zv = jnp.zeros((nev,), f64)
            lam_re, res_nrm = lax.fori_loop(0, nv, body_oc, (zv, zv))
            return theta, lam_re, res_nrm

        return jax.jit(core)

    @lru_cache(maxsize=8)
    def _refine_light_jit(self, m: int):
        """Working-precision twin of :meth:`_refine_jit` (``refine="light"``).

        Same inputs/outputs and the same spurious-gate semantics as the
        emulated-f64 refine, but the operator applies run in the ITERATE's
        real dtype (one full-width ``ama_bb_p`` — the exact program shape of
        a single solver iteration — plus one ``ama_p`` on the leading nev
        refined modes), with the projected (m, m) pencil f64-ACCUMULATED
        (rayleigh_ritz.gram_f64_p) and solved by the f64 real-embedding
        pencil.  theta is still subspace-limited exactly like the f64
        refine (__init__ docnote); the only extra noise is the ~1e-7 f32
        quantization of the applies — invisible against the 1e-3 physical
        gate and the ~2e-3 c64 golden scale.  It replaces ~13 chunked f64
        applies + 64 f64 Grams with ~1 solver-iteration of work."""
        nev, n = self.cfg.nev, self.cfg.n
        rdt = self.rdt

        def core(d1, d0, ct, alpha, pnt, shift, x_ri, diel):
            d_a64 = rs.build_curl_p(d1, d0, ct, alpha)
            b_diag64, b_sdiag64 = rs.penalty_p(d_a64, pnt)
            cast = lambda p: (p[0].astype(rdt), p[1].astype(rdt))
            d_a = cast(d_a64)
            b_diag = b_diag64.astype(rdt)
            b_sdiag = cast(b_sdiag64)
            x = (x_ri[..., 0].astype(rdt), x_ri[..., 1].astype(rdt))
            hx = rs.ama_bb_p(x, d_a, b_diag, b_sdiag, diel, shift.astype(rdt))
            flat = lambda p, k: (p[0].reshape(k, -1), p[1].reshape(k, -1))
            xf, hxf = flat(x, m), flat(hx, m)
            t = rs.hermitize_p(rr.gram_f64_p(xf, hxf))
            g = rs.hermitize_p(rr.gram_f64_p(xf, xf))
            theta, c = rs.pencil_f64_embedding(t, g)

            # validation of the leading nev refined modes (unpenalized
            # quotients + residuals, f64-accumulated reductions)
            cm_ = (c[0][:, :nev].astype(rdt), c[1][:, :nev].astype(rdt))
            y = rr.mix_pair(cm_, xf)
            yg = (y[0].reshape(nev, 3, n, n, n),
                  y[1].reshape(nev, 3, n, n, n))
            ay = flat(rs.ama_p(yg, d_a, diel), nev)
            den = jnp.maximum(jnp.diagonal(rr.gram_f64_p(y, y)[0]), 1e-30)
            lam_re = jnp.diagonal(rr.gram_f64_p(y, ay)[0]) / den
            lam = (theta[:nev] - shift).astype(rdt)[:, None]
            r = (ay[0] - lam * y[0], ay[1] - lam * y[1])
            res_nrm = jnp.sqrt(jnp.diagonal(rr.gram_f64_p(r, r)[0]) / den)
            return theta, lam_re, res_nrm

        return jax.jit(core)

    def _refine_report(self, alpha, x, verbose=False,
                       raise_on_spurious=True, mode=None):
        """Run the refine program (f64 or "light"); returns
        (report, theta, x_refined).  ``mode`` overrides self.refine for
        one call (the sweep escalates marginal light-refine failures to
        the f64 refine before paying a cold retry)."""
        cfg = self.cfg
        (shift, _), pnt = set_relaxation(alpha)
        shift = shift / cfg.scal**2
        f = self._f64
        m = x.shape[0]
        mode = self.refine if mode is None else mode
        refine_jit = (self._refine_light_jit if mode == "light"
                      else self._refine_jit)
        theta, lam_re, res_nrm = refine_jit(m)(
            f["d1"], f["d0"], f["ct"],
            jnp.asarray(np.asarray(alpha, np.float64)),
            jnp.asarray(np.float64(pnt)), jnp.asarray(np.float64(shift)),
            x.ri if isinstance(x, boundary.CArr) else boundary.encode(x).ri,
            self.diel)
        theta = np.asarray(theta)
        report = validate.recompute(
            theta[: cfg.nev], shift=shift, scal=cfg.scal,
            stats=(np.asarray(lam_re), np.asarray(res_nrm)),
            verbose=verbose, raise_on_spurious=raise_on_spurious)
        return report, theta, x

    def _place(self, tree):
        """Move a (possibly complex) host pytree to the device in the
        backend's boundary format: real-boundary encoded (CArr of (..., 2)
        reals) when self.rb, plain complex arrays otherwise."""
        rdt = self.rdt
        if self.rb:
            tree = boundary.encode(tree, rdt=rdt)

            def put(x):
                if isinstance(x, boundary.CArr):
                    return boundary.CArr(jax.device_put(x.ri))
                if isinstance(x, (np.ndarray, np.generic)):
                    return jax.device_put(np.asarray(x, rdt))
                return x
            return jax.tree_util.tree_map(
                put, tree, is_leaf=lambda l: isinstance(l, boundary.CArr))

        def put(x):
            if isinstance(x, (np.ndarray, np.generic)):
                return jnp.asarray(
                    x, self.dtype if np.iscomplexobj(x) else rdt)
            return x
        return jax.tree_util.tree_map(put, tree)

    def _symbols_np(self, alpha):
        """Host-side (numpy, full precision) symbol build for one k-point.

        Clean scaling semantics (identical to the reference at SCAL=1,
        numerical_experiments.py:55-63, consistent at any scal): the curl
        symbol is the unit-cell symbol divided by the lattice constant,
        D_A = (D + i alpha D0)/scal, so lambda ~ 1/scal^2 and
        omega = sqrt(lambda) * scal / (2 pi) is scale-invariant; the
        Gamma-point shift scales with the spectrum as shift/scal^2."""
        cfg = self.cfg
        (shift, _), pnt = set_relaxation(alpha)
        shift = shift / cfg.scal**2
        d_a = sym.shift_symbol(self._d, self._di, alpha, scal=1.0) / cfg.scal
        b_raw = sym.penalty_symbol(d_a)
        inv = sym.inverse_penalized(b_raw, pnt, shift=shift)
        b = sym.HermSymbol(pnt * b_raw.diag, pnt * b_raw.sdiag)
        return d_a, b, inv, float(shift)

    def symbols_for(self, alpha):
        """Device-placed k-dependent symbols (boundary format of the mode).

        The last few k-points are cached on device: repeated solves at one
        alpha (benchmarks, retries, validation) must not re-upload ~140 MB
        of symbols per call."""
        key = tuple(np.asarray(alpha, dtype=float).tolist())
        hit = self._sym_cache.get(key)
        if hit is not None:
            return hit
        d_a, b, inv, shift = self._symbols_np(alpha)
        d_a, b, inv = self._place((d_a, b, inv))
        pack = (d_a, b, inv, shift)
        self._sym_cache[key] = pack
        while len(self._sym_cache) > 2:
            self._sym_cache.pop(next(iter(self._sym_cache)))
        return pack

    def block_width(self, alpha) -> int:
        (_, rlx), _ = set_relaxation(alpha)
        return block_width(self.cfg.nev, rlx)

    @lru_cache(maxsize=8)
    def _x0gen(self, m: int):
        """Jitted random-block generator (device-side RNG; in real-boundary
        mode the block leaves the program as (..., 2) reals)."""
        n, dt = self.cfg.n, self.dtype
        gen = lambda key: maxwell.random_block(key, n, m, dt)
        return jax.jit(boundary.real_boundary(gen) if self.rb else gen)

    @lru_cache(maxsize=8)
    def _pwgen(self, m: int):
        """Jitted plane-wave scatter: builds the (m, 3, N, N, N) cold-start
        block ON DEVICE from (m,) indices + (m, 3) amplitudes (nothing
        block-sized crosses the host link)."""
        n = self.cfg.n
        gen = lambda idx, amps, key: maxwell.plane_wave_scatter(
            idx, amps, n, jitter_key=key)
        return jax.jit(boundary.real_boundary(gen) if self.rb else gen)

    def _coarse(self) -> "KPointSolver":
        """Lazily built coarse-grid twin for x0_mode='coarse' (same lattice,
        dielectric type, solver implementation and levers; no f64 refine —
        only the c64/c128 subspace is consumed as a start).  The coarse
        solve stops on Ritz-value movement (lam_tol) well above the floor:
        start quality saturates once the coarse frequencies stop moving."""
        if self._coarse_cache is None:
            opts = dict(self.solver_opts)
            if self.impl == "rs":  # Ritz-movement stop is an rs-only lever
                opts.setdefault("lam_tol", 1e-5)
                opts.setdefault("lam_patience", 2)
            self._coarse_cache = KPointSolver(
                dataclasses.replace(self.cfg, n=self._coarse_n),
                dtype=self.dtype, tol=self.tol, maxiter=self.maxiter,
                solver=self._solver_name, solver_opts=opts,
                real_boundary=self.rb, refine=False,
                solver_impl=self.impl, x0_mode="plane_wave")
        return self._coarse_cache

    @lru_cache(maxsize=2)
    def _upjit(self):
        """Jitted trigonometric lift (m, 3, nc, nc, nc) -> (m, 3, n, n, n);
        the (nc, n) interpolation matrix crosses as an argument."""
        gen = lambda x, u: dft_mod.resample3(x, u)
        return jax.jit(boundary.real_boundary(gen) if self.rb else gen)

    def _x0_cold(self, alpha, m: int, seed: int):
        """Cold-start block by self.x0_mode."""
        if self.x0_mode == "coarse":
            res = self._coarse().solve(alpha, seed=seed,
                                       validate_result=False)
            if int(res.status) in (lob.Status.NAN, lob.Status.BLOWUP):
                return self._x0gen(m)(jax.random.PRNGKey(seed))
            u = dft_mod.upsample_mat(self._coarse_n, self.cfg.n,
                                     dtype=np.dtype(self.dtype))
            x = self._upjit()(res.x, self._place(u))
            return x if x.shape[0] == m else self._fit(x, m, seed)
        if self.x0_mode == "random":
            return self._x0gen(m)(jax.random.PRNGKey(seed))
        cfg = self.cfg
        d_a_np = sym.shift_symbol(self._d, self._di,
                                  np.asarray(alpha, float),
                                  scal=1.0) / cfg.scal
        idx, amps = maxwell.plane_wave_cols(d_a_np, m)
        amps = self._place(amps.astype(np.complex128))
        return self._pwgen(m)(jnp.asarray(idx), amps,
                              jax.random.PRNGKey(seed))

    def _fit(self, x, m: int, seed: int):
        """Warm-start width adaptation: truncate or pad with random columns
        (reference: numerical_experiments.py:425-432)."""
        if x.shape[0] >= m:
            return x[:m]
        extra = self._x0gen(m - x.shape[0])(jax.random.PRNGKey(seed + 1))
        if isinstance(x, boundary.CArr):
            return boundary.CArr(jnp.concatenate((x.ri, extra.ri), axis=0))
        return jnp.concatenate((x, extra), axis=0)

    @lru_cache(maxsize=4)
    def _jitted_batch(self, m: int, bsize: int):
        """Vmapped solve over a stacked batch of k-points: one compiled
        program runs `bsize` independent solves in lockstep, raising the
        arithmetic intensity of the FFTs/GEMMs on one chip.  (The reference
        sweeps k-points serially, numerical_experiments.py:418.)"""
        nev, tol, maxiter, locking = (self.cfg.nev, self.tol, self.maxiter,
                                      self.locking)
        opts = self.solver_opts

        def one(d_a, b, inv, shift, x0, diel, dft):
            h = lambda v: maxwell.ama_bb(v, d_a, b, diel, dft=dft) + shift * v
            p = lambda v: h_block(v, inv)
            return lob.lobpcg_sep(h, p, x0, nev, tol=tol, maxiter=maxiter,
                                  locking=locking, **opts)

        # The dielectric op is shared across the batch (in_axes=None) and is
        # a jit argument, not a closure constant (see _jitted).
        fn = boundary.real_boundary(one) if self.rb else one
        return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, None, None)))

    @lru_cache(maxsize=4)
    def _jitted_batch_rs(self, m: int, bsize: int):
        """Vmapped pair-layout batch solve with DEVICE-built symbols: the
        production (rs) analog of _jitted_batch — shared (N,) stencil
        parts, per-k alpha/pnt/shift, one compiled program for the whole
        group."""
        nev, tol, maxiter, locking = (self.cfg.nev, self.tol, self.maxiter,
                                      self.locking)
        opts = self.solver_opts
        rs_opts = _filter_rs_opts(opts)

        funcs = self._rs_hp_builder(m, 0)

        def one(d1, d0, ct, alpha, pnt, shift, x0, diel, dft):
            rdt = x0.real.dtype
            h_func, p_func = funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel)
            res = lob_rs.lobpcg_sep_rs(h_func, p_func,
                                       (x0.real, x0.imag), nev, tol=tol,
                                       maxiter=maxiter, locking=locking,
                                       **rs_opts)
            return res._replace(x=jax.lax.complex(*res.x).astype(x0.dtype),
                                lambdas=res.lambdas.astype(rdt))

        fn = boundary.real_boundary(one) if self.rb else one
        return jax.jit(jax.vmap(
            fn, in_axes=(None, None, None, 0, 0, 0, 0, None, None)))

    @lru_cache(maxsize=4)
    def _jitted_batch_seg(self, m: int, bsize: int):
        """Segmented vmapped batch solve (the batch analog of _jitted_seg):
        each device program advances every lane by at most ``segment_iters``
        iterations of the lockstep batched while_loop.  Finished lanes are
        frozen by the batched while_loop's select; the host re-enters until
        every lane terminates."""
        assert self.impl == "rs" and self.dev_sym
        nev, tol, maxiter, locking = (self.cfg.nev, self.tol, self.maxiter,
                                      self.locking)
        n = self.cfg.n
        rs_opts = _filter_rs_opts(self.solver_opts)
        funcs = self._rs_hp_builder(m, 0)

        def parts_for(funcs_out, rdt):
            h_func, p_func = funcs_out
            return lob_rs.rs_solver_parts(
                h_func, p_func, (m, 3, n, n, n), rdt, nev, tol=tol,
                maxiter=maxiter, locking=locking, **rs_opts)

        def init_one(d1, d0, ct, alpha, pnt, shift, x0, diel, dft):
            rdt = x0.real.dtype
            init, _, _ = parts_for(
                funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel), rdt)
            return init((x0.real, x0.imag))

        def run_one(d1, d0, ct, alpha, pnt, shift, state, diel, dft,
                    it_stop):
            rdt = state["x"][0].dtype
            _, run_to, _ = parts_for(
                funcs(d1, d0, ct, alpha, pnt, shift, rdt, diel), rdt)
            return run_to(state, it_stop)

        def fin_one(state):
            rdt = state["x"][0].dtype
            xc = jax.lax.complex(state["x"][0], state["x"][1])
            xc = xc.reshape((m, 3, n, n, n)).astype(self.dtype)
            status = jnp.where(state["status"] == lob.Status.RUNNING,
                               lob.Status.MAXITER,
                               state["status"]).astype(jnp.int32)
            return lob.SolveResult(
                lambdas=state["lambdas"].astype(rdt), x=xc,
                iterations=state["it"], status=status,
                res_history=state["res_his"])

        wrap = boundary.real_boundary if self.rb else (lambda f: f)
        binit = jax.jit(jax.vmap(
            wrap(init_one), in_axes=(None, None, None, 0, 0, 0, 0, None,
                                     None)))
        brun = jax.jit(jax.vmap(
            wrap(run_one), in_axes=(None, None, None, 0, 0, 0, 0, None,
                                    None, None)), donate_argnums=(6,))
        bfin = jax.jit(jax.vmap(wrap(fin_one)))
        return binit, brun, bfin

    def _kshard(self, tag, fn, mesh, in_specs, out_specs=None,
                donate=()):
        """shard_map an already-vmapped batch callable over the mesh "k"
        axis: each device runs the vmapped solve on its own contiguous
        slice of the k-group — data parallelism over independent k-points
        (SURVEY.md section 2.4; the reference sweeps k serially,
        numerical_experiments.py:418).  Cached per (tag, mesh) so the
        outer jit's compilation cache holds across groups."""
        key = (tag, mesh)
        w = self._kshard_cache.get(key)
        if w is None:
            from jax import shard_map
            out_specs = (jax.sharding.PartitionSpec("k")
                         if out_specs is None else out_specs)
            w = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                  out_specs=out_specs, check_vma=False),
                        donate_argnums=tuple(donate))
            self._kshard_cache[key] = w
        return w

    def solve_batch(self, alphas, x0s=None, seed: int = 0,
                    validate_result: bool = True, mesh=None):
        """Solve a batch of k-points in one vmapped program.  All k-points
        must share the same block width (true along a path; the relaxation
        ratio is constant, config.set_relaxation).

        ``mesh``: a jax Mesh with a "k" axis (pcx.parallel.mesh.make_mesh)
        — the group is sharded over that axis and each device solves its
        slice in lockstep (multi-chip DP over k-points).  A group whose
        size is not a multiple of the axis is transparently padded by
        repeating the last k-point; only the requested results return."""
        cfg = self.cfg
        alphas = [np.asarray(a, float) for a in alphas]
        n_req = len(alphas)
        if mesh is not None:
            nk = int(mesh.shape["k"])
            pad = (-n_req) % nk
            if pad:
                alphas = alphas + [alphas[-1]] * pad
                if isinstance(x0s, (list, tuple)):
                    x0s = list(x0s) + [x0s[-1]] * pad
        ms = {self.block_width(a) for a in alphas}
        if len(ms) != 1:
            raise ValueError(f"batch mixes block widths {ms}")
        m = ms.pop()
        bsize = len(alphas)
        shifts_pnts = []
        for a in alphas:
            (sh, _), pnt = set_relaxation(a)
            shifts_pnts.append((float(sh) / cfg.scal**2, float(pnt)))
        if not self.dev_sym:
            packs = [self._symbols_np(a) for a in alphas]
            d_a_np = np.stack([p[0] for p in packs])
            b_np = sym.HermSymbol(np.stack([p[1].diag for p in packs]),
                                  np.stack([p[1].sdiag for p in packs]))
            inv_np = sym.HermSymbol(np.stack([p[2].diag for p in packs]),
                                    np.stack([p[2].sdiag for p in packs]))
            d_a, b, inv = self._place((d_a_np, b_np, inv_np))
            shifts = jnp.asarray(
                np.asarray([p[3] for p in packs], dtype=self.rdt))
        x0_wall = 0.0
        if x0s is None:
            t_x0 = time.time()
            blocks = [self._x0_cold(a, m, seed + i)
                      for i, a in enumerate(alphas)]
            if self.x0_mode == "coarse":
                # Same accounting as solve(): the two-grid start runs full
                # coarse solves — charge them to this batch's wall time.
                x0_wall = time.time() - t_x0
        elif isinstance(x0s, (list, tuple)):
            blocks = [self._fit(x, m, seed + i) if x.shape[0] != m else x
                      for i, x in enumerate(x0s)]
        elif mesh is not None and len(alphas) != n_req:
            raise ValueError(
                "x0s must be a list/tuple (not a pre-stacked array) when a "
                "mesh group needs padding — pass one block per k-point")
        else:
            blocks = None
        if blocks is not None:
            if self.rb:
                x0s = boundary.CArr(jnp.stack([blk.ri for blk in blocks]))
            else:
                x0s = jnp.stack(blocks)

        t0 = time.time()
        if self.dev_sym:
            f = self._f64
            sym_args = (f["d1"], f["d0"], f["ct"],
                        jnp.asarray(np.stack([np.asarray(a, np.float64)
                                              for a in alphas])),
                        jnp.asarray(np.asarray(
                            [sp[1] for sp in shifts_pnts], np.float64)),
                        jnp.asarray(np.asarray(
                            [sp[0] for sp in shifts_pnts], np.float64)))
            seg = self.segment_iters
            pk = jax.sharding.PartitionSpec("k")
            pr = jax.sharding.PartitionSpec()
            if seg > 0:
                binit, brun, bfin = self._jitted_batch_seg(m, bsize)
                if mesh is not None:
                    sym_specs = (pr, pr, pr, pk, pk, pk)
                    binit = self._kshard(("seg_init", m, bsize), binit, mesh,
                                         sym_specs + (pk, pr, pr))
                    # donate the solver state (arg 6) like the inner
                    # _jitted_batch_seg does — re-entries must not hold two
                    # full state copies in device memory
                    brun = self._kshard(("seg_run", m, bsize), brun, mesh,
                                        sym_specs + (pk, pr, pr, pr),
                                        donate=(6,))
                    bfin = self._kshard(("seg_fin", m, bsize), bfin, mesh,
                                        (pk,))
                state = binit(*sym_args, x0s, self.diel, self.dft)
                it = 0
                for _ in range(-(-self.maxiter // seg) + 2):
                    stop = jnp.asarray(min(it + seg, self.maxiter),
                                       jnp.int32)
                    state = brun(*sym_args, state, self.diel, self.dft,
                                 stop)
                    sts = np.asarray(state["status"])
                    its = np.asarray(state["it"])
                    running = ((sts == lob.Status.RUNNING)
                               & (its < self.maxiter))
                    if not np.any(running):
                        break
                    # next bound from the laggard RUNNING lane (terminated
                    # lanes are frozen and must not cap the stop)
                    it = int(its[running].min())
                res = bfin(state)
            else:
                run = self._jitted_batch_rs(m, bsize)
                if mesh is not None:
                    run = self._kshard(("rs", m, bsize), run, mesh,
                                       (pr, pr, pr, pk, pk, pk, pk, pr, pr))
                res = run(*sym_args, x0s, self.diel, self.dft)
        else:
            run = self._jitted_batch(m, bsize)
            if mesh is not None:
                pk = jax.sharding.PartitionSpec("k")
                pr = jax.sharding.PartitionSpec()
                run = self._kshard(("cplx", m, bsize), run, mesh,
                                   (pk, pk, pk, pk, pk, pr, pr))
            res = run(d_a, b, inv, shifts, x0s, self.diel, self.dft)
        res.lambdas.block_until_ready()
        wall = time.time() - t0 + x0_wall

        out = []
        _, stats = self._jitted(m)
        for i, alpha in enumerate(alphas[:n_req]):  # drop mesh padding
            lambdas = np.asarray(res.lambdas[i])
            status = int(res.status[i])
            report = None
            omega = omega_re = None
            if status in (lob.Status.CONVERGED, lob.Status.FLOOR,
                          lob.Status.MAXITER) and validate_result:
                shift = shifts_pnts[i][0]
                if self.refine:
                    report, _th, _x = self._refine_report(alpha, res.x[i])
                else:
                    if self.dev_sym:
                        d_a_i = self.symbols_for(alpha)[0]
                    else:
                        d_a_i = d_a[i]
                    lam_pen = lambdas - (shift if shift > 0 else 0.0)
                    lam_re, res_nrm = stats(
                        d_a_i, self.diel, res.x[i],
                        jnp.asarray(lam_pen.astype(self.rdt)), self.dft)
                    report = validate.recompute(
                        lambdas[: cfg.nev], shift=shift, scal=cfg.scal,
                        stats=(np.asarray(lam_re), np.asarray(res_nrm)))
                omega, omega_re = report.omega_pnt, report.omega_re
            out.append(EigenResult(
                omega=omega, omega_re=omega_re, lambdas=lambdas,
                x=res.x[i], iterations=int(res.iterations[i]),
                # Per-point share of REAL elapsed time: divide by the
                # requested count so recorded walls sum to the batch
                # wall even when mesh padding added throwaway lanes.
                wall_time=wall / n_req, status=status, report=report))
        return out

    def validate_solution(self, alpha, result: "EigenResult",
                          verbose: bool = False,
                          raise_on_spurious: bool = True):
        """Validation report for an existing solve at ``alpha`` — runs only
        the jitted stats program on result.x (no re-solve)."""
        cfg = self.cfg
        if self.refine:
            report, _theta, _x = self._refine_report(
                alpha, result.x, verbose=verbose,
                raise_on_spurious=raise_on_spurious)
            return report
        d_a, _b, _inv, shift = self.symbols_for(alpha)
        _, stats = self._jitted(result.x.shape[0])
        lambdas = np.asarray(result.lambdas)
        lam_pen = lambdas - (shift if shift > 0 else 0.0)
        lam_re, res_nrm = stats(d_a, self.diel, result.x,
                                jnp.asarray(lam_pen.astype(self.rdt)),
                                self.dft)
        return validate.recompute(
            lambdas[: cfg.nev], shift=shift, scal=cfg.scal,
            stats=(np.asarray(lam_re), np.asarray(res_nrm)),
            verbose=verbose, raise_on_spurious=raise_on_spurious)

    def solve(self, alpha, x0=None, seed: int = 0,
              validate_result: bool = True,
              verbose: bool = False) -> EigenResult:
        cfg = self.cfg
        m = self.block_width(alpha)
        warm = x0 is not None
        x0_wall = 0.0
        if x0 is None:
            t_x0 = time.time()
            x0 = self._x0_cold(alpha, m, seed)
            if self.x0_mode == "coarse":
                # The two-grid start runs a full coarse solve: charge it to
                # this solve's wall time so benchmarks stay honest
                # (time-to-validated-frequencies from scratch).
                x0_wall = time.time() - t_x0
        elif x0.shape[0] != m:
            x0 = self._fit(x0, m, seed)

        run, stats = self._jitted(m)
        if self.dev_sym:
            (shift, _), pnt = set_relaxation(alpha)
            shift = float(shift) / cfg.scal**2
            f = self._f64
            sym_args = (f["d1"], f["d0"], f["ct"],
                        jnp.asarray(np.asarray(alpha, np.float64)),
                        jnp.asarray(np.float64(pnt)),
                        jnp.asarray(np.float64(shift)))
            seg = self.segment_iters
            if seg > 0:
                # Trampolined solve: init once, then re-enter the bounded
                # while_loop with the device-resident state until the
                # solver terminates (only (it, status) scalars come back
                # per segment).
                seg_init, seg_run, seg_fin = self._jitted_seg(m)
                w_auto = self.solver_opts.get("w_cap") == "auto"
                buckets = sorted({max(1, m // 4), max(1, m // 2), m})
                # Warm-start iteration cap (see __init__.warm_maxiter):
                # enforced by stopping the trampoline early; the solver
                # state is identical to a maxiter-sized run cut at the
                # same iteration, so fin_core reports MAXITER and the
                # sweep's acceptance gate / cold retry takes over.
                limit = (min(self.maxiter, self.warm_maxiter)
                         if warm and self.warm_maxiter > 0 else self.maxiter)
                t0 = time.time()
                state = seg_init(*sym_args, x0, self.diel, self.dft)
                it = 0
                run_fn = seg_run
                self.last_doom = None
                prev_worst = None
                nev = cfg.nev
                # Shorter FIRST warm segment: healthy warm solves finish in
                # 13-19 iterations and never reach a boundary, while a
                # doomed chain hits the doom check at 24 instead of 40 —
                # cutting a rejected point's warm cost ~2x (same program,
                # it_stop is a traced argument).
                first_seg = min(24, seg) if (warm and self.doom_check) \
                    else seg
                for _ in range(-(-limit // seg) + 3):
                    step_iters = first_seg if it == 0 else seg
                    stop = jnp.asarray(min(it + step_iters, limit),
                                       jnp.int32)
                    state = run_fn(*sym_args, state, self.diel,
                                   self.dft, stop)
                    st, it = int(state["status"]), int(state["it"])
                    _heartbeat()
                    if st != lob.Status.RUNNING or it >= limit:
                        break
                    if warm and self.doom_check:
                        # Frequency-error admissibility of the tracked
                        # columns (see __init__.doom_check).  m-sized host
                        # reads only.
                        res9 = np.asarray(state["res"])[:nev]
                        lam9 = np.abs(np.asarray(state["lambdas"]))[:nev]
                        cap = (self.doom_tol * 4.0 * np.pi
                               * np.sqrt(np.maximum(lam9, 1.0)))
                        with np.errstate(invalid="ignore"):
                            viol = res9 / cap
                        worst = float(np.nanmax(viol)) if viol.size else 0.0
                        doomed = worst > 10.0 or (
                            prev_worst is not None and worst > 1.0
                            and worst > 0.85 * prev_worst)
                        if doomed:
                            self.last_doom = (it, worst * self.doom_tol)
                            break
                        prev_worst = worst
                    if w_auto:
                        # Re-enter through the smallest bucket that holds
                        # every active column (state carries over — the
                        # pytree is w_cap-independent).
                        n_act = int(state["n_act"])
                        b = next(b for b in buckets if n_act <= b)
                        run_fn = (seg_run if b >= m
                                  else self._jitted_seg(m, b)[1])
                res = seg_fin(state)
            else:
                t0 = time.time()
                res = run(*sym_args, x0, self.diel, self.dft)
        else:
            d_a, b, inv, shift = self.symbols_for(alpha)
            t0 = time.time()
            res = run(d_a, b, inv, jnp.asarray(shift, self.rdt), x0,
                      self.diel, self.dft)
        res.lambdas.block_until_ready()
        wall = time.time() - t0 + x0_wall

        lambdas = np.asarray(res.lambdas)
        status = int(res.status)
        x_final = res.x
        report = None
        omega = omega_re = None
        if status in (lob.Status.CONVERGED, lob.Status.FLOOR,
                      lob.Status.MAXITER):
            if validate_result and self.refine:
                report, lambdas, x_final = self._refine_report(
                    alpha, res.x, verbose=verbose)
                omega, omega_re = report.omega_pnt, report.omega_re
            elif validate_result:
                if self.dev_sym:
                    # refine=False on the dev_sym path: stats need the
                    # complex d_a, so this rebuilds ~(3,N,N,N) symbols on
                    # the HOST and uploads them — acceptable only because
                    # every production accelerator config runs refine=True
                    # (device-built f64 validation) and never reaches here.
                    d_a = self.symbols_for(alpha)[0]
                lam_pen = lambdas - (shift if shift > 0 else 0.0)
                lam_re, res_nrm = stats(
                    d_a, self.diel, res.x,
                    jnp.asarray(lam_pen.astype(self.rdt)), self.dft)
                report = validate.recompute(
                    lambdas[: cfg.nev], shift=shift, scal=cfg.scal,
                    stats=(np.asarray(lam_re), np.asarray(res_nrm)),
                    verbose=verbose)
                omega, omega_re = report.omega_pnt, report.omega_re
            else:
                from pcx.utils import sqrt_robust
                lam = lambdas[: cfg.nev] - (shift if shift > 0 else 0.0)
                omega = np.array([sqrt_robust(v) * cfg.scal / (2 * np.pi)
                                  for v in lam])
                omega_re = omega
        return EigenResult(omega=omega, omega_re=omega_re, lambdas=lambdas,
                           x=x_final, iterations=int(res.iterations),
                           wall_time=wall, status=status, report=report)


def eigen_1p(n: int, lattice: str, alpha, diel_type: str = "chiral",
             nev: int = NEV, dtype=jnp.complex128, tol: float = TOL,
             maxiter: int = MAXITER, seed: int = 0,
             solver: str = "softlock", eps_opt: int = 0,
             verbose: bool = True, **solver_kw) -> EigenResult:
    """Single-k-point demo (reference: numerical_experiments.py:209-247).

    ``solver`` selects the eigensolver variant (reference's ``solver``
    argument): softlock/nolock/mixed/descent/davidson/jd."""
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type, nev=nev,
                        eps_opt=eps_opt)
    kps = KPointSolver(cfg, dtype=dtype, tol=tol, maxiter=maxiter,
                       solver=solver, **solver_kw)
    result = kps.solve(np.asarray(alpha, dtype=float), seed=seed,
                       verbose=verbose)
    if verbose:
        print(f"n = {n}, lattice: {lattice}, "
              f"alpha/pi = {np.asarray(alpha) / np.pi}, "
              f"iter = {result.iterations}, "
              f"runtime = {result.wall_time:<6.3f}s, status = {result.status}")
    return result


def bandgap(n: int, lattice: str, diel_type: str = "chiral",
            eps_opt: int = 0, output_dir: str = "output",
            indices: Optional[list] = None, gap: int = GAP,
            dtype=jnp.complex128, tol: float = TOL, maxiter: int = MAXITER,
            nev: int = NEV, seed: int = 0, verbose: bool = True,
            metrics_path: Optional[str] = None, k_batch: int = 1,
            solver_opts: Optional[dict] = None,
            solver_kw: Optional[dict] = None, mesh=None) -> list:
    """Full Brillouin-zone band sweep with per-k-point JSON checkpointing,
    resume, warm starts, and failure containment.

    Reference: bandgap, numerical_experiments.py:313-496.  Returns the list
    of failed indices.

    ``solver_kw``: extra KPointSolver keyword arguments (e.g.
    ``real_boundary``/``solver_impl``/``segment_iters``) — lets CPU tests
    drive the sweep surface on the accelerator production path (pair-layout
    solver, segmented), which the device-policy defaults would otherwise
    only select on an accelerator.

    ``mesh``: jax Mesh with a "k" axis (pcx.parallel.mesh.make_mesh) —
    index groups are sharded over the axis and solved one-per-device in
    lockstep (multi-chip DP over the sweep).  ``k_batch`` defaults to the
    axis size; checkpointing/validation/warm starts are unchanged.
    """
    if mesh is not None and k_batch <= 1:
        k_batch = int(mesh.shape["k"])
    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel_type,
                        eps_opt=eps_opt, nev=nev)
    solver = KPointSolver(cfg, dtype=dtype, tol=tol / cfg.scal**2,
                          maxiter=maxiter, solver_opts=solver_opts,
                          **(solver_kw or {}))
    alphas = lattices.k_path(lattice, gap=gap)
    n_k = alphas.shape[0]

    suffix = str(eps_opt) if eps_opt else ""
    path = f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"
    lib = BandLibrary(path, lattice, n, n_k, nev)
    from pcx.metrics import RunLogger
    logger = RunLogger(metrics_path, echo=False)

    if indices is None:
        pending = lib.pending_indices()
        indices = pending if len(pending) < n_k else list(range(n_k))
        if not indices:
            if verbose:
                print(f"{GREEN}All indices of {diel_type},{lattice} have "
                      f"been computed without errors.{RESET}")
            return []

    err_index = []
    x_prev = None
    prev_idx = None

    # Rows that already failed on a PREVIOUS run get a fresh per-run seed
    # salt: retry seeds were fully determined by (seed, i) before, so a
    # numerically deterministic failure (e.g. sc_flat1 N=120 k=0,
    # under-converged band 9 in two consecutive campaigns) would repeat
    # identically every supervisor round and the row could never heal.
    failed_before = set(lib.failed_indices())
    salt = 0
    if failed_before:
        salt = int(np.random.SeedSequence().entropy % 100003) or 1
        if verbose:
            print(f"{YELLOW}{len(failed_before)} previously-failed rows "
                  f"will retry with seed salt {salt}{RESET}")

    def _seed_for(i):
        return seed + i + (salt if i in failed_before else 0)

    def _accept(result):
        # Backstop: a MAXITER solve whose recomputed f64 residuals and
        # spurious gate pass is physically valid — the c64 floor was
        # reached without the FLOOR heuristic firing (possible on warm
        # starts; see lobpcg_rs gate notes).
        # Solve stats in every rejection message: the warm-start spurious
        # analysis needs to see whether the rejected
        # attempt terminated quickly (genuine wrong subspace) or burned
        # iterations in slow false convergence (warm_maxiter territory).
        stats = (f" [status={lob.Status(result.status).name} "
                 f"iters={result.iterations} wall={result.wall_time:.1f}s]")
        ok = result.status in (lob.Status.CONVERGED, lob.Status.FLOOR)
        if (not ok and result.status == lob.Status.MAXITER
                and result.report is not None
                and not result.report.spurious):
            ok = True
        if not ok:
            raise RuntimeError(
                f"solver status {lob.Status(result.status).name}{stats}")
        if result.report is not None and result.report.spurious:
            raise RuntimeError(f"spurious eigenvalues{stats}")
        # Subspace-quality gate.  The spurious check (omega_pnt vs
        # omega_re) is blind to a solve whose terminal subspace MISSES a
        # near-degenerate direction: the mixed vector's penalized and
        # recomputed quotients agree while both sit O(splitting) off the
        # true band (bcc_sg N=120 doublets, round-3: 40/91 k-points up to
        # 9e-3 off with validations passing).  The refine's residual
        # bounds the eigenvalue error (|theta - lambda_nearest| <= ||r||
        # for normalized modes), i.e. a frequency-error bound of
        # res*scal^2/(8 pi^2 omega); reject the solve when any tracked
        # band's bound exceeds the golden-parity scale so the cold-retry
        # path re-solves it from a fresh subspace.
        rep = result.report
        if rep is not None and rep.residuals is not None:
            om = np.maximum(np.asarray(rep.omega_re, float), 0.05)
            bound = (np.asarray(rep.residuals, float)[: len(om)]
                     * cfg.scal**2 / (8.0 * np.pi**2 * om))
            if float(np.max(bound)) > 2e-3:
                b = float(np.max(bound))
                raise RuntimeError(
                    f"under-converged: frequency-error bound {b:.2e} "
                    f"(band {int(np.argmax(bound))}; subspace likely "
                    f"missing a near-degenerate direction){stats}")

    def _accept_or_escalate(i, result):
        """_accept, with one escalation: when the per-point "light"
        (working-precision) refine rejects a solve on the spurious or
        frequency-error-bound gate, re-validate with the STREAMED f64
        refine (~17 s at N=120) before paying the 150-330 s cold retry —
        the light refine's statistics sit at the c64 noise floor, so a
        marginal few-e-3 failure is frequently measurement noise rather
        than genuine subspace error.  Returns the (possibly re-validated)
        result to commit; raises like _accept when the f64 gate also
        fails."""
        try:
            _accept(result)
            return result
        except RuntimeError as e:
            msg = str(e)
            if (solver.refine != "light"
                    or not ("under-converged" in msg or "spurious" in msg)):
                raise
            print(f"{YELLOW}k={i}: light-refine gate failed ({e}); "
                  f"re-validating with the f64 refine{RESET}")
            report, _theta, _x = solver._refine_report(
                alphas[i], result.x, raise_on_spurious=False, mode="f64")
            r2 = dataclasses.replace(result, report=report,
                                     omega=report.omega_pnt,
                                     omega_re=report.omega_re)
            _accept(r2)
            print(f"{GREEN}k={i}: f64 re-validation PASSED — accepting "
                  f"(light-refine false rejection){RESET}")
            return r2

    committed_grp = []  # members of the CURRENT group already recorded
    last_commit_t = [time.time()]  # outer wall cadence (solve + refine +
    # retries + checkpoint IO), the number that actually bounds sweep
    # throughput — `t =` below is the solve kernel alone and under-reports
    # by minutes when a cold retry recompiles (sc_flat1 c24 sweep).

    def _commit(i, result):
        nonlocal x_prev, prev_idx
        committed_grp.append(i)
        lib.record(i, result.iterations, result.wall_time, result.omega_re)
        logger.log_solve(RunLogger.from_result("bandgap_k", cfg,
                                               alphas[i], result))
        x_prev, prev_idx = result.x, i
        if verbose:
            now = time.time()
            print(f"Gap {i + 1}/{n_k} ({lattice}), "
                  f"alpha/pi = {np.round(alphas[i] / np.pi, 3)}: "
                  f"iters = {result.iterations}, "
                  f"t = {result.wall_time:<6.2f}s, "
                  f"wall = {now - last_commit_t[0]:.1f}s")
            last_commit_t[0] = now

    def _is_device_error(e):
        msg = str(e)
        return any(tag in msg for tag in
                   ("UNAVAILABLE", "INTERNAL", "DEADLINE_EXCEEDED",
                    "device error", "RESOURCE_EXHAUSTED"))

    # Batched mode: consecutive index groups solved in one vmapped program
    # (throughput on one chip; the reference sweeps serially).
    groups = ([indices[i:i + k_batch] for i in range(0, len(indices), k_batch)]
              if k_batch > 1 else [[i] for i in indices])
    for grp in groups:
        committed_grp.clear()
        try:
            if len(grp) > 1:
                # Warm start every member of the group from the nearest
                # previously-solved eigenvector block (the reference warm
                # start, num_exp.py:425-432, extended to lockstep groups).
                x0s = ([x_prev] * len(grp)
                       if (x_prev is not None and prev_idx is not None
                           and abs(grp[0] - prev_idx) <= 1) else None)
                results = solver.solve_batch([alphas[i] for i in grp],
                                             x0s=x0s, seed=_seed_for(grp[0]),
                                             mesh=mesh)
                for i, result in zip(grp, results):
                    result = _accept_or_escalate(i, result)
                    _commit(i, result)
            else:
                i = grp[0]
                warm = (x_prev is not None and prev_idx is not None
                        and abs(i - prev_idx) <= 1)
                if not warm and i in failed_before:
                    # Warm-feeder retry: a failed row resumed in isolation
                    # has no warm chain, yet cold starts are exactly how it
                    # failed before (near-Gamma points with a ~0 doublet,
                    # e.g. sc_flat1 N=120 k=0, burn maxiter from every cold
                    # seed).  Re-solve an already-COMPUTED neighbor (not
                    # recorded — the library row stays untouched) and
                    # warm-start the retry from its subspace, the same
                    # mechanism that lets mid-sweep points converge in
                    # 13-50 iterations.  Feeder failures fall back to the
                    # cold retry path.
                    done = {k for k, rec in enumerate(lib.iterations)
                            if rec[0] > 0}
                    for j in (i + 1, i - 1):
                        if 0 <= j < n_k and j in done:
                            try:
                                feeder = solver.solve(
                                    alphas[j], x0=None, seed=_seed_for(i),
                                    verbose=False)
                            except Exception as e:  # noqa: BLE001
                                if _is_device_error(e):
                                    raise
                                # Numerical feeder failure: try the OTHER
                                # computed neighbor before giving up on the
                                # warm feeder (a `break` here fell
                                # back to the cold start that is the known
                                # failure mode).
                                continue
                            if verbose:
                                print(f"{YELLOW}k={i}: warm-feeder solve of "
                                      f"computed neighbor k={j} "
                                      f"({feeder.iterations} iters){RESET}")
                            x_prev, prev_idx = feeder.x, j
                            warm = True
                            break
                retry_cold = False
                try:
                    result = solver.solve(alphas[i],
                                          x0=(x_prev if warm else None),
                                          seed=_seed_for(i), verbose=False)
                    result = _accept_or_escalate(i, result)
                except Exception as e:
                    # Immediate cold retry: the dominant numerical failure
                    # mode is a warm-started solve converging onto a
                    # spurious subspace (the sc_curv crossdof N=120 sweep
                    # lost k=11 and k=20 this way while cold-started
                    # neighbors passed).  One fresh-start attempt here
                    # saves a whole supervisor resume round.  The retry
                    # itself runs AFTER this handler exits: inside it the
                    # live traceback pins the failed solve's device blocks
                    # (~2 GB at N=120), and the retry's fresh state on top
                    # OOMed the chip (bcc_sg c22 sweep, k=7).
                    if not warm or _is_device_error(e):
                        raise
                    print(f"{YELLOW}Warm-started k={i} failed ({e}); "
                          f"retrying with a cold start{RESET}")
                    retry_cold = True
                if retry_cold:
                    x_prev = None  # free the warm block before re-solving
                    result = solver.solve(alphas[i], x0=None,
                                          seed=_seed_for(i) + 10007,
                                          verbose=False)
                    result = _accept_or_escalate(i, result)
                _commit(i, result)
        except Exception as e:  # NaN, blowup, spurious, RR failure
            # Distinguish NUMERICAL failures (record [-1,-1] and continue —
            # the reference's containment, num_exp.py:467-477) from DEVICE /
            # infrastructure faults: once the accelerator session is broken
            # every subsequent solve errors instantly, so recording would
            # mass-fail the whole library.  Abort instead — the supervisor
            # (tools/run_sweep.py) restarts and resumes.
            if _is_device_error(e):
                print(f"{RED}DEVICE ERROR at k-points {grp}: {e} — "
                      f"aborting sweep (resume will retry){RESET}")
                raise
            print(f"{RED}WARNING: Error at k-points {grp}: {e}{RESET}")
            for i in grp:
                if i in committed_grp:
                    continue  # already recorded successfully; keep it
                err_index.append(i)
                lib.record(i, -1, -1, None)
            x_prev, prev_idx = None, None

    if err_index:
        print(f"{RED}Error occurs at indices: {err_index}{RESET}")
    elif verbose:
        print(f"{GREEN}All indices computed correctly.{RESET}")
    return err_index


def _open_library(path: str, lattice: str, n: int, gap):
    """Open an existing band library, reconstructing its k-path.

    ``gap`` (points per BZ path segment) is inferred from the committed
    row count when not given, so libraries swept with a non-default gap
    are indexed correctly (the old fixed GAP=20 assumption
    silently mis-indexed such libraries)."""
    import json as _json
    import os as _os
    n_seg = lattices.sym_points(lattice).shape[0] - 1
    if gap is None:
        gap = GAP
        if _os.path.exists(path):
            with open(path) as f:
                rows = _json.load(f).get(f"{lattice}_{n}_iterations")
            if rows is not None:
                if len(rows) % n_seg:
                    raise ValueError(
                        f"{path}: {len(rows)} rows is not a multiple of "
                        f"{n_seg} path segments for {lattice!r}")
                gap = len(rows) // n_seg
    alphas = lattices.k_path(lattice, gap=gap)
    return BandLibrary(path, lattice, n, alphas.shape[0], NEV), alphas


def bandgap_wnk_check(n: int, lattice: str, diel_type: str = "chiral",
                      eps_opt: int = 0, output_dir: str = "output",
                      indices=(), gap: int = None):
    """Inspect selected k-points of a band library: wave vector,
    iterations/runtime, frequencies
    (reference: bandgap_wnk_check, numerical_experiments.py:254-276)."""
    suffix = str(eps_opt) if eps_opt else ""
    path = f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"
    lib, alphas = _open_library(path, lattice, n, gap)
    out = []
    for i in indices:
        a = alphas[i] / np.pi
        it = lib.iterations[i]
        freq = np.asarray(lib.frequencies[i])
        print(f"Index = {i}, wnk = ({a[0]:<6.3f}, {a[1]:<6.3f}, "
              f"{a[2]:<6.3f})pi.")
        print(f"Iterations = {int(it[0]):4d}, runtime = {it[1]:6.3f}s.")
        print("List of frequencies follows as:")
        print(freq)
        out.append((alphas[i], it, freq))
    return out


def bandgap_history_check(n: int, lattice: str, diel_type: str = "chiral",
                          eps_opt: int = 0, output_dir: str = "output",
                          gap: int = None):
    """Report failed/uncomputed k-points of a band library
    (reference: numerical_experiments.py:277-311)."""
    suffix = str(eps_opt) if eps_opt else ""
    path = f"{output_dir}/{diel_type}/bandgap_{lattice}{suffix}.json"
    import os
    if not os.path.exists(path):
        print(f"The bandgap of type {diel_type},{lattice} has no previous record.")
        return None
    lib, _ = _open_library(path, lattice, n, gap)
    failed = lib.failed_indices()
    pending = lib.pending_indices()
    empty = sorted(set(pending) - set(failed))
    if failed:
        print(f"{RED}Warning: Blow up results detected: {failed}.{RESET}")
    if empty:
        print(f"{YELLOW}Following indices remain uncomputed: {empty}.{RESET}")
    if not failed and not empty:
        print(f"{GREEN}All indices of {diel_type},{lattice} have been "
              f"computed without errors.{RESET}")
    return failed, empty
