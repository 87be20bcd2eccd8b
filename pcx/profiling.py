"""Profiling & observability: per-phase breakdown of the LOBPCG iteration.

The reference prints FFT/RR/MM/LOCK percentages per iteration from
hand-placed synchronized timers (paper_2/lobpcg.py:478-480,
environment.py:84-111).  Under jit the loop is one fused program, so pcx
profiles differently:

* ``phase_breakdown`` — times the jitted phase kernels (operator apply,
  preconditioner, Gram+RR, update GEMMs) standalone over repeats: the
  steady-state cost model of one iteration;
* ``trace`` — wraps a callable in a ``jax.profiler`` trace for Perfetto;
* ``device_memory_mib`` (pcx.utils) — the analog of the per-iteration
  cupy memory-pool print (lobpcg.py:471-472).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from pcx.utils import device_memory_mib


def _time_jitted(fn, args, repeats: int = 5) -> float:
    """Median wall seconds of a jitted call (compile excluded)."""
    jfn = jax.jit(fn)
    out = jfn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jfn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_breakdown(solver, alpha, m: Optional[int] = None,
                    repeats: int = 5, verbose: bool = True) -> Dict[str, float]:
    """Per-iteration phase cost model for a KPointSolver at one k-point.

    Phases (reference print: FFT / RR / MM / LOCK, lobpcg.py:478-480):
      operator   — AMA_BB on the active block (the 2 batched FFTs + blocks),
      precond    — zero-FFT block preconditioner,
      gram_rr    — f64-accumulated Gram + embedded eigh,
      update     — the 6 update GEMMs (mix),
      ortho      — projection + Loewdin of W and P.
    """
    from pcx.operators import maxwell
    from pcx.operators.blocks import h_block
    from pcx.solvers import rayleigh_ritz as rr

    n = solver.cfg.n
    m = m or solver.block_width(alpha)
    d_a, b, inv, shift = solver.symbols_for(alpha)
    x = maxwell.random_block(jax.random.PRNGKey(0), n, m, solver.dtype)
    s3 = jnp.concatenate([x, x, x], axis=0).reshape(3 * m, -1)
    ones = jnp.ones((3 * m,), s3.real.dtype)
    coeff = jnp.eye(3 * m, m, dtype=solver.dtype)

    out = {
        "operator_s": _time_jitted(
            lambda v: maxwell.ama_bb(v, d_a, b, solver.diel, shift), (x,),
            repeats),
        "precond_s": _time_jitted(lambda v: h_block(v, inv), (x,), repeats),
        "gram_rr_s": _time_jitted(
            lambda s: rr.eigh_f64_embedding(*rr.gram_f64(s, s)), (s3,),
            repeats),
        "update_s": _time_jitted(
            lambda s, c: rr.mix(c, s), (s3, coeff), repeats),
        "ortho_s": _time_jitted(
            lambda s: rr.masked_loewdin(s[:m], ones[:m], 1e-5)[0], (s3,),
            repeats),
    }
    # One LOBPCG iteration ~ operator + precond + gram_rr + 2*ortho +
    # 6*update-equivalent GEMMs.
    out["iteration_estimate_s"] = (out["operator_s"] + out["precond_s"]
                                   + out["gram_rr_s"] + 2 * out["ortho_s"]
                                   + 3 * out["update_s"])
    out["memory_mib"] = device_memory_mib()
    if verbose:
        tot = out["iteration_estimate_s"]
        print(f"Phase breakdown (N={n}, m={m}, {solver.dtype}):")
        for k in ("operator_s", "precond_s", "gram_rr_s", "update_s",
                  "ortho_s"):
            print(f"  {k:<12} {out[k] * 1e3:8.2f} ms "
                  f"({out[k] / tot * 100:5.1f}% of est. iteration)")
        print(f"  est. iteration {tot * 1e3:8.2f} ms, "
              f"device memory {out['memory_mib']:.0f} MiB")
    return out


def trace(fn, *args, logdir: str = "/tmp/pcx_trace"):
    """Run ``fn(*args)`` under a jax.profiler trace (Perfetto UI-compatible,
    the device analog of the reference's hand timers)."""
    with jax.profiler.trace(logdir):
        out = fn(*args)
        jax.block_until_ready(out)
    print(f"trace written to {logdir}")
    return out
