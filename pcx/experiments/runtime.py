"""Runtime / speedup studies: accelerator vs host CPU.

Reference: the pack_cmp / speedup runs behind
paper_2/output/chiral/{runtime,speedup}_sc_curv.json and the MATLAB
run_timecmp.m — single-k-point solve timings across grid sizes on the
accelerator and on CPU, with speedup ratios.  Output schema matches the
committed JSONs: {"<lattice>_<N>": [iters, cpu_s, accel_s, speedup]}.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

_PI = np.pi


def pack_cmp(ns: Sequence[int] = (100, 120, 150), lattice: str = "sc_curv",
             alpha=None, nev: int = 10, run_cpu: bool = True,
             output_path: Optional[str] = None, verbose: bool = True):
    """Accelerator-vs-CPU single-solve timing table
    (reference: runtime_sc_curv.json / speedup_sc_curv.json)."""
    import jax
    import jax.numpy as jnp
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig, device_policy

    if alpha is None:
        alpha = np.array([_PI, _PI, _PI])

    dtype = device_policy().dtype
    results = {}
    for n in ns:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        # Default-device run in the device's iterate dtype.
        solver = KPointSolver(cfg, dtype=dtype)
        warm = solver.solve(alpha, seed=0, validate_result=False)
        fast = solver.solve(alpha, seed=1, validate_result=False)

        cpu_s = float("nan")
        if run_cpu:
            cpu_dev = jax.devices("cpu")[0]
            with jax.default_device(cpu_dev):
                solver_cpu = KPointSolver(cfg, dtype=jnp.complex128)
                r_cpu = solver_cpu.solve(alpha, seed=1,
                                         validate_result=False)
                cpu_s = r_cpu.wall_time

        results[f"{lattice}_{n}"] = [
            int(fast.iterations), cpu_s, fast.wall_time,
            (cpu_s / fast.wall_time) if run_cpu else float("nan"),
        ]
        if verbose:
            print(f"N = {n}: iters = {fast.iterations}, "
                  f"accel = {fast.wall_time:<6.2f}s, cpu = {cpu_s:<6.2f}s, "
                  f"speedup = {results[f'{lattice}_{n}'][3]:<6.2f}x")

    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(results, f, indent=4)
    return results
