#!/usr/bin/env python
"""Record a stubborn band-library row by validating a c64 solve DIRECTLY
against a committed converged-f64 ground truth (data/*_f64.json).

The sweep's acceptance gate rejects a solve when its frequency-error
BOUND exceeds ~2e-3 — a bound, not an error: on dense-doublet rows (e.g.
bcc_sg N=120 k=100, Sigma segment) every seed stalls with the bound at
5e-3..1e-2 while the frequencies themselves are already accurate.  Where
a CONVERGED complex128 truth exists (tools/f64_truth.py, ~80 min/point
on the host), comparing omega to the truth is a STRONGER gate than the
bound: we record the row iff max |omega - omega_f64| < --gate (default
1e-3, the library-wide spurious gate).  The deviation is printed and
should be quoted in the commit message.

Usage:
  python tools/record_vs_truth.py --lattice bcc_sg --n 120 --k 100 \
      [--truth data/bcc_sg_n120_k100_f64.json] [--tries 3]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lattice", required=True)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--truth", default=None)
    ap.add_argument("--gate", type=float, default=1e-3)
    ap.add_argument("--tries", type=int, default=3)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from pcx import lattices
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig, enable_compile_cache
    enable_compile_cache(REPO)
    from pcx.io import BandLibrary
    from pcx.solvers.lobpcg import Status

    truth_path = args.truth or os.path.join(
        REPO, "data", f"{args.lattice}_n{args.n}_k{args.k}_f64.json")
    truth = json.load(open(truth_path))
    want = np.asarray(truth["omega_f64"], float)
    assert truth.get("status", 1) in (1, 5), "truth must be converged"

    path = lattices.k_path(args.lattice)
    alpha = path[args.k]
    np.testing.assert_allclose(np.asarray(alpha) / np.pi,
                               truth["alpha_over_pi"], atol=1e-9)

    cfg = ProblemConfig(n=args.n, lattice=args.lattice,
                        diel_type=args.diel, eps_opt=args.eps_opt, nev=10)
    solver = KPointSolver(
        cfg, dtype=jnp.complex64,
        solver_opts={"lam_tol": 2e-6, "floor_patience": 3,
                     "col_patience": 3, "w_cap": "auto"})
    best = None
    for t in range(args.tries):
        res = solver.solve(alpha, seed=1000 + 7 * t,
                           validate_result=True)
        omega = np.asarray(res.omega_re, float)[: len(want)]
        dev = float(np.abs(omega - want).max())
        print(f"# try {t}: status={Status(res.status).name} "
              f"iters={res.iterations} wall={res.wall_time:.1f}s "
              f"max|omega-omega_f64|={dev:.3e}", flush=True)
        if best is None or dev < best[0]:
            best = (dev, omega, res)
        if dev < args.gate / 4:
            break
    dev, omega, res = best
    if dev >= args.gate:
        print(f"# REFUSED: best deviation {dev:.3e} >= gate {args.gate}")
        return 1

    suffix = str(args.eps_opt) if args.eps_opt else ""
    lib_path = os.path.join(args.output, args.diel,
                            f"bandgap_{args.lattice}{suffix}.json")
    n_k = len(path)
    lib = BandLibrary(lib_path, args.lattice, args.n, n_k=n_k, nev=10)
    lib.record(args.k, int(res.iterations), float(res.wall_time),
               omega)
    print(f"# RECORDED k={args.k} into {lib_path} "
          f"(max dev vs f64 truth {dev:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
