#!/usr/bin/env python
"""Produce a CONVERGED complex128 ground-truth solve of one k-point and
commit it under data/ for the f64 pin tests.

The gyroid golden gate (tests/test_bandstructure.py::golden_threshold) is
loosened to 1.1e-2 because the COMMITTED REFERENCE's doublet bands are
under-converged; pcx regressions on
gyroids are instead caught by pinning the c64 library row against a
converged f64 solve.  This tool writes those pins:

  python tools/f64_truth.py --lattice bcc_sg --n 120 --k 37
  python tools/f64_truth.py --lattice bcc_sg --n 24 --k 37   # live-test pin

Output: data/{lattice}_n{N}_k{K}_f64.json with enough metadata for
tests/test_bandstructure.py::test_library_rows_match_f64_ground_truth to
discover it (lattice, n, diel, eps_opt, k, alpha_over_pi, omega_f64).

Runs on the CPU; N=120 takes ~80 min/point there.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lattice", default="bcc_sg")
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--k", type=int, required=True,
                    help="k-point index on the lattice's standard path")
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--maxiter", type=int, default=1500)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from pcx import lattices
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.solvers.lobpcg import Status

    path = lattices.k_path(args.lattice)
    alpha = path[args.k]
    cfg = ProblemConfig(n=args.n, lattice=args.lattice, diel_type=args.diel,
                        eps_opt=args.eps_opt, nev=args.nev)
    solver = KPointSolver(cfg, dtype=jnp.complex128, tol=args.tol,
                          maxiter=args.maxiter)
    t0 = time.time()
    res = solver.solve(alpha, seed=0, validate_result=True)
    dt = time.time() - t0
    omega = np.asarray(res.omega_re, float)
    print(f"# status={Status(res.status).name} iters={res.iterations} "
          f"t={dt:.1f}s omega={np.round(omega, 8)}")
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        print("# NOT converged — refusing to write a pin", file=sys.stderr)
        return 1
    out = args.out or os.path.join(
        REPO, "data", f"{args.lattice}_n{args.n}_k{args.k}_f64.json")
    rec = {
        "lattice": args.lattice, "n": args.n, "diel": args.diel,
        "eps_opt": args.eps_opt, "k": args.k,
        "alpha_over_pi": [round(float(a) / np.pi, 10) for a in alpha],
        "status": int(res.status), "iters": int(res.iterations),
        "seconds": round(dt, 1), "tol": args.tol,
        "omega_f64": [round(float(w), 8) for w in omega],
    }
    with open(out, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    print(f"# wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
