#!/usr/bin/env python
"""Rescue stubborn failed k-points of a band library with an escalation
ladder the plain sweep doesn't use.

The sweep's containment (warm -> cold retry -> supervisor re-seed) heals
transient numerical failures, but some points fail STRUCTURALLY: e.g.
sc_flat1 N=120 k=0 (near-Gamma, omega ~ 0.0174 doublet + three 3-fold
clusters) runs to MAXITER=500 in complex64 with a frequency-error bound
stuck at ~6.5e-3 for every seed (reference f64 run: 59 iterations,
bandgap_sc_flat1.json k=0).  Ladder, cheapest first:

  coarse  two-grid start: converge the same k-point on a coarse grid
          (default n//2), lift by trigonometric interpolation, then solve
          at full resolution (KPointSolver x0_mode="coarse").
  f64     full complex128 solve: slower per apply, but reaches the
          reference's f64 floor; worth minutes for one point.

Each step runs bandgap() restricted to the failed indices so checkpoint
/ validation / recording are exactly the production path.

Usage:
  python tools/rescue_point.py --n 120 --lattice sc_flat1 [--diel chiral]
      [--indices 0 7] [--steps coarse f64] [--output output_c64]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--lattice", default="sc_flat1")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--indices", type=int, nargs="*", default=None,
                    help="k-point indices to rescue (default: the "
                         "library's failed rows)")
    ap.add_argument("--steps", nargs="*", default=["refine64", "coarse",
                                                   "f64"],
                    choices=["refine64", "coarse", "f64"])
    ap.add_argument("--coarse-n", type=int, default=0,
                    help="coarse grid size (default n//2)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from pcx.bandstructure import bandgap
    from pcx.config import device_policy, enable_compile_cache
    enable_compile_cache(REPO)

    suffix = str(args.eps_opt) if args.eps_opt else ""
    path = os.path.join(args.output, args.diel,
                        f"bandgap_{args.lattice}{suffix}.json")

    def failed_rows():
        if not os.path.exists(path):
            return []
        it = json.load(open(path)).get(
            f"{args.lattice}_{args.n}_iterations") or []
        return [i for i, r in enumerate(it) if r[0] == -1]

    indices = args.indices if args.indices else failed_rows()
    if not indices:
        print("no failed rows to rescue")
        return 0

    c64 = device_policy().dtype
    coarse = f"coarse:{args.coarse_n}" if args.coarse_n else "coarse"
    # No fast termination levers on rescue steps: robustness over speed;
    # the f64 step converges like the reference's f64 run.
    f64_kw = {}
    ladder = {
        # iterate-dtype solve + f64 Rayleigh-Ritz refine: the refine
        # re-diagonalizes the projected pencil in STREAMED f64 (production
        # machinery) — recovers the subspace's true accuracy from the c64
        # noise floor, which is exactly what the near-Gamma
        # under-convergence gate measures.
        "refine64": dict(dtype=c64, solver_kw={"refine": True},
                         solver_opts=None),
        "coarse": dict(dtype=c64, solver_kw={"x0_mode": coarse},
                       solver_opts=None),
        "f64": dict(dtype=jnp.complex128, solver_kw=f64_kw,
                    solver_opts=None),
    }

    for step in args.steps:
        todo = [i for i in indices if i in set(failed_rows())] \
            if os.path.exists(path) else indices
        if not todo:
            break
        cfgd = ladder[step]
        print(f"# rescue step '{step}' on indices {todo}", flush=True)
        err = bandgap(n=args.n, lattice=args.lattice, diel_type=args.diel,
                      eps_opt=args.eps_opt, output_dir=args.output,
                      indices=todo, gap=args.gap, nev=args.nev,
                      maxiter=args.maxiter, dtype=cfgd["dtype"],
                      solver_opts=cfgd["solver_opts"],
                      solver_kw=cfgd["solver_kw"])
        print(f"# step '{step}' remaining failures: {err}", flush=True)
    left = failed_rows()
    print(f"# rescue done; failed rows now: {left}")
    return 0 if not any(i in left for i in indices) else 1


if __name__ == "__main__":
    sys.exit(main())
