#!/usr/bin/env python
"""CPU iteration-tail decomposition for the termination levers.

Seed-matched c64 solves of one lattice/dielectric config across a lever
matrix, reporting iterations, status, max |omega - omega_base| and the
f64-recompute validation for each variant.  Iteration counts are
hardware-independent, so savings transfer to device sweeps; per-iteration
cost does not — measure that on the device (tools/profile_rs.py).

Usage: python tools/iter_tail.py --n 48 --lattice sc_curv --diel chiral
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # a CPU protocol
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

import pcx.bandstructure as bs
from pcx.config import ProblemConfig

VARIANTS = [
    ("base", {}),
    ("p3", {"floor_patience": 3}),
    ("colp3", {"col_patience": 3}),
    ("stack_p3", {"floor_patience": 3, "col_patience": 3, "w_cap": "auto"}),
    # c64 Ritz jitter floor measured at 4e-7..1.6e-6 per iteration (N=16
    # sc_curv trace): lam_tol must sit just ABOVE the jitter band to fire.
    ("lam2e6", {"lam_tol": 2e-6}),
    ("lam5e6", {"lam_tol": 5e-6}),
    ("stack_lam2e6", {"floor_patience": 3, "col_patience": 3,
                      "w_cap": "auto", "lam_tol": 2e-6}),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--lattice", default="sc_curv")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--nev", type=int, default=None)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()

    cfg_kw = dict(n=args.n, lattice=args.lattice)
    if args.diel != "chiral":
        cfg_kw["diel_type"] = args.diel
    if args.nev is not None:
        cfg_kw["nev"] = args.nev
    cfg = ProblemConfig(**cfg_kw)
    alphas = [np.array([np.pi, 0.0, 0.0]),
              np.array([np.pi / 3, np.pi / 5, 0.0])]
    kw = dict(dtype=jnp.complex64, solver_impl="rs", real_boundary=True)

    variants = VARIANTS if args.only is None else [
        (n_, o) for n_, o in VARIANTS if n_ in set(args.only)]
    base_omega = {}
    for name, opts in variants:
        solver = bs.KPointSolver(cfg, solver_opts=dict(opts), **kw)
        rec = {"variant": name, "n": args.n, "lattice": args.lattice,
               "diel": args.diel, "iters": [], "status": [], "val": []}
        dmax = 0.0
        for i, alpha in enumerate(alphas):
            r = solver.solve(alpha, seed=args.seed)
            rec["iters"].append(int(r.iterations))
            rec["status"].append(int(r.status))
            val = float(np.abs(np.asarray(r.report.omega_pnt)
                               - np.asarray(r.report.omega_re)).max()) \
                if r.report is not None else None
            rec["val"].append(None if val is None else float(f"{val:.2e}"))
            om = np.asarray(r.omega_re)
            if name == "base":
                base_omega[i] = om
            elif i in base_omega:
                dmax = max(dmax, float(np.abs(om - base_omega[i]).max()))
        if name != "base":
            rec["max_domega_vs_base"] = float(f"{dmax:.2e}")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
