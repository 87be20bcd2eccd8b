"""Command-line launcher: the L7 layer.

Replaces the reference's run.sh GPU autoselection + edit-the-main-function
dispatch (paper_2/run.sh:10-30, README.md:134) with explicit subcommands:

    python -m pcx eigen1p --n 32 --lattice sc_curv --alpha 1,0,0
    python -m pcx bandgap --n 100 --lattice sc_flat2 --type chiral
    python -m pcx check   --n 100 --lattice sc_flat2
    python -m pcx plot    --n 120 --lattice sc_curv --out band.png
    python -m pcx devices
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _parse_alpha(s: str) -> np.ndarray:
    """'1,0,0' (in units of pi) or 'index:<i>' into the BZ path."""
    return np.array([float(v) for v in s.split(",")]) * np.pi


def _add_common(p):
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--lattice", default="sc_curv")
    p.add_argument("--type", dest="diel_type", default="chiral")
    p.add_argument("--eps-opt", type=int, default=0)
    p.add_argument("--nev", type=int, default=10)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--single", action="store_true",
                   help="complex64 (the GPU default)")


def _setup_backend(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from pcx.config import device_policy, enable_compile_cache
    enable_compile_cache()
    return jnp.complex64 if args.single else device_policy().dtype


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pcx", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("eigen1p", help="single k-point solve")
    _add_common(p1)
    p1.add_argument("--alpha", default="1,0,0",
                    help="wave vector in units of pi, e.g. '1,0,0'")

    p2 = sub.add_parser("bandgap", help="full BZ band sweep w/ checkpointing")
    _add_common(p2)
    p2.add_argument("--output", default="output")
    p2.add_argument("--indices", default=None,
                    help="comma-separated k indices (default: resume)")

    p3 = sub.add_parser("check", help="band-library status (resume scan)")
    _add_common(p3)
    p3.add_argument("--output", default="output")

    p4 = sub.add_parser("plot", help="band diagram with gap ratio")
    _add_common(p4)
    p4.add_argument("--output", default="output")
    p4.add_argument("--out", default=None, help="png path")

    sub.add_parser("devices", help="list JAX devices")

    args = ap.parse_args(argv)

    if args.cmd == "devices":
        import jax
        for d in jax.devices():
            print(d)
        return 0

    dtype = _setup_backend(args)
    from pcx.config import MAXITER, TOL

    tol = args.tol if args.tol is not None else TOL
    maxiter = args.maxiter if args.maxiter is not None else MAXITER

    if args.cmd == "eigen1p":
        from pcx.bandstructure import eigen_1p
        res = eigen_1p(args.n, args.lattice, _parse_alpha(args.alpha),
                       diel_type=args.diel_type, nev=args.nev, dtype=dtype,
                       tol=tol, maxiter=maxiter, verbose=True)
        if res.report is not None:
            print(res.report.table())
        return 0 if res.omega is not None else 1

    if args.cmd == "bandgap":
        from pcx.bandstructure import bandgap
        indices = ([int(i) for i in args.indices.split(",")]
                   if args.indices else None)
        err = bandgap(args.n, args.lattice, diel_type=args.diel_type,
                      eps_opt=args.eps_opt, output_dir=args.output,
                      indices=indices, dtype=dtype, tol=tol,
                      maxiter=maxiter, nev=args.nev)
        return 1 if err else 0

    if args.cmd == "check":
        from pcx.bandstructure import bandgap_history_check
        bandgap_history_check(args.n, args.lattice, diel_type=args.diel_type,
                              eps_opt=args.eps_opt, output_dir=args.output)
        return 0

    if args.cmd == "plot":
        from pcx.plotting import plot_bandgap
        out = args.out or f"band_{args.lattice}_{args.n}.png"
        ratio, _ = plot_bandgap(args.n, args.lattice,
                                diel_type=args.diel_type,
                                eps_opt=args.eps_opt,
                                output_dir=args.output, save_path=out)
        print(f"saved {out} (gap ratio {ratio:.6f})")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
