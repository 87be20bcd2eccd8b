#!/usr/bin/env python
"""Band-library production runner: reproduce a reference band library at
full resolution.

Runs the checkpointed band sweep (pcx.bandstructure.bandgap) under a
supervisor loop: the sweep writes its JSON library after every k-point, so
a device fault costs exactly the in-flight k-point — the supervisor
restarts the worker subprocess, which resumes from the library and retries
failed ([-1,-1]) records up to --max-rounds times.  The JAX persistent
compile cache makes restarts cheap (the solve program compiles once per
(grid, block width, dtype)).

Usage:
  python tools/run_sweep.py --n 120 --lattice sc_curv [--diel chiral]
      [--output output_c64] [--gap 20] [--max-rounds 4]
Then golden-diff against the reference's bandgap_*.json with
tools/golden_diff.py.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pcx.supervisor import SuperviseConfig, library_status, supervise  # noqa: E402

WORKER = r"""
import os, sys
import jax
if os.environ.get("PCX_SWEEP_CPU"):
    jax.config.update("jax_platforms", "cpu")   # test mode
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
from pcx.bandstructure import bandgap
from pcx.config import device_policy, enable_compile_cache
enable_compile_cache({repo!r})
err = bandgap(n={n}, lattice={lattice!r}, diel_type={diel!r},
              eps_opt={eps_opt}, output_dir={output!r}, gap={gap},
              dtype=device_policy().dtype,
              maxiter={maxiter}, nev={nev}, k_batch={k_batch},
              metrics_path={metrics!r}, solver_opts={solver_opts!r},
              solver_kw={solver_kw!r})
sys.exit(2 if err else 0)
"""


def parse_opt(kv: str):
    """'key=val' with val coerced to int/float where possible."""
    k, _, v = kv.partition("=")
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    return k, v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--lattice", default="sc_curv")
    ap.add_argument("--diel", default="chiral")
    ap.add_argument("--eps-opt", type=int, default=0)
    ap.add_argument("--output", default="output_c64")
    ap.add_argument("--gap", type=int, default=20)
    ap.add_argument("--nev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--k-batch", type=int, default=1)
    ap.add_argument("--max-rounds", type=int, default=8,
                    help="budget of PRODUCTIVE rounds (attempts that "
                         "changed the checkpoint)")
    ap.add_argument("--outage-budget", type=float, default=4 * 3600,
                    help="total seconds allowed across no-progress "
                         "attempts (device outage) before giving up")
    ap.add_argument("--stall", type=int, default=900,
                    help="kill the worker if the checkpoint JSON stops "
                         "advancing for this many seconds (a k-point "
                         "normally takes well under a minute)")
    ap.add_argument("--stall-grace", type=int, default=1800,
                    help="stall allowance before the round's FIRST "
                         "heartbeat/checkpoint write (covers the worker's "
                         "start-up compiles; with the per-segment heartbeat "
                         "the first beat CUTS this, so it only bounds "
                         "fully-hung rounds)")
    ap.add_argument("--hb-stall", type=int, default=420,
                    help="kill the worker if the per-segment heartbeat "
                         "goes silent this long after its first beat "
                         "(covers a mid-solve one-off bucket/refine "
                         "compile)")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--solver-opt", action="append", default=[],
                    metavar="KEY=VAL",
                    help="extra KPointSolver solver_opts entry (repeatable),"
                         " e.g. --solver-opt floor_patience=3")
    ap.add_argument("--refine", default="light",
                    choices=["light", "f64", "off"],
                    help="per-point validation mode: 'light' (default for "
                         "sweeps; working-precision refine, same 1e-3 "
                         "spurious gate, ~1 iteration of cost) or 'f64' "
                         "(f64 refine, ~13 chunked f64 applies per point)")
    args = ap.parse_args()
    solver_opts = dict(parse_opt(kv) for kv in args.solver_opt) or None
    solver_kw = {"refine": {"light": "light", "f64": True,
                            "off": False}[args.refine]}

    suffix = str(args.eps_opt) if args.eps_opt else ""
    path = os.path.join(args.output, args.diel,
                        f"bandgap_{args.lattice}{suffix}.json")
    worker = WORKER.format(repo=REPO, n=args.n, lattice=args.lattice,
                           diel=args.diel, eps_opt=args.eps_opt,
                           output=args.output, gap=args.gap,
                           nev=args.nev, maxiter=args.maxiter,
                           k_batch=args.k_batch, metrics=args.metrics,
                           solver_opts=solver_opts, solver_kw=solver_kw)

    # Supervision (round loop, stall watchdog, outage-vs-productive budget
    # split) lives in pcx.supervisor — unit-tested with fake clocks; this
    # tool only assembles the worker command line.
    hb_path = os.path.join(
        args.output, f".pcx_hb_{args.lattice}{args.n}_{args.diel}{suffix}")
    os.makedirs(args.output, exist_ok=True)
    env = dict(os.environ, PCX_HEARTBEAT=hb_path)
    cfg = SuperviseConfig(max_rounds=args.max_rounds,
                          outage_budget=args.outage_budget,
                          stall=args.stall, stall_grace=args.stall_grace,
                          hb_path=hb_path, hb_stall=args.hb_stall)
    outcome = supervise(
        lambda: subprocess.Popen([sys.executable, "-u", "-c", worker],
                                 cwd=REPO, env=env),
        path, args.lattice, args.n, cfg,
        log=lambda msg: print(msg, flush=True))
    if not outcome.ok:
        print(f"# {outcome.status}: pending={outcome.pending}, "
              f"failed={outcome.failed}", file=sys.stderr)
    return 0 if outcome.ok else 1


if __name__ == "__main__":
    sys.exit(main())
