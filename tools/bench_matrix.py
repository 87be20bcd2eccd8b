#!/usr/bin/env python
"""Benchmark the reference's full runtime-table config matrix on the
default device: per-k-point LOBPCG wall time per (lattice, dielectric, N)
row, led by the BCC-DG north star.

Baselines: RTX-4090 seconds from BASELINE.md (README.md:223-379).
Runs in ONE process (one process per card, and compiled programs are
shared across rows); each row = warmup solve + `--reps` timed solves +
f64-refine validation.  Appends one JSON line per row to --out
(resumable: completed rows are skipped).

Usage: python tools/bench_matrix.py [--rows north_star|all|REST...]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

from pcx.config import enable_compile_cache  # noqa: E402

enable_compile_cache(REPO)

import jax.numpy as jnp

# (key, lattice, diel_type, n, baseline_gpu_s) — BASELINE.md rows.
ROWS = [
    ("bcc_dg_chiral_120", "bcc_dg", "chiral", 120, 44.61),
    ("bcc_dg_pseudo_120", "bcc_dg", "pseudochiral_crossdof", 120, 43.55),
    ("sc_curv_chiral_120", "sc_curv", "chiral", 120, 19.85),
    ("sc_curv_pseudo_120", "sc_curv", "pseudochiral_crossdof", 120, 28.67),
    ("fcc_chiral_120", "fcc", "chiral", 120, 27.71),
    ("fcc_pseudo_120", "fcc", "pseudochiral_crossdof", 120, 34.15),
    ("bcc_sg_chiral_120", "bcc_sg", "chiral", 120, 27.96),
    ("bcc_sg_pseudo_120", "bcc_sg", "pseudochiral_crossdof", 120, 41.08),
    ("sc_curv_chiral_100", "sc_curv", "chiral", 100, 10.79),
    ("sc_curv_pseudo_100", "sc_curv", "pseudochiral_crossdof", 100, 16.67),
    ("fcc_chiral_100", "fcc", "chiral", 100, 16.00),
    ("bcc_dg_chiral_100", "bcc_dg", "chiral", 100, 26.83),
    ("sc_curv_chiral_150", "sc_curv", "chiral", 150, 49.20),
]

ALPHA = np.array([np.pi, 0.0, 0.0])


def run_row(key, lattice, diel, n, baseline, reps, maxiter):
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.solvers.lobpcg import Status

    cfg = ProblemConfig(n=n, lattice=lattice, diel_type=diel, nev=10)
    solver = KPointSolver(cfg, dtype=jnp.complex64, maxiter=maxiter)
    r = solver.solve(ALPHA, seed=0, validate_result=False)
    print(f"#   warmup: {Status(r.status).name} iters={r.iterations} "
          f"t={r.wall_time:.2f}s", flush=True)
    times, iters = [], []
    for i in range(reps):
        r = solver.solve(ALPHA, seed=i + 1, validate_result=False)
        if r.status not in (Status.CONVERGED, Status.FLOOR):
            raise RuntimeError(f"status {Status(r.status).name}")
        times.append(r.wall_time)
        iters.append(int(r.iterations))
        print(f"#   rep {i}: {r.wall_time:.3f}s iters={r.iterations}",
              flush=True)
    rep = solver.validate_solution(ALPHA, r)
    dev = float(np.abs(rep.omega_pnt - rep.omega_re).max())
    if dev > 1e-3:
        raise RuntimeError(f"spurious: dev={dev:.2e}")
    value = float(min(times))
    return {"row": key, "lattice": lattice, "diel": diel, "n": n,
            "seconds": round(value, 3), "iters": iters[-1],
            "validation": float(f"{dev:.3e}"),
            "baseline_gpu_s": baseline,
            "vs_baseline": round(baseline / value, 3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", nargs="*", default=["all"])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--out", default="output/bench_matrix.jsonl")
    args = ap.parse_args()

    sel = ROWS
    if args.rows == ["north_star"]:
        sel = ROWS[:2]
    elif args.rows != ["all"]:
        sel = [r for r in ROWS if r[0] in set(args.rows)]

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            done = {json.loads(ln)["row"] for ln in f if ln.strip()}

    print("devices:", jax.devices(), flush=True)
    for key, lattice, diel, n, baseline in sel:
        if key in done:
            print(f"# skip {key} (done)", flush=True)
            continue
        print(f"# === {key} [{time.strftime('%H:%M:%S')}] ===", flush=True)
        try:
            rec = run_row(key, lattice, diel, n, baseline, args.reps,
                          args.maxiter)
        except Exception as e:
            print(f"# ROW FAILED {key}: {e}", flush=True)
            continue
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
