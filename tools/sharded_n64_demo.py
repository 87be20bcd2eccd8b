#!/usr/bin/env python
"""N=64 end-to-end grid-sharded solve on the 8-virtual-device CPU mesh
(an N that needs several grid planes per shard, complementing the N=16
pytest case; the four-card run is `chip_smoke.py --four`).

Solves one SC-CURV chiral k-point at N=64 (3*64^3 = 786k complex DoFs)
twice — single-device KPointSolver vs solve_kpoint_sharded over a
Mesh(grid=4, k=2) — and reports the eigenvalue agreement.  Appends one
JSON line to output/sharded_demo.jsonl.
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")   # virtual CPU mesh
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp


def main(n=64, nev=4, tol=1e-6, maxiter=400):
    from jax.sharding import Mesh
    from pcx.bandstructure import KPointSolver
    from pcx.config import CHIRAL_EPS_EG, ProblemConfig
    from pcx.operators import maxwell
    from pcx.parallel.solve import solve_kpoint_sharded
    from pcx import geometry

    alpha = np.array([np.pi, 0.0, 0.0])
    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=nev)
    # same tol/maxiter as the sharded solve below, so the recorded
    # iteration/time columns are apples-to-apples (the eigenvalue
    # agreement is the evidence either way)
    single = KPointSolver(cfg, dtype=jnp.complex128, tol=tol,
                          maxiter=maxiter)
    d_a, b, inv, shift = single.symbols_for(alpha)
    x0 = maxwell.random_block(jax.random.PRNGKey(0), n, nev + 2,
                              jnp.complex128)

    t0 = time.time()
    r1 = single.solve(alpha, x0=x0, validate_result=False)
    t1 = time.time() - t0
    print(f"single-device: status={r1.status} iters={r1.iterations} "
          f"t={t1:.1f}s", flush=True)

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("grid", "k"))
    mask = geometry.edge_mask(n, "sc_curv")
    scale = jnp.asarray(np.where(mask, 1.0 / CHIRAL_EPS_EG["sc_curv"], 1.0))
    t0 = time.time()
    r2 = solve_kpoint_sharded(mesh, d_a, b, inv, scale, shift, x0, nev,
                              tol=tol, maxiter=maxiter)
    t2 = time.time() - t0
    lam2 = np.asarray(r2.lambdas)[:nev] - shift
    lam1 = np.asarray(r1.lambdas)[:nev]
    dev = float(np.abs(lam2 - lam1).max() / np.abs(lam1).max())
    rec = {"demo": "sharded_n64", "n": n, "nev": nev,
           "mesh": "grid=4 x k=2 (virtual CPU)",
           "iters_single": int(r1.iterations), "iters_sharded": int(r2.iterations),
           "seconds_single": round(t1, 1), "seconds_sharded": round(t2, 1),
           "lambdas_single": [float(v) for v in lam1],
           "lambdas_sharded": [float(v) for v in lam2],
           "max_rel_dev": float(f"{dev:.3e}")}
    os.makedirs(os.path.join(REPO, "output"), exist_ok=True)
    with open(os.path.join(REPO, "output", "sharded_demo.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    assert dev < 1e-4, dev
    print("# PASS", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nev", type=int, default=4)
    a = ap.parse_args()
    main(n=a.n, nev=a.nev)
