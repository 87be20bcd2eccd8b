#!/usr/bin/env python
"""Per-phase microbenchmark of one complex-solver LOBPCG iteration.

Times each phase as its own jitted program on the default device so the
per-iteration time of the complex solver can be attributed: operator apply
(FFT and matmul DFT), preconditioner, MGS orthonormalization, f64 Grams,
f64 embedding eigh, update GEMMs.

Usage: python tools/profile_phases.py [--n 96] [--m 16] [--reps 5]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

from pcx.bandstructure import KPointSolver  # noqa: E402
from pcx.config import ProblemConfig, enable_compile_cache  # noqa: E402
from pcx.operators import dft as dft_mod  # noqa: E402
from pcx.operators import maxwell  # noqa: E402
from pcx.operators.blocks import h_block  # noqa: E402
from pcx.solvers import rayleigh_ritz as rr  # noqa: E402


def timeit(name, fn, *args, reps=5):
    jax.block_until_ready(fn(*args))   # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    print(f"{name:42s} {best*1e3:9.2f} ms")
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    n, m = args.n, args.m

    enable_compile_cache()
    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=10)
    solver = KPointSolver(cfg, dtype=jnp.complex64, solver_impl="complex",
                          refine=False)
    alpha = np.array([np.pi, 0.0, 0.0])
    d_a, b, inv, shift = solver.symbols_for(alpha)
    diel = solver.diel
    dft = jax.tree_util.tree_map(jnp.asarray,
                                 dft_mod.dft_mats(n, np.complex64))

    def rand_block(seed):
        r = np.random.default_rng(seed)
        return jnp.asarray((r.random((m, 3, n, n, n)) +
                            1j * r.random((m, 3, n, n, n))).astype(
                                np.complex64))

    ex = rand_block(0)
    D = 3 * n**3

    j = jax.jit

    h_apply = j(lambda x, da, bb, dl, w: maxwell.ama_bb(x, da, bb, dl, dft=w))
    p_apply = j(lambda x, iv: h_block(x, iv))
    timeit("h_func (ama_bb, FFT)", h_apply, ex, d_a, b, diel, None,
           reps=args.reps)
    timeit("h_func (ama_bb, matmul DFT)", h_apply, ex, d_a, b, diel, dft,
           reps=args.reps)
    timeit("p_func (h_block inv)", p_apply, ex, inv, reps=args.reps)

    dft_only = j(lambda x, w: dft_mod.dft3(x, w.fwd))
    timeit("  dft3 fwd alone (matmul)", dft_only, ex, dft, reps=args.reps)
    fft_builtin = j(lambda x: jnp.fft.fftn(x, axes=(-3, -2, -1)))
    timeit("  fftn fwd alone", fft_builtin, ex, reps=args.reps)

    ones_m = np.ones((m,), np.float32)
    noise_floor = 30.0 * (D ** 0.5) * float(jnp.finfo(jnp.float32).eps)

    flatten = j(lambda x: x.reshape(m, -1))
    xf = flatten(ex)
    wf = flatten(rand_block(1))
    hpf = flatten(rand_block(2))

    mgs_w = j(lambda w, x: rr.masked_mgs(w, jnp.asarray(ones_m), noise_floor,
                                         against=(x,), passes=2))
    timeit("masked_mgs W (passes=2, vs X)", mgs_w, wf, xf, reps=args.reps)

    mgs_p = j(lambda p, hp, x, w: rr.masked_mgs(
        p, jnp.asarray(ones_m), noise_floor, hblock=hp,
        against=(x, w), h_against=(x, w), passes=2))
    timeit("masked_mgs P (passes=2, vs X,W, +hp)", mgs_p, hpf, hpf, xf, wf,
           reps=args.reps)

    svqb = j(lambda w: rr.masked_loewdin(w, jnp.asarray(ones_m), 1e-12))
    timeit("masked_loewdin W (1 pass)", svqb, wf, reps=args.reps)

    gram1 = j(lambda a, bb: rr.gram_f64(a, bb))
    timeit("gram_f64 (one m x m block)", gram1, xf, wf, reps=args.reps)

    def grams9(a, bb, c):
        blocks = (a, bb, c)
        out = []
        for bi in blocks:
            for bj in blocks:
                out.append(rr.gram_f64(bi, bj))
        return out
    timeit("gram_f64 x 9 (full T)", j(grams9), xf, wf, hpf, reps=args.reps)

    tre = np.random.default_rng(0).standard_normal((3 * m, 3 * m))
    tre = (tre + tre.T) / 2
    tim = np.random.default_rng(1).standard_normal((3 * m, 3 * m))
    tim = (tim - tim.T) / 2
    eig64 = j(lambda a, bb: rr.eigh_f64_embedding(a, bb))
    timeit(f"eigh_f64_embedding ({6*m}x{6*m})", eig64, tre, tim,
           reps=args.reps)
    eig32 = j(lambda a, bb: rr.eigh_embedding_refined(a, bb))
    timeit("eigh_embedding_refined (f32+RQ)", eig32, tre, tim, reps=args.reps)

    cmix = jnp.asarray(np.random.default_rng(2).standard_normal((m, m)),
                       jnp.complex64)
    def updates(c, a, bb, cc):
        # 6 mixes like _sep_update: p=cw*W+cp*P; hp; x=cx*X+p; hx
        p1 = rr.mix(c, a) + rr.mix(c, bb)
        p2 = rr.mix(c, a) + rr.mix(c, cc)
        x1 = rr.mix(c, a) + p1
        x2 = rr.mix(c, bb) + p2
        return p1, p2, x1, x2
    timeit("update mixes (8 GEMMs)", j(updates), cmix, xf, wf, hpf,
           reps=args.reps)

    norm = j(lambda x: jnp.sqrt(jnp.sum((x.conj() * x).real, axis=1)))
    timeit("column norms", norm, xf, reps=args.reps)

    print(f"\nblock bytes: {m*D*8/1e6:.0f} MB (c64)")


if __name__ == "__main__":
    main()
