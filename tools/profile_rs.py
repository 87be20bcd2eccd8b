#!/usr/bin/env python
"""Per-phase microbenchmark of the PAIR-LAYOUT (rs) LOBPCG iteration.

Times each phase of solvers.lobpcg_rs as its own jitted program on real
pair inputs, to attribute the per-iteration wall time of a solve on the
default device.

Usage: python tools/profile_rs.py [--n 96] [--m 16] [--reps 5]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from pcx.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pcx import boundary
from pcx.bandstructure import KPointSolver
from pcx.config import ProblemConfig
from pcx.operators import rs
from pcx.solvers import rayleigh_ritz as rr


def timeit(name, fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    print(f"{name:44s} {best*1e3:9.2f} ms", flush=True)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    n, m = args.n, args.m

    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=10)
    solver = KPointSolver(cfg, dtype=jnp.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    d_a, b, inv, shift = solver.symbols_for(alpha)
    put = jax.device_put

    def pair(x):
        if isinstance(x, boundary.CArr):
            ri = np.asarray(x.ri)
            return (put(ri[..., 0]), put(ri[..., 1]))
        x = np.asarray(x)
        return (put(np.ascontiguousarray(x.real)),
                put(np.ascontiguousarray(x.imag)))

    d_ap = pair(d_a)
    b_diag = put(np.asarray(b.diag))
    b_sd = pair(b.sdiag)
    inv_diag = put(np.asarray(inv.diag))
    inv_sd = pair(inv.sdiag)
    diel = solver.diel
    sh = np.float32(shift)
    D = 3 * n**3

    rng = np.random.default_rng(0)

    def rand_pair(seed, shape):
        r = np.random.default_rng(seed)
        return (put(r.standard_normal(shape, dtype=np.float32)),
                put(r.standard_normal(shape, dtype=np.float32)))

    shape5 = (m, 3, n, n, n)
    x5 = rand_pair(0, shape5)
    flat = lambda a: (a[0].reshape(m, -1), a[1].reshape(m, -1))
    xf = jax.jit(flat)(x5)
    wf = jax.jit(flat)(rand_pair(1, shape5))
    pf = jax.jit(flat)(rand_pair(2, shape5))
    hpf = jax.jit(flat)(rand_pair(3, shape5))

    # chunked apply exactly like run_core_rs
    chunk = solver.apply_chunk
    c = max((d for d in range(1, min(chunk, m) + 1) if m % d == 0),
            default=0) if chunk else 0
    print(f"# N={n} m={m} D={D} apply_chunk={c} "
          f"block={m*D*4/1e6:.0f} MB/part", flush=True)

    def h_one(v):
        return rs.ama_bb_p(v, d_ap, b_diag, b_sd, diel, shift=sh)

    if c and m > c:
        def h_func(v):
            vc = tuple(a.reshape((m // c, c) + a.shape[1:]) for a in v)
            out = jax.lax.map(h_one, vc)
            return tuple(a.reshape((m,) + a.shape[2:]) for a in out)
    else:
        h_func = h_one

    timeit("h_func (pair ama_bb, chunked)", jax.jit(h_func), x5,
           reps=args.reps)
    timeit("h_func unchunked", jax.jit(h_one), x5, reps=args.reps)
    timeit("p_func (h_block_p)",
           jax.jit(lambda v: rs.h_block_p(v, inv_diag, inv_sd)), x5,
           reps=args.reps)
    timeit("fft3_p fwd alone",
           jax.jit(lambda v: rs.fft3_p(v)), x5, reps=args.reps)

    ones_m = jnp.ones((m,), jnp.float32)
    noise_floor = 30.0 * (D ** 0.5) * float(jnp.finfo(jnp.float32).eps)

    timeit("svqb_p W (passes=3, vs X)",
           jax.jit(lambda w, x: rr.masked_svqb_drop_p(
               w, ones_m, noise_floor, against=(x,), passes=3)),
           wf, xf, reps=args.reps)
    timeit("svqb_p P (passes=3, vs X,W, +hp)",
           jax.jit(lambda p, hp, x, w: rr.masked_svqb_drop_p(
               p, ones_m, noise_floor, hblock=hp,
               against=(x, w), h_against=(x, w), passes=3)),
           pf, hpf, xf, wf, reps=args.reps)

    timeit("gram_f64_p (one m x m)",
           jax.jit(lambda a, bb: rr.gram_f64_p(a, bb)), xf, wf,
           reps=args.reps)

    def grams9(a, bb, cc):
        out = []
        for bi in (a, bb, cc):
            for bj in (a, bb, cc):
                out.append(rr.gram_f64_p(bi, bj))
        return out
    timeit("gram_f64_p x 9 (full T)", jax.jit(grams9), xf, wf, pf,
           reps=args.reps)

    def gram_stacked(a, bb, cc):
        s = (jnp.concatenate([a[0], bb[0], cc[0]]),
             jnp.concatenate([a[1], bb[1], cc[1]]))
        return rr.gram_f64_p(s, s)
    timeit("gram_f64_p stacked (48 x 48 once)", jax.jit(gram_stacked),
           xf, wf, pf, reps=args.reps)

    p3 = 3 * m
    tre = np.random.default_rng(4).standard_normal((p3, p3))
    tre = (tre + tre.T) / 2
    tim = np.random.default_rng(5).standard_normal((p3, p3))
    tim = (tim - tim.T) / 2
    timeit(f"eigh_f64_embedding ({2*p3}x{2*p3}, Newton)",
           jax.jit(lambda a, bb: rr.eigh_f64_embedding(a, bb)),
           jnp.asarray(tre), jnp.asarray(tim), reps=args.reps)

    cm = rand_pair(6, (m, m))
    def updates(c, a, bb, cc):
        p1 = rr.mix_pair(c, a)
        p2 = rr.mix_pair(c, bb)
        p_new = (p1[0] + p2[0], p1[1] + p2[1])
        x1 = rr.mix_pair(c, cc)
        x_new = (x1[0] + p_new[0], x1[1] + p_new[1])
        h1 = rr.mix_pair(c, a)
        h2 = rr.mix_pair(c, bb)
        hp_new = (h1[0] + h2[0], h1[1] + h2[1])
        h3 = rr.mix_pair(c, cc)
        hx_new = (h3[0] + hp_new[0], h3[1] + hp_new[1])
        return p_new, x_new, hp_new, hx_new
    timeit("update mixes (6 pair GEMMs)", jax.jit(updates), cm, xf, wf, pf,
           reps=args.reps)

    timeit("colnorms_p", jax.jit(lambda x: rr.colnorms_p(x)), xf,
           reps=args.reps)

    # --- one full solver iteration as a single program ---------------------
    ones = jnp.ones((m,), jnp.float32)
    rr_split = rr.split_for(jnp.float32)
    tiny = float(jnp.finfo(jnp.float32).tiny ** 0.5)
    unflat = lambda a: (a[0].reshape(shape5), a[1].reshape(shape5))

    def full_iter(xf, hxf, pf, hpf, lambdas):
        lam = lambdas[:, None]
        r = (lam * xf[0] - hxf[0], lam * xf[1] - hxf[1])
        res = rr.colnorms_p(r)
        active = (res > 1e-4).astype(jnp.float32)
        ac = active[:, None]
        w = rs.h_block_p(unflat((ac * r[0], ac * r[1])), inv_diag, inv_sd)
        wfl = (w[0].reshape(m, -1) * ac, w[1].reshape(m, -1) * ac)
        wn = rr.colnorms_p(wfl)
        wfl = rr.scale_cols_p(wfl, 1.0 / jnp.maximum(wn, tiny))
        wfl, _, w_ok = rr.masked_svqb_drop_p(
            wfl, active, 1e-3, against=(xf,), passes=2)
        hw5 = h_func(unflat(wfl))
        hwf = (hw5[0].reshape(m, -1), hw5[1].reshape(m, -1))
        pn = rr.colnorms_p(pf)
        ipn = (1.0 / jnp.maximum(pn, tiny))[:, None]
        pf = (ipn * pf[0], ipn * pf[1])
        hpf = (ipn * hpf[0], ipn * hpf[1])
        pf, hpf, p_ok = rr.masked_svqb_drop_p(
            pf, active, 1e-3, hblock=hpf, against=(xf, wfl),
            h_against=(hxf, hwf), passes=2)
        bm = jnp.concatenate((ones, w_ok, p_ok))
        sf = (jnp.concatenate((xf[0], wfl[0], pf[0])),
              jnp.concatenate((xf[1], wfl[1], pf[1])))
        hsf = (jnp.concatenate((hxf[0], hwf[0], hpf[0])),
               jnp.concatenate((hxf[1], hwf[1], hpf[1])))
        t_re, t_im = rr.gram_f64_p(sf, hsf)
        keep = (bm[:, None] * bm[None, :]).astype(jnp.float64)
        t_re = 0.5 * (t_re + t_re.T) * keep
        t_im = 0.5 * (t_im - t_im.T) * keep
        theta_all, v_re, v_im = rr.eigh_f64_embedding(t_re, t_im,
                                                      split=rr_split)
        theta = theta_all[:m].astype(jnp.float32)
        cx = (v_re[:m, :m].astype(jnp.float32),
              v_im[:m, :m].astype(jnp.float32))
        cw = (v_re[m:2*m, :m].astype(jnp.float32),
              v_im[m:2*m, :m].astype(jnp.float32))
        cp = (v_re[2*m:, :m].astype(jnp.float32),
              v_im[2*m:, :m].astype(jnp.float32))
        pw = rr.mix_pair(cw, wfl)
        pp = rr.mix_pair(cp, pf)
        p_new = (pw[0] + pp[0], pw[1] + pp[1])
        hw2 = rr.mix_pair(cw, hwf)
        hp2 = rr.mix_pair(cp, hpf)
        hp_new = (hw2[0] + hp2[0], hw2[1] + hp2[1])
        xc = rr.mix_pair(cx, xf)
        x_new = (xc[0] + p_new[0], xc[1] + p_new[1])
        hxc = rr.mix_pair(cx, hxf)
        hx_new = (hxc[0] + hp_new[0], hxc[1] + hp_new[1])
        return x_new, hx_new, p_new, hp_new, theta

    lam0 = jnp.linspace(1.0, 10.0, m).astype(jnp.float32)
    timeit("FULL ITERATION (one jit)", jax.jit(full_iter),
           xf, wf, pf, hpf, lam0, reps=args.reps)


if __name__ == "__main__":
    main()
