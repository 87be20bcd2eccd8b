#!/usr/bin/env python
"""Bisect the full rs-iteration cost by ablating phases one at a time.

Each variant is the full iteration with ONE phase stubbed out; the delta
to the full time attributes that phase's true in-program cost (including
fusion/layout effects the standalone profile misses).
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

from pcx import boundary
from pcx.bandstructure import KPointSolver
from pcx.config import ProblemConfig, enable_compile_cache
from pcx.operators import rs
from pcx.solvers import rayleigh_ritz as rr


def timeit(name, fn, *args, reps=3):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    print(f"{name:40s} {min(ts)*1e3:9.2f} ms", flush=True)
    return min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--m", type=int, default=16)
    args = ap.parse_args()
    n, m = args.n, args.m
    enable_compile_cache()

    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=10)
    solver = KPointSolver(cfg, dtype=jnp.complex64)
    d_a, b, inv, shift = solver.symbols_for(np.array([np.pi, 0.0, 0.0]))
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
    shape5 = (m, 3, n, n, n)

    r0 = np.random.default_rng(0)
    mk = lambda s: (put(np.random.default_rng(s).standard_normal(
        (m, 3*n*n*n), dtype=np.float32)),
        put(np.random.default_rng(s+10).standard_normal(
            (m, 3*n*n*n), dtype=np.float32)))
    xf, wf0, pf0, hpf0 = mk(0), mk(1), mk(2), mk(3)
    lam0 = jnp.linspace(1.0, 10.0, m).astype(jnp.float32)
    ones = jnp.ones((m,), jnp.float32)
    rr_split = rr.split_for(jnp.float32)
    tiny = float(jnp.finfo(jnp.float32).tiny ** 0.5)
    unflat = lambda a: (a[0].reshape(shape5), a[1].reshape(shape5))

    def h_func(v):
        return rs.ama_bb_p(v, d_ap, b_diag, b_sd, diel, shift=sh)

    def make_iter(do_h=True, do_svqb_w=True, do_svqb_p=True, do_eigh=True,
                  do_updates=True, do_precond=True):
        def full_iter(xf, hxf, pf, hpf, lambdas):
            lam = lambdas[:, None]
            r = (lam * xf[0] - hxf[0], lam * xf[1] - hxf[1])
            res = rr.colnorms_p(r)
            active = (res > 1e-4).astype(jnp.float32)
            ac = active[:, None]
            if do_precond:
                w = rs.h_block_p(unflat((ac * r[0], ac * r[1])),
                                 inv_diag, inv_sd)
                wfl = (w[0].reshape(m, -1) * ac, w[1].reshape(m, -1) * ac)
            else:
                wfl = (ac * r[0], ac * r[1])
            wn = rr.colnorms_p(wfl)
            wfl = rr.scale_cols_p(wfl, 1.0 / jnp.maximum(wn, tiny))
            if do_svqb_w:
                wfl, _, w_ok = rr.masked_svqb_drop_p(
                    wfl, active, 1e-3, against=(xf,), passes=2)
            else:
                w_ok = active
            if do_h:
                hw5 = h_func(unflat(wfl))
                hwf = (hw5[0].reshape(m, -1), hw5[1].reshape(m, -1))
            else:
                hwf = wfl
            pn = rr.colnorms_p(pf)
            ipn = (1.0 / jnp.maximum(pn, tiny))[:, None]
            pf = (ipn * pf[0], ipn * pf[1])
            hpf = (ipn * hpf[0], ipn * hpf[1])
            if do_svqb_p:
                pf, hpf, p_ok = rr.masked_svqb_drop_p(
                    pf, active, 1e-3, hblock=hpf, against=(xf, wfl),
                    h_against=(hxf, hwf), passes=2)
            else:
                p_ok = active
            bm = jnp.concatenate((ones, w_ok, p_ok))
            sf = (jnp.concatenate((xf[0], wfl[0], pf[0])),
                  jnp.concatenate((xf[1], wfl[1], pf[1])))
            hsf = (jnp.concatenate((hxf[0], hwf[0], hpf[0])),
                   jnp.concatenate((hxf[1], hwf[1], hpf[1])))
            t_re, t_im = rr.gram_f64_p(sf, hsf)
            keep = (bm[:, None] * bm[None, :]).astype(jnp.float64)
            t_re = 0.5 * (t_re + t_re.T) * keep
            t_im = 0.5 * (t_im - t_im.T) * keep
            if do_eigh:
                theta_all, v_re, v_im = rr.eigh_f64_embedding(
                    t_re, t_im, split=rr_split)
            else:
                theta_all = jnp.diag(t_re)
                v_re = jnp.eye(3 * m, dtype=jnp.float64)
                v_im = jnp.zeros((3 * m, 3 * m), jnp.float64)
            theta = theta_all[:m].astype(jnp.float32)
            if do_updates:
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
            else:
                p_new, hp_new, x_new, hx_new = pf, hpf, wfl, hwf
            return x_new, hx_new, p_new, hp_new, theta
        return jax.jit(full_iter)

    t_full = timeit("FULL", make_iter(), xf, wf0, pf0, hpf0, lam0)
    for name, kw in [("no h_func", dict(do_h=False)),
                     ("no svqb W", dict(do_svqb_w=False)),
                     ("no svqb P", dict(do_svqb_p=False)),
                     ("no eigh", dict(do_eigh=False)),
                     ("no updates", dict(do_updates=False)),
                     ("no precond", dict(do_precond=False))]:
        t = timeit(f"FULL {name}", make_iter(**kw), xf, wf0, pf0, hpf0, lam0)
        print(f"   -> {name} costs {1e3*(t_full - t):8.2f} ms", flush=True)


if __name__ == "__main__":
    main()
