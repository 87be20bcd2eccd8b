"""Block Davidson and Jacobi-Davidson eigensolvers (archive parity).

Reference: paper_1_python/eigen_solver.py:848-983 (davidson_sep) and
:985-1124 (jd_sep) — these exist only in the Paper-1 archive.  Redesign: a
FIXED-capacity subspace with a fill mask under one jit'd
``lax.while_loop`` (no dynamic basis growth); when the basis is full it
restarts from the current Ritz block.  The Jacobi-Davidson variant expands
with approximate solutions of the projected correction equation
    (I - X X^H)(H - theta)(I - X X^H) t = -r
by a fixed number of preconditioned CG steps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pcx.config import MAXITER, N_SUBSPACE, TOL
from pcx.solvers import rayleigh_ritz as rr_mod
from pcx.solvers.lobpcg import SolveResult, Status, _col_normalize
from pcx.utils import norms


class _DState(NamedTuple):
    it: jnp.ndarray
    status: jnp.ndarray
    lambdas: jnp.ndarray
    x: jnp.ndarray          # (m, D...) current Ritz block
    hx: jnp.ndarray
    v: jnp.ndarray          # (cap, D...) basis storage
    hv: jnp.ndarray
    fill: jnp.ndarray       # (cap,) 0/1 fill mask
    res_his: jnp.ndarray


def _davidson(h_func: Callable, p_func: Callable, x0: jnp.ndarray, nev: int,
              correction: str, tol: float, maxiter: int, cap: int,
              inner_steps: int) -> SolveResult:
    m = x0.shape[0]
    cdtype = x0.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    jitter = 100.0 * float(jnp.finfo(rdtype).eps)
    bshape = (-1,) + (1,) * (x0.ndim - 1)
    shape_rest = x0.shape[1:]

    def flat(a):
        return a.reshape(a.shape[0], -1)

    # Init: orthonormal X, Ritz rotate.
    x, _ = _col_normalize(x0, tiny)
    xf, _ = rr_mod.masked_loewdin(flat(x), jnp.ones(m, rdtype), jitter)
    hxf = flat(h_func(xf.reshape(x.shape)))
    t_re, t_im = rr_mod.gram_f64(xf, hxf)
    theta0, vr, vi = rr_mod.eigh_f64_embedding(0.5 * (t_re + t_re.T),
                                               0.5 * (t_im - t_im.T))
    c0 = jax.lax.complex(vr.astype(rdtype), vi.astype(rdtype)).astype(cdtype)
    x = rr_mod.mix(c0, xf).reshape(x.shape)
    hx = rr_mod.mix(c0, hxf).reshape(x.shape)

    v0 = jnp.zeros((cap,) + shape_rest, cdtype)
    hv0 = jnp.zeros_like(v0)
    v0 = v0.at[:m].set(x)
    hv0 = hv0.at[:m].set(hx)
    fill0 = jnp.concatenate([jnp.ones(m, rdtype), jnp.zeros(cap - m, rdtype)])

    state0 = _DState(jnp.asarray(0, jnp.int32),
                     jnp.asarray(Status.RUNNING, jnp.int32),
                     theta0[:m].astype(rdtype), x, hx, v0, hv0, fill0,
                     jnp.full((maxiter,), jnp.nan, rdtype))

    def correction_block(r, x, lambdas):
        """New search directions from the residual block."""
        if correction == "davidson":
            # Diagonal/preconditioned Davidson correction t = P r.
            return p_func(r)
        # Jacobi-Davidson: approximately solve the projected correction
        # equation with `inner_steps` preconditioned CG iterations.
        xf = flat(x)

        def proj(z):
            zf = flat(z)
            coeff = rr_mod.gram(xf, zf)
            return (zf - rr_mod.mix(coeff, xf)).reshape(z.shape)

        lam = lambdas.reshape(bshape).astype(cdtype)

        def a_op(z):
            return proj(h_func(proj(z)) - lam * proj(z))

        b = proj(-r)
        t = jnp.zeros_like(b)
        res = b - a_op(t)
        z = proj(p_func(res))
        p = z
        rz = jnp.sum((res.conj() * z).real, axis=tuple(range(1, b.ndim)))

        def cg_body(_, carry):
            t, res, p, rz = carry
            ap = a_op(p)
            pap = jnp.sum((p.conj() * ap).real,
                          axis=tuple(range(1, b.ndim)))
            alpha = (rz / jnp.where(jnp.abs(pap) > tiny, pap, 1.0))
            alpha_c = alpha.reshape(bshape).astype(cdtype)
            t = t + alpha_c * p
            res = res - alpha_c * ap
            z = proj(p_func(res))
            rz_new = jnp.sum((res.conj() * z).real,
                             axis=tuple(range(1, b.ndim)))
            beta = rz_new / jnp.where(jnp.abs(rz) > tiny, rz, 1.0)
            p = z + beta.reshape(bshape).astype(cdtype) * p
            return t, res, p, rz_new

        t, _, _, _ = lax.fori_loop(0, inner_steps, cg_body, (t, res, p, rz))
        return t

    def cond_fun(s):
        return (s.status == Status.RUNNING) & (s.it < maxiter)

    def body_fun(s):
        it = s.it
        r = s.lambdas.reshape(bshape).astype(cdtype) * s.x - s.hx
        res = norms(r)
        res_his = s.res_his.at[it].set(jnp.linalg.norm(res[:nev]))
        converged = jnp.max(res[:nev]) < tol
        is_nan = jnp.isnan(res).any()
        status = jnp.where(is_nan, Status.NAN,
                           jnp.where(converged, Status.CONVERGED,
                                     Status.RUNNING)).astype(jnp.int32)

        def finish(_):
            return s._replace(it=it, status=status, res_his=res_his)

        def step(_):
            n_fill = jnp.sum(s.fill).astype(jnp.int32)
            restart = n_fill + m > cap

            # On restart the basis collapses to the current Ritz block.
            v = jnp.where(restart, jnp.zeros_like(s.v),
                          s.v)
            hv = jnp.where(restart, jnp.zeros_like(s.hv), s.hv)
            v = jnp.where(restart, v.at[:m].set(s.x), v)
            hv = jnp.where(restart, hv.at[:m].set(s.hx), hv)
            fill = jnp.where(restart,
                             jnp.concatenate([jnp.ones(m, rdtype),
                                              jnp.zeros(cap - m, rdtype)]),
                             s.fill)
            n_fill = jnp.sum(fill).astype(jnp.int32)

            # New directions: correction block, orthogonalized against the
            # filled basis, Loewdin-orthonormalized, written at n_fill.
            t = correction_block(r, s.x, s.lambdas)
            tf, _ = _col_normalize(flat(t), tiny)
            vf = flat(v) * fill[:, None].astype(cdtype)
            tf, _ = rr_mod.project_off(tf, vf)
            rho = norms(tf)
            ok = (rho > 1e3 * jnp.finfo(rdtype).eps).astype(rdtype)
            tf = tf * ok[:, None].astype(cdtype)
            tf, _ = rr_mod.masked_loewdin(tf, ok, jitter, passes=2)
            ht = h_func(tf.reshape(s.x.shape))

            # Scatter the new columns into the storage at [n_fill, ...).
            idx = n_fill + jnp.cumsum(ok).astype(jnp.int32) - 1
            idx = jnp.where(ok > 0, idx, cap - 1)  # dead cols -> overwrite
            v = flat(v).at[idx].set(
                jnp.where(ok[:, None] > 0, tf, flat(v)[idx])).reshape(v.shape)
            hv = flat(hv).at[idx].set(
                jnp.where(ok[:, None] > 0, flat(ht),
                          flat(hv)[idx])).reshape(hv.shape)
            fill = fill.at[idx].set(jnp.where(ok > 0, 1.0, fill[idx]))

            # Rayleigh-Ritz over the filled basis (phantom-masked).
            vf, hvf = flat(v), flat(hv)
            keep = fill[:, None] * fill[None, :]
            t_re, t_im = rr_mod.gram_f64(vf * fill[:, None].astype(cdtype),
                                         hvf)
            t_re = 0.5 * (t_re + t_re.T) * keep.astype(jnp.float64)
            t_im = 0.5 * (t_im - t_im.T) * keep.astype(jnp.float64)
            dead_val = jnp.sqrt(jnp.sum(t_re**2) + jnp.sum(t_im**2)) + 1.0
            t_re = t_re - dead_val * jnp.diag(1.0 - fill).astype(jnp.float64)
            theta_all, u_re, u_im = rr_mod.eigh_f64_embedding(t_re, t_im)
            n_dead = (cap - jnp.sum(fill)).astype(jnp.int32)
            theta = lax.dynamic_slice(theta_all, (n_dead,), (m,))
            c = lax.dynamic_slice(
                jax.lax.complex(u_re.astype(rdtype),
                                u_im.astype(rdtype)).astype(cdtype),
                (jnp.int32(0), n_dead), (cap, m))
            c = c * fill[:, None].astype(cdtype)
            x_new = rr_mod.mix(c, vf).reshape(s.x.shape)
            hx_new = rr_mod.mix(c, hvf).reshape(s.x.shape)

            return _DState(it + 1, jnp.asarray(Status.RUNNING, jnp.int32),
                           theta.astype(rdtype), x_new, hx_new, v, hv, fill,
                           res_his)

        return lax.cond(status != Status.RUNNING, finish, step, None)

    final = lax.while_loop(cond_fun, body_fun, state0)
    status = jnp.where(final.status == Status.RUNNING, Status.MAXITER,
                       final.status).astype(jnp.int32)
    return SolveResult(final.lambdas, final.x, final.it, status,
                       final.res_his)


def davidson_sep(h_func, p_func, x0, nev, tol: float = TOL,
                 maxiter: int = MAXITER, subspace: int = N_SUBSPACE,
                 **_) -> SolveResult:
    """Preconditioned block Davidson (reference: davidson_sep,
    paper_1_python/eigen_solver.py:848-983).  Pass ``x0`` as a (re, im)
    pair to run the all-real pair twin (the pair-layout solver path)."""
    if isinstance(x0, tuple):
        return _davidson_p(h_func, p_func, x0, nev, "davidson", tol,
                           maxiter, max(subspace, 3 * x0[0].shape[0]), 0)
    return _davidson(h_func, p_func, x0, nev, "davidson", tol, maxiter,
                     max(subspace, 3 * x0.shape[0]), 0)


def jd_sep(h_func, p_func, x0, nev, tol: float = TOL,
           maxiter: int = MAXITER, subspace: int = N_SUBSPACE,
           inner_steps: int = 5, **_) -> SolveResult:
    """Block Jacobi-Davidson with CG-solved correction equation
    (reference: jd_sep, paper_1_python/eigen_solver.py:985-1124).
    Pair ``x0`` selects the all-real pair twin (see davidson_sep)."""
    if isinstance(x0, tuple):
        return _davidson_p(h_func, p_func, x0, nev, "jd", tol, maxiter,
                           max(subspace, 3 * x0[0].shape[0]), inner_steps)
    return _davidson(h_func, p_func, x0, nev, "jd", tol, maxiter,
                     max(subspace, 3 * x0.shape[0]), inner_steps)


# ---------------------------------------------------------------------------
# Pair-layout twins: the mechanical pair transform of the complex
# _davidson above, for KPointSolver(solver_impl="rs"), using the same
# toolbox as lobpcg_rs
# (gram_f64_p / mix_pair / masked_loewdin_p / project_off_p /
# eigh_f64_embedding); davidson_sep/jd_sep dispatch on the input type.
# ---------------------------------------------------------------------------


def _davidson_p(h_func, p_func, x0, nev: int, correction: str, tol: float,
                maxiter: int, cap: int, inner_steps: int) -> SolveResult:
    m = x0[0].shape[0]
    rdtype = x0[0].dtype
    f64 = jnp.float64
    tiny = float(jnp.finfo(rdtype).tiny ** 0.5)
    jitter = 100.0 * float(jnp.finfo(rdtype).eps)
    shape_rest = x0[0].shape[1:]

    def flat(a):
        return (a[0].reshape(a[0].shape[0], -1),
                a[1].reshape(a[1].shape[0], -1))

    def unflat(a, lead):
        return (a[0].reshape((lead,) + shape_rest),
                a[1].reshape((lead,) + shape_rest))

    def scale(a, s):  # s real (p,) per-row
        sc = s.reshape((-1,) + (1,) * (a[0].ndim - 1)).astype(rdtype)
        return (a[0] * sc, a[1] * sc)

    def axpy(al, x, y):  # al real (p,) rows: al*x + y
        sc = al.reshape((-1,) + (1,) * (x[0].ndim - 1)).astype(rdtype)
        return (sc * x[0] + y[0], sc * x[1] + y[1])

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1])

    # Init: normalize + Loewdin + Ritz rotate (all pair).
    n0 = rr_mod.colnorms_p(flat(x0))
    x = scale(x0, 1.0 / jnp.maximum(n0, tiny))
    xf, _ = rr_mod.masked_loewdin_p(flat(x), jnp.ones(m, rdtype), jitter)
    hxf = flat(h_func(unflat(xf, m)))
    t_re, t_im = rr_mod.gram_f64_p(xf, hxf)
    theta0, vr, vi = rr_mod.eigh_f64_embedding(0.5 * (t_re + t_re.T),
                                               0.5 * (t_im - t_im.T))
    c0 = (vr.astype(rdtype), vi.astype(rdtype))
    x = unflat(rr_mod.mix_pair(c0, xf), m)
    hx = unflat(rr_mod.mix_pair(c0, hxf), m)

    z_store = jnp.zeros((cap,) + shape_rest, rdtype)
    v0 = (z_store.at[:m].set(x[0]), z_store.at[:m].set(x[1]))
    hv0 = (z_store.at[:m].set(hx[0]), z_store.at[:m].set(hx[1]))
    fill0 = jnp.concatenate([jnp.ones(m, rdtype),
                             jnp.zeros(cap - m, rdtype)])

    state0 = dict(it=jnp.asarray(0, jnp.int32),
                  status=jnp.asarray(Status.RUNNING, jnp.int32),
                  lambdas=theta0[:m].astype(rdtype),
                  x=x, hx=hx, v=v0, hv=hv0, fill=fill0,
                  res_his=jnp.full((maxiter,), jnp.nan, rdtype))

    def correction_block(r, x, lambdas):
        if correction == "davidson":
            return p_func(r)
        xf = flat(x)

        def proj(z):
            zf = flat(z)
            coeff = rr_mod.gram_p32(xf, zf)
            return unflat(sub(zf, rr_mod.mix_pair(coeff, xf)), m)

        def a_op(z):
            pz = proj(z)
            hz = h_func(pz)
            return proj(sub(hz, scale(pz, lambdas)))

        b = proj((-r[0], -r[1]))
        t = (jnp.zeros_like(b[0]), jnp.zeros_like(b[1]))
        res = sub(b, a_op(t))
        z = proj(p_func(res))
        p = z

        def dotr(a_, b_):
            return jnp.sum(a_[0] * b_[0] + a_[1] * b_[1],
                           axis=tuple(range(1, a_[0].ndim)))

        rz = dotr(res, z)

        def cg_body(_, carry):
            t, res, p, rz = carry
            ap = a_op(p)
            pap = dotr(p, ap)
            alpha = rz / jnp.where(jnp.abs(pap) > tiny, pap, 1.0)
            t = axpy(alpha, p, t)
            res = axpy(-alpha, ap, res)
            z = proj(p_func(res))
            rz_new = dotr(res, z)
            beta = rz_new / jnp.where(jnp.abs(rz) > tiny, rz, 1.0)
            p = axpy(beta, p, z)
            return t, res, p, rz_new

        t, _, _, _ = lax.fori_loop(0, inner_steps, cg_body,
                                   (t, res, p, rz))
        return t

    def cond_fun(s):
        return (s["status"] == Status.RUNNING) & (s["it"] < maxiter)

    def body_fun(s):
        it = s["it"]
        r = sub(scale(s["x"], s["lambdas"]), s["hx"])
        res = rr_mod.colnorms_p(flat(r))
        res_his = s["res_his"].at[it].set(jnp.linalg.norm(res[:nev]))
        converged = jnp.max(res[:nev]) < tol
        is_nan = jnp.isnan(res).any()
        status = jnp.where(is_nan, Status.NAN,
                           jnp.where(converged, Status.CONVERGED,
                                     Status.RUNNING)).astype(jnp.int32)

        def finish(_):
            return dict(s, it=it, status=status, res_his=res_his)

        def step(_):
            n_fill = jnp.sum(s["fill"]).astype(jnp.int32)
            restart = n_fill + m > cap

            def sel(a, b):
                return jnp.where(restart, a, b)

            v = (sel(z_store.at[:m].set(s["x"][0]), s["v"][0]),
                 sel(z_store.at[:m].set(s["x"][1]), s["v"][1]))
            hv = (sel(z_store.at[:m].set(s["hx"][0]), s["hv"][0]),
                  sel(z_store.at[:m].set(s["hx"][1]), s["hv"][1]))
            fill = jnp.where(restart, fill0, s["fill"])
            n_fill = jnp.sum(fill).astype(jnp.int32)

            t = correction_block(r, s["x"], s["lambdas"])
            tf = flat(t)
            tn = rr_mod.colnorms_p(tf)
            tf = rr_mod.scale_cols_p(tf, 1.0 / jnp.maximum(tn, tiny))
            fmask = fill[:, None].astype(rdtype)
            vf_m = (flat(v)[0] * fmask, flat(v)[1] * fmask)
            tf, _ = rr_mod.project_off_p(tf, vf_m)
            rho = rr_mod.colnorms_p(tf)
            ok = (rho > 1e3 * jnp.finfo(rdtype).eps).astype(rdtype)
            tf = rr_mod.scale_cols_p(tf, ok)
            tf, _ = rr_mod.masked_loewdin_p(tf, ok, jitter, passes=2)
            ht = flat(h_func(unflat(tf, m)))

            idx = n_fill + jnp.cumsum(ok).astype(jnp.int32) - 1
            idx = jnp.where(ok > 0, idx, cap - 1)
            okc = ok[:, None]

            def scatter(store, new):
                sf = store.reshape(cap, -1)
                return sf.at[idx].set(
                    jnp.where(okc > 0, new, sf[idx])).reshape(store.shape)

            v = (scatter(v[0], tf[0]), scatter(v[1], tf[1]))
            hv = (scatter(hv[0], ht[0]), scatter(hv[1], ht[1]))
            fill = fill.at[idx].set(jnp.where(ok > 0, 1.0, fill[idx]))

            vf, hvf = flat(v), flat(hv)
            keep64 = (fill[:, None] * fill[None, :]).astype(f64)
            fm = fill[:, None].astype(rdtype)
            t_re, t_im = rr_mod.gram_f64_p((vf[0] * fm, vf[1] * fm), hvf)
            t_re = 0.5 * (t_re + t_re.T) * keep64
            t_im = 0.5 * (t_im - t_im.T) * keep64
            dead_val = jnp.sqrt(jnp.sum(t_re**2) + jnp.sum(t_im**2)) + 1.0
            t_re = t_re - dead_val * jnp.diag(1.0 - fill).astype(f64)
            theta_all, u_re, u_im = rr_mod.eigh_f64_embedding(t_re, t_im)
            n_dead = (cap - jnp.sum(fill)).astype(jnp.int32)
            # static one-hot selection instead of dynamic_slice-at-traced-
            # offset (UNIMPLEMENTED inside while_loop on this backend —
            # see lobpcg_gep_rs)
            sel = (jnp.arange(cap)[:, None]
                   == (n_dead + jnp.arange(m))[None, :]).astype(f64)
            theta = theta_all @ sel
            c_re = u_re @ sel
            c_im = u_im @ sel
            cp = ((c_re * fill[:, None].astype(f64)).astype(rdtype),
                  (c_im * fill[:, None].astype(f64)).astype(rdtype))
            x_new = unflat(rr_mod.mix_pair(cp, vf), m)
            hx_new = unflat(rr_mod.mix_pair(cp, hvf), m)

            return dict(s, it=it + 1,
                        status=jnp.asarray(Status.RUNNING, jnp.int32),
                        lambdas=theta.astype(rdtype),
                        x=x_new, hx=hx_new, v=v, hv=hv, fill=fill,
                        res_his=res_his)

        return lax.cond(status != Status.RUNNING, finish, step, None)

    final = lax.while_loop(cond_fun, body_fun, state0)
    status = jnp.where(final["status"] == Status.RUNNING, Status.MAXITER,
                       final["status"]).astype(jnp.int32)
    return SolveResult(final["lambdas"], final["x"], final["it"], status,
                       final["res_his"])
