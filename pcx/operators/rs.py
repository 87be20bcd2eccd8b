"""Real-split ("complex-as-pair") Maxwell operator.

The penalized Maxwell operator on pairs ``(re, im)`` of real arrays (f32
for the complex64 solve, f64 for its refinement): the layout of the
pair-layout solver (pcx.solvers.lobpcg_rs), whose Grams and updates run as
real GEMMs on the split planes.

The f64 variant serves the two accuracy-critical moments of a complex64
solve:

* the final Rayleigh-Ritz refinement of the c64-iterated subspace (Ritz
  values are variationally limited only by the SUBSPACE, not by the c64
  arithmetic, once the projected problem is formed in f64), and
* the validation quotients omega_re against the unpenalized operator
  (the spurious-eigenvalue gate must not be polluted by c64 apply noise).

Everything here is jit-traceable with REAL-only boundary types.
Reference semantics: AMA/AMA_BB, paper_2/pcfft.py:130-181.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

Pair = Tuple[jnp.ndarray, jnp.ndarray]


# -- pair arithmetic ---------------------------------------------------------

def pmul(a: Pair, b: Pair) -> Pair:
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def pconj(a: Pair) -> Pair:
    return (a[0], -a[1])


def pneg(a: Pair) -> Pair:
    return (-a[0], -a[1])


def padd(a: Pair, b: Pair) -> Pair:
    return (a[0] + b[0], a[1] + b[1])


def pscale(a: Pair, r) -> Pair:
    """Multiply by a REAL scalar/array."""
    return (a[0] * r, a[1] * r)


def pabs2(a: Pair) -> jnp.ndarray:
    return a[0] * a[0] + a[1] * a[1]


def from_carr_ri(ri: jnp.ndarray, dtype=jnp.float64) -> Pair:
    """(..., 2) real array (a CArr payload) -> f64 pair."""
    return (ri[..., 0].astype(dtype), ri[..., 1].astype(dtype))


def to_ri(x: Pair) -> jnp.ndarray:
    """Pair -> (..., 2) real array (a CArr payload)."""
    return jnp.stack(x, axis=-1)


def from_complex(z: jnp.ndarray) -> Pair:
    return (z.real, z.imag)


def to_complex(x: Pair) -> jnp.ndarray:
    return jax.lax.complex(x[0], x[1])


# -- block multiplies (pair versions of operators/blocks.py) -----------------

def _comp(x: Pair, c: int) -> Pair:
    return (x[0][..., c, :, :, :], x[1][..., c, :, :, :])


def _stack3(ys, axis=-4) -> Pair:
    return (jnp.stack([y[0] for y in ys], axis=axis),
            jnp.stack([y[1] for y in ys], axis=axis))


def a_block_p(x: Pair, d: Pair) -> Pair:
    """Antisymmetric curl-block multiply on pairs (blocks.a_block)."""
    x0, x1, x2 = _comp(x, 0), _comp(x, 1), _comp(x, 2)
    d0 = (d[0][0], d[1][0])
    d1 = (d[0][1], d[1][1])
    d2 = (d[0][2], d[1][2])
    return _stack3((
        padd(pneg(pmul(d2, x1)), pmul(d1, x2)),
        padd(pmul(d2, x0), pneg(pmul(d0, x2))),
        padd(pneg(pmul(d1, x0)), pmul(d0, x1)),
    ))


def h_block_p(x: Pair, diag: jnp.ndarray, sdiag: Pair) -> Pair:
    """Hermitian 3x3 block multiply: diag REAL (3,...), sdiag pair (3,...)."""
    x0, x1, x2 = _comp(x, 0), _comp(x, 1), _comp(x, 2)
    s0 = (sdiag[0][0], sdiag[1][0])
    s1 = (sdiag[0][1], sdiag[1][1])
    s2 = (sdiag[0][2], sdiag[1][2])
    y0 = padd(padd(pscale(x0, diag[0]), pmul(s0, x1)), pmul(s1, x2))
    y1 = padd(padd(pmul(pconj(s0), x0), pscale(x1, diag[1])), pmul(s2, x2))
    y2 = padd(padd(pmul(pconj(s1), x0), pmul(pconj(s2), x1)),
              pscale(x2, diag[2]))
    return _stack3((y0, y1, y2))


# -- 3-D DFT -------------------------------------------------------------------

def fft3_p(x: Pair, inverse: bool = False) -> Pair:
    """3-D DFT over the last three axes of a pair (``jnp.fft.fftn`` /
    ``ifftn`` conventions).  The pair is joined into one complex buffer of
    the matching width (f32 -> complex64, f64 -> complex128), so the
    transform is the backend's FFT (cuFFT on the GPU) at full precision."""
    z = lax.complex(x[0], x[1])
    fn = jnp.fft.ifftn if inverse else jnp.fft.fftn
    z = fn(z, axes=(-3, -2, -1))
    return (z.real, z.imag)


# -- dielectric apply on pairs ------------------------------------------------

def diel_apply_p(diel, x: Pair, dtype=jnp.float64) -> Pair:
    """Pair apply of a DielectricOp, dispatched on op.name.

    Device params (f32 / CArr f32) are cast to ``dtype`` inside the program —
    the constants themselves are exactly representable small rationals, so
    no accuracy is lost relative to the host-side c128 construction.
    """
    from pcx import boundary

    def realp(p):
        a = p.ri if isinstance(p, boundary.CArr) else p
        return a

    name = diel.name
    if name == "identity":
        return x
    if name in ("chiral", "scalar_field"):
        scale = jnp.asarray(realp(diel.params[0])).astype(dtype)
        return pscale(x, scale)
    if name == "pseudochiral_trivial":
        diag = jnp.asarray(realp(diel.params[0])).astype(dtype)
        sd = diel.params[1]
        sdp = (from_carr_ri(sd.ri, dtype) if isinstance(sd, boundary.CArr)
               else (jnp.real(sd).astype(dtype),
                     jnp.imag(sd).astype(dtype)))
        return h_block_p(x, diag, sdp)
    if name == "pseudochiral_crossdof":
        sten, eps = dict(diel.meta)["sten"], dict(diel.meta)["eps"]
        diag = jnp.asarray(realp(diel.params[0])).astype(dtype)
        masks = jnp.asarray(realp(diel.params[1])).astype(dtype)
        return _crossdof_p(x, diag, masks, sten, eps, dtype)
    raise NotImplementedError(f"no pair apply for dielectric {name!r}")


def _crossdof_p(x: Pair, diag, masks, sten, eps, dtype=jnp.float64) -> Pair:
    """Pair version of dielectric.make_crossdof_apply: the averaging rolls
    are REAL-linear (apply to re/im independently); the eps scalars are the
    only complex factors."""
    from pcx.operators.dielectric import _avg, _PAIR_DEFS

    def t_apply(v: Pair, axes, transpose_all) -> Pair:
        re, im = v
        for axis, tr in axes:
            re = _avg(re, sten, axis, tr != transpose_all)
            im = _avg(im, sten, axis, tr != transpose_all)
        return (re, im)

    def m_apply(v: Pair, row_c, col_c, axes) -> Pair:
        t1 = t_apply(v, axes, False)
        t2 = t_apply(pscale(v, masks[col_c]), axes, False)
        return pscale(padd(pscale(t1, masks[row_c]), t2), 0.5)

    def mt_apply(v: Pair, row_c, col_c, axes) -> Pair:
        t1 = t_apply(pscale(v, masks[row_c]), axes, True)
        t2 = pscale(t_apply(v, axes, True), masks[col_c])
        return pscale(padd(t1, t2), 0.5)

    e3, e4, e5 = [(jnp.asarray(complex(e).real, dtype),
                   jnp.asarray(complex(e).imag, dtype)) for e in eps]
    x0, x1, x2 = _comp(x, 0), _comp(x, 1), _comp(x, 2)
    r12, c12, a12 = _PAIR_DEFS["12"]
    r13, c13, a13 = _PAIR_DEFS["13"]
    r23, c23, a23 = _PAIR_DEFS["23"]

    def cs(e: Pair, v: Pair) -> Pair:        # complex-scalar * pair
        return (e[0] * v[0] - e[1] * v[1], e[0] * v[1] + e[1] * v[0])

    y0 = padd(pscale(x0, diag[0]),
              padd(cs(e3, m_apply(x1, r12, c12, a12)),
                   cs(e4, m_apply(x2, r13, c13, a13))))
    y1 = padd(pscale(x1, diag[1]),
              padd(cs(pconj(e3), mt_apply(x0, r12, c12, a12)),
                   cs(e5, m_apply(x2, r23, c23, a23))))
    y2 = padd(pscale(x2, diag[2]),
              padd(cs(pconj(e4), mt_apply(x0, r13, c13, a13)),
                   cs(pconj(e5), mt_apply(x1, r23, c23, a23))))
    return _stack3((y0, y1, y2))


# -- the penalized operator ---------------------------------------------------

def ama_p(x: Pair, d_a: Pair, diel) -> Pair:
    """A M A^H on pairs (reference: AMA, pcfft.py:130-158)."""
    y = a_block_p(x, pneg(pconj(d_a)))
    y = fft3_p(y)
    y = diel_apply_p(diel, y, dtype=x[0].dtype)
    y = fft3_p(y, inverse=True)
    return a_block_p(y, d_a)


def ama_bb_p(x: Pair, d_a: Pair, b_diag: jnp.ndarray, b_sdiag: Pair,
             diel, shift=0.0) -> Pair:
    """A M A^H + pnt B^H B (+ shift) on pairs (b pre-scaled by pnt)."""
    y = padd(ama_p(x, d_a, diel), h_block_p(x, b_diag, b_sdiag))
    return padd(y, pscale(x, shift))


# -- on-device symbol construction from 1-D parts -----------------------------

def _bcast1(v: jnp.ndarray, axis: int) -> jnp.ndarray:
    shape = [1, 1, 1]
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def build_curl_p(d1: Pair, d0: Pair, ct: jnp.ndarray,
                 alpha: jnp.ndarray) -> Pair:
    """Curl symbol D_A as an f64 pair (3, N, N, N), built ON DEVICE from the
    1-D stencil symbols (the big symbol arrays are closed-form broadcasts —
    ship (N,)-sized parts to the device, not 100+ MB products).

    d1/d0: (N,) pairs already divided by the lattice constant;
    ct: (3, 3) real; alpha: (3,) real.
    D_A[c] = sum_j ct[c, j] * bcast(d1, j) + i * alpha[c] * bcast(d0, c)
    (reference: fft_blocks + k-shift, discretization.py:301-346).
    """
    n = d1[0].shape[0]
    full = (n, n, n)
    rows = []
    for c in range(3):
        # The three 1-axis broadcasts sum to a full (N, N, N) array.
        re = sum(ct[c, j] * _bcast1(d1[0], j) for j in range(3))
        im = sum(ct[c, j] * _bcast1(d1[1], j) for j in range(3))
        # + i*alpha_c*d0: i*(a+ib) = -b + ia.
        re = re - alpha[c] * _bcast1(d0[1], c)
        im = im + alpha[c] * _bcast1(d0[0], c)
        rows.append((jnp.broadcast_to(re, full), jnp.broadcast_to(im, full)))
    return (jnp.stack([r[0] for r in rows]),
            jnp.stack([r[1] for r in rows]))


def penalty_p(d_a: Pair, pnt) -> Tuple[jnp.ndarray, Pair]:
    """pnt-scaled penalty symbol from the curl pair: diag REAL (3,N,N,N),
    sdiag pair (3,N,N,N) = (s12, s13, s23) with s_ab = conj(Da) Db
    (reference: discretization.py:343-344)."""
    comp = lambda c: (d_a[0][c], d_a[1][c])
    diag = jnp.stack([pabs2(comp(c)) for c in range(3)]) * pnt
    pairs = [pmul(pconj(comp(a)), comp(b)) for a, b in ((0, 1), (0, 2), (1, 2))]
    sdiag = (jnp.stack([p[0] for p in pairs]) * pnt,
             jnp.stack([p[1] for p in pairs]) * pnt)
    return diag, sdiag


def inverse_penalized_p(d_a: Pair, pnt, shift=0.0) -> Tuple[jnp.ndarray, Pair]:
    """Preconditioner symbol (A A^H + pnt B^H B + shift)^{-1} as pairs,
    built ON DEVICE from the curl pair (diag REAL (3,N,N,N), sdiag pair).

    Pair analog of symbols.inverse_penalized + inverse_3x3_block
    (reference: discretization.py:224-295).  All arithmetic is real; the
    determinant of the Hermitian 3x3 symbol is real.
    """
    comp = lambda c: (d_a[0][c], d_a[1][c])
    b0, b1, b2 = (pabs2(comp(c)) for c in range(3))
    d0 = pnt * b0 + b1 + b2 + shift
    d1 = b0 + pnt * b1 + b2 + shift
    d2 = b0 + b1 + pnt * b2 + shift
    q = pnt - 1.0
    s0 = pscale(pmul(pconj(comp(0)), comp(1)), q)   # (row0, col1)
    s1 = pscale(pmul(pconj(comp(0)), comp(2)), q)   # (row0, col2)
    s2 = pscale(pmul(pconj(comp(1)), comp(2)), q)   # (row1, col2)

    a0, a1, a2 = pabs2(s0), pabs2(s1), pabs2(s2)
    # 2*Re(s0 * s2 * conj(s1))
    cross = pmul(s0, s2)
    tri = 2.0 * (cross[0] * s1[0] + cross[1] * s1[1])
    det = d0 * d1 * d2 - (d0 * a2 + d1 * a1 + d2 * a0) + tri
    inv_det = 1.0 / det

    f_diag = jnp.stack(((d1 * d2 - a2) * inv_det,
                        (d0 * d2 - a1) * inv_det,
                        (d0 * d1 - a0) * inv_det))
    f0 = pscale(padd(pmul(s1, pconj(s2)), pscale(s0, -d2)), inv_det)
    f1 = pscale(padd(pmul(s0, s2), pscale(s1, -d1)), inv_det)
    f2 = pscale(padd(pmul(s1, pconj(s0)), pscale(s2, -d0)), inv_det)
    f_sdiag = (jnp.stack((f0[0], f1[0], f2[0])),
               jnp.stack((f0[1], f1[1], f2[1])))
    return f_diag, f_sdiag


# -- small dense pencil solver (f64 real embedding) ----------------------------

def hermitize_p(m: Pair) -> Pair:
    return (0.5 * (m[0] + m[0].T), 0.5 * (m[1] - m[1].T))


def pencil_f64_embedding(t: Pair, g: Pair, split: float = 1e-12):
    """theta, C (pair) solving the Hermitian-definite pencil T C = theta G C
    entirely in f64 reals via the standard *-algebra embedding
    z -> [[Re, -Im], [Im, Re]] (the pair layout's own small-pencil solve).

    G is whitened by its embedding Loewdin inverse square root (eigh-based,
    so numerically dead directions deflate instead of breaking a Cholesky);
    a graded diagonal perturbation separates degenerate pairs before the
    every-other-column extraction (same device trick as
    rayleigh_ritz.eigh_f64_embedding).
    """
    m = t[0].shape[0]
    emb = lambda p: jnp.block([[p[0], -p[1]], [p[1], p[0]]])
    ge = emb(hermitize_p(g))
    te = emb(hermitize_p(t))
    lam, u = jnp.linalg.eigh(ge)
    # Deflate numerically-dead basis directions (zeroed/locked columns):
    # their whitening weight is zeroed and their Ritz slot is bumped ABOVE
    # the spectrum so they sort LAST — never as below-spectrum phantoms.
    alive = lam > 1e-12 * jnp.max(lam)
    inv_sqrt = jnp.where(alive, 1.0 / jnp.sqrt(jnp.maximum(lam, 1e-30)), 0.0)
    s = (u * inv_sqrt[None, :]) @ u.T
    tw = s @ te @ s
    scale = jnp.max(jnp.abs(tw)) + 1e-30
    pert = split * scale * (jnp.arange(2 * m, dtype=jnp.float64) / (2 * m))
    dead = 1.0 - jnp.diag(s @ ge @ s)          # ~1 at deflated coords
    bump = 2.0 * scale * jnp.where(dead > 0.5, 1.0, 0.0)
    th2, v = jnp.linalg.eigh(0.5 * (tw + tw.T) + jnp.diag(pert + bump))
    c = s @ v
    return th2[::2], (c[:m, ::2], c[m:, ::2])


# -- Gram / small dense helpers ----------------------------------------------
# Canonical pair Gram/mix kernels live in solvers.rayleigh_ritz (same
# dot_generals, plus optional psum over a mesh axis); aliased rather than
# duplicated so precision/chunking fixes apply to every caller — the f64
# refine path (bandstructure._refine_jit) uses these names.

from pcx.solvers.rayleigh_ritz import gram_p32 as gram_p  # noqa: E402
from pcx.solvers.rayleigh_ritz import mix_pair as mix_p  # noqa: E402
