"""Dense local algebra: Gram matrices, Rayleigh-Ritz, small GEP solvers.

Reference: paper_2/orthogonalization.py.  Differences:

* blocks of vectors are (p, D) arrays (vector index first);
* Gram products run through ``dot_general`` with HIGHEST precision, so f32
  products keep full f32 precision (no TF32 or bf16 passes on the GPU);
* the Rayleigh-Ritz supports a *basis mask* for fixed-shape soft locking:
  masked-out basis vectors are replaced by decoupled phantom coordinates
  with Ritz value -1 that sort strictly BELOW the physical spectrum of the
  (positive definite) operator and are sliced away -- the jit-compatible
  analog of the reference's dynamic column compaction
  (paper_2/lobpcg.py:429-437).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from pcx.utils import real_dtype
from jax import lax


def hermitize(m: jnp.ndarray) -> jnp.ndarray:
    """(M + M^H)/2 (reference: orthogonalization.py:26-33)."""
    return (m + m.conj().T) * 0.5


def _rdot(a: jnp.ndarray, b: jnp.ndarray, dims) -> jnp.ndarray:
    return jax.lax.dot_general(a, b, dimension_numbers=dims,
                               precision=lax.Precision.HIGHEST)


_GRAM_DIMS = (((1,), (1,)), ((), ()))
_MIX_DIMS = (((0,), (0,)), ((), ()))


def _csplit_dot(a: jnp.ndarray, b: jnp.ndarray, dims, conj_a: bool):
    """Complex contraction via four REAL dot_generals.

    All Gram/update GEMMs run as real f32/f64 dots at HIGHEST precision,
    so the stated precision holds whatever the backend's complex GEMM
    would choose.
    """
    if not jnp.iscomplexobj(a):
        return _rdot(a, b, dims)
    ar, ai = a.real, a.imag
    if conj_a:
        ai = -ai
    br, bi = b.real, b.imag
    re = _rdot(ar, br, dims) - _rdot(ai, bi, dims)
    im = _rdot(ar, bi, dims) + _rdot(ai, br, dims)
    return jax.lax.complex(re, im)


def gram(x: jnp.ndarray, y: jnp.ndarray, axis_name=None) -> jnp.ndarray:
    """G[i, j] = <x_i, y_j> for row-blocks x (p, D), y (q, D).
    ``axis_name``: mesh axis to psum over when D is sharded."""
    g = _csplit_dot(x, y, _GRAM_DIMS, conj_a=True)
    if axis_name is not None:
        g = lax.psum(g, axis_name)
    return g


def mix(coeff: jnp.ndarray, blocks: jnp.ndarray) -> jnp.ndarray:
    """Linear combinations: out_j = sum_i coeff[i, j] * blocks_i.

    coeff (p, q), blocks (p, D) -> (q, D).
    """
    if jnp.iscomplexobj(coeff) != jnp.iscomplexobj(blocks):
        cdt = jnp.promote_types(coeff.dtype, blocks.dtype)
        coeff = coeff.astype(cdt)
        blocks = blocks.astype(cdt)
    return _csplit_dot(coeff, blocks, _MIX_DIMS, conj_a=False)


def short_qr(x: jnp.ndarray) -> jnp.ndarray:
    """Orthonormalize a row-block via Cholesky-QR
    (reference: orthogonalization.py:36-46)."""
    g = hermitize(gram(x, x))
    l = jnp.linalg.cholesky(g)
    return jax.scipy.linalg.solve_triangular(l, x, lower=True)


def eigh_pencil(t: jnp.ndarray, g: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve the Hermitian-definite pencil T v = theta G v by Cholesky
    reduction to a standard Hermitian eigenproblem
    (reference: GEP_chol, orthogonalization.py:99-115)."""
    l = jnp.linalg.cholesky(g)
    t1 = jax.scipy.linalg.solve_triangular(l, t, lower=True)
    t2 = jax.scipy.linalg.solve_triangular(l, t1.conj().T, lower=True).conj().T
    theta, q = jnp.linalg.eigh(hermitize(t2))
    # Back-transform: v = L^{-H} q.
    v = jax.scipy.linalg.solve_triangular(l.conj().T, q, lower=False)
    return theta, v


def eigh_pencil_embedding(t: jnp.ndarray, g: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hermitian-definite pencil solver through the f64 real *-algebra
    embedding (no complex Cholesky / triangular solves: a nearly singular
    G of a c64 basis deflates instead of breaking the factorization).
    Same contract as :func:`eigh_pencil`; use for c64 paths.
    """
    from pcx.operators import rs
    f64 = jnp.float64
    tp = (t.real.astype(f64), t.imag.astype(f64))
    gp = (g.real.astype(f64), g.imag.astype(f64))
    theta, c = rs.pencil_f64_embedding(tp, gp)
    rdt = real_dtype(t.dtype)
    v = jax.lax.complex(c[0].astype(rdt), c[1].astype(rdt)).astype(t.dtype)
    return theta.astype(rdt), v


def eigh_pencil_whiten(t: jnp.ndarray, g: jnp.ndarray, split: float = 1e-10
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hermitian-definite pencil solver via G-whitening with
    :func:`eigh_f64_embedding` (same contract as :func:`eigh_pencil`).

    Built from the primitives of the production lobpcg_rs Rayleigh-Ritz
    (eigh_f64_embedding + real f64 GEMMs): whiten G by its Loewdin inverse
    square root S = G^(-1/2) in complex PAIR arithmetic (p x p blocks,
    never the 2p x 2p embedding matmuls of pencil_f64_embedding), eigh the
    whitened S T S, and back-transform C = S V.  Numerically-dead directions
    (masked/locked basis columns: zero G rows) get their whitening weight
    zeroed and their Ritz slot bumped ABOVE the spectrum so they sort
    LAST, matching pencil_f64_embedding's contract.
    """
    f64 = jnp.float64
    t_re = 0.5 * (t.real + t.real.T).astype(f64)
    t_im = 0.5 * (t.imag - t.imag.T).astype(f64)
    g_re = 0.5 * (g.real + g.real.T).astype(f64)
    g_im = 0.5 * (g.imag - g.imag.T).astype(f64)
    wg, ur, ui = eigh_f64_embedding(g_re, g_im, split=1e-12)
    alive = wg > 1e-12 * jnp.max(wg)
    inv = jnp.where(alive, 1.0 / jnp.sqrt(jnp.maximum(wg, 1e-30)), 0.0)
    # S = U diag(inv) U^H (Hermitian), complex pair arithmetic.
    urw, uiw = ur * inv[None, :], ui * inv[None, :]
    s_re = urw @ ur.T + uiw @ ui.T
    s_im = uiw @ ur.T - urw @ ui.T
    # TW = S T S.
    a_re = s_re @ t_re - s_im @ t_im
    a_im = s_re @ t_im + s_im @ t_re
    tw_re = a_re @ s_re - a_im @ s_im
    tw_im = a_re @ s_im + a_im @ s_re
    # Dead coordinates: diag(S G S) is ~1 alive, ~0 deflated; bump their
    # Ritz slots above the spectrum.
    b_re = s_re @ g_re - s_im @ g_im
    b_im = s_re @ g_im + s_im @ g_re
    sgs_diag = jnp.diag(b_re @ s_re - b_im @ s_im)
    scale = jnp.max(jnp.abs(tw_re)) + jnp.max(jnp.abs(tw_im)) + 1e-30
    bump = 2.0 * scale * jnp.where(sgs_diag < 0.5, 1.0, 0.0)
    tw_re = 0.5 * (tw_re + tw_re.T) + jnp.diag(bump)
    tw_im = 0.5 * (tw_im - tw_im.T)
    theta, vr, vi = eigh_f64_embedding(tw_re, tw_im, split=split)
    c_re = s_re @ vr - s_im @ vi
    c_im = s_re @ vi + s_im @ vr
    rdt = real_dtype(t.dtype)
    v = jax.lax.complex(c_re.astype(rdt), c_im.astype(rdt)).astype(t.dtype)
    return theta.astype(rdt), v


def rayleigh_ritz(s: jnp.ndarray, hs: jnp.ndarray):
    """Plain RR on a row-block: Ritz values/vecs of H in span(s)
    (reference: rayleigh_ritz_chol_sep, orthogonalization.py:140-154)."""
    g = hermitize(gram(s, s))
    gh = hermitize(gram(s, hs))
    return eigh_pencil(gh, g)


def gram_f64(x: jnp.ndarray, y: jnp.ndarray, chunk: int = 65536,
             axis_name=None):
    """Gram matrix of complex64 row-blocks with float64 accumulation.

    The long contraction axis is split into chunks: each chunk's Gram runs
    in f32 (HIGHEST), the (nc, p, q) partials are upcast to f64 and
    reduced.  Returns the result
    as a (real, imag) f64 pair.  Error ~ sqrt(chunk)*eps_f32 instead of
    sqrt(D)*eps_f32 — the key to accurate Rayleigh-Ritz in single precision.
    """
    p, d = x.shape
    q = y.shape[0]
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)))
        y = jnp.pad(y, ((0, 0), (0, pad)))
    xc = x.reshape(p, nc, chunk).transpose(1, 0, 2)
    yc = y.reshape(q, nc, chunk).transpose(1, 0, 2)
    # Real-split batched dots: (nc, p, q) f32 partials, accumulated in f64.
    dims = (((2,), (2,)), ((0,), (0,)))
    xr, xi, yr, yi = xc.real, xc.imag, yc.real, yc.imag
    p_rr = _rdot(xr, yr, dims)
    p_ii = _rdot(xi, yi, dims)
    p_ri = _rdot(xr, yi, dims)
    p_ir = _rdot(xi, yr, dims)
    re = jnp.sum(p_rr.astype(jnp.float64) + p_ii.astype(jnp.float64), axis=0)
    im = jnp.sum(p_ri.astype(jnp.float64) - p_ir.astype(jnp.float64), axis=0)
    if axis_name is not None:
        re = lax.psum(re, axis_name)
        im = lax.psum(im, axis_name)
    return re, im


def split_for(rdtype, svqb: bool = False) -> float:
    """Degeneracy-splitting size for :func:`eigh_f64_embedding`, chosen by
    the ITERATE dtype (the Gram/T matrices are always f64, but their entries
    carry the iterate's noise).

    f32 iterates: Gram entries carry ~eps_f32 relative noise, so the graded
    perturbation must DOMINATE it (1e-7) for the pair-selection to see
    deterministically separated clusters; the induced eigenvalue bias
    (<= 1e-7 * scale) sits at the data's own noise level, costing nothing.
    Measured: split=1e-12 under f32 noise contaminated SVQB/Ritz bases of
    degenerate photonic bands at ~5e-4.

    f64 iterates: 1e-10 (Rayleigh-Ritz) / 1e-12 (SVQB Grams, whose small
    eigenvalues ~1e-9*scale are meaningful directions) stay far above the
    f64 backward error and far below target accuracy.  A 1e-7 perturbation
    there scrambles legitimately small Gram eigenvalues and STALLS
    convergence (measured: n=8 f64 sweep stalls at res ~0.3 vs converging
    in 86 iterations at 1e-12).
    """
    if jnp.dtype(rdtype) == jnp.float32:
        return 1e-7
    return 1e-12 if svqb else 1e-10


def eigh_f64_embedding(t_re: jnp.ndarray, t_im: jnp.ndarray,
                       split: float = 1e-10) -> Tuple[jnp.ndarray, ...]:
    """complex128-equivalent Hermitian eigh, entirely on device, via the
    real-symmetric embedding  M = [[Re T, -Im T], [Im T, Re T]]  in f64.

    The embedding's spectrum is each complex eigenvalue doubled,
    and an embedding eigenvector [x; y] maps to the complex eigenvector
    x + i y (the pair partner is its multiplication by i).

    Degenerate complex eigenvalues (multiplicity d -> embedding 2d) would
    make every-other-column selection unsafe, so a deterministic graded
    diagonal perturbation of size ``split * scale`` separates all complex
    eigenvalues first.  ``split`` balances eigenvector mixing (~eps/delta
    for clusters separated by delta) against the eigenvalue bias it induces
    (<= split * scale); it must also dominate the DATA noise of the input
    matrix — see :func:`split_for` for the dtype-aware choice.

    Inputs: t_re symmetric, t_im antisymmetric, both (p, p) f64.
    Returns (w (p,) f64 ascending, v_re (p, p) f64, v_im (p, p) f64).
    """
    p = t_re.shape[0]
    scale = jnp.max(jnp.abs(t_re)) + jnp.max(jnp.abs(t_im)) + 1e-30
    pert = split * scale * (jnp.arange(p, dtype=jnp.float64) / p)
    # Protective diagonal shift: an emulated-f64 eigh was seen to return
    # all-NaN when an eigenvalue sits at ~1e-13 RELATIVE to the matrix
    # scale (ANY shift >= 1e-6*scale cures it).  A constant shift leaves eigenvectors exactly unchanged and is
    # subtracted back from the eigenvalues.  Structural zeros (phantom or
    # exactly-dead directions) land at +1e-3*scale, far from the trigger;
    # the negative dead-column sentinel (~ -||T||_F) is equally safe.
    shift = 1e-3 * scale
    a_re = t_re + jnp.diag(pert) + shift * jnp.eye(p, dtype=jnp.float64)
    m = jnp.block([[a_re, -t_im], [t_im, a_re]])
    w2, u = jnp.linalg.eigh(m)
    vr, vi = u[:p, ::2], u[p:, ::2]
    # Within a cluster tighter than the graded perturbation resolves, the
    # f64 eigh mixes J-pair partners across the cluster's complex lines:
    # the selected columns are then real-orthonormal but NOT complex-
    # orthonormal (Im<z_i, z_j> ~ eps/delta; measured 5e-4 floors in both
    # SVQB output and LOBPCG residuals).  Two Newton-Schulz Loewdin steps
    # V <- 1.5 V - 0.5 V (V^H V) restore complex orthonormality
    # quadratically (5e-4 -> 2.5e-7 -> 6e-14) while only rotating within
    # clusters, so eigenpair accuracy is untouched.  Cost: 12 (p, p) f64
    # GEMMs, negligible next to the (2p, 2p) eigh.
    for _ in range(2):
        sr = vr.T @ vr + vi.T @ vi
        si = vr.T @ vi - vi.T @ vr
        vr, vi = (1.5 * vr - 0.5 * (vr @ sr - vi @ si),
                  1.5 * vi - 0.5 * (vr @ si + vi @ sr))
    # Newton eigenvector refinement.  An eigh with f64 eigenvalues but only
    # ~f32-quality EIGENVECTORS (residual ~1.5e-8 * ||A||, against 1e-15
    # for LAPACK) is fatal downstream: in SVQB the 1/sqrt(w) scaling amplifies the eigh's cross-
    # magnitude mixing (~eps_vec/gap) into nearly-dependent basis columns,
    # which breed below-spectrum phantom Ritz values (observed: theta_min
    # decaying geometrically to 1e-10 and a residual floor 1e4x above CPU).
    # Since f64 GEMMs are exact, two first-order
    # perturbation corrections V <- V (I + K), K_ij = E_ij / (d_j - d_i)
    # with R = V^H A V = diag(d) + E, restore f64-quality vectors for all
    # pairs separated by more than the gap gate; mixing within tighter
    # clusters is left (a free rotation, harmless downstream).
    for _ in range(2):
        # R = V^H A V in complex pair arithmetic (A = a_re + i t_im)
        av_r = a_re @ vr - t_im @ vi
        av_i = a_re @ vi + t_im @ vr
        r_re = vr.T @ av_r + vi.T @ av_i
        r_im = vr.T @ av_i - vi.T @ av_r
        d = jnp.diag(r_re)
        e_re = r_re - jnp.diag(d)
        e_im = r_im - jnp.diag(jnp.diag(r_im))
        denom = d[None, :] - d[:, None]
        dscale = jnp.max(jnp.abs(d)) + 1e-30
        gate = 1e-6 * dscale
        # The first-order formula is a CONTRACTION only for |K| << 1.  In a
        # tight cluster the eigh misassigns directions, making |E_ij| as
        # large as the gap itself: K ~ O(1) would push V(I+K) far from
        # unitary and the NS polish below then DIVERGES (overflow -> NaN in
        # the f32-pair-emulated f64).  Correct only pairs whose rotation is
        # provably small (|E| < 0.1 |gap|); the rest is intra-cluster mixing,
        # which is a free rotation downstream.  No inf/NaN may enter the
        # emulated-f64 path (double-word arithmetic propagates them as NaN
        # through its compensation sums): gate via where-on-the-result with
        # a finite dummy denominator.
        e_mag = jnp.sqrt(e_re * e_re + e_im * e_im)
        wide = jnp.abs(denom) >= jnp.maximum(gate, 10.0 * e_mag)
        denom_safe = jnp.where(wide, denom, 1.0)
        k_re = jnp.where(wide, e_re / denom_safe, 0.0)
        k_im = jnp.where(wide, e_im / denom_safe, 0.0)
        # V <- V + V K (complex)
        vr, vi = (vr + (vr @ k_re - vi @ k_im),
                  vi + (vr @ k_im + vi @ k_re))
        # re-orthonormalize the corrected columns (one NS step suffices:
        # the correction is O(1e-2) at worst near the gap gate)
        for _ in range(2):
            sr = vr.T @ vr + vi.T @ vi
            si = vr.T @ vi - vi.T @ vr
            vr, vi = (1.5 * vr - 0.5 * (vr @ sr - vi @ si),
                      1.5 * vi - 0.5 * (vr @ si + vi @ sr))
    # f64-exact Rayleigh quotients of the refined vectors, shift removed.
    av_r = a_re @ vr - t_im @ vi
    av_i = a_re @ vi + t_im @ vr
    theta = (jnp.sum(vr * av_r + vi * av_i, axis=0)
             / jnp.maximum(jnp.sum(vr * vr + vi * vi, axis=0), 1e-30))
    theta = theta - shift
    # refinement only rotates within tight clusters, but re-sort to keep
    # the ascending contract exact.
    order = jnp.argsort(theta)
    return theta[order], vr[:, order], vi[:, order]


def eigh_embedding_refined(t_re: jnp.ndarray, t_im: jnp.ndarray,
                           split: float = 1e-8):
    """Cheaper variant of :func:`eigh_f64_embedding`: the (2p, 2p)
    embedding eigh runs in FLOAT32 and the Ritz values are then refined in
    f64 by Rayleigh quotients theta_j = v_j^H T v_j — the quadratic error
    bound restores f64-level eigenvalues from f32-level eigenvectors.  Use
    when the f64 eigh dominates the iteration.
    """
    p = t_re.shape[0]
    scale = jnp.max(jnp.abs(t_re)) + jnp.max(jnp.abs(t_im)) + 1e-30
    pert = split * scale * (jnp.arange(p, dtype=jnp.float64) / p)
    t_re = t_re + jnp.diag(pert)
    m32 = jnp.block([[t_re, -t_im], [t_im, t_re]]).astype(jnp.float32)
    _, u = jnp.linalg.eigh(m32)
    vr = u[:p, ::2].astype(jnp.float64)
    vi = u[p:, ::2].astype(jnp.float64)
    # f64 Rayleigh quotients: theta = Re[(vr - i vi)^T (T)(vr + i vi)] per col.
    tr_vr = t_re @ vr - t_im @ vi
    tr_vi = t_re @ vi + t_im @ vr
    num = jnp.sum(vr * tr_vr + vi * tr_vi, axis=0)
    den = jnp.sum(vr * vr + vi * vi, axis=0)
    theta = num / jnp.maximum(den, 1e-30)
    # eigh ordering is ascending in f32; re-sort after refinement.
    order = jnp.argsort(theta)
    return theta[order], vr[:, order], vi[:, order]


def _loewdin_mixer(g_re: jnp.ndarray, g_im: jnp.ndarray, jitter: float):
    """Hermitian inverse square root S = V L^{-1/2} V^H of a PSD Gram given
    as f64 (re, im), eigendecomposed via the real embedding.  Returns S as
    f64 (re, im).  Eigenvalues are clamped at ``jitter * max`` so the mixer
    is always finite."""
    w, vr, vi = eigh_f64_embedding(g_re, g_im)
    w = jnp.maximum(w, jitter * jnp.maximum(w[-1], 1e-30))
    d = 1.0 / jnp.sqrt(w)
    vrd, vid = vr * d, vi * d
    s_re = vrd @ vr.T + vid @ vi.T
    s_im = vid @ vr.T - vrd @ vi.T
    return s_re, s_im


def masked_loewdin(block: jnp.ndarray, mask: jnp.ndarray, jitter: float,
                   hblock: Optional[jnp.ndarray] = None, passes: int = 1,
                   axis_name=None):
    """Orthonormalize active rows by Loewdin/SVQB symmetric orthogonalization.

    Equivalent role to :func:`masked_cholqr` but built ONLY from f64 real
    eigh + matmuls — no complex Cholesky / triangular solves, so a nearly
    dependent c64 block deflates instead of breaking a factorization.
    Masked-out
    rows must be zero; their Gram diagonal is padded so they stay zero and
    decoupled.  Row convention: Q = mix(S, B) with S = (G + pad)^{-1/2}.
    """
    keep = mask[:, None] * mask[None, :]
    dead64 = jnp.diag(1.0 - mask).astype(jnp.float64)
    keep64 = keep.astype(jnp.float64)
    rdtype = real_dtype(block.dtype)
    for _ in range(passes):
        g_re, g_im = gram_f64(block, block, axis_name=axis_name)
        g_re = 0.5 * (g_re + g_re.T) * keep64 + dead64
        g_im = 0.5 * (g_im - g_im.T) * keep64
        s_re, s_im = _loewdin_mixer(g_re, g_im, jitter)
        s = jax.lax.complex(s_re.astype(rdtype),
                            s_im.astype(rdtype)).astype(block.dtype)
        block = mix(s, block) * mask[:, None].astype(block.dtype)
        if hblock is not None:
            hblock = mix(s, hblock) * mask[:, None].astype(block.dtype)
    return block, hblock


def masked_mgs(block: jnp.ndarray, mask: jnp.ndarray, drop_tol: float,
               hblock: Optional[jnp.ndarray] = None,
               against=(), h_against=(), axis_name=None, passes: int = 2):
    """Masked modified Gram-Schmidt with dependent-column DROPPING.

    Orthonormalizes the active rows of ``block`` against the (already
    orthonormal) row-bases in ``against`` and against each other,
    sequentially.  A column whose residual norm after projection falls
    below ``drop_tol`` (columns enter unit-norm, so this is the sine of its
    angle to the accepted span) is zeroed and masked out.

    This is the structurally safe orthonormalizer for low precision: every
    surviving column is EXACTLY unit norm and orthogonal to its
    predecessors, so the Rayleigh-Ritz matrix diagonal is a true Rayleigh
    quotient and spurious below-spectrum Ritz values cannot appear (the
    failure mode of jitter-clamped Loewdin/Cholesky on nearly dependent
    blocks).  ``hblock``/``h_against`` are transformed consistently.
    Returns (q, hq, new_mask).
    """
    m = block.shape[0]
    cdtype = block.dtype
    rdtype = jnp.zeros((), cdtype).real.dtype
    mask = mask.astype(rdtype)

    # Pass 0: block projection off the fixed orthonormal bases.
    for base, hbase in zip(against, h_against or [None] * len(against)):
        for _ in range(passes):
            coeff = gram(base, block, axis_name=axis_name)
            block = block - mix(coeff, base)
            if hblock is not None and hbase is not None:
                hblock = hblock - mix(coeff, hbase)

    # Sequential MGS within the block (fixed shapes: triangular weighting).
    hb = hblock if hblock is not None else jnp.zeros((m, 0), cdtype)
    idx = jnp.arange(m)

    def step(i, carry):
        q, hq, msk = carry
        col = q[i][None, :]
        hcol = hq[i][None, :]
        wsel = (((idx < i).astype(rdtype) * msk)[:, None]).astype(cdtype)
        for _ in range(passes):
            # real-split contractions at stated precision
            coeff = gram(q, col, axis_name=axis_name) * wsel   # (m, 1)
            col = col - mix(coeff, q)
            hcol = hcol - mix(coeff, hq)
        nrm2 = jnp.sum((col.conj() * col).real)
        if axis_name is not None:
            nrm2 = lax.psum(nrm2, axis_name)
        nrm = jnp.sqrt(nrm2)
        ok = msk[i] * (nrm > drop_tol).astype(rdtype)
        tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype)
        scale = (ok / jnp.maximum(nrm, tiny)).astype(cdtype)
        q = q.at[i].set(col[0] * scale)
        hq = hq.at[i].set(hcol[0] * scale)
        return q, hq, msk.at[i].set(ok)

    q, hq, mask = lax.fori_loop(0, m, step, (block, hb, mask))
    return q, (hq if hblock is not None else None), mask


def masked_svqb_drop(block: jnp.ndarray, mask: jnp.ndarray, drop_tol: float,
                     hblock: Optional[jnp.ndarray] = None,
                     against=(), h_against=(), axis_name=None,
                     passes: int = 2):
    """SVQB orthonormalization with dependent-direction DROPPING — the
    GEMM-bound replacement for :func:`masked_mgs`.

    masked_mgs is structurally safe but sequential: its fori_loop reads the
    full (m, D) block every step (m steps x passes), which made it half
    the LOBPCG iteration at N=96.  This variant does the same
    job with 2 Gram+mix passes:

    per pass:
      1. project the block off the fixed orthonormal bases in ``against``;
      2. f64-accumulated Gram G of the block (masked rows decoupled);
      3. eigendecompose G (f64 real embedding); eigendirections with
         eigenvalue < drop_tol^2 (i.e. sine of angle to the accepted span
         < drop_tol, matching the MGS drop rule) are DROPPED — their
         output rows are zeroed and masked out, never jitter-inflated
         (jitter-clamping is what bred below-spectrum phantom Ritz values);
      4. mix with V diag(ok / sqrt(eigval)): surviving rows are orthonormal
         to f64-Gram accuracy.

    Passes after the first are GRAM-NS refinements, not repeated eighs:
    B <- mix((3 diag(mask) - G)/2, B) with G the masked f64 Gram.  This is
    one Newton-Schulz step toward orthonormality — quadratic (E -> 3E^2/4),
    rank-safe, and immune to the eigh-in-a-degenerate-cluster pathology:
    when the pass-1 output Gram is ~I, ALL its eigenvalues sit in one tight
    cluster and an embedding eigh returns a nearly-singular complex V
    (J-pair duplicate selection), which no polish can repair — measured as
    a 1e-2 orthonormality floor.  The NS step needs no spectral
    information at all.

    ``hblock``/``h_against`` are transformed consistently (no extra operator
    applies).  Returns (q, hq, new_mask); new_mask is eigen-ordered
    (ascending eigenvalue), which is fine for the caller's basis_mask use.
    """
    m = block.shape[0]
    cdtype = block.dtype
    rdtype = real_dtype(cdtype)
    mask = mask.astype(jnp.float64)
    split = split_for(rdtype, svqb=True)
    # Drop floor relative to gscale: 1e-6 (f32 noise level) / 1e-9 (f64).
    lam_fac = 10.0 if jnp.dtype(rdtype) == jnp.float32 else 1e3

    hb = hblock if hblock is not None else jnp.zeros((m, 0), cdtype)
    if len(against) > 1:
        against = (jnp.concatenate(against),)
        if h_against:
            h_against = (jnp.concatenate(h_against),)
    for pno in range(passes):
        for base, hbase in zip(against, h_against or [None] * len(against)):
            coeff = gram(base, block, axis_name=axis_name)
            block = block - mix(coeff, base)
            if hblock is not None and hbase is not None:
                hb = hb - mix(coeff, hbase)
        keep = (mask[:, None] * mask[None, :])
        g_re, g_im = gram_f64(block, block, axis_name=axis_name)
        g_re = 0.5 * (g_re + g_re.T) * keep
        g_im = 0.5 * (g_im - g_im.T) * keep
        if pno == 0:
            # The drop threshold must clear the eigh's degeneracy
            # perturbation (split * gscale): otherwise exactly-dead
            # directions get perturbed to eigenvalue ~split*gscale, survive
            # a tiny drop_tol, and return as 1/sqrt(lambda)-amplified junk
            # columns (phantom Ritz values).
            gscale = jnp.max(jnp.abs(g_re)) + jnp.max(jnp.abs(g_im))
            lam_min = jnp.maximum(
                jnp.asarray(float(drop_tol) ** 2, jnp.float64),
                lam_fac * split * gscale)
            w, vr, vi = eigh_f64_embedding(g_re, g_im, split=split)
            ok = (w > lam_min).astype(jnp.float64)
            scale = ok / jnp.sqrt(jnp.maximum(w, lam_min))
            c_re = (vr * scale).astype(rdtype)
            c_im = (vi * scale).astype(rdtype)
            mask = ok
        else:
            c_re = (1.5 * jnp.diag(mask) - 0.5 * g_re).astype(rdtype)
            c_im = (-0.5 * g_im).astype(rdtype)
        coeff = jax.lax.complex(c_re, c_im).astype(cdtype)
        block = mix(coeff, block)
        hb = mix(coeff, hb)
    return (block, (hb if hblock is not None else None),
            mask.astype(rdtype))


def masked_cholqr(block: jnp.ndarray, mask: jnp.ndarray, jitter: float,
                  hblock: Optional[jnp.ndarray] = None, passes: int = 1,
                  axis_name=None):
    """Orthonormalize the active rows of a (p, D) block via Cholesky-QR.

    Masked-out rows must already be zero; they stay zero (their Gram diagonal
    is padded with 1).  ``hblock`` (= H @ block) is transformed by the same
    row mixing so it stays consistent without extra operator applies.
    ``jitter`` (relative to the max Gram diagonal) regularizes the Cholesky
    in low precision; ``passes=2`` gives CholQR2 orthonormality.
    """
    keep = mask[:, None] * mask[None, :]
    dead = jnp.diag(1.0 - mask).astype(block.dtype)
    for _ in range(passes):
        g = hermitize(gram(block, block, axis_name=axis_name)) * keep + dead
        g = g + (jitter * jnp.max(jnp.abs(jnp.diag(g)))) * jnp.eye(
            block.shape[0], dtype=block.dtype)
        l = jnp.linalg.cholesky(g)
        # Row convention: Q = conj(L)^{-1} B  =>  conj(Q) Q^T = I on active rows.
        block = jax.scipy.linalg.solve_triangular(l.conj(), block, lower=True)
        if hblock is not None:
            hblock = jax.scipy.linalg.solve_triangular(l.conj(), hblock,
                                                       lower=True)
        block = block * mask[:, None].astype(block.dtype)
        if hblock is not None:
            hblock = hblock * mask[:, None].astype(block.dtype)
    return block, hblock


def project_off(block: jnp.ndarray, basis: jnp.ndarray,
                hblock: Optional[jnp.ndarray] = None,
                hbasis: Optional[jnp.ndarray] = None,
                axis_name=None):
    """Project the rows of ``block`` off the orthonormal rows of ``basis``
    (and apply the same combination to hblock using hbasis)."""
    coeff = gram(basis, block, axis_name=axis_name)   # (p_basis, p_block)
    block = block - mix(coeff, basis)
    if hblock is not None:
        hblock = hblock - mix(coeff, hbasis)
    return block, hblock


# ---------------------------------------------------------------------------
# Pair-layout ("real-split") kernels: complex vectors carried as (re, im)
# tuples of REAL arrays.  A complex GEMM split into real dots materializes
# .real/.imag copies and a recombine pass per call; on pairs the four real
# dot_generals read the operands directly.  Used by solvers.lobpcg_rs.
# ---------------------------------------------------------------------------

def divisor_chunk(d: int, target: int = 65536) -> int:
    """Largest Gram chunk <= target that divides d (so the chunked reshape
    is a free view).  A non-divisor chunk pads, which materializes a copy
    of every (m, D) operand plane — 0.6 GB each at N=150.  Falls back to
    target when d has no divisor near it (then padding is unavoidable)."""
    lo = -(-d // target)
    for nc in range(lo, min(d, 4 * lo) + 1):
        if d % nc == 0:
            return d // nc
    return target


def gram_f64_p(x, y, chunk: int = 0, axis_name=None):
    """f64-accumulated Gram of PAIR row-blocks x=(xr, xi), y=(yr, yi) of
    shape (p, D): G[i, j] = <x_i, y_j>.  Pair twin of :func:`gram_f64`.

    ``chunk=0`` (default) picks :func:`divisor_chunk` of D so no call site
    pays the padding copies; pass an explicit chunk to override."""
    xr, xi = x
    yr, yi = y
    p, d = xr.shape
    q = yr.shape[0]
    if not chunk:
        chunk = divisor_chunk(d)
    nc = -(-d // chunk)
    pad = nc * chunk - d
    if pad:
        xr, xi, yr, yi = (jnp.pad(a, ((0, 0), (0, pad)))
                          for a in (xr, xi, yr, yi))
    resh = lambda a, k: a.reshape(k, nc, chunk)
    xr, xi = resh(xr, p), resh(xi, p)
    yr, yi = resh(yr, q), resh(yi, q)
    dims = (((2,), (2,)), ((1,), (1,)))   # batch over chunks, no transpose
    rd = lambda a, b: lax.dot_general(a, b, dims,
                                      precision=lax.Precision.HIGHEST)
    f64 = jnp.float64
    re = jnp.sum(rd(xr, yr).astype(f64) + rd(xi, yi).astype(f64), axis=0)
    im = jnp.sum(rd(xr, yi).astype(f64) - rd(xi, yr).astype(f64), axis=0)
    if axis_name is not None:
        re = lax.psum(re, axis_name)
        im = lax.psum(im, axis_name)
    return re, im


def gram_p32(x, y, axis_name=None):
    """Plain f32 Gram of pair row-blocks (for projections, where the
    coefficient only needs working precision)."""
    dims = (((1,), (1,)), ((), ()))
    rd = lambda a, b: lax.dot_general(a, b, dims,
                                      precision=lax.Precision.HIGHEST)
    re = rd(x[0], y[0]) + rd(x[1], y[1])
    im = rd(x[0], y[1]) - rd(x[1], y[0])
    if axis_name is not None:
        re = lax.psum(re, axis_name)
        im = lax.psum(im, axis_name)
    return re, im


def mix_pair(c, blocks):
    """out_j = sum_i c[i, j] blocks_i on pairs; c = (cr, ci) small (p, q)."""
    dims = (((0,), (0,)), ((), ()))
    rd = lambda a, b: lax.dot_general(a, b, dims,
                                      precision=lax.Precision.HIGHEST)
    cr, ci = c
    br, bi = blocks
    return (rd(cr, br) - rd(ci, bi), rd(cr, bi) + rd(ci, br))


def colnorms_p(x, axis_name=None):
    n2 = jnp.sum(x[0] * x[0] + x[1] * x[1],
                 axis=tuple(range(1, x[0].ndim)))
    if axis_name is not None:
        n2 = lax.psum(n2, axis_name)
    return jnp.sqrt(n2)


def scale_cols_p(x, s):
    shape = (-1,) + (1,) * (x[0].ndim - 1)
    sc = s.reshape(shape).astype(x[0].dtype)
    return (x[0] * sc, x[1] * sc)


def masked_svqb_drop_p(block, mask, drop_tol, hblock=None,
                       against=(), h_against=(), axis_name=None,
                       passes: int = 2):
    """Pair twin of :func:`masked_svqb_drop` (same drop rule and guarantees);
    block/hblock/against are pairs of (p, D) real arrays."""
    rdtype = block[0].dtype
    mask = mask.astype(jnp.float64)
    split = split_for(rdtype, svqb=True)
    lam_fac = 10.0 if jnp.dtype(rdtype) == jnp.float32 else 1e3

    hb = hblock
    # Concatenate the projection bases ONCE: one wide Gram + one wide mix
    # per pass instead of one pair per base (halves the big-block traffic
    # and dispatches when projecting P off both X and W).
    if len(against) > 1:
        against = ((jnp.concatenate([a[0] for a in against]),
                    jnp.concatenate([a[1] for a in against])),)
        if h_against:
            h_against = ((jnp.concatenate([a[0] for a in h_against]),
                          jnp.concatenate([a[1] for a in h_against])),)
    for pno in range(passes):
        for base, hbase in zip(against, h_against or [None] * len(against)):
            coeff = gram_p32(base, block, axis_name=axis_name)
            d = mix_pair(coeff, base)
            block = (block[0] - d[0], block[1] - d[1])
            if hb is not None and hbase is not None:
                dh = mix_pair(coeff, hbase)
                hb = (hb[0] - dh[0], hb[1] - dh[1])
        keep = (mask[:, None] * mask[None, :])
        g_re, g_im = gram_f64_p(block, block, axis_name=axis_name)
        g_re = 0.5 * (g_re + g_re.T) * keep
        g_im = 0.5 * (g_im - g_im.T) * keep
        if pno == 0:
            gscale = jnp.max(jnp.abs(g_re)) + jnp.max(jnp.abs(g_im))
            lam_min = jnp.maximum(
                jnp.asarray(float(drop_tol) ** 2, jnp.float64),
                lam_fac * split * gscale)
            w, vr, vi = eigh_f64_embedding(g_re, g_im, split=split)
            ok = (w > lam_min).astype(jnp.float64)
            scale = ok / jnp.sqrt(jnp.maximum(w, lam_min))
            coeff = ((vr * scale).astype(rdtype),
                     (vi * scale).astype(rdtype))
            mask = ok
        else:
            # Gram-NS refinement pass (see masked_svqb_drop): quadratic,
            # rank-safe, no eigh.
            coeff = ((1.5 * jnp.diag(mask) - 0.5 * g_re).astype(rdtype),
                     (-0.5 * g_im).astype(rdtype))
        block = mix_pair(coeff, block)
        if hb is not None:
            hb = mix_pair(coeff, hb)
    return block, hb, mask.astype(rdtype)


def power_method(a_func, x0: jnp.ndarray, maxiter: int = 1000,
                 tol: float = 1e-5):
    """Largest eigenvalue by the power method
    (reference: orthogonalization.py:57-85).

    Norms/residuals are computed via real/imag splits (sum of squares)."""

    def _norm(z):
        if jnp.iscomplexobj(z):
            return jnp.sqrt(jnp.sum(jnp.real(z) ** 2 + jnp.imag(z) ** 2))
        return jnp.sqrt(jnp.sum(z * z))

    def _absmax(z):
        if jnp.iscomplexobj(z):
            return jnp.sqrt(jnp.max(jnp.real(z) ** 2 + jnp.imag(z) ** 2))
        return jnp.max(jnp.abs(z))

    def body(carry):
        i, x, lam, res = carry
        ax = a_func(x)
        lam = _norm(ax.reshape(-1))
        xn = ax / lam
        res = _absmax(ax - lam * x) / jnp.abs(lam)
        return i + 1, xn, lam, res

    def cond(carry):
        i, _, _, res = carry
        return (i < maxiter) & (res > tol)

    x0 = x0 / _norm(x0.reshape(-1))
    i, x, lam, res = lax.while_loop(
        cond, body, (0, x0, jnp.asarray(0.0, x0.real.dtype),
                     jnp.asarray(jnp.inf, x0.real.dtype)))
    return lam, x, i


def masked_loewdin_p(block, mask, jitter: float, hblock=None,
                     passes: int = 1, axis_name=None):
    """Pair twin of :func:`masked_loewdin`: Loewdin/SVQB orthonormalization
    of pair row-blocks (f64 Gram + real-embedding eigh + pair mixes — no
    complex value anywhere)."""
    keep64 = (mask[:, None] * mask[None, :]).astype(jnp.float64)
    dead64 = jnp.diag(1.0 - mask).astype(jnp.float64)
    rdt = block[0].dtype
    for _ in range(passes):
        g_re, g_im = gram_f64_p(block, block, axis_name=axis_name)
        g_re = 0.5 * (g_re + g_re.T) * keep64 + dead64
        g_im = 0.5 * (g_im - g_im.T) * keep64
        s_re, s_im = _loewdin_mixer(g_re, g_im, jitter)
        sp = (s_re.astype(rdt), s_im.astype(rdt))
        mk = mask[:, None].astype(rdt)
        b = mix_pair(sp, block)
        block = (b[0] * mk, b[1] * mk)
        if hblock is not None:
            hb = mix_pair(sp, hblock)
            hblock = (hb[0] * mk, hb[1] * mk)
    return block, hblock


def project_off_p(block, basis, hblock=None, hbasis=None, axis_name=None):
    """Pair twin of :func:`project_off`: project pair rows off an
    orthonormal pair basis."""
    cr, ci = gram_p32(basis, block, axis_name=axis_name)
    # coeff^H enters the update: out = block - basis^T conj-combination;
    # mix_pair contracts over the BASIS index with coeff (p_basis, p_block)
    mx = mix_pair((cr, ci), basis)
    block = (block[0] - mx[0], block[1] - mx[1])
    if hblock is not None:
        mh = mix_pair((cr, ci), hbasis)
        hblock = (hblock[0] - mh[0], hblock[1] - mh[1])
    return block, hblock
