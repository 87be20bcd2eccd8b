"""Unit tests of the dense-algebra kernels (rayleigh_ritz)."""

import numpy as np
import pytest

import jax.numpy as jnp

from pcx.solvers import rayleigh_ritz as rr


def _rand_herm(p, rng, degenerate=False):
    a = rng.normal(size=(p, p)) + 1j * rng.normal(size=(p, p))
    h = (a + a.conj().T) / 2
    if degenerate:
        w, v = np.linalg.eigh(h)
        w[1] = w[0]            # exact 2-fold degeneracy
        w[4] = w[3] = w[2]     # exact 3-fold degeneracy
        h = (v * w) @ v.conj().T
        h = (h + h.conj().T) / 2
    return h


def test_eigh_f64_embedding_basic(rng):
    h = _rand_herm(12, rng)
    w, vr, vi = rr.eigh_f64_embedding(jnp.asarray(h.real), jnp.asarray(h.imag))
    want = np.linalg.eigvalsh(h)
    np.testing.assert_allclose(np.asarray(w), want, atol=1e-9)
    v = np.asarray(vr) + 1j * np.asarray(vi)
    # Orthonormal eigenvectors, correct residuals.
    np.testing.assert_allclose(v.conj().T @ v, np.eye(12), atol=1e-9)
    np.testing.assert_allclose(h @ v, v * np.asarray(w), atol=1e-8)


def test_eigh_f64_embedding_degenerate(rng):
    """Exact degeneracies: the graded perturbation keeps the even-index
    pair selection sound (eigenvectors stay complex-linearly independent)."""
    h = _rand_herm(10, rng, degenerate=True)
    w, vr, vi = rr.eigh_f64_embedding(jnp.asarray(h.real), jnp.asarray(h.imag))
    v = np.asarray(vr) + 1j * np.asarray(vi)
    # Within exactly-degenerate clusters the graded split (1e-10) vs the
    # f64 eigh backward error leaves ~1e-5 mixing between pair partners -
    # harmless (any orthobasis of the cluster is valid); require it small.
    np.testing.assert_allclose(v.conj().T @ v, np.eye(10), atol=1e-4)
    np.testing.assert_allclose(np.asarray(w), np.linalg.eigvalsh(h),
                               atol=1e-7)
    np.testing.assert_allclose(h @ v, v * np.asarray(w), atol=1e-4)


def test_gram_f64_beats_f32(rng):
    """Chunked-f64 Gram of complex64 blocks is far more accurate than the
    plain f32 Gram over a long axis."""
    p, d = 8, 400_000
    x = (rng.normal(size=(p, d)) + 1j * rng.normal(size=(p, d)))
    want = (x.conj() @ x.T)
    x32 = jnp.asarray(x.astype(np.complex64))
    g32 = np.asarray(rr.gram(x32, x32))
    re, im = rr.gram_f64(x32, x32)
    g64 = np.asarray(re) + 1j * np.asarray(im)
    # The inputs are rounded to c64, so ~1e-7 relative error is the floor;
    # the chunked-f64 version must sit at that floor.  (On CPU, XLA already
    # accumulates f32 dots widely, so only assert it never does worse.)
    err32 = np.abs(g32 - want).max() / np.abs(want).max()
    err64 = np.abs(g64 - want).max() / np.abs(want).max()
    assert err64 < 1e-7
    assert err64 <= err32


def test_masked_loewdin_orthonormal(rng):
    p, d = 6, 5000
    x = jnp.asarray((rng.normal(size=(p, d)) + 1j * rng.normal(size=(p, d)))
                    .astype(np.complex64))
    mask = jnp.asarray([1, 1, 0, 1, 1, 0], jnp.float32)
    x = x * mask[:, None].astype(x.dtype)
    q, _ = rr.masked_loewdin(x, mask, 1e-6)
    g = np.asarray(rr.gram(q, q))
    want = np.diag(np.asarray(mask))
    np.testing.assert_allclose(g, want, atol=2e-5)



def test_project_off(rng):
    p, d = 4, 3000
    basis = jnp.asarray(rng.normal(size=(p, d)) + 1j * rng.normal(size=(p, d)))
    basis, _ = rr.masked_loewdin(basis, jnp.ones(p), 1e-14)
    block = jnp.asarray(rng.normal(size=(2, d)) + 1j * rng.normal(size=(2, d)))
    out, _ = rr.project_off(block, basis)
    g = np.asarray(rr.gram(basis, out))
    np.testing.assert_allclose(g, 0, atol=1e-10)


def test_masked_mgs_twice_is_enough_on_noise_columns():
    """A column that is 99.99% inside span(X) must come out orthonormal
    after 2 passes — single-pass MGS can leave such columns nearly parallel,
    which the identity-Gram Rayleigh-Ritz turns into below-spectrum phantom
    eigenvalues (observed at N=120 complex64)."""
    import numpy as np
    import jax.numpy as jnp
    from pcx.solvers import rayleigh_ritz as rr

    rng = np.random.default_rng(5)
    m, d = 6, 4096
    x = rng.standard_normal((m, d)) + 1j * rng.standard_normal((m, d))
    x = np.asarray(rr.masked_mgs(jnp.asarray(x, jnp.complex64),
                                 jnp.ones(m, jnp.float32), 1e-6)[0])
    # w: almost inside span(x) + tiny independent noise
    w = (x[:3] * np.array([[1.0], [1.0], [1.0]])
         + 1e-4 * (rng.standard_normal((3, d))
                   + 1j * rng.standard_normal((3, d)))).astype(np.complex64)
    for passes in (1, 2):
        q, _, ok = rr.masked_mgs(jnp.asarray(w), jnp.ones(3, jnp.float32),
                                 1e-7, against=(jnp.asarray(x),),
                                 passes=passes)
        q = np.asarray(q)[np.asarray(ok) > 0]
        if len(q) == 0:
            continue
        g = q @ q.conj().T
        basis_err = np.abs(g - np.eye(len(q))).max()
        cross = np.abs(q @ np.asarray(x).conj().T).max()
        if passes == 2:
            assert basis_err < 5e-6, basis_err
            assert cross < 5e-6, cross


def test_eigh_f64_embedding_tiny_relative_eigenvalue(rng):
    """Eigenvalues at ~1e-13 RELATIVE to the matrix scale: the protective
    diagonal shift must keep the result finite and accurate (an
    emulated-f64 eigh was seen to return all-NaN for such inputs; the
    shift leaves eigenvectors exactly unchanged)."""
    p = 24
    q = np.linalg.qr(rng.normal(size=(p, p)) + 1j * rng.normal(size=(p, p)))[0]
    wt = np.concatenate([np.array([1.5e-10, 5e-7]), np.linspace(2.7, 600.0, p - 2)])
    h = (q * wt) @ q.conj().T
    h = (h + h.conj().T) / 2
    w, vr, vi = rr.eigh_f64_embedding(jnp.asarray(h.real), jnp.asarray(h.imag))
    assert not np.isnan(np.asarray(w)).any()
    v = np.asarray(vr) + 1j * np.asarray(vi)
    assert not np.isnan(v).any()
    np.testing.assert_allclose(np.sort(np.asarray(w)), np.sort(wt),
                               atol=1e-5)
    np.testing.assert_allclose(v.conj().T @ v, np.eye(p), atol=1e-8)


def test_eigh_f64_embedding_zero_matrix():
    """All-dead SVQB Grams are exactly zero: must return finite output (a
    1e-300 guard constant flushes to 0 in an f32-pair-emulated f64, which
    once turned the Newton gap gate into 0/0)."""
    z = jnp.zeros((8, 8), jnp.float64)
    w, vr, vi = rr.eigh_f64_embedding(z, z)
    assert not np.isnan(np.asarray(w)).any()
    assert not np.isnan(np.asarray(vr)).any()
    np.testing.assert_allclose(np.asarray(w), 0.0, atol=1e-12)


def test_masked_svqb_drop_near_identity_gram(rng):
    """Pass-2-style input (already orthonormal + noise): the Gram-NS
    refinement pass must not degrade orthonormality (the embedding eigh of
    a fully-clustered Gram returns a nearly singular complex V, which is
    why later passes avoid the eigh entirely)."""
    m, d = 12, 500
    b = rng.normal(size=(m, d)) + 1j * rng.normal(size=(m, d))
    q, _ = np.linalg.qr(b.conj().T)
    q = q.T.conj() + 1e-6 * (rng.normal(size=(m, d))
                             + 1j * rng.normal(size=(m, d)))
    out, _, mask = rr.masked_svqb_drop(jnp.asarray(q), jnp.ones(m), 1e-8,
                                       passes=2)
    g = np.asarray(out) @ np.asarray(out).conj().T
    assert np.asarray(mask).sum() == m
    np.testing.assert_allclose(g, np.eye(m), atol=1e-10)
    # pair twin
    outp, _, maskp = rr.masked_svqb_drop_p(
        (jnp.asarray(q.real), jnp.asarray(q.imag)), jnp.ones(m), 1e-8,
        passes=2)
    qp = np.asarray(outp[0]) + 1j * np.asarray(outp[1])
    gp = qp @ qp.conj().T
    np.testing.assert_allclose(gp, np.eye(m), atol=1e-10)


def test_dft3_p_stacked_matches_fftn(rng):
    """The pair 3-D DFT (rs.fft3_p) is a drop-in fftn/ifftn, and agrees
    with the explicit matmul DFT."""
    from pcx.operators import dft as dft_mod
    from pcx.operators import rs
    n, m = 10, 2
    mats = dft_mod.dft_mats(n, np.complex64)
    x = (rng.standard_normal((m, 3, n, n, n)).astype(np.float32),
         rng.standard_normal((m, 3, n, n, n)).astype(np.float32))
    got = rs.fft3_p((jnp.asarray(x[0]), jnp.asarray(x[1])))
    want = np.fft.fftn((x[0] + 1j * x[1]).astype(np.complex64),
                       axes=(-3, -2, -1))
    gotc = np.asarray(got[0]) + 1j * np.asarray(got[1])
    assert np.abs(gotc - want).max() / np.abs(want).max() < 1e-5
    mm = np.asarray(dft_mod.dft3(jnp.asarray(x[0] + 1j * x[1]),
                                 jnp.asarray(mats.fwd)))
    assert np.abs(gotc - mm).max() / np.abs(want).max() < 1e-5
    back = rs.fft3_p(got, inverse=True)
    backc = np.asarray(back[0]) + 1j * np.asarray(back[1])
    assert np.abs(backc - (x[0] + 1j * x[1])).max() < 1e-5
