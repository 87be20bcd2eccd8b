"""3-D DFT as explicit matmuls with controlled precision.

For the moderate per-axis sizes of this problem (N <= ~200) the DFT along
each grid axis is a single (N, N) matrix contraction; at
``Precision.HIGHEST`` it keeps full f32 (or f64) accuracy.  The solvers use
the backend FFT (``jnp.fft``, cuFFT on the GPU), which is faster at equal
accuracy on the GPU (PERF.md); this matmul form serves
``KPointSolver(fft_mode="matmul")`` on the complex solver, and its
contraction also applies the trigonometric resampling of the two-grid
start (:func:`resample3`).

The (N, N) twiddle matrices are k-independent, built once per grid on the
host, and passed through the jit boundary as ARGUMENTS (230 KB at N=120 —
never closure constants).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


class DFTMats(NamedTuple):
    """Forward/inverse DFT matrices, each (N, N) complex.

    fwd[j, k] = exp(-2 pi i j k / N); inv = conj(fwd) / N  — matching the
    jnp.fft.fftn / ifftn normalization used by the Fourier-domain operator.
    """
    fwd: jnp.ndarray
    inv: jnp.ndarray


def dft_mats(n: int, dtype=np.complex64) -> DFTMats:
    j = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(j, j) / n)
    return DFTMats(np.asarray(w, dtype=dtype),
                   np.asarray(w.conj() / n, dtype=dtype))


def _axis_dft(x: jnp.ndarray, w: jnp.ndarray, precision) -> jnp.ndarray:
    """Contract the -3rd axis of x with w (N_in x N_out), appending the
    transformed axis last: (..., a, b, c) -> (..., b, c, a').  Complex via
    four real dots, each at the stated precision."""
    dims = (((x.ndim - 3,), (0,)), ((), ()))
    xr, xi = x.real, x.imag
    wr, wi = w.real, w.imag
    rd = lambda a, b: lax.dot_general(a, b, dims, precision=precision)
    re = rd(xr, wr) - rd(xi, wi)
    im = rd(xr, wi) + rd(xi, wr)
    return lax.complex(re, im)


def dft3(x: jnp.ndarray, w: jnp.ndarray,
         precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """3-D DFT over the last three axes of x via three cyclic axis
    contractions (axis layout is restored after the third)."""
    for _ in range(3):
        x = _axis_dft(x, w, precision)
    return x


def upsample_mat(nc: int, n: int, dtype=np.complex64) -> np.ndarray:
    """(nc, n) trigonometric-interpolation matrix: contracting a periodic
    signal sampled on an nc-grid with this matrix evaluates its truncated
    Fourier series on the finer n-grid (zero-padded spectrum; the even-nc
    Nyquist bin is split half/half onto +/- so real inputs stay real).
    Used to lift converged coarse-grid eigenvector blocks into fine-grid
    LOBPCG starts (KPointSolver x0_mode='coarse')."""
    if n < nc:
        raise ValueError(f"upsample requires n >= nc, got {nc} -> {n}")
    fwd = np.exp(-2j * np.pi * np.outer(np.arange(nc), np.arange(nc)) / nc)
    # P[k, k']: coarse frequency bin k -> fine frequency bin k'.
    pad = np.zeros((nc, n), np.complex128)
    h = nc // 2
    for k in range(nc):
        if k < h or nc % 2 and k == h:
            pad[k, k] = 1.0
        elif k > h:
            pad[k, n - nc + k] = 1.0
        elif n == nc:
            pad[k, k] = 1.0
        else:  # even-nc Nyquist: split to keep conjugate symmetry
            pad[k, k] = 0.5
            pad[k, n - h] = 0.5
    g = np.exp(2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    u = (fwd @ pad @ g.T) / nc
    return np.asarray(u, dtype=dtype)


def resample3(x: jnp.ndarray, u: jnp.ndarray,
              precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Apply the (n_in, n_out) resampling matrix ``u`` along the last three
    axes of x: (..., nc, nc, nc) -> (..., n, n, n).  Same cyclic axis
    contraction as dft3, so the axis order is restored."""
    for _ in range(3):
        x = _axis_dft(x, u, precision)
    return x


def make_fft_pair(mats: DFTMats, precision=lax.Precision.HIGHEST):
    """(fftn, ifftn) closures over the twiddle ARGUMENTS, drop-in for
    jnp.fft.fftn/ifftn over the last three axes."""
    return (lambda x: dft3(x, mats.fwd, precision),
            lambda x: dft3(x, mats.inv, precision))
