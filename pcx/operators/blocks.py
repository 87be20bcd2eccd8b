"""Fused 3x3 block-diagonal multiplies on (..., 3, N, N, N) fields.

These replace the reference's two CUDA ElementwiseKernels
(paper_2/_kernels.py:13-71, wrappers paper_2/pcfft.py:18-43).  Here they
are pure jnp elementwise expressions — XLA fuses the whole chain (symbol
multiply + FFT prologue/epilogue) into a handful of loops, so a custom
kernel is only warranted if a trace shows XLA failed to fuse.

Layout: a block of m field vectors is an array X of shape (m, 3, N, N, N)
(component axis -4, spatial axes -3..-1).  A "symbol" D is (3, N, N, N) and
broadcasts against X.  The Hermitian block symbol is a (diag, sdiag) pair:
diag = (d11, d22, d33), sdiag = (d12, d13, d23), each (3, N, N, N).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def a_block(x: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Antisymmetric curl-block multiply: y = [[0,-d3,d2],[d3,0,-d1],[-d2,d1,0]] x.

    Reference: a_block_kernel, paper_2/_kernels.py:43-71.
    """
    x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
    d0, d1, d2 = d[0], d[1], d[2]
    return jnp.stack(
        (
            -d2 * x1 + d1 * x2,
            d2 * x0 - d0 * x2,
            -d1 * x0 + d0 * x1,
        ),
        axis=-4,
    )


def h_block(x: jnp.ndarray, diag_sdiag: Tuple[jnp.ndarray, jnp.ndarray]) -> jnp.ndarray:
    """Hermitian 3x3 block multiply with diagonal blocks.

    y = [[d11, s12, s13], [s12*, d22, s23], [s13*, s23*, d33]] x.
    Reference: h_block_kernel, paper_2/_kernels.py:13-41.
    """
    diag, sdiag = diag_sdiag
    x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
    d0, d1, d2 = diag[0], diag[1], diag[2]
    s0, s1, s2 = sdiag[0], sdiag[1], sdiag[2]
    return jnp.stack(
        (
            d0 * x0 + s0 * x1 + s1 * x2,
            s0.conj() * x0 + d1 * x1 + s2 * x2,
            s1.conj() * x0 + s2.conj() * x1 + d2 * x2,
        ),
        axis=-4,
    )


def diag_block(x: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Plain diagonal multiply y_c = d_c * x_c."""
    return d * x
