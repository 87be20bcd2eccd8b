"""Pencil-decomposed distributed 3-D FFT over a mesh axis.

The way to scale the grid beyond one device's memory
(SURVEY.md section 5.7): the field (..., Nx, Ny, Nz) is sharded over its
LAST axis; the transform runs

    fft over (x, y) locally
    all_to_all over the mesh axis: reshard z-split -> x-split
    fft over z locally

so each 3-D FFT costs exactly one all_to_all each way.  Designed for use
inside ``shard_map``; the inverse reverses the dance so the output sharding
matches the input.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Axis indices within (..., 3, Nx, Ny, Nz) field blocks.
AX_X, AX_Y, AX_Z = -3, -2, -1


def _a2a(x: jnp.ndarray, axis_name: str, split_axis: int, concat_axis: int):
    nd = x.ndim
    return lax.all_to_all(x, axis_name, split_axis % nd, concat_axis % nd,
                          tiled=True)


def pencil_fftn(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Forward 3-D FFT of a z-sharded block (inside shard_map).

    Input:  local shard (..., Nx, Ny, Nz/g), z-sharded.
    Output: local shard (..., Nx/g, Ny, Nz), x-sharded (pencil-transposed).
    """
    x = jnp.fft.fftn(x, axes=(AX_X, AX_Y))
    x = _a2a(x, axis_name, AX_X, AX_Z)      # z gathers, x splits
    return jnp.fft.fft(x, axis=AX_Z)


def pencil_ifftn(x: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Inverse of :func:`pencil_fftn`: x-sharded in, z-sharded out."""
    x = jnp.fft.ifft(x, axis=AX_Z)
    x = _a2a(x, axis_name, AX_Z, AX_X)      # x gathers, z splits
    return jnp.fft.ifftn(x, axes=(AX_X, AX_Y))


def sharded_roll(x: jnp.ndarray, shift: int, axis: int, axis_name: str,
                 n_shards: int) -> jnp.ndarray:
    """Circular roll along an axis SHARDED over ``axis_name`` (|shift| must
    be <= local extent): a halo exchange via ppermute of the wrapped slab.

    Used by the cross-DoF dielectric stencils when their averaging axis is
    the sharded one (reference applies them as a CSR SpMV on one GPU,
    paper_2/discretization.py:403-453; here the 2k-wide stencil needs only
    a k-plane halo from the ring neighbor).
    """
    if shift == 0 or n_shards == 1:
        return jnp.roll(x, shift, axis=axis)
    nloc = x.shape[axis]
    ndim = x.ndim
    ax = axis % ndim
    # Decompose shift = q*nloc + r (0 <= r < nloc): whole-block ppermute by
    # q shards, then an r-plane halo from the left neighbor.
    q, r = divmod(shift, nloc)
    q %= n_shards
    if q:
        perm = [(i, (i + q) % n_shards) for i in range(n_shards)]
        x = lax.ppermute(x, axis_name, perm)
    if r == 0:
        return x
    # out[i] = in[i - r]: first r local planes come from the LEFT neighbor.
    send = lax.slice_in_dim(x, nloc - r, nloc, axis=ax)
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    recv = lax.ppermute(send, axis_name, perm)
    body = lax.slice_in_dim(x, 0, nloc - r, axis=ax)
    return jnp.concatenate([recv, body], axis=ax)
