"""Real-boundary jit shim: carry complex arrays across the jit boundary as
trailing-axis (..., 2) real arrays.

Used by ``KPointSolver(real_boundary=True)``: every jitted entry point that
touches complex data gets wrapped, arguments and results cross the boundary
as pairs of reals, and ``jax.lax.complex`` / ``.real/.imag`` splits live
just inside the program where XLA fuses them.  The CPU and GPU backends
move complex buffers natively, so the default path runs without it; tests
use it to drive the pair-layout solver behind an all-real boundary.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class CArr:
    """A complex array in transit: ``ri`` is real with a trailing axis of
    size 2 holding (real, imag).  Registered as a pytree so it can sit
    anywhere inside jit/vmap argument structures."""

    __slots__ = ("ri",)

    def __init__(self, ri):
        self.ri = ri

    @property
    def shape(self):
        return self.ri.shape[:-1]

    @property
    def dtype(self):
        return self.ri.dtype

    def tree_flatten(self):
        return (self.ri,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def __getitem__(self, idx):
        """Slice along leading (non-pair) axes — an eager REAL-buffer op."""
        return CArr(self.ri[idx])

    def to_numpy(self) -> np.ndarray:
        """Host-side complex view (D2H of the REAL buffer, then combine)."""
        ri = np.asarray(self.ri)
        return ri[..., 0] + 1j * ri[..., 1]

    def __repr__(self):
        return f"CArr(shape={self.shape}, rdtype={self.dtype})"


def _is_carr(leaf):
    return isinstance(leaf, CArr)


def encode(tree, rdt=None):
    """Replace every complex leaf with a CArr of (..., 2) reals.

    numpy leaves are split host-side (no device op); jax arrays / tracers
    are split with device ops (safe: real outputs only).  ``rdt`` optionally
    casts numpy splits to a target real width (e.g. f32 for a c64 run).
    """
    def enc(x):
        if isinstance(x, CArr):
            return x
        if not np.iscomplexobj(x):
            return x
        if isinstance(x, (np.ndarray, np.generic, complex)):
            x = np.asarray(x)
            ri = np.stack((x.real, x.imag), axis=-1)
            return CArr(ri.astype(rdt) if rdt is not None else ri)
        return CArr(jnp.stack((x.real, x.imag), axis=-1))

    return jax.tree_util.tree_map(enc, tree, is_leaf=_is_carr)


def decode(tree):
    """Inverse of :func:`encode`: CArr leaves -> complex arrays (in-program:
    one fused lax.complex per leaf; on host: numpy combine)."""
    def dec(leaf):
        if not isinstance(leaf, CArr):
            return leaf
        if isinstance(leaf.ri, np.ndarray):
            return leaf.to_numpy()
        return jax.lax.complex(leaf.ri[..., 0], leaf.ri[..., 1])

    return jax.tree_util.tree_map(dec, tree, is_leaf=_is_carr)


def real_boundary(fn):
    """Wrap a traceable function so all complex args/results cross the jit
    boundary as CArr reals.  Callers pass pre-encoded args (see encode)."""
    def wrapped(*eargs, **ekw):
        args, kw = decode((eargs, ekw))
        return encode(fn(*args, **kw))

    return wrapped
