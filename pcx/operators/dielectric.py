"""Inverse-dielectric operators M = eps^{-1} applied in physical space.

The reference builds these as index scatters (chiral,
paper_2/discretization.py:352-366) or GPU CSR matrices assembled with sparse
Kronecker products (pseudochiral, paper_2/discretization.py:368-453).  Here
all three are mask-based elementwise/stencil ops with no sparse storage:

* chiral:                y = where(edge_mask, x / eps1, x)
* pseudochiral trivial:  pointwise Hermitian 3x3 block with spatially varying
                         diag (edge masks) and sdiag (volume mask) —
                         a single ``h_block`` apply;
* pseudochiral crossdof: same diag, but off-diagonal coupling through
                         separable 2k-wide averaging stencils restricted by
                         the per-component edge masks (replaces
                         sparse_kron + CSR SpMV entirely).

All builders return a ``DielectricOp`` whose ``apply`` is jit-traceable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from pcx import geometry
from pcx import stencils
from pcx.config import (
    CHIRAL_EPS_EG,
    PSEUDOCHIRAL_EPS_LOC,
    TYPE_CHIRAL,
    TYPE_PSEUDO_CROSSDOF,
    TYPE_PSEUDO_TRIVIAL,
)
from pcx.operators.blocks import h_block
from pcx.utils import real_dtype


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class DielectricOp:
    """A jit-traceable inverse-dielectric operator.

    Registered as a JAX pytree: ``params`` (the mask/coefficient arrays) are
    the leaves, so an op passes straight through ``jax.jit`` / ``jax.vmap``
    as an ARGUMENT.  Never close a jitted function over an op: closure
    capture embeds the arrays as program constants, which bloats the
    executable by the full mask size and ties it to one geometry.

    ``diag`` / ``offdiag_abs_row_sums``: optional structural accessors used
    by the SDD / HPD censuses (reference: check_sdd, paper_2_test.py:259-297)
    — matrix-free equivalents of the reference's CSR row scans.
    """
    name: str
    apply_fn: Callable                  # (params, x) -> y, params-explicit
    params: tuple = ()
    diag: Optional[Callable[[], jnp.ndarray]] = None
    offdiag_abs_row_sums: Optional[Callable[[], jnp.ndarray]] = None
    # Static construction facts needed by precision-variant applies (e.g.
    # the f64 pair path, pcx.operators.rs): hashable tuple of (key, value).
    meta: tuple = ()

    def __call__(self, x):
        return self.apply_fn(self.params, x)

    def apply(self, x):
        return self.apply_fn(self.params, x)

    def tree_flatten(self):
        return (self.params,), (self.name, self.apply_fn, self.diag,
                                self.offdiag_abs_row_sums, self.meta)

    @classmethod
    def tree_unflatten(cls, aux, children):
        name, apply_fn, diag, offdiag, meta = aux
        return cls(name, apply_fn, children[0], diag, offdiag, meta)

    def sdd_violations(self) -> int:
        """Rows where strict diagonal dominance fails."""
        if self.diag is None or self.offdiag_abs_row_sums is None:
            raise NotImplementedError(f"{self.name} has no SDD accessors")
        d = self.diag()
        s = self.offdiag_abs_row_sums()
        return int(jnp.sum(d <= s))


def identity_op() -> DielectricOp:
    """Vacuum (eps = 1) — used by operator-only tests."""
    return DielectricOp("identity", lambda p, x: x)


def scalar_field_op(inv_eps: jnp.ndarray) -> DielectricOp:
    """Spatially varying scalar eps^{-1} on a (N,N,N) or (3,N,N,N) grid
    (covers the smooth-eps ablation, paper_2/paper_2_test.py:146-190)."""
    inv_eps = np.asarray(inv_eps)
    return DielectricOp("scalar_field", lambda p, x: x * p[0], (inv_eps,))


def smooth_eps_op(n: int, eps_func: Callable = None,
                  dtype=jnp.float64) -> DielectricOp:
    """Smooth spatially varying scalar eps evaluated at the staggered edge
    DoF coordinates (reference: largek_smooth_cmp, paper_2_test.py:146-190;
    default eps(x,y,z) = 8.9 sin(2 pi (x+y+z)) + 13)."""
    if eps_func is None:
        eps_func = lambda x, y, z: 8.9 * np.sin(2 * np.pi * (x + y + z)) + 13.0
    from pcx import geometry
    inv = np.empty((3, n, n, n))
    for c in range(3):
        x, y, z = geometry.edge_coords(n, c)
        inv[c] = 1.0 / np.broadcast_to(eps_func(x, y, z), (n, n, n))
    return scalar_field_op(inv.astype(dtype))


def chiral_op(n: int, lattice: Optional[str], eps: float = 0.0,
              dtype=jnp.float64, edge_mask: Optional[np.ndarray] = None) -> DielectricOp:
    """Isotropic two-material eps: divide by eps1 inside the material region.

    Reference: chiral_handle, paper_2/discretization.py:352-366.
    """
    if not eps:
        eps = CHIRAL_EPS_EG[lattice]
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    # Multiply is cheaper than select+divide and fuses as one elementwise
    # op: scale = 1/eps at material DoFs, 1 elsewhere.  Params stay NUMPY:
    # the solver places them (KPointSolver._place).
    scale = np.where(edge_mask, 1.0 / eps, 1.0).astype(dtype)
    return DielectricOp("chiral", lambda p, x: x * p[0], (scale,))


def _eps_components(lattice: str, eps_opt: int, eps_mat):
    """(d11,d22,d33,d12,d13,d23) of eps^{-1}, already divided by the chiral
    constant (reference: discretization.py:376-380, 411-414)."""
    if eps_mat is None:
        return PSEUDOCHIRAL_EPS_LOC[eps_opt] / CHIRAL_EPS_EG[lattice]
    return np.asarray(eps_mat)


def pseudochiral_trivial_op(n: int, lattice: Optional[str], eps_opt: int = 0,
                            eps_mat=None, dtype=jnp.complex128,
                            edge_mask: Optional[np.ndarray] = None,
                            vol_mask: Optional[np.ndarray] = None) -> DielectricOp:
    """Hermitian tensor eps^{-1} with trivial (collocated) cross-DoF coupling.

    diag_c = eps_loc[c].real at material edge DoFs of component c, else 1;
    sdiag  = eps_loc[3..5] at material volume cells, else 0.
    Reference: pseudochiral_trivial_handle, paper_2/discretization.py:368-401.
    """
    eps_loc = _eps_components(lattice, eps_opt, eps_mat)
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    if vol_mask is None:
        vol_mask = geometry.volume_mask(n, lattice)

    diag = np.ones((3, n, n, n), dtype=np.float64)
    for c in range(3):
        diag[c] = np.where(edge_mask[c], eps_loc[c].real, 1.0)
    sdiag = np.stack([np.where(vol_mask, eps_loc[3 + c], 0.0) for c in range(3)])

    rdt = real_dtype(dtype)
    diag_j = diag.astype(rdt)
    sdiag_j = sdiag.astype(dtype)

    def offdiag_abs():
        a = jnp.abs(sdiag_j)
        return jnp.stack((a[0] + a[1], a[0] + a[2], a[1] + a[2]))

    return DielectricOp("pseudochiral_trivial",
                        lambda p, x: h_block(x, (p[0], p[1])),
                        (diag_j, sdiag_j),
                        diag=lambda: diag_j,
                        offdiag_abs_row_sums=offdiag_abs)


# ---------------------------------------------------------------------------
# Cross-DoF coupling via separable averaging stencils.
# ---------------------------------------------------------------------------

def _avg(x: jnp.ndarray, sten, axis: int, transpose: bool,
         roll_fn=None) -> jnp.ndarray:
    """1-D circulant averaging along ``axis``.

    Forward form C:   (C x)[r]  = sum_{o=1-k..k} sten[o+k-1] * x[(r+o) % n]
    Transposed  C^T:  (C^T x)[r] = sum_{o}      sten[o+k-1] * x[(r-o) % n]
    Matches the circulant COO built at paper_2/discretization.py:428-431.
    ``roll_fn(x, shift, axis)`` defaults to jnp.roll; the grid-sharded path
    substitutes a halo-exchange roll for the sharded axis.
    """
    if roll_fn is None:
        roll_fn = lambda v, s, a: jnp.roll(v, s, axis=a)
    k = len(sten) // 2
    out = None
    for j, w in enumerate(sten):
        o = j - (k - 1)           # offsets 1-k .. k
        shift = o if transpose else -o
        term = w * roll_fn(x, shift, axis)
        out = term if out is None else out + term
    return out


# Axis indices within (..., 3, N, N, N): i -> -3, j -> -2, k -> -1, and the
# (pair) -> (row component, col component, T factors as (axis, transpose)).
_AX_I, _AX_J, _AX_K = -3, -2, -1
_PAIR_DEFS = {
    "12": (0, 1, ((_AX_K, False), (_AX_J, True))),
    "13": (0, 2, ((_AX_K, False), (_AX_I, True))),
    "23": (1, 2, ((_AX_J, False), (_AX_I, True))),
}


def make_crossdof_apply(sten, eps3, eps4, eps5, roll_fn=None):
    """Cross-DoF eps^{-1} apply from (averaging stencil, off-diagonal eps
    entries); the spatial arrays come in as ``params = (diag, masks)``.
    Shared by the single-device op and the grid-sharded path (which passes a
    halo-exchange roll_fn)."""

    def t_apply(x, axes, transpose_all):
        for axis, tr in axes:
            x = _avg(x, sten, axis, tr != transpose_all, roll_fn)
        return x

    def apply(params, x):
        diag_j, masks = params

        def m_apply(x, row_c, col_c, axes):
            # (R_row T + T R_col)/2 applied to x.
            return 0.5 * (masks[row_c] * t_apply(x, axes, False)
                          + t_apply(masks[col_c] * x, axes, False))

        def mt_apply(x, row_c, col_c, axes):
            # transpose: (T^T R_row + R_col T^T)/2 applied to x.
            return 0.5 * (t_apply(masks[row_c] * x, axes, True)
                          + masks[col_c] * t_apply(x, axes, True))

        # Cast the eps scalars to the input dtype: Python complex scalars
        # would promote complex64 blocks to complex128.
        e3 = jnp.asarray(eps3, x.dtype)
        e4 = jnp.asarray(eps4, x.dtype)
        e5 = jnp.asarray(eps5, x.dtype)
        x0, x1, x2 = x[..., 0, :, :, :], x[..., 1, :, :, :], x[..., 2, :, :, :]
        r12, c12, a12 = _PAIR_DEFS["12"]
        r13, c13, a13 = _PAIR_DEFS["13"]
        r23, c23, a23 = _PAIR_DEFS["23"]
        y0 = (diag_j[0] * x0
              + e3 * m_apply(x1, r12, c12, a12)
              + e4 * m_apply(x2, r13, c13, a13))
        y1 = (diag_j[1] * x1
              + jnp.conj(e3) * mt_apply(x0, r12, c12, a12)
              + e5 * m_apply(x2, r23, c23, a23))
        y2 = (diag_j[2] * x2
              + jnp.conj(e4) * mt_apply(x0, r13, c13, a13)
              + jnp.conj(e5) * mt_apply(x1, r23, c23, a23))
        return jnp.stack((y0, y1, y2), axis=-4)

    return apply


def pseudochiral_crossdof_op(n: int, lattice: Optional[str], eps_opt: int = 0,
                             eps_mat=None, k: int = 1, dtype=jnp.complex128,
                             edge_mask: Optional[np.ndarray] = None) -> DielectricOp:
    """Hermitian tensor eps^{-1} with 2k-wide cross-DoF averaging coupling —
    the novel HPD discretization of Paper 2.

    The reference assembles, for component pair (a, b), the CSR matrix
      M_ab = ( R_a T_ab + T_ab R_b ) / 2
    where R_c restricts to the material edge DoFs of component c and T_ab is
    a Kronecker product of 1-D averaging circulants
    (paper_2/discretization.py:403-453).  With the flat index i + j*N + k*N^2
    (i fastest) and the kron convention row = r_outer * n_inner + r_inner,
      T_12 = C  on axis k (slow)  o  C^T on axis j,
      T_13 = C  on axis k         o  C^T on axis i,
      T_23 = C  on axis j         o  C^T on axis i,
    which we apply as separable jnp.roll stencils — no sparse matrix.
    """
    eps_loc = _eps_components(lattice, eps_opt, eps_mat)
    if edge_mask is None:
        edge_mask = geometry.edge_mask(n, lattice)
    sten = tuple(float(w) for w in stencils.mfd_stencil(k, 0))

    rdt = real_dtype(dtype)
    diag = np.ones((3, n, n, n), dtype=np.float64)
    for c in range(3):
        diag[c] = np.where(edge_mask[c], eps_loc[c].real, 1.0)
    diag_j = diag.astype(rdt)
    masks = np.asarray(edge_mask, dtype=rdt)
    e3, e4, e5 = (complex(eps_loc[3]), complex(eps_loc[4]), complex(eps_loc[5]))

    apply = make_crossdof_apply(sten, e3, e4, e5)
    pair_defs = _PAIR_DEFS

    def offdiag_abs():
        # |M_ab| entries factor exactly: entry = T_rc * (mask_row_r +
        # mask_col_c)/2 with T from real stencils, so |M| row sums are the
        # same separable stencils with |weights| (matrix-free SDD census;
        # the reference scans the CSR, paper_2_test.py:259-269).
        sten_abs = tuple(abs(w) for w in sten)
        one = jnp.ones((n, n, n), diag_j.dtype)

        def tabs(x, axes, transpose_all):
            for axis, tr in axes:
                x = _avg(x, sten_abs, axis, tr != transpose_all)
            return x

        def m_rowsum(row_c, col_c, axes):
            return 0.5 * (masks[row_c] * tabs(one, axes, False)
                          + tabs(masks[col_c], axes, False))

        def mt_rowsum(row_c, col_c, axes):
            return 0.5 * (tabs(masks[row_c], axes, True)
                          + masks[col_c] * tabs(one, axes, True))

        r12, c12, a12 = pair_defs["12"]
        r13, c13, a13 = pair_defs["13"]
        r23, c23, a23 = pair_defs["23"]
        s0 = abs(e3) * m_rowsum(r12, c12, a12) + abs(e4) * m_rowsum(r13, c13, a13)
        s1 = (abs(e3) * mt_rowsum(r12, c12, a12)
              + abs(e5) * m_rowsum(r23, c23, a23))
        s2 = (abs(e4) * mt_rowsum(r13, c13, a13)
              + abs(e5) * mt_rowsum(r23, c23, a23))
        return jnp.stack((s0, s1, s2))

    return DielectricOp("pseudochiral_crossdof", apply, (diag_j, masks),
                        diag=lambda: diag_j,
                        offdiag_abs_row_sums=offdiag_abs,
                        meta=(("sten", sten), ("eps", (e3, e4, e5))))


DIELECTRIC_REGISTRY: Dict[str, Callable] = {
    TYPE_CHIRAL: chiral_op,
    TYPE_PSEUDO_TRIVIAL: pseudochiral_trivial_op,
    TYPE_PSEUDO_CROSSDOF: pseudochiral_crossdof_op,
}


def build(diel_type: str, n: int, lattice: Optional[str], eps_opt: int = 0,
          eps_mat=None, k: int = 1, dtype=jnp.complex128) -> DielectricOp:
    """Registry dispatch (replaces the reference's string-eval dispatch,
    numerical_experiments.py:230, 349)."""
    if diel_type is None or diel_type == "identity":
        return identity_op()
    if diel_type == TYPE_CHIRAL:
        return chiral_op(n, lattice, eps=float(eps_opt) if eps_opt else 0.0,
                         dtype=real_dtype(dtype))
    if diel_type == TYPE_PSEUDO_TRIVIAL:
        return pseudochiral_trivial_op(n, lattice, eps_opt, eps_mat, dtype=dtype)
    if diel_type == TYPE_PSEUDO_CROSSDOF:
        return pseudochiral_crossdof_op(n, lattice, eps_opt, eps_mat, k=k, dtype=dtype)
    raise KeyError(f"Unknown dielectric type {diel_type!r}; "
                   f"known: {sorted(DIELECTRIC_REGISTRY)}")
