"""Grid-sharded Maxwell LOBPCG under shard_map: the TP/SP axis of pcx.

Scales a single k-point solve past one chip's HBM (SURVEY.md section 5.7):
the (m, 3, Nx, Ny, Nz) Fourier-space block is sharded on its LAST grid axis
over mesh axis "grid"; each operator application is

    a_block(-conj D_A)          local   (z-sharded symbols)
    pencil fftn                 1 all_to_all (-> x-sharded)
    pointwise eps^{-1}          local   (x-sharded dielectric arrays)
    pencil ifftn                1 all_to_all (-> z-sharded)
    a_block(D_A) + penalty      local

and every Gram / norm inside LOBPCG psums over "grid"
(solvers are reduce_axis-aware).  The k-point sweep is the embarrassingly
parallel "k" axis: independent solves vmapped/placed per device.

Pointwise dielectrics (chiral scale, pseudochiral trivial) shard exactly;
the cross-DoF averaging stencils couple along sharded axes and need halo
exchange — single-chip only for now.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from pcx.config import MAXITER, TOL
from pcx.operators.blocks import a_block, h_block
from pcx.operators.dielectric import make_crossdof_apply, _AX_I
from pcx.parallel.fft import pencil_fftn, pencil_ifftn, sharded_roll
from pcx.parallel.mesh import GRID_AXIS
from pcx.solvers import lobpcg as lob


def make_sharded_crossdof(diag, masks, sten, eps3, eps4, eps5,
                          n_shards: int, axis_name: str = GRID_AXIS):
    """Cross-DoF eps^{-1} apply for the pencil (x-sharded) layout: the
    averaging stencils along the sharded x-axis run through halo-exchange
    rolls (one k-plane ppermute per offset); z/y stencils stay local.
    ``diag``/``masks`` must be the LOCAL x-shards."""

    def roll_fn(v, shift, axis):
        if axis % v.ndim == _AX_I % v.ndim and n_shards > 1:
            return sharded_roll(v, shift, axis, axis_name, n_shards)
        return jnp.roll(v, shift, axis=axis)

    apply = make_crossdof_apply(sten, eps3, eps4, eps5, roll_fn)
    return lambda x: apply((diag, masks), x)


def sharded_ama_bb(x, d_a, b, diel_apply, shift, axis_name=GRID_AXIS):
    """Penalized operator on a z-sharded local block; ``diel_apply`` acts in
    the x-sharded (pencil) layout between the distributed FFT pair — either
    a pointwise scale array or any local callable (e.g. h_block for the
    pseudochiral tensor)."""
    y = a_block(x, -d_a.conj())
    y = pencil_fftn(y, axis_name)
    y = diel_apply(y) if callable(diel_apply) else y * diel_apply
    y = pencil_ifftn(y, axis_name)
    y = a_block(y, d_a)
    y = y + h_block(x, b)
    return y + shift * x


def solve_kpoint_sharded(
    mesh: Mesh,
    d_a: jnp.ndarray,                   # (3, N, N, N) complex, full
    b: Tuple[jnp.ndarray, jnp.ndarray],
    inv: Tuple[jnp.ndarray, jnp.ndarray],
    scale: jnp.ndarray,                 # pointwise eps^{-1}: (3,N,N,N) array
    shift: float,                       # or (diag, sdiag) Hermitian tensor
    x0: jnp.ndarray,                    # (m, 3, N, N, N)
    nev: int,
    tol: float = TOL,
    maxiter: int = MAXITER,
    **solver_kw,
):
    """One grid-sharded LOBPCG solve.  Arrays may be passed unsharded; the
    in_specs place them (z-sharded symbols/fields, x-sharded dielectric).

    ``scale`` is one of
      * the pointwise eps^{-1} multiplier array (chiral / smooth),
      * a (diag, sdiag) pair for the pseudochiral-trivial Hermitian tensor
        (both pointwise in the pencil layout), or
      * ``{"crossdof": (diag, masks, sten, eps3, eps4, eps5)}`` for the
        cross-DoF averaging dielectric — its x-axis stencils then run
        through halo-exchange rolls (make_sharded_crossdof) while y/z
        stencils stay local (reference CSR build: disc.py:403-453).
    """
    zspec3 = P(None, None, None, GRID_AXIS)     # (3, Nx, Ny, Nz) on z
    xspec3 = P(None, GRID_AXIS, None, None)     # (3, Nx, Ny, Nz) on x
    fspec = P(None, None, None, None, GRID_AXIS)
    cdtype = x0.dtype
    is_cross = isinstance(scale, dict) and "crossdof" in scale
    is_herm = not is_cross and isinstance(scale, (tuple, list))
    if is_cross:
        diag, masks, sten, e3, e4, e5 = scale["crossdof"]
        diel_args = (diag, masks)
        diel_specs = (xspec3, xspec3)
    else:
        diel_args = tuple(scale) if is_herm else (scale,)
        diel_specs = (xspec3, xspec3) if is_herm else (xspec3,)
    n_shards = mesh.shape[GRID_AXIS]

    @partial(
        shard_map, mesh=mesh,
        in_specs=(zspec3, zspec3, zspec3, zspec3, zspec3) + diel_specs
        + (fspec,),
        out_specs=(P(), fspec, P(), P(), P()),
        check_vma=False,
    )
    def _run(d_a, b_d, b_s, i_d, i_s, *rest):
        *diel_local, x0 = rest
        if is_cross:
            diel = make_sharded_crossdof(diel_local[0], diel_local[1],
                                         sten, e3, e4, e5, n_shards)
        elif is_herm:
            diel = lambda v: h_block(v, (diel_local[0], diel_local[1]))
        else:
            diel = diel_local[0]
        h = lambda v: sharded_ama_bb(v, d_a, (b_d, b_s), diel,
                                     jnp.asarray(shift, cdtype))
        p = lambda v: h_block(v, (i_d, i_s))
        solver_kw.setdefault("rr_mode", "f64")
        res = lob.lobpcg_sep(h, p, x0, nev, tol=tol, maxiter=maxiter,
                             reduce_axis=GRID_AXIS, **solver_kw)
        return (res.lambdas, res.x, res.iterations, res.status,
                res.res_history)

    lam, x, it, st, his = _run(d_a, b[0], b[1], inv[0], inv[1],
                               *diel_args, x0)
    return lob.SolveResult(lam, x, it, st, his)
