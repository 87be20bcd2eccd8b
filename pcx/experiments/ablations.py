"""Parameter-ablation experiments (the Paper-1 study set).

Reference: paper_2/paper_1_test.py:40-255 (tol/pnt/rela/scal/eps/grid_cmp).
Each runner returns a structured dict (and prints the reference-style
summary) so it can be scripted or asserted on in tests — replacing the
reference's edit-the-main workflow (SURVEY.md section 5.6).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from pcx import validate
from pcx.bandstructure import KPointSolver
from pcx.config import (NEV, TOL, ProblemConfig, block_width,
                        set_relaxation)
from pcx.operators import maxwell, symbols as sym
from pcx.operators.blocks import h_block
from pcx.solvers import lobpcg as lob

_PI = np.pi
DEFAULT_ALPHA = np.array([_PI, _PI, _PI])


def _collect(results):
    omega = np.stack([r.omega for r in results])
    omega_re = np.stack([r.omega_re for r in results])
    iters = np.array([[r.iterations, r.wall_time] for r in results])
    return omega, omega_re, iters


def tol_cmp(n: int, lattice: str, tols: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV, dtype=jnp.complex128,
            verbose: bool = True):
    """Eigenvalue invariance across solver tolerances
    (reference: paper_1_test.py:40-75)."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    results = []
    for t in tols:
        solver = KPointSolver(cfg, dtype=dtype, tol=t)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for t, it in zip(tols, iters):
            print(f"tol = {t:<5.2e}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"tols": list(tols), "omega": omega, "omega_re": omega_re,
            "iters": iters}


def pnt_cmp(n: int, lattice: str, pnt_factors: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV, dtype=jnp.complex128,
            verbose: bool = True):
    """Eigenvalue invariance across penalty weights gamma
    (reference: paper_1_test.py:77-107; factors scale the default gamma)."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    base = KPointSolver(cfg, dtype=dtype)
    # Same scaling chain as KPointSolver._symbols_np: the unit-cell curl
    # symbol is divided by the lattice constant (spectrum ~ 1/scal^2), so
    # the Gamma shift scales with it (shift/scal^2) — NOT shift_symbol's
    # alpha-only scal argument.
    (shift, rlx), pnt0 = set_relaxation(alpha)
    shift = float(shift) / cfg.scal**2
    m = block_width(nev, rlx)
    results = []
    for f in pnt_factors:
        pnt = pnt0 * f
        d_a = sym.shift_symbol(base._d, base._di, alpha,
                               scal=1.0) / cfg.scal
        b_raw = sym.penalty_symbol(d_a)
        inv = sym.inverse_penalized(b_raw, pnt, shift=shift)
        b = sym.HermSymbol(jnp.asarray(pnt * b_raw.diag),
                           jnp.asarray(pnt * b_raw.sdiag, dtype))
        inv = sym.HermSymbol(jnp.asarray(inv.diag),
                             jnp.asarray(inv.sdiag, dtype))
        d_aj = jnp.asarray(d_a, dtype)
        x0 = maxwell.random_block(jax.random.PRNGKey(0), n, m, dtype)
        h = lambda v: maxwell.ama_bb(v, d_aj, b, base.diel, shift)
        p = lambda v: h_block(v, inv)
        res = jax.jit(lambda x: lob.lobpcg_sep(h, p, x, nev))(x0)
        lam = np.asarray(res.lambdas)
        rep = validate.recompute(lam[:nev], res.x[:nev],
                                 lambda v: maxwell.ama(v, d_aj, base.diel),
                                 shift=shift)
        results.append((f, int(res.iterations), rep))
    if verbose:
        for f, it, rep in results:
            print(f"pnt = {f:<5.2f}*gamma0, iterations = {it}, "
                  f"omega[0] = {rep.omega_re[0]:<8.6f}")
        omega = np.stack([r[2].omega_pnt for r in results])
        omega_re = np.stack([r[2].omega_re for r in results])
        validate.print_standard_deviation(omega, omega_re, nev)
    return results


def rela_cmp(n: int, lattice: str, relas: Sequence[float],
             alpha=DEFAULT_ALPHA, nev: int = NEV, dtype=jnp.complex128,
             verbose: bool = True):
    """Effect of the extra-block relaxation ratio on convergence
    (reference: paper_1_test.py:109-145)."""
    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, dtype=dtype)
    results = []
    for r in relas:
        m = block_width(nev, r)
        x0 = maxwell.random_block(jax.random.PRNGKey(0), n, m, dtype)
        results.append(solver.solve(alpha, x0=x0, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for r, it in zip(relas, iters):
            print(f"Relaxation ratio = {r:<5.2f}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"relas": list(relas), "omega_re": omega_re, "iters": iters}


def scal_cmp(n: int, lattice: str, scals: Sequence[float],
             alpha=DEFAULT_ALPHA, nev: int = NEV, dtype=jnp.complex128,
             verbose: bool = True):
    """Frequency invariance under the lattice scaling constant
    (reference: paper_1_test.py:147-184)."""
    results = []
    for s in scals:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev, scal=s)
        solver = KPointSolver(cfg, dtype=dtype, tol=TOL / s**2)
        results.append(solver.solve(np.asarray(alpha), seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for s, it in zip(scals, iters):
            print(f"scal = {s:<5.2f}, iterations = {int(it[0])}, "
                  f"runtime = {it[1]:<5.2f}s.")
        validate.print_standard_deviation(omega, omega_re, nev)
    return {"scals": list(scals), "omega_re": omega_re, "iters": iters}


def eps_cmp(n: int, lattice: str, eps_values: Sequence[float],
            alpha=DEFAULT_ALPHA, nev: int = NEV, dtype=jnp.complex128,
            verbose: bool = True):
    """Band structure vs the isotropic dielectric constant
    (reference: paper_1_test.py:186-217)."""
    from pcx.operators import dielectric as diel_mod
    results = []
    for e in eps_values:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        diel = diel_mod.chiral_op(n, lattice, eps=e)
        solver = KPointSolver(cfg, dtype=dtype, diel=diel)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for e, om, it in zip(eps_values, omega_re, iters):
            print(f"eps = {e:<5.1f}: omega[0:3] = {np.round(om[:3], 5)}, "
                  f"iters = {int(it[0])}")
    return {"eps": list(eps_values), "omega_re": omega_re, "iters": iters}


def grid_cmp(ns: Sequence[int], lattice: str, alpha=DEFAULT_ALPHA,
             nev: int = NEV, dtype=jnp.complex128, verbose: bool = True):
    """Eigenvalues vs grid size (reference: paper_1_test.py:219-255)."""
    results = []
    for n in ns:
        cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
        solver = KPointSolver(cfg, dtype=dtype)
        results.append(solver.solve(alpha, seed=0))
    omega, omega_re, iters = _collect(results)
    if verbose:
        for n, om, it in zip(ns, omega_re, iters):
            print(f"N = {n}: omega[0:3] = {np.round(om[:3], 5)}, "
                  f"iters = {int(it[0])}, t = {it[1]:<5.2f}s")
    return {"ns": list(ns), "omega_re": omega_re, "iters": iters}


def library_cmp(n: int, lattice: str, alpha=DEFAULT_ALPHA, nev: int = 6,
                verbose: bool = True):
    """Compare against jax's library LOBPCG on the same operator — the
    JAX analog of the cupyx-LOBPCG comparison
    (reference: test_cpxlobpcg, paper_1_test.py:257-270)."""
    from jax.experimental.sparse.linalg import lobpcg_standard

    cfg = ProblemConfig(n=n, lattice=lattice, nev=nev)
    solver = KPointSolver(cfg, dtype=jnp.complex128)
    ours = solver.solve(alpha, seed=0)

    d_a, b, inv, shift = solver.symbols_for(alpha)
    d = 3 * n**3

    def a_mat(x_cols):  # library wants column vectors (d, m)
        blk = x_cols.T.reshape(-1, 3, n, n, n)
        y = maxwell.ama_bb(blk, d_a, b, solver.diel, shift)
        return y.reshape(y.shape[0], -1).T

    m = nev + 4
    key = jax.random.PRNGKey(1)
    x0 = maxwell.random_block(key, n, m, jnp.complex128).reshape(m, -1).T
    theta, _, it = lobpcg_standard(a_mat, x0, m=300)
    lam_lib = np.sort(np.asarray(theta))[:nev] - shift
    lam_ours = (2 * np.pi * np.asarray(ours.omega_re)) ** 2
    if verbose:
        print(f"pcx iters = {ours.iterations}, library iters = {int(it)}")
        print(f"pcx lambdas = {np.round(lam_ours, 6)}")
        print(f"lib lambdas = {np.round(lam_lib, 6)}")
    return lam_ours, lam_lib
