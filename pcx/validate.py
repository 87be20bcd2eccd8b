"""Validation & postprocessing: eigenvalue recompute, spurious-mode check,
frequency normalization, statistics.

Reference: recompute_normalize_print + helpers,
paper_2/numerical_experiments.py:87-202.  The core invariant: eigenvalues of
the *penalized* operator, recomputed as Rayleigh quotients of the
*unpenalized* A M A^H, must agree — otherwise the eigenvector has a
divergence component (spurious mode) and the run is invalid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax.numpy as jnp

from pcx.config import SCAL
from pcx.utils import RED, RESET, dots, norms, sqrt_robust


class SpuriousModeError(RuntimeError):
    """Raised when penalized and recomputed frequencies deviate > 1e-3
    (reference: numerical_experiments.py:152-156)."""


@dataclasses.dataclass
class ValidationReport:
    omega_pnt: np.ndarray      # frequencies from penalized eigenvalues
    omega_re: np.ndarray       # recomputed (unpenalized Rayleigh quotient)
    residuals: np.ndarray      # per-mode residual norms of A M A^H
    spurious: bool

    def table(self) -> str:
        lines = ["| i  |    omega   |  omega_re  | |omega-omega_re| | residual  |"]
        for i, (l1, l2, r) in enumerate(
                zip(self.omega_pnt, self.omega_re, self.residuals)):
            lines.append(f"| {i + 1:<2d} | {l1:<10.6f} | {l2:<10.6f} "
                         f"|    {abs(l1 - l2):<10.3e}    | {r:<6.3e} |")
        return "\n".join(lines)


def recompute(lambdas_in, x=None, a_apply=None, shift: float = 0.0,
              scal: float = SCAL, spurious_tol: float = 1e-3,
              raise_on_spurious: bool = True, verbose: bool = False,
              stats=None) -> ValidationReport:
    """Recompute eigenvalues against the unpenalized operator and convert to
    frequencies omega = sqrt(lambda) * scal / (2 pi).

    Either pass (x, a_apply) to compute the Rayleigh quotients here (eager
    device ops — CPU paths), or ``stats = (lam_re, residual_norms)``
    precomputed by a jitted device program (the solver's own stats or
    refine program).

    Reference: recompute_normalize_print, numerical_experiments.py:87-158.
    """
    lambdas = np.asarray(lambdas_in, dtype=float)
    if shift > 0.0:
        lambdas = lambdas - shift

    if stats is not None:
        lam_re = np.asarray(stats[0], dtype=float)[: lambdas.shape[0]]
        res = np.asarray(stats[1], dtype=float)[: lambdas.shape[0]]
    else:
        adax = a_apply(x)
        lam_re = np.asarray((dots(x, adax) / dots(x, x)).real)
        r = adax - jnp.asarray(lambdas, dtype=x.dtype).reshape(
            (-1,) + (1,) * (x.ndim - 1)) * x
        res = np.asarray(norms(r))

    # NaN cross-checks (reference: numerical_experiments.py:113-132).
    nan_pnt = np.isnan(lambdas)
    nan_re = np.isnan(lam_re)
    lam_re = np.where(nan_re & ~nan_pnt, lambdas, lam_re)

    omega_pnt = np.array([sqrt_robust(v) * scal / (2 * np.pi) for v in lambdas])
    omega_re = np.array([sqrt_robust(v) * scal / (2 * np.pi) for v in lam_re])

    # Absolute deviation (the reference checks the SIGNED difference,
    # numerical_experiments.py:152, which misses modes where the recomputed
    # frequency exceeds the penalized one — observed in single precision).
    # Non-finite frequencies are spurious by definition: NaN compares
    # False against any tolerance, so without this a fully-NaN solve
    # (degenerate basis after long floor-wobble) would PASS the gate and
    # be recorded into a library (observed: seven 500-iteration MAXITER
    # points wrote NaN rows).  sqrt_robust clamps the legitimate tiny
    # negatives at Gamma to 0, so finite inputs stay finite here.
    spurious = bool(np.any(np.abs(omega_pnt - omega_re) > spurious_tol)
                    | np.any(~np.isfinite(omega_pnt))
                    | np.any(~np.isfinite(omega_re)))
    report = ValidationReport(omega_pnt, omega_re, res, spurious)
    if verbose:
        print(report.table())
    if spurious and raise_on_spurious:
        raise SpuriousModeError(f"{RED}Spurious eigenvalues occur.{RESET}")
    return report


def print_standard_deviation(omega_pnt: np.ndarray, omega_re: np.ndarray,
                             nev: Optional[int] = None):
    """Std-dev table across repeated runs
    (reference: numerical_experiments.py:179-187)."""
    sd_pnt = np.std(np.asarray(omega_pnt), axis=0)
    sd_re = np.std(np.asarray(omega_re), axis=0)
    nev = nev or len(sd_pnt)
    print("\nStandard deviation of each eigenvalue:")
    print("| i  |  std_pnt  |  std_re   |")
    for i in range(nev):
        print(f"| {i + 1:<2d} | {sd_pnt[i]:<6.3e} | {sd_re[i]:<6.3e} |")
    return sd_pnt, sd_re


def observed_order(freqs_by_n: dict, verbose: bool = True) -> np.ndarray:
    """Observed convergence order from a grid-refinement study
    {N: omega array}, Ns doubling: order = log2(|d1| / |d2|)
    (reference: paper_2_test.py:363-401 precision_test)."""
    ns = sorted(freqs_by_n)
    if len(ns) < 3:
        raise ValueError("Need at least 3 grid sizes.")
    orders = []
    for i in range(len(ns) - 2):
        f0, f1, f2 = (np.asarray(freqs_by_n[ns[i + j]]) for j in range(3))
        d1 = np.abs(f1 - f0)
        d2 = np.abs(f2 - f1)
        orders.append(np.log2(np.maximum(d1, 1e-300) / np.maximum(d2, 1e-300)))
    orders = np.array(orders)
    if verbose:
        for i, row in enumerate(orders):
            print(f"N={ns[i]}->{ns[i + 2]}: orders {np.round(row, 2)}")
    return orders
