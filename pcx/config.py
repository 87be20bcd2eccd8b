"""Configuration: global defaults, precision policy, problem/solver configs.

Replaces the module-level constants + edit-the-main workflow of the reference
(paper_2/environment.py:23-55, numerical_experiments.py:498-513) with explicit
dataclasses and registries (no string ``eval`` dispatch).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Global defaults (reference: paper_2/environment.py:23-32).
# ---------------------------------------------------------------------------

K = 1          # Stencil half-width (accuracy order 2K).
NEV = 10       # Number of desired eigenpairs.
SCAL = 1.0     # Lattice scaling constant.
TOL = 1e-4     # LOBPCG residual tolerance.
GAP = 20       # Points per Brillouin-zone path segment.

MAXITER = 500
N_SUBSPACE = 40   # Davidson/JD subspace capacity (solvers/davidson.py).

# Lattice type names (reference: paper_2/environment.py:35-40).
SC_F1 = "sc_flat1"
SC_F2 = "sc_flat2"
SC_C = "sc_curv"
BCC_SG = "bcc_sg"
BCC_DG = "bcc_dg"
FCC = "fcc"

ALL_LATTICES = (SC_F1, SC_F2, SC_C, BCC_SG, BCC_DG, FCC)

# Dielectric ("chiroptical") types (reference: paper_2/environment.py:43-46).
TYPE_CHIRAL = "chiral"
TYPE_PSEUDO_TRIVIAL = "pseudochiral_trivial"
TYPE_PSEUDO_CROSSDOF = "pseudochiral_crossdof"
TYPE_PSEUDO_CROSSDOF2 = "pseudochiral_crossdof2"

# Isotropic dielectric constants per lattice
# (reference: paper_2/environment.py:49).
CHIRAL_EPS_EG = {
    SC_F1: 13.0,
    SC_F2: 13.0,
    SC_C: 13.0,
    BCC_SG: 16.0,
    BCC_DG: 16.0,
    FCC: 13.0,
}

# Hermitian positive-definite 3x3 tensors stored as 6 components
# (d11, d22, d33, d12, d13, d23) (reference: paper_2/environment.py:52-55).
PSEUDOCHIRAL_EPS_LOC = [
    np.array([(1 + 0.875**2) ** 0.5, (1 + 0.875**2) ** 0.5, 1.0,
              -1j * 0.875, 0.0, 0.0]),
    np.array([(1 + 0.875**2) ** 0.5, 1.0, (1 + 0.875**2) ** 0.5,
              0.0, 1j * 0.875, 0.0]),
    np.array([1.0346, 0.5059, 0.2595,
              -0.0163 - 0.2319j, 0.027 + 0.0827j, -0.2743 - 0.0076j]),
    np.array([3.0, 3.0, 3.0,
              np.sqrt(3) + 1j, 1j, np.sqrt(2) * (1 + 1j)]) / 5.0,
]


# Precision policy note: precision is selected by the ``dtype`` argument
# threaded through assembly and solvers (complex128 on CPU parity paths,
# complex64 on the GPU production path, see :func:`device_policy`), plus the
# dedicated mixed-precision variant ``lobpcg_sep_mixedprecision`` (reference
# scheme, paper_2/lobpcg.py:494-629).  Solver tuning knobs travel as
# validated ``solver_opts`` kwargs (bandstructure._filter_rs_opts raises on
# unknown keys), so there is no separate config dataclass to drift out of
# sync.


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """What the default device can do, read once per platform.

    ``dtype``: the iterate dtype (the f64-pinned libraries in data/ validate
    complex64 rows, so accelerators iterate in complex64).
    ``accelerator``: selects the production path — pair-layout solver with
    device-built symbols, f64 refine/validation and the segmented solve.
    """

    dtype: type
    accelerator: bool


def device_policy(platform: str | None = None) -> DevicePolicy:
    """Policy for ``platform`` (default: ``jax.default_backend()``).  An
    unknown platform raises instead of inheriting another device's
    defaults."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    import jax.numpy as jnp
    if platform == "cpu":
        return DevicePolicy(jnp.complex128, accelerator=False)
    if platform in ("gpu", "cuda"):
        return DevicePolicy(jnp.complex64, accelerator=True)
    raise ValueError(f"no device policy for platform {platform!r} "
                     f"(supported: cpu, gpu)")


# Column-sized temporaries one operator apply holds at once (split planes,
# the complex FFT buffer and its workspace, the penalty term), and the share
# of device memory an apply may take: the solver state (X, HX, P, HP, W, HW
# and the stacked Rayleigh-Ritz bases) holds the rest.
_APPLY_TEMPS = 8
_APPLY_SHARE = 0.25


def apply_chunk_for(n: int, itemsize: int, bytes_limit, m: int = 16) -> int:
    """Column chunk for the operator apply of an (m, 3, n, n, n) block with
    ``itemsize``-byte complex entries on a device with ``bytes_limit`` bytes
    (``device.memory_stats()["bytes_limit"]``); 0 = apply all columns at
    once.  None (a device that reports no limit) never chunks."""
    if not bytes_limit:
        return 0
    col_bytes = 3 * n**3 * itemsize * _APPLY_TEMPS
    budget = _APPLY_SHARE * bytes_limit
    if col_bytes * m <= budget:
        return 0
    return max(1, int(budget // col_bytes))


def compile_cache_dir(root: str | None = None) -> str:
    """JAX's persistent compile cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``."""
    import os
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def enable_compile_cache(root: str | None = None) -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`;
    returns the directory."""
    import jax
    path = compile_cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """One Maxwell eigenproblem instance."""

    n: int                                   # Grid size N (DoFs = 3N^3).
    lattice: str = SC_C                      # Lattice flag name.
    diel_type: str = TYPE_CHIRAL             # Dielectric operator type.
    eps_opt: int = 0                         # Preset index for pseudochiral.
    k: int = K                               # Stencil half-width.
    scal: float = SCAL                       # Lattice scaling constant.
    nev: int = NEV

    def __post_init__(self):
        if self.lattice is not None and self.lattice not in ALL_LATTICES:
            raise ValueError(f"Unknown lattice {self.lattice!r}; "
                             f"expected one of {ALL_LATTICES}.")


def set_relaxation(alpha: Sequence[float], scal: float = SCAL):
    """Spectral shift, block-relaxation ratio, and penalty gamma.

    Reference: paper_2/discretization.py:31-49.  Returns ((shift, rlx), pnt).
    The shift guarantees non-singularity at the Gamma point; the penalty
    gamma ("pnt") weights the divergence penalty B'B.
    """
    nrm_alpha = float(np.linalg.norm(np.asarray(alpha) / scal))
    if nrm_alpha > 1:
        opt = (0.0, 0.6)
        pnt = 4 * np.pi * np.pi
    elif nrm_alpha == 0:
        opt = (1.0 / np.pi, 0.6)
        pnt = 4 * np.pi * np.pi
    else:
        opt = (nrm_alpha, 0.6)
        pnt = (2 * np.pi / nrm_alpha) ** 2
    return opt, pnt


def block_width(nev: int, rlx: float = 0.6) -> int:
    """LOBPCG block width m = nev + round(rlx * nev)
    (reference: numerical_experiments.py:64)."""
    return nev + round(nev * rlx)
