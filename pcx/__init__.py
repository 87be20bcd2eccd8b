"""pcx — Photonic Crystals on XLA.

A JAX framework (GPU production path) for linear Maxwell eigenvalue
problems in 3D photonic crystals: band-structure computation for periodic
dielectric lattices via a mimetic finite-difference (Yee) discretization
with kernel compensation, solved matrix-free in Fourier space with a
blocked LOBPCG eigensolver.

Capability reference: Epsilon-79th/linear-eigenvalue-problems-in-photonic-crystals
(see SURVEY.md).  The design:

* the LOBPCG iterate lives in Fourier space, so one batched 3-D FFT pair per
  operator application and a zero-FFT block-diagonal preconditioner
  (reference: paper_2/pcfft.py:130-181);
* all block multiplies are fused elementwise ops over ``(m, 3, N, N, N)``
  arrays (reference: paper_2/_kernels.py CUDA kernels);
* the solver is a fixed-shape ``lax.while_loop`` under ``jax.jit`` with
  mask-based soft locking (reference: paper_2/lobpcg.py:325-492);
* multi-chip scaling uses ``jax.sharding.Mesh`` axes ("k", "grid") with a
  pencil-decomposed sharded FFT, not a communication backend.
"""

from pcx import config
from pcx.config import (
    ProblemConfig,
    NEV,
    TOL,
    GAP,
    MAXITER,
    SCAL,
    K,
)
from pcx import lattices
from pcx import stencils
from pcx import geometry
from pcx import utils

__version__ = "0.1.0"
