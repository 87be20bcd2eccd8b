"""Matrix-free penalized Maxwell operator in Fourier space.

Implements the kernel-compensated eigenproblem
    (A M A^H + pnt * B^H B + shift) x = lambda x
with the Fourier-domain-iterate design of the reference's Paper-2 code
(paper_2/pcfft.py:130-181): the LOBPCG block lives in Fourier space, so one
operator application costs exactly one batched forward + inverse 3-D FFT
(bracketing the physical-space dielectric apply), and both the divergence
penalty and the preconditioner are zero-FFT block-diagonal multiplies.

    ama(x)    = Ablk(D_A) . ifftn . M . fftn . Ablk(-conj(D_A)) x
    ama_bb(x) = ama(x) + Hblk(pnt * B) x + shift * x
    precond(x)= Hblk((A A^H + pnt B^H B + shift)^{-1}) x
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from pcx import lattices
from pcx.config import ProblemConfig, SCAL, set_relaxation
from pcx.operators import symbols as sym
from pcx.operators import dielectric as diel_mod
from pcx.operators import dft as dft_mod
from pcx.operators.blocks import a_block, h_block
from pcx.utils import real_dtype

_SPATIAL_AXES = (-3, -2, -1)


def ama(x: jnp.ndarray, d_a: jnp.ndarray, diel: Callable,
        dft: Optional[dft_mod.DFTMats] = None) -> jnp.ndarray:
    """A M A^H applied to a Fourier-space block (..., 3, N, N, N).

    Reference: AMA, paper_2/pcfft.py:130-158 (2 batched 3-D FFTs per call).
    ``dft``: optional explicit twiddle matrices — the transforms then run as
    full-precision matmuls (pcx.operators.dft) instead of the backend FFT
    (KPointSolver fft_mode="matmul"; slower than cuFFT on the GPU).
    """
    y = a_block(x, -d_a.conj())
    if dft is None:
        y = jnp.fft.fftn(y, axes=_SPATIAL_AXES)
        y = diel(y)
        y = jnp.fft.ifftn(y, axes=_SPATIAL_AXES)
    else:
        y = dft_mod.dft3(y, dft.fwd)
        y = diel(y)
        y = dft_mod.dft3(y, dft.inv)
    return a_block(y, d_a)


def ama_bb(x: jnp.ndarray, d_a: jnp.ndarray, b: sym.HermSymbol,
           diel: Callable, shift: float = 0.0,
           dft: Optional[dft_mod.DFTMats] = None) -> jnp.ndarray:
    """A M A^H + pnt B^H B (+ shift) — the penalized HPD operator.

    ``b`` must already include the penalty factor pnt.
    Reference: AMA_BB, paper_2/pcfft.py:160-181.
    """
    y = ama(x, d_a, diel, dft=dft) + h_block(x, b)
    static_zero = isinstance(shift, (int, float)) and shift == 0.0
    if not static_zero:
        y = y + shift * x
    return y


@dataclasses.dataclass(frozen=True)
class MaxwellProblem:
    """Assembled single-k-point eigenproblem: symbols + dielectric + policy.

    Mirrors uniform_initialization + pc_mfd_handle
    (paper_2/numerical_experiments.py:33-85).
    """

    n: int
    alpha: Tuple[float, float, float]
    d_a: jnp.ndarray                  # curl symbol, scaled (3,N,N,N) complex
    b: sym.HermSymbol                 # pnt-scaled penalty symbol
    inv: sym.HermSymbol               # preconditioner symbol
    diel: diel_mod.DielectricOp
    shift: float
    pnt: float
    scal: float = SCAL

    # -- operator handles (all jit-traceable) --------------------------------

    def a_apply(self, x):
        """Unpenalized A M A^H — used by the validation recompute
        (reference: numerical_experiments.py:81)."""
        return ama(x, self.d_a, self.diel)

    def h_apply(self, x):
        """Penalized operator incl. shift (reference: num_exp.py:82)."""
        return ama_bb(x, self.d_a, self.b, self.diel, self.shift)

    def p_apply(self, x):
        """Preconditioner (A A^H + pnt B^H B + shift)^{-1}: zero FFTs
        (reference: num_exp.py:83)."""
        return h_block(x, self.inv)

    @property
    def dof_shape(self):
        return (3, self.n, self.n, self.n)


def assemble_symbols(n: int, k: int, ct: np.ndarray, alpha, pnt: float,
                     shift: float, scal: float = SCAL, dtype=jnp.complex128):
    """Build (d_a, b, inv) for one dimensionless BZ wave vector alpha.

    Scaling semantics (reference chain at SCAL=1, num_exp.py:55-63; made
    consistent for any scal): D_A = (D_unit + i alpha D0) / scal, the
    shift is passed already in physical units."""
    d, di = sym.curl_symbols(n, k, ct, scal=1.0)
    d_a = sym.shift_symbol(d, di, alpha, scal=1.0) / scal
    b_raw = sym.penalty_symbol(d_a)
    inv = sym.inverse_penalized(b_raw, pnt, shift=shift)
    b = sym.HermSymbol(pnt * b_raw.diag, pnt * b_raw.sdiag)

    rdt = real_dtype(dtype)
    return (
        jnp.asarray(d_a, dtype=dtype),
        sym.HermSymbol(jnp.asarray(b.diag, dtype=rdt),
                       jnp.asarray(b.sdiag, dtype=dtype)),
        sym.HermSymbol(jnp.asarray(inv.diag, dtype=rdt),
                       jnp.asarray(inv.sdiag, dtype=dtype)),
    )


def assemble_problem(cfg: ProblemConfig, alpha,
                     dtype=jnp.complex128,
                     diel: Optional[diel_mod.DielectricOp] = None) -> MaxwellProblem:
    """Full problem assembly for one k-point.

    Reference call chain: set_relaxation -> fft_blocks -> inverse_3_times_3_B
    -> scaling -> dielectric handle (numerical_experiments.py:33-85).
    """
    (shift, _rlx), pnt = set_relaxation(alpha)
    shift = shift / cfg.scal**2
    ct = lattices.ct_matrix(cfg.lattice) if cfg.lattice else np.eye(3)
    d_a, b, inv = assemble_symbols(cfg.n, cfg.k, ct, alpha, pnt, shift,
                                   scal=cfg.scal, dtype=dtype)
    if diel is None:
        diel = diel_mod.build(cfg.diel_type, cfg.n, cfg.lattice,
                              eps_opt=cfg.eps_opt, k=cfg.k, dtype=dtype)
    return MaxwellProblem(n=cfg.n, alpha=tuple(np.asarray(alpha, dtype=float)),
                          d_a=d_a, b=b, inv=inv, diel=diel,
                          shift=float(shift), pnt=float(pnt), scal=cfg.scal)


def plane_wave_cols(d_a: np.ndarray, m: int):
    """Host-side column selection for the plane-wave start: returns
    (idx (m,) flat frequency indices, amps (m, 3) complex polarizations).

    At frequency f the vacuum operator A A^H acts on the 2D transverse
    space { v : D(f) . v = 0 } as |D(f)|^2, so the best m-dimensional
    starting subspace for the lowest bands is the pair of polarizations at
    the m/2 smallest |D(f)|^2.  Only O(N^3) host flops — nothing shipped
    to the device but m indices and m 3-vectors.
    """
    d = np.asarray(d_a).reshape(3, -1)
    score = np.sum(np.abs(d) ** 2, axis=0)
    n_freq = (m + 1) // 2 + 1
    sel = np.argpartition(score, n_freq)[:n_freq]
    sel = sel[np.argsort(score[sel])]

    idx, amps = [], []
    for f in sel:
        df = d[:, f]
        # Orthonormal basis of the transverse space {v : df . v = 0}
        # = orthogonal complement of conj(df).
        a = np.conj(df)
        na = np.linalg.norm(a)
        if na < 1e-14:
            basis = np.eye(3)[:, :2]
        else:
            a = a / na
            q, _ = np.linalg.qr(np.column_stack(
                [a, np.roll(np.eye(3), 1, 1)[:, :2]]))
            basis = q[:, 1:3]
        for p in range(2):
            if len(idx) >= m:
                break
            idx.append(int(f))
            amps.append(basis[:, p])
        if len(idx) >= m:
            break
    return np.asarray(idx, np.int32), np.stack(amps).astype(np.complex128)


def plane_wave_scatter(idx: jnp.ndarray, amps: jnp.ndarray, n: int,
                       jitter_key=None, jitter: float = 1e-2) -> jnp.ndarray:
    """Device-side (jit-traceable) plane-wave block builder: scatter the m
    one-hot polarization 3-vectors into a zero (m, 3, N^3) block.  The
    ~(m * 3N^3)-sized block never crosses the host link — only (m,) indices
    and (m, 3) amplitudes do.

    A tiny random component breaks symmetry-induced invariant subspaces
    (the exact eigenvectors are NOT plane waves).
    """
    m = idx.shape[0]
    vec = jnp.zeros((m, 3, n * n * n), amps.dtype)
    vec = vec.at[jnp.arange(m), :, idx].set(amps)
    x0 = vec.reshape(m, 3, n, n, n)
    if jitter_key is not None:
        x0 = x0 + jitter * random_block(jitter_key, n, m, amps.dtype)
    return x0


def plane_wave_block(d_a: np.ndarray, m: int, dtype=jnp.complex128,
                     jitter_key=None) -> jnp.ndarray:
    """Physics-informed initial block: transverse plane waves at the m/2
    lowest vacuum eigenvalues (host-assembled convenience wrapper; the
    sweep path uses plane_wave_cols + plane_wave_scatter to build the
    block on device).  The reference starts from uniform random vectors,
    numerical_experiments.py:66 — plane waves typically save a third of
    the LOBPCG iterations.
    """
    idx, amps = plane_wave_cols(d_a, m)
    return plane_wave_scatter(jnp.asarray(idx),
                              jnp.asarray(amps, dtype), np.asarray(d_a).shape[1],
                              jitter_key=jitter_key)


def random_block(key, n: int, m: int, dtype=jnp.complex128) -> jnp.ndarray:
    """Random initial block, shape (m, 3, N, N, N)
    (reference: numerical_experiments.py:66 uses rand + 1j*rand)."""
    rdt = real_dtype(dtype)
    k1, k2 = jax.random.split(key)
    shape = (m, 3, n, n, n)
    # lax.complex keeps the width (f32 -> c64), no complex128 detour.
    return jax.lax.complex(
        jax.random.uniform(k1, shape, dtype=rdt),
        jax.random.uniform(k2, shape, dtype=rdt)).astype(dtype)
