"""Small utilities: norms, timing, robust sqrt, logging colors.

Reference: paper_2/environment.py:59-180.  ``norms``/``dots`` here operate on
the pcx block layout — a block of m vectors is an array of shape
``(m, ...)`` (vector index FIRST, each vector contiguous), unlike the
reference's column-major ``(3N^3, m)``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np

RED = "\033[31m"
GREEN = "\033[32m"
YELLOW = "\033[33m"
BLUE = "\033[34m"
MAGENTA = "\033[35m"
CYAN = "\033[36m"
WHITE = "\033[37m"
RESET = "\033[0m"


def real_dtype(dtype):
    """Real counterpart of a (possibly complex) dtype, computed HOST-side.

    Never use ``jnp.zeros((), dtype).real.dtype`` for this — with no tracer
    inputs it executes EAGERLY on the device even inside a traced
    function."""
    return np.zeros(0, dtype=np.dtype(dtype)).real.dtype


def sqrt_robust(x: float) -> float:
    """Clamp tiny negatives to 0 before sqrt
    (reference: environment.py:59, numerical_experiments.py:135-140)."""
    return 0.0 if x < 1e-10 else float(x) ** 0.5


def as_blockvec(x: jnp.ndarray) -> jnp.ndarray:
    """Flatten a block (m, ...) to (m, D)."""
    return x.reshape(x.shape[0], -1)


def norm(x) -> jnp.ndarray:
    """Frobenius norm (reference: environment.py:117-129)."""
    return jnp.linalg.norm(jnp.asarray(x))


def norms(x: jnp.ndarray, axis_name=None) -> jnp.ndarray:
    """Per-vector 2-norms of a block (m, ...) -> (m,)
    (reference: environment.py:131-143).  ``axis_name``: mesh axis to psum
    over when the vector dimension is sharded (shard_map contexts)."""
    v = as_blockvec(x)
    sq = jnp.sum((v.conj() * v).real, axis=1)
    if axis_name is not None:
        sq = jax.lax.psum(sq, axis_name)
    return jnp.sqrt(sq)


def dots(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Per-vector inner products diag(X^H Y) -> (m,)
    (reference: environment.py:145-157)."""
    return jnp.sum(as_blockvec(x).conj() * as_blockvec(y), axis=1)


def block_until_ready(tree):
    return jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready") else a,
        tree,
    )


@contextmanager
def timing(process_name=None, runtime_dict=None, print_time=False, sync=None):
    """Device-synchronized wall timing (reference: environment.py:84-111).

    ``sync`` is an optional array/pytree to ``block_until_ready`` before
    reading the clock (the analog of ``cupy.Device.synchronize``).
    """
    t_h = time.time()
    box = {}
    yield box
    if sync is not None:
        block_until_ready(sync)
    elif "sync" in box:
        block_until_ready(box["sync"])
    elapsed = time.time() - t_h
    box["elapsed"] = elapsed
    if runtime_dict is not None and process_name is not None:
        runtime_dict[process_name] = runtime_dict.get(process_name, 0.0) + elapsed
    if print_time and process_name is not None:
        print(f"Runtime of {process_name} is {elapsed:<6.3f} s.")


def device_memory_mib() -> float:
    """Live device memory in MiB (reference prints cupy pool bytes,
    lobpcg.py:471-472)."""
    try:
        stats = jax.local_devices()[0].memory_stats()
        return stats.get("bytes_in_use", 0) / 2**20
    except Exception:
        return float("nan")


def convergence_rate(residuals: np.ndarray, verbose: bool = True):
    """Average residual dampening rates by log-linear regression
    (reference: numerical_experiments.py:189-202)."""
    residuals = np.asarray(residuals)

    def rated(x):
        return np.polyfit(np.arange(len(x)), x, 1)[0]

    m0 = np.exp(rated(np.log(residuals)))
    n_half = len(residuals) // 2
    m1 = np.exp(rated(np.log(residuals[:n_half])))
    m2 = np.exp(rated(np.log(residuals[n_half:])))
    if verbose:
        print(f"\nGlobal average convergence rate: {m0:<6.3f}.")
        print(f"First half average convergence rate: {m1:<6.3f}.")
        print(f"Second half average convergence rate: {m2:<6.3f}.")
    return m0, m1, m2
