"""Rayleigh-Ritz Gram variants of the pair-layout solver (rr_gram) and
the Gram chunking rule."""


def test_rr_gram_xla9_solver_end_to_end():
    """solver_opts={'rr_gram': 'xla9'} (concat-free blockwise Gram, the
    N=150 HBM-fit mode) reproduces the stacked-Gram solve."""
    import numpy as np
    import jax.numpy as jnp
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig

    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.2, 0.0])
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    r_x = KPointSolver(cfg, **kw).solve(alpha, seed=3)
    r_9 = KPointSolver(cfg, solver_opts={"rr_gram": "xla9"},
                       **kw).solve(alpha, seed=3)
    assert r_9.status in (1, 5)
    np.testing.assert_allclose(r_9.omega_re, r_x.omega_re, atol=5e-9)


def test_divisor_chunk():
    from pcx.solvers.lobpcg_rs import _divisor_chunk
    for n in (100, 120, 150, 96):
        d = 3 * n ** 3
        ch = _divisor_chunk(d)
        assert d % ch == 0 and ch <= 65536
    assert _divisor_chunk(65536) == 65536
    # prime-ish d with no divisor in the window falls back to the target
    assert _divisor_chunk(262147) == 65536
