"""Real-boundary jit shim and matmul DFT.

Pins the contracts of the (..., 2)-real boundary encoding (boundary.py) and
of the explicit matmul DFT (operators/dft.py), and the solver's
real_boundary path (pair-layout solver behind the encoded boundary) against
the default complex path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pcx import boundary
from pcx.bandstructure import KPointSolver
from pcx.config import ProblemConfig
from pcx.operators import dft


def test_encode_decode_roundtrip():
    z = np.random.rand(3, 4).astype(np.float64) + 1j * np.random.rand(3, 4)
    r = np.random.rand(5).astype(np.float32)
    tree = {"z": z, "r": r, "s": 2.0, "zs": 1.5 - 0.5j}
    enc = boundary.encode(tree, rdt=np.float64)
    assert isinstance(enc["z"], boundary.CArr)
    assert enc["z"].ri.shape == (3, 4, 2)
    assert enc["r"] is r and enc["s"] == 2.0
    dec = boundary.decode(enc)
    np.testing.assert_array_equal(dec["z"], z)
    np.testing.assert_array_equal(np.asarray(dec["zs"]), np.asarray(1.5 - 0.5j))


def test_real_boundary_jit_no_complex_io():
    """The wrapped jitted fn must see complex inside, reals at the boundary."""
    def core(a, b):
        assert jnp.iscomplexobj(a)
        return a * b, (a + b).real

    f = jax.jit(boundary.real_boundary(core))
    a = np.random.rand(4, 4) + 1j * np.random.rand(4, 4)
    b = np.random.rand(4, 4)
    out_c, out_r = f(boundary.encode(a), b)
    assert isinstance(out_c, boundary.CArr)
    assert not np.iscomplexobj(out_c.ri)
    np.testing.assert_allclose(out_c.to_numpy(), a * b, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(out_r), (a + b).real, rtol=1e-12)


def test_carr_getitem_and_shape():
    z = np.arange(24, dtype=np.complex128).reshape(2, 3, 4)
    c = boundary.encode(z)
    assert c.shape == (2, 3, 4)
    np.testing.assert_array_equal(c[1].to_numpy(), z[1])


@pytest.mark.parametrize("n", [8, 12])
def test_dft3_matches_fftn(n, rng):
    x = rng.standard_normal((2, 3, n, n, n)) + 1j * rng.standard_normal(
        (2, 3, n, n, n))
    mats = dft.dft_mats(n, np.complex128)
    fwd = np.asarray(dft.dft3(jnp.asarray(x), jnp.asarray(mats.fwd)))
    np.testing.assert_allclose(fwd, np.fft.fftn(x, axes=(-3, -2, -1)),
                               atol=1e-10)
    inv = np.asarray(dft.dft3(jnp.asarray(fwd), jnp.asarray(mats.inv)))
    np.testing.assert_allclose(inv, x, atol=1e-10)


@pytest.mark.parametrize("diel_type", ["chiral", "pseudochiral_crossdof"])
def test_real_boundary_solver_matches_normal(diel_type):
    """real_boundary=True (pair-layout solver behind the encoded boundary)
    reproduces the default CPU solve."""
    cfg = ProblemConfig(n=8, lattice="sc_curv", diel_type=diel_type, nev=4)
    a = np.array([np.pi, 0.0, 0.0])
    ref = KPointSolver(cfg, dtype=jnp.complex128,
                       real_boundary=False).solve(a, seed=0)
    got = KPointSolver(cfg, dtype=jnp.complex128,
                       real_boundary=True).solve(a, seed=0)
    assert got.status in (1, 5)
    assert isinstance(got.x, boundary.CArr)
    np.testing.assert_allclose(got.omega_re, ref.omega_re, atol=1e-8)


def test_f64_refine_recovers_accuracy():
    """c64 solve + f64 pair Rayleigh-Ritz refinement: the gate deviation
    drops to f64 level and omega approaches the c128 reference."""
    cfg = ProblemConfig(n=8, lattice="sc_curv",
                        diel_type="pseudochiral_crossdof", nev=4)
    a = np.array([np.pi, 0.0, 0.0])
    ref = KPointSolver(cfg, dtype=jnp.complex128,
                       real_boundary=False).solve(a, seed=0)
    got = KPointSolver(cfg, dtype=jnp.complex64, real_boundary=True,
                       refine=True).solve(a, seed=0)
    assert got.status in (1, 5)
    dev = np.abs(np.asarray(got.omega) - np.asarray(got.omega_re)).max()
    assert dev < 1e-9          # f64-level agreement of the refined pair
    np.testing.assert_allclose(got.omega_re, ref.omega_re, atol=1e-6)


def test_light_refine_matches_f64_refine():
    """refine="light" (working-precision refine + f64-accumulated pencil,
    the sweep-production validation) reproduces the f64 refine's
    theta / quotients / residual norms on the same solve."""
    cfg = ProblemConfig(n=8, lattice="sc_curv",
                        diel_type="pseudochiral_crossdof", nev=4)
    a = np.array([np.pi, 0.3, 0.0])
    heavy = KPointSolver(cfg, dtype=jnp.complex64, real_boundary=True,
                         refine=True)
    r = heavy.solve(a, seed=0)
    assert r.status in (1, 5) and not r.report.spurious
    light = KPointSolver(cfg, dtype=jnp.complex64, real_boundary=True,
                         refine="light")
    rep_h, th_h, _ = heavy._refine_report(a, r.x)
    rep_l, th_l, _ = light._refine_report(a, r.x)
    # theta limited by the shared c64 subspace; light adds only ~1e-7
    # f32-apply quantization on O(1) eigenvalues
    np.testing.assert_allclose(th_l, th_h, rtol=0, atol=5e-5)
    np.testing.assert_allclose(rep_l.omega_re, rep_h.omega_re, atol=5e-5)
    np.testing.assert_allclose(rep_l.omega_pnt, rep_h.omega_pnt, atol=5e-5)
    # the spurious gate agrees, with residual norms at the same scale
    assert not rep_l.spurious
    np.testing.assert_allclose(rep_l.residuals, rep_h.residuals,
                               rtol=0.2, atol=1e-5)

    # end-to-end: a solve under refine="light" validates and matches
    r_l = light.solve(a, seed=0)
    assert r_l.status in (1, 5) and not r_l.report.spurious
    np.testing.assert_allclose(r_l.omega_re, r.omega_re, atol=5e-5)


def test_real_boundary_warm_start_and_batch():
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    s = KPointSolver(cfg, dtype=jnp.complex128, real_boundary=True)
    a0, a1 = np.array([np.pi, 0, 0]), np.array([np.pi, np.pi / 2, 0])
    r0 = s.solve(a0, seed=0)
    # Warm start via CArr (truncate + pad paths both exercised by _fit).
    r1 = s.solve(a1, x0=r0.x, seed=1)
    assert r1.status in (1, 5) and not r1.report.spurious
    batch = s.solve_batch([a0, a1], seed=2)
    ref = KPointSolver(cfg, dtype=jnp.complex128,
                       real_boundary=False).solve_batch([a0, a1], seed=2)
    for rb_r, cp_r in zip(batch, ref):
        np.testing.assert_allclose(rb_r.omega_re, cp_r.omega_re, atol=2e-5)
