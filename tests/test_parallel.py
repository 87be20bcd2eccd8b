"""Multi-device tests on the 8-virtual-CPU mesh: pencil FFT correctness and
the grid-sharded solve matching the single-device solve."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map
from functools import partial

from pcx.parallel import fft as pfft
from pcx.parallel.mesh import make_mesh, GRID_AXIS


@pytest.fixture(scope="module")
def mesh4():
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    return make_mesh(n_k=2, n_grid=2, devices=jax.devices()[:4])


def test_pencil_fft_roundtrip_and_value(mesh4):
    rng = np.random.default_rng(0)
    n = 8
    x = jnp.asarray(rng.normal(size=(2, 3, n, n, n))
                    + 1j * rng.normal(size=(2, 3, n, n, n)))

    fspec = P(None, None, None, None, GRID_AXIS)
    xspec = P(None, None, GRID_AXIS, None, None)

    fwd = partial(shard_map, mesh=mesh4, in_specs=(fspec,), out_specs=xspec,
                  check_vma=False)(lambda v: pfft.pencil_fftn(v, GRID_AXIS))
    inv = partial(shard_map, mesh=mesh4, in_specs=(xspec,), out_specs=fspec,
                  check_vma=False)(lambda v: pfft.pencil_ifftn(v, GRID_AXIS))

    y = fwd(x)
    want = np.fft.fftn(np.asarray(x), axes=(-3, -2, -1))
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-10)
    back = inv(y)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-10)


def test_sharded_solve_matches_single_device(mesh4):
    """Grid-sharded LOBPCG must reproduce the single-device frequencies."""
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.operators import maxwell
    from pcx.parallel.solve import solve_kpoint_sharded
    from pcx import geometry

    n, nev = 8, 4
    alpha = np.array([np.pi, 0, 0])
    cfg = ProblemConfig(n=n, lattice="sc_flat1", diel_type="chiral", nev=nev)
    single = KPointSolver(cfg, dtype=jnp.complex128)
    d_a, b, inv, shift = single.symbols_for(alpha)
    x0 = maxwell.random_block(jax.random.PRNGKey(0), n, nev + 2,
                              jnp.complex128)

    r_single = single.solve(alpha, x0=x0, validate_result=False)

    from pcx.config import CHIRAL_EPS_EG
    mask = geometry.edge_mask(n, "sc_flat1")
    scale = jnp.asarray(np.where(mask, 1.0 / CHIRAL_EPS_EG["sc_flat1"], 1.0))

    r_shard = solve_kpoint_sharded(mesh4, d_a, b, inv, scale, shift, x0,
                                   nev, tol=1e-6, maxiter=300)
    lam_s = np.asarray(r_shard.lambdas)[:nev] - shift
    lam_1 = np.asarray(r_single.lambdas)[:nev]
    np.testing.assert_allclose(lam_s, lam_1, rtol=5e-5, atol=1e-6)


def test_dryrun_multichip_runs():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_sharded_solve_pseudochiral_trivial(mesh4):
    """Hermitian-tensor (pointwise) dielectric sharded solve matches the
    single-device pseudochiral-trivial solve."""
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.operators import maxwell
    from pcx.parallel.solve import solve_kpoint_sharded
    from pcx.operators import dielectric as diel_mod

    n, nev = 8, 3
    alpha = np.array([np.pi, 0, 0])
    cfg = ProblemConfig(n=n, lattice="sc_curv",
                        diel_type="pseudochiral_trivial", nev=nev)
    single = KPointSolver(cfg, dtype=jnp.complex128)
    d_a, b, inv, shift = single.symbols_for(alpha)
    x0 = maxwell.random_block(jax.random.PRNGKey(1), n, nev + 2,
                              jnp.complex128)
    r1 = single.solve(alpha, x0=x0, validate_result=False)

    # Rebuild the same tensor arrays for the sharded path.
    from pcx import geometry
    from pcx.config import PSEUDOCHIRAL_EPS_LOC, CHIRAL_EPS_EG
    eps_loc = PSEUDOCHIRAL_EPS_LOC[0] / CHIRAL_EPS_EG["sc_curv"]
    em = geometry.edge_mask(n, "sc_curv")
    vm = geometry.volume_mask(n, "sc_curv")
    diag = np.stack([np.where(em[c], eps_loc[c].real, 1.0) for c in range(3)])
    sdiag = np.stack([np.where(vm, eps_loc[3 + c], 0.0) for c in range(3)])
    r2 = solve_kpoint_sharded(mesh4, d_a, b, inv,
                              (jnp.asarray(diag), jnp.asarray(sdiag)),
                              shift, x0, nev, tol=1e-6, maxiter=300)
    lam2 = np.asarray(r2.lambdas)[:nev] - shift
    lam1 = np.asarray(r1.lambdas)[:nev]
    np.testing.assert_allclose(lam2, lam1, rtol=5e-5, atol=1e-6)


def test_sharded_crossdof_apply_matches(mesh4):
    """Halo-exchange cross-DoF dielectric (x-sharded pencil layout) matches
    the single-device roll implementation."""
    from pcx.operators import dielectric as diel_mod
    from pcx.parallel.solve import make_sharded_crossdof
    from pcx.parallel.mesh import GRID_AXIS
    from pcx import geometry, stencils
    from pcx.config import PSEUDOCHIRAL_EPS_LOC, CHIRAL_EPS_EG

    n, k = 8, 2  # stencil wider than 1 to exercise multi-plane halos
    lattice = "sc_curv"
    op = diel_mod.pseudochiral_crossdof_op(n, lattice, k=k)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 3, n, n, n))
                    + 1j * rng.normal(size=(2, 3, n, n, n)))
    want = np.asarray(op(x))

    eps_loc = PSEUDOCHIRAL_EPS_LOC[0] / CHIRAL_EPS_EG[lattice]
    em = geometry.edge_mask(n, lattice)
    diag = np.stack([np.where(em[c], eps_loc[c].real, 1.0) for c in range(3)])
    sten = tuple(float(w) for w in stencils.mfd_stencil(k, 0))
    e3, e4, e5 = (complex(eps_loc[3]), complex(eps_loc[4]),
                  complex(eps_loc[5]))

    xspec3 = P(None, GRID_AXIS, None, None)
    xspecf = P(None, None, GRID_AXIS, None, None)

    @partial(shard_map, mesh=mesh4,
             in_specs=(xspecf, xspec3, xspec3), out_specs=xspecf,
             check_vma=False)
    def apply_sharded(xloc, diag_loc, masks_loc):
        fn = make_sharded_crossdof(diag_loc, masks_loc, sten, e3, e4, e5,
                                   n_shards=2)
        return fn(xloc)

    got = np.asarray(apply_sharded(x, jnp.asarray(diag),
                                   jnp.asarray(em, jnp.float64)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_pencil_fft_four_way():
    """4-way grid sharding of the pencil FFT (deeper all_to_all)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh(n_k=2, n_grid=4)
    rng = np.random.default_rng(7)
    n = 8
    x = jnp.asarray(rng.normal(size=(1, 3, n, n, n))
                    + 1j * rng.normal(size=(1, 3, n, n, n)))
    fspec = P(None, None, None, None, GRID_AXIS)
    xspec = P(None, None, GRID_AXIS, None, None)
    fwd = partial(shard_map, mesh=mesh, in_specs=(fspec,), out_specs=xspec,
                  check_vma=False)(lambda v: pfft.pencil_fftn(v, GRID_AXIS))
    inv = partial(shard_map, mesh=mesh, in_specs=(xspec,), out_specs=fspec,
                  check_vma=False)(lambda v: pfft.pencil_ifftn(v, GRID_AXIS))
    y = fwd(x)
    np.testing.assert_allclose(np.asarray(y),
                               np.fft.fftn(np.asarray(x), axes=(-3, -2, -1)),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(inv(y)), np.asarray(x), atol=1e-10)


def test_sharded_roll_matches_roll():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh(n_k=1, n_grid=8)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(16, 8)))
    spec = P(GRID_AXIS, None)
    for shift in (-2, -1, 1, 2):
        f = partial(shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec,
                    check_vma=False)(
            lambda v: pfft.sharded_roll(v, shift, 0, GRID_AXIS, 8))
        np.testing.assert_allclose(np.asarray(f(x)),
                                   np.roll(np.asarray(x), shift, axis=0))


@pytest.mark.slow
def test_sharded_solve_crossdof(mesh4):
    """End-to-end grid-sharded solve with the cross-DoF dielectric (halo
    exchange inside the solver loop) matches the single-device solve at an
    N large enough for multi-plane halos."""
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.operators import maxwell
    from pcx.parallel.solve import solve_kpoint_sharded
    from pcx import geometry, stencils
    from pcx.config import PSEUDOCHIRAL_EPS_LOC, CHIRAL_EPS_EG

    n, nev, k = 16, 3, 1
    lattice = "sc_curv"
    alpha = np.array([np.pi, 0, 0])
    cfg = ProblemConfig(n=n, lattice=lattice,
                        diel_type="pseudochiral_crossdof", nev=nev)
    single = KPointSolver(cfg, dtype=jnp.complex128)
    d_a, b, inv, shift = single.symbols_for(alpha)
    x0 = maxwell.random_block(jax.random.PRNGKey(2), n, nev + 2,
                              jnp.complex128)
    r1 = single.solve(alpha, x0=x0, validate_result=False)

    eps_loc = PSEUDOCHIRAL_EPS_LOC[0] / CHIRAL_EPS_EG[lattice]
    em = geometry.edge_mask(n, lattice)
    diag = np.stack([np.where(em[c], eps_loc[c].real, 1.0)
                     for c in range(3)])
    sten = tuple(float(w) for w in stencils.mfd_stencil(k, 0))
    spec = {"crossdof": (jnp.asarray(diag), jnp.asarray(em, jnp.float64),
                         sten, complex(eps_loc[3]), complex(eps_loc[4]),
                         complex(eps_loc[5]))}
    r2 = solve_kpoint_sharded(mesh4, d_a, b, inv, spec, shift, x0, nev,
                              tol=1e-6, maxiter=300)
    lam2 = np.asarray(r2.lambdas)[:nev] - shift
    lam1 = np.asarray(r1.lambdas)[:nev]
    np.testing.assert_allclose(lam2, lam1, rtol=5e-5, atol=1e-6)


@pytest.mark.slow
def test_multihost_two_process_cpu(tmp_path):
    """Real two-process jax.distributed bring-up on CPU (gloo collectives):
    init_distributed + make_multihost_mesh + a cross-host psum + host_slice
    partitioning (SURVEY.md section 5.8)."""
    import subprocess, sys, textwrap, socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    prog = textwrap.dedent(f"""
        import os, sys
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        os.environ["JAX_COORDINATOR_ADDRESS"] = "localhost:{port}"
        os.environ["JAX_NUM_PROCESSES"] = "2"
        os.environ["JAX_PROCESS_ID"] = sys.argv[1]
        import jax, jax.numpy as jnp
        jax.config.update("jax_platforms", "cpu")
        from pcx.parallel.mesh import (init_distributed, make_multihost_mesh,
                                       host_slice, K_AXIS)
        pid = init_distributed()
        assert jax.process_count() == 2, jax.process_count()
        assert len(jax.devices()) == 4
        mesh = make_multihost_mesh(n_grid=1)
        assert mesh.shape[K_AXIS] == 4
        from jax.sharding import PartitionSpec as P
        from jax import shard_map
        from functools import partial
        f = partial(shard_map, mesh=mesh, in_specs=P(K_AXIS),
                    out_specs=P())(lambda v: jax.lax.psum(v.sum(), K_AXIS))
        total = f(jnp.arange(8.0))
        assert float(total) == 28.0, float(total)
        mine = host_slice(10)
        assert mine == list(range(pid, 10, 2))
        print("OK", pid)
    """)
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env,
                              cwd="/root/repo")
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"OK {i}" in out


def test_solve_batch_k_mesh_matches_serial():
    """Multi-device DP over k-points: KPointSolver.solve_batch(mesh=...)
    shards a k-group over the mesh "k" axis (one solve per device, all
    paths: complex, rs pair-layout, segmented rs) and must reproduce the
    serial per-k frequencies — including a ragged group that the batch
    transparently pads (SURVEY.md section 2.4 DP row)."""
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx import lattices

    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    alphas = list(lattices.k_path("sc_flat1", gap=4)[1:5])
    mesh = make_mesh(n_k=4, n_grid=1, devices=jax.devices()[:4])

    for kw in ({}, dict(real_boundary=True, solver_impl="rs"),
               dict(real_boundary=True, solver_impl="rs", segment_iters=5)):
        s = KPointSolver(cfg, dtype=jnp.complex128, **kw)
        serial = [s.solve(a, seed=0) for a in alphas]
        batch = s.solve_batch(alphas, seed=0, mesh=mesh)
        for r0, r1 in zip(serial, batch):
            np.testing.assert_allclose(np.asarray(r1.omega_re),
                                       np.asarray(r0.omega_re), atol=1e-8)
        ragged = s.solve_batch(alphas[:3], seed=0, mesh=mesh)
        assert len(ragged) == 3
        for r0, r1 in zip(serial[:3], ragged):
            np.testing.assert_allclose(np.asarray(r1.omega_re),
                                       np.asarray(r0.omega_re), atol=1e-8)


def test_bandgap_k_mesh_sweep(tmp_path):
    """bandgap(mesh=...) — the full checkpointed sweep with k-groups
    sharded one-per-device; the written library must match a serial sweep
    record-for-record."""
    from pcx.bandstructure import bandgap
    import json

    mesh = make_mesh(n_k=4, n_grid=1, devices=jax.devices()[:4])
    kw = dict(n=8, lattice="sc_flat1", nev=4, gap=4, verbose=False)
    err_m = bandgap(output_dir=str(tmp_path / "mesh"), mesh=mesh, **kw)
    err_s = bandgap(output_dir=str(tmp_path / "serial"), **kw)
    assert err_m == [] and err_s == []
    fm = json.load(open(tmp_path / "mesh/chiral/bandgap_sc_flat1.json"))
    fs = json.load(open(tmp_path / "serial/chiral/bandgap_sc_flat1.json"))
    np.testing.assert_allclose(np.asarray(fm["sc_flat1_8_frequencies"]),
                               np.asarray(fs["sc_flat1_8_frequencies"]),
                               atol=1e-6)
    its = np.asarray(fm["sc_flat1_8_iterations"])
    assert (its[:, 0] > 0).all()
