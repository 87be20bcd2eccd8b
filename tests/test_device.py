"""Device policy, memory-derived chunking, compile cache, the FFT route of
the pair operator, and the phases of chip_smoke.py at tiny sizes (CPU).
The `gpu`-marked test runs only on the card."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pcx import config
from pcx.operators import dft as dft_mod
from pcx.operators import rs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


# -- pair FFT route ------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [6, 8, 9, 12])
def test_pair_fft_matches_matmul_dft_and_numpy(n, inverse, rng):
    """rs.fft3_p (jnp.fft, cuFFT on the GPU) against the explicit matmul
    DFT and numpy, for even and odd N, forward and inverse."""
    x = (rng.standard_normal((2, 3, n, n, n))
         + 1j * rng.standard_normal((2, 3, n, n, n)))
    got = rs.fft3_p((jnp.asarray(x.real), jnp.asarray(x.imag)),
                    inverse=inverse)
    got = np.asarray(got[0]) + 1j * np.asarray(got[1])
    ax = (-3, -2, -1)
    want = np.fft.ifftn(x, axes=ax) if inverse else np.fft.fftn(x, axes=ax)
    mats = dft_mod.dft_mats(n, np.complex128)
    mm = np.asarray(dft_mod.dft3(jnp.asarray(x), jnp.asarray(
        mats.inv if inverse else mats.fwd)))
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got, mm, atol=1e-12 * np.abs(want).max())


def test_pair_fft_keeps_f32_width(rng):
    """An f32 pair transforms as complex64 (no complex128 detour)."""
    x = rng.standard_normal((1, 3, 6, 6, 6)).astype(np.float32)
    out = rs.fft3_p((jnp.asarray(x), jnp.asarray(x)))
    assert out[0].dtype == jnp.float32 and out[1].dtype == jnp.float32


# -- device policy -------------------------------------------------------------

@pytest.mark.parametrize("platform,dtype,accel", [
    ("cpu", jnp.complex128, False),
    ("gpu", jnp.complex64, True),
    ("cuda", jnp.complex64, True),
])
def test_device_policy(platform, dtype, accel):
    pol = config.device_policy(platform)
    assert pol.dtype == dtype and pol.accelerator == accel


@pytest.mark.parametrize("platform", ["rocm", "metal", "iree"])
def test_device_policy_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no device policy"):
        config.device_policy(platform)


def test_device_policy_default_reads_backend():
    assert config.device_policy() == config.device_policy(
        jax.default_backend())


def test_kpointsolver_cpu_defaults():
    """On the CPU the solver keeps the complex path: no chunking, no
    segments, no refine, no real-boundary shim."""
    from pcx.bandstructure import KPointSolver
    s = KPointSolver(config.ProblemConfig(n=8, nev=4))
    assert (s.impl, s.rb, s.segment_iters, s.apply_chunk, s.refine) == \
        ("complex", False, 0, 0, False)
    assert s.dft is None


def test_fft_mode_matmul_rejected_on_pair_solver():
    from pcx.bandstructure import KPointSolver
    with pytest.raises(ValueError, match="complex solver only"):
        KPointSolver(config.ProblemConfig(n=8, nev=4), solver_impl="rs",
                     fft_mode="matmul")


# -- apply chunk from the device memory limit ------------------------------------

@pytest.mark.parametrize("n,bytes_limit,want", [
    (120, 60e9, 0),           # 80 GB card (3/4 reserved): N=120 unchunked
    (120, None, 0),           # device reports no limit
    (200, 60e9, 9),           # N=200: budget / column bytes
    (120, 12e9, 9),           # a 16 GB device at N=120
    (120, 1e6, 1),            # never below one column
])
def test_apply_chunk_for(n, bytes_limit, want):
    assert config.apply_chunk_for(n, 8, bytes_limit, m=16) == want


def test_apply_chunk_for_fits_budget():
    for limit in (8e9, 24e9, 60e9):
        c = config.apply_chunk_for(150, 8, limit, m=16)
        col = 3 * 150**3 * 8 * config._APPLY_TEMPS
        assert c == 0 or c * col <= config._APPLY_SHARE * limit


# -- compile cache -------------------------------------------------------------

def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert config.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert config.compile_cache_dir("/x") == os.path.join("/x", ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert config.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# -- chip_smoke ------------------------------------------------------------------

def test_chip_smoke_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err and '"ok"' not in out.out


def test_hlo_helpers():
    text = ("HloModule m\n\nfused_computation {\n  d = f32[4,4]{1,0} dot(a, b),"
            " operand_precision={highest,highest}\n}\n\nENTRY main {\n"
            "  f = f32[4,4]{1,0} fusion(x), kind=kLoop\n"
            "  g = (f32[4,4]{1,0}, s8[8]{0}) custom-call(x, y), "
            "custom_call_target=\"__cublas$gemm\", backend_config="
            "{\"precision_config\":{\"operand_precision\":[\"DEFAULT\","
            "\"DEFAULT\"]}}\n}\n")
    assert chip_smoke.hlo_kernel_count(text) == 2
    assert chip_smoke.f32_gemm_precision(text) == {
        "f32_gemms": 2, "f32_gemms_full_precision": 1}


def test_chip_smoke_device_phase():
    rec = chip_smoke.phase_device()
    assert rec["platform"] == jax.devices()[0].platform
    assert rec["fft_c128_rel_err"] < 1e-12


def test_chip_smoke_kernels_phase():
    rec = chip_smoke.phase_kernels(n=8, m=4, reps=1)
    for k in ("dft_c64", "dft_c128"):
        assert rec[k]["fft_rel_err"] < 1e-5
        assert rec[k]["matmul_rel_err"] < 1e-5
    assert rec["resid_precond"]["kernels"] >= 1
    assert rec["gram_3m"]["f32_gemms"] == \
        rec["gram_3m"]["f32_gemms_full_precision"]


def test_chip_smoke_main_and_reference_phases(tmp_path):
    main = chip_smoke.phase_main(n=8, nev=4, out_dir=str(tmp_path))
    assert main["fcc"]["failed"] == [] and main["gate_dev"] < 1e-3
    ref = chip_smoke.phase_reference(main, n=8, nev=4)
    assert ref["max_domega"] <= chip_smoke.OMEGA_TOL


def test_chip_smoke_four_phases(tmp_path):
    """The --four phases on four virtual CPU devices."""
    rec = chip_smoke.phase_four_bandgap(n=8, nev=4, out_dir=str(tmp_path))
    assert rec["max_domega"] <= chip_smoke.OMEGA_TOL
    rec = chip_smoke.phase_four_sharded(n=8, nev=2)
    assert rec["max_domega"] <= chip_smoke.OMEGA_TOL


@pytest.mark.gpu
def test_chip_smoke_kernels_on_gpu(gpu):
    """The kernel phase at the real width on the card: both DFT routes
    agree with numpy, and every f32 GEMM of the Gram runs at full f32."""
    rec = chip_smoke.phase_kernels(n=120, m=16, reps=2)
    assert rec["dft_c64"]["fft_rel_err"] < 1e-5
    assert rec["gram_3m"]["f32_gemms"] == \
        rec["gram_3m"]["f32_gemms_full_precision"]


# -- removed accelerator options ----------------------------------------------

@pytest.mark.parametrize("opts,match", [
    ({"rp_fuse": "pallas"}, "not supported"),
    ({"dft_fuse": "pallas"}, "not supported"),
    ({"rp_layout": "cm"}, "not supported"),
    ({"rr_gram": "pallas"}, "unknown rr_gram"),
])
def test_removed_kernel_options_rejected(opts, match):
    """The options of the removed fused kernels raise instead of being
    silently dropped."""
    from pcx.bandstructure import KPointSolver
    s = KPointSolver(config.ProblemConfig(n=6, lattice="sc_curv", nev=2),
                     dtype=jnp.complex64, solver_impl="rs", refine=False,
                     solver_opts=opts)
    with pytest.raises(ValueError, match=match):
        s.solve(np.array([np.pi, 0.0, 0.0]), seed=0)


# -- trace reduction -----------------------------------------------------------

def test_trace_summary_busy_idle_and_ranking():
    """tools/trace_summary on a recorded-shape trace: busy time is the
    union of overlapping device events, host events are ignored, kernels
    rank by total device time."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_summary
    meta = lambda pid, name: {"ph": "M", "name": "process_name", "pid": pid,
                              "args": {"name": name}}
    ev = lambda pid, name, ts, dur: {"ph": "X", "pid": pid, "name": name,
                                     "ts": ts, "dur": dur}
    events = [meta(1, "/device:GPU:0"), meta(2, "/host:CPU"),
              ev(1, "gemm", 0, 40), ev(1, "fft", 30, 20),    # overlap
              ev(1, "gemm", 80, 20), ev(2, "python", 0, 1000)]
    s = trace_summary.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(70e-6)
    assert s["idle_share"] == pytest.approx(0.3)
    assert [k[:2] for k in s["kernels"]] == [("gemm", 2), ("fft", 1)]
    with pytest.raises(ValueError, match="no device events"):
        trace_summary.summarize([meta(2, "/host:CPU"),
                                 ev(2, "python", 0, 10)])
