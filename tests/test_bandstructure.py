"""Band sweep driver tests: checkpoint/resume semantics, failure records,
schema compatibility (reference: bandgap, numerical_experiments.py:313-496)."""

import json
import os

import numpy as np
import pytest

from pcx import bandstructure as bs
from pcx.io import BandLibrary, EMPTY, FAILED


def test_band_library_resume(tmp_path):
    path = str(tmp_path / "bandgap_test.json")
    lib = BandLibrary(path, "sc_curv", 8, n_k=5, nev=3)
    assert lib.pending_indices() == [0, 1, 2, 3, 4]
    lib.record(1, 10, 1.5, np.array([0.1, 0.2, 0.3]))
    lib.record(3, -1, -1, None)
    # Reload from disk: computed point excluded, failed point included.
    lib2 = BandLibrary(path, "sc_curv", 8, n_k=5, nev=3)
    assert lib2.pending_indices() == [0, 2, 3, 4]
    assert lib2.failed_indices() == [3]
    assert lib2.frequencies[1] == [0.1, 0.2, 0.3]
    assert lib2.iterations[3] == FAILED


def test_band_library_schema_matches_reference(tmp_path):
    """Written JSON must use the reference key schema
    (numerical_experiments.py:355-357)."""
    path = str(tmp_path / "bandgap_sc_curv.json")
    lib = BandLibrary(path, "sc_curv", 100, n_k=4, nev=10)
    lib.record(0, 31, 10.79, np.arange(10) * 0.1)
    with open(path) as f:
        raw = json.load(f)
    assert set(raw) == {"sc_curv_100_iterations", "sc_curv_100_frequencies"}
    assert len(raw["sc_curv_100_iterations"]) == 4
    assert len(raw["sc_curv_100_frequencies"][0]) == 10


@pytest.mark.slow
def test_bandgap_sweep_and_resume(tmp_path):
    out = str(tmp_path / "output")
    kw = dict(n=8, lattice="sc_flat1", diel_type="chiral", output_dir=out,
              nev=4, gap=4, verbose=False)
    # Partial sweep: first 3 of 16 k-points.
    err = bs.bandgap(indices=[0, 1, 2], **kw)
    assert err == []
    path = f"{out}/chiral/bandgap_sc_flat1.json"
    lib = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib.pending_indices() == list(range(3, 16))
    freqs_before = [list(r) for r in lib.frequencies[:3]]
    # Resume computes only the remaining points and keeps previous results.
    err = bs.bandgap(**kw)
    assert err == []
    lib2 = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib2.pending_indices() == []
    assert [list(r) for r in lib2.frequencies[:3]] == freqs_before
    # All frequencies positive and finite.
    f = np.array(lib2.frequencies)
    assert np.isfinite(f).all() and (f >= 0).all()


def test_failed_row_retry_uses_warm_feeder(tmp_path, capsys):
    """An isolated FAILED row resumed with no warm chain must first
    re-solve a computed neighbor (not recorded) and warm-start the retry
    from its subspace — cold retries are how near-Gamma rows fail
    repeatedly (sc_flat1 N=120 k=0, round 4)."""
    out = str(tmp_path / "output")
    kw = dict(n=8, lattice="sc_flat1", diel_type="chiral", output_dir=out,
              nev=4, gap=4)
    err = bs.bandgap(indices=[0, 1, 2], verbose=False, **kw)
    assert err == []
    path = f"{out}/chiral/bandgap_sc_flat1.json"
    lib = BandLibrary(path, "sc_flat1", 8, 16, 4)
    row1_before = list(lib.frequencies[1])
    # Corrupt row 0 into the FAILED sentinel and resume just the retry.
    lib.record(0, -1, -1, None)
    lib2 = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib2.failed_indices() == [0]
    err = bs.bandgap(indices=[0], verbose=True, **kw)
    assert err == []
    captured = capsys.readouterr().out
    assert "warm-feeder solve of computed neighbor k=1" in captured
    lib3 = BandLibrary(path, "sc_flat1", 8, 16, 4)
    assert lib3.failed_indices() == []
    f0 = np.array(lib3.frequencies[0])
    assert np.isfinite(f0).all() and (f0 >= 0).all()
    # The feeder solve must NOT have overwritten the neighbor's row.
    assert list(lib3.frequencies[1]) == row1_before


@pytest.mark.slow
def test_bandgap_k_batch_matches_serial(tmp_path):
    """k_batch>1 sweeps through the vmapped path and writes the same
    library (to tolerance) as the serial sweep."""
    kw = dict(n=8, lattice="sc_flat1", diel_type="chiral", nev=4, gap=2,
              verbose=False, indices=list(range(4)))
    err = bs.bandgap(output_dir=str(tmp_path / "serial"), **kw)
    assert err == []
    err = bs.bandgap(output_dir=str(tmp_path / "batched"), k_batch=2, **kw)
    assert err == []
    f_s = np.array(BandLibrary(str(tmp_path / "serial/chiral/bandgap_sc_flat1.json"),
                               "sc_flat1", 8, 8, 4).frequencies[:4])
    f_b = np.array(BandLibrary(str(tmp_path / "batched/chiral/bandgap_sc_flat1.json"),
                               "sc_flat1", 8, 8, 4).frequencies[:4])
    np.testing.assert_allclose(f_b, f_s, atol=2e-5)


def test_solve_batch_matches_serial():
    """Vmapped multi-k batch solve reproduces serial per-k results."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    solver = bs.KPointSolver(cfg, dtype=jnp.complex128)
    alphas = [np.array([np.pi, 0, 0]), np.array([np.pi, np.pi, 0])]
    batch = solver.solve_batch(alphas, seed=3)
    for a, rb in zip(alphas, batch):
        rs = solver.solve(a, seed=11)
        assert rb.status in (1, 5)
        np.testing.assert_allclose(rb.omega_re, rs.omega_re, atol=2e-5)


def test_apply_chunk_matches_unchunked():
    """Column-chunked operator application (the HBM-bounding lax.map path,
    auto-enabled at large N on accelerators) must be bit-equivalent in
    results to the unchunked apply."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.3, 0.0])
    r_full = bs.KPointSolver(cfg, dtype=jnp.complex128,
                             apply_chunk=0).solve(alpha, seed=5)
    r_chunk = bs.KPointSolver(cfg, dtype=jnp.complex128,
                              apply_chunk=2).solve(alpha, seed=5)
    assert r_chunk.status in (1, 5)
    np.testing.assert_allclose(r_chunk.omega_re, r_full.omega_re, atol=1e-10)


def test_apply_chunk_matches_unchunked_rs():
    """Same invariant on the pair-layout (GPU production) solver path."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.3, 0.0])
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    r_full = bs.KPointSolver(cfg, apply_chunk=0, **kw).solve(alpha, seed=5)
    r_chunk = bs.KPointSolver(cfg, apply_chunk=2, **kw).solve(alpha, seed=5)
    assert r_chunk.status in (1, 5)
    np.testing.assert_allclose(r_chunk.omega_re, r_full.omega_re, atol=1e-10)


def test_plane_wave_cold_start_converges_and_saves_iterations():
    """Plane-wave cold start (the default) solves correctly and takes no
    more iterations than the random start (typically ~1/3 fewer)."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=10, lattice="sc_curv", nev=6)
    alpha = np.array([np.pi, 0.0, 0.0])
    r_pw = bs.KPointSolver(cfg, x0_mode="plane_wave").solve(alpha, seed=0)
    r_rnd = bs.KPointSolver(cfg, x0_mode="random").solve(alpha, seed=0)
    assert r_pw.status in (1, 5)
    np.testing.assert_allclose(r_pw.omega_re, r_rnd.omega_re, atol=1e-6)
    assert r_pw.iterations <= r_rnd.iterations


def test_coarse_cold_start_matches_plane_wave():
    """Two-grid cold start (x0_mode='coarse'): solve on a coarse grid,
    lift the converged block by trigonometric interpolation, use it as the
    fine-grid x0 — frequencies must match the plane-wave-started solve on
    the production (rs, real-boundary) path."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=12, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.3, 0.0])
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    r_pw = bs.KPointSolver(cfg, x0_mode="plane_wave", **kw).solve(
        alpha, seed=3)
    sc = bs.KPointSolver(cfg, x0_mode="coarse:6", **kw)
    r_c = sc.solve(alpha, seed=3)
    assert sc._coarse_cache is not None
    assert sc._coarse_cache.cfg.n == 6
    assert r_c.status in (1, 5)
    np.testing.assert_allclose(r_c.omega_re, r_pw.omega_re, atol=1e-8)


def test_bandgap_failure_taxonomy(tmp_path, monkeypatch):
    """Numerical failures record [-1,-1] and the sweep continues; device /
    infrastructure errors abort the sweep (a broken accelerator session
    would otherwise instantly mass-fail every remaining k-point)."""
    calls = {"n": 0}

    def fake_solve(self, alpha, x0=None, seed=0, validate_result=True,
                   verbose=False):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("NaN residuals")  # numerical: contained
        raise RuntimeError(
            "UNAVAILABLE: device error — often a kernel fault")

    monkeypatch.setattr(bs.KPointSolver, "solve", fake_solve)
    import pytest as _pytest
    with _pytest.raises(RuntimeError, match="UNAVAILABLE"):
        bs.bandgap(n=8, lattice="sc_flat1", nev=4, gap=4,
                   output_dir=str(tmp_path), verbose=False)
    lib = BandLibrary(str(tmp_path / "chiral/bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    assert lib.failed_indices() == [0]      # only the numerical failure
    assert len(lib.pending_indices()) == 16  # device-error point NOT failed


def test_bandgap_warm_failure_cold_retry(tmp_path, monkeypatch):
    """A warm-started solve that fails numerically is retried once with a
    cold start before being recorded as [-1,-1] (the sc_curv crossdof
    N=120 sweep lost k=11/20 to warm-start spurious convergence while
    cold-started neighbors passed)."""
    calls = []

    class FakeResult:
        status = 1  # Status.CONVERGED
        iterations = 7
        wall_time = 0.5
        omega_re = np.arange(4) * 0.1
        report = None
        x = np.ones((4, 4))
        lambdas = omega_re

    def fake_solve(self, alpha, x0=None, seed=0, validate_result=True,
                   verbose=False):
        calls.append(x0 is not None)
        # every warm-started solve fails; cold starts succeed
        if x0 is not None:
            raise RuntimeError("spurious eigenvalues")
        return FakeResult()

    monkeypatch.setattr(bs.KPointSolver, "solve", fake_solve)
    from pcx import metrics as _metrics
    monkeypatch.setattr(_metrics.RunLogger, "from_result",
                        staticmethod(lambda *a, **k: {}))
    monkeypatch.setattr(_metrics.RunLogger, "log_solve",
                        lambda self, rec: None)
    err = bs.bandgap(n=8, lattice="sc_flat1", nev=4, gap=4,
                     output_dir=str(tmp_path), verbose=False)
    assert err == []                       # every point recovered
    # point 0: cold; points 1..: warm attempt + cold retry
    assert calls[0] is False
    assert True in calls[1:] and calls.count(False) >= len(calls) // 2
    lib = BandLibrary(str(tmp_path / "chiral/bandgap_sc_flat1.json"),
                      "sc_flat1", 8, 16, 4)
    assert lib.failed_indices() == []
    assert lib.pending_indices() == []


def test_bandgap_wnk_check(tmp_path, capsys):
    """Per-index library inspector (reference num_exp.py:254-276)."""
    path = str(tmp_path / "chiral/bandgap_sc_flat1.json")
    lib = BandLibrary(path, "sc_flat1", 8, 80, 10)
    lib.record(3, 12, 1.25, np.arange(10) * 0.1)
    out = bs.bandgap_wnk_check(8, "sc_flat1", output_dir=str(tmp_path),
                               indices=[3])
    assert len(out) == 1
    alpha, it, freq = out[0]
    assert int(it[0]) == 12
    np.testing.assert_allclose(freq, np.arange(10) * 0.1)
    assert "Index = 3" in capsys.readouterr().out


def test_bandgap_checks_infer_non_default_gap(tmp_path, capsys):
    """A library swept with gap != 20 must be indexed by its own k-path
    (the old fixed-GAP reconstruction mis-indexed)."""
    from pcx import lattices
    gap = 5
    alphas = lattices.k_path("sc_flat1", gap=gap)       # 16 segments * 5
    path = str(tmp_path / "chiral/bandgap_sc_flat1.json")
    lib = BandLibrary(path, "sc_flat1", 8, alphas.shape[0], 10)
    lib.record(7, 9, 0.5, np.arange(10) * 0.1)
    out = bs.bandgap_wnk_check(8, "sc_flat1", output_dir=str(tmp_path),
                               indices=[7])
    np.testing.assert_allclose(out[0][0], alphas[7])    # the TRUE wavevector
    failed, empty = bs.bandgap_history_check(8, "sc_flat1",
                                             output_dir=str(tmp_path))
    assert failed == [] and len(empty) == alphas.shape[0] - 1
    capsys.readouterr()


def test_solve_batch_rs_matches_serial():
    """Vmapped pair-layout batch (device-built symbols) reproduces serial
    rs solves — the accelerator k-batch throughput path."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    solver = bs.KPointSolver(cfg, dtype=jnp.complex128, solver_impl="rs",
                             real_boundary=True, refine=False)
    alphas = [np.array([np.pi, 0, 0]), np.array([np.pi, np.pi, 0])]
    batch = solver.solve_batch(alphas, seed=3)
    for a, rb_res in zip(alphas, batch):
        r_ser = solver.solve(a, seed=11)
        assert rb_res.status in (1, 5)
        np.testing.assert_allclose(rb_res.omega_re, r_ser.omega_re,
                                   atol=2e-5)


def test_solve_batch_segmented_matches_oneshot():
    """Segmented vmapped batch (the accelerator k-batch path)
    reproduces the one-shot batch exactly."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    alphas = [np.array([np.pi, 0, 0]), np.array([np.pi / 8, 0, 0])]
    one = bs.KPointSolver(cfg, segment_iters=0, **kw)
    seg = bs.KPointSolver(cfg, segment_iters=6, **kw)
    r_one = one.solve_batch(alphas, seed=7)
    r_seg = seg.solve_batch(alphas, seed=7)
    for a, b in zip(r_one, r_seg):
        assert a.status == b.status
        assert a.iterations == b.iterations
        np.testing.assert_allclose(b.omega_re, a.omega_re, atol=1e-8)


def test_warm_maxiter_caps_warm_solves_only():
    """warm_maxiter cuts off WARM-started segmented solves host-side (no
    recompile); cold solves keep the full maxiter budget.  (A warm chain
    stuck on a mixed subspace otherwise burns to maxiter=500 before the
    sweep's acceptance gate rejects it.)"""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    from pcx.solvers.lobpcg import Status
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False, segment_iters=4)
    alpha = np.array([np.pi, 0, 0])
    solver = bs.KPointSolver(cfg, solver_opts={"warm_maxiter": 8}, **kw)
    cold = solver.solve(alpha, seed=1, validate_result=False)
    assert cold.iterations > 8          # full budget on the cold solve
    # Warm start from a RANDOM block (not the converged cold block) so the
    # solve genuinely needs many iterations: the cap must fire.
    import jax
    x0 = jax.random.normal(
        jax.random.PRNGKey(0), (cold.x.shape[0],) + cold.x.shape[1:],
        dtype=jnp.float64).astype(jnp.complex128)
    warm = solver.solve(alpha, x0=x0, validate_result=False)
    assert warm.iterations <= 8
    assert warm.status == Status.MAXITER


def test_solver_lever_opts_preserve_frequencies():
    """The per-iteration A/B levers (refresh_every, ortho_passes,
    floor_patience, rr_gram='xla9') are pure cost/termination knobs: each
    must reproduce the default configuration's frequencies through the
    validation gate (protects lever A/B variants from silent
    mis-wiring)."""
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_curv", nev=4)
    alpha = np.array([np.pi, 0.3, 0.0])
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    base = bs.KPointSolver(cfg, **kw).solve(alpha, seed=3)
    for opts in ({"refresh_every": 12}, {"refresh_every": 16},
                 {"ortho_passes": 1}, {"floor_patience": 3},
                 {"rr_gram": "xla9"}, {"col_patience": 6},
                 {"col_patience": 3, "w_cap": "auto",
                  "floor_patience": 3},
                 {"lam_tol": 1e-9},
                 {"lam_tol": 1e-9, "lam_patience": 3, "col_patience": 3,
                  "w_cap": "auto", "floor_patience": 3}):
        r = bs.KPointSolver(cfg, solver_opts=dict(opts), **kw).solve(
            alpha, seed=3)
        assert r.status in (1, 5), (opts, r.status)
        np.testing.assert_allclose(r.omega_re, base.omega_re, atol=5e-6,
                                   err_msg=str(opts))


def test_committed_libraries_match_reference_goldens():
    """Every reference-resolution band library committed under output_c64/
    must match the reference's committed golden (paper_2/output/...) on
    all computed k-points: the executable form of the golden-parity claim
    (pure JSON compare, no solver).  Deviations sit at the c64-solve +
    discretization-difference scale (observed max 3.5e-3);
    a spurious mode would deviate >1e-2."""
    import glob
    import json
    import os

    ref_root = "/root/reference/paper_2/output"
    # the reference's chiral gyroid files/keys use long lattice names
    # (tools/golden_diff.py REF_NAME_CHIRAL)
    alias = {"bcc_sg": "bcc_single_gyroid", "bcc_dg": "bcc_double_gyroid"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    libs = sorted(
        glob.glob(os.path.join(repo, "output_c64/*/bandgap_*.json"))
        + glob.glob(os.path.join(repo, "output_c64_fast/*/bandgap_*.json")))
    assert libs, "no committed reference-resolution libraries"
    checked = 0
    for path in libs:
        diel = os.path.basename(os.path.dirname(path))
        name = os.path.basename(path)
        # reference file may use the short (crossdof) or long
        # (chiral/trivial) gyroid name regardless of the pcx short name
        cand_names = [name] + [name.replace(s, l) for s, l in alias.items()
                               if s in name]
        # the reference writes eps_opt=0 libraries with an explicit "0"
        # suffix (bandgap_sc_curv0.json, bandgap_bcc_double_gyroid0.json);
        # pcx suffixes only eps_opt != 0 — try the "0" forms after the
        # exact names
        cand_names += [c.replace(".json", "0.json") for c in list(cand_names)
                       if not c[-6].isdigit()]
        ref_path = next((p for p in
                         (os.path.join(ref_root, diel, c)
                          for c in cand_names) if os.path.exists(p)), None)
        if ref_path is None:
            continue
        ours, ref = json.load(open(path)), json.load(open(ref_path))

        def key_map(k, ref=ref):
            # reference keys always use the long gyroid names, even in
            # files named with the short ones (e.g. crossdof bcc_dg0)
            if k in ref:
                return k
            for s, l in alias.items():
                if s in k and k.replace(s, l) in ref:
                    return k.replace(s, l)
            return k
        for key in ours:
            if not key.endswith("_frequencies") or key_map(key) not in ref:
                continue
            a = np.array(ours[key], float)
            b = np.array(ref[key_map(key)], float)
            if a.shape != b.shape:
                continue
            it_key = key.replace("_frequencies", "_iterations")
            its = np.array(ours[it_key])
            computed = its[:, 0] > 0          # solved rows only
            mask = (computed[:, None] & ~np.isnan(b) & (b >= 0)
                    & ~np.isnan(a) & (a >= 0))
            if not mask.any():
                continue
            dev = np.abs(a - b)[mask].max()
            lattice = key.rsplit("_", 2)[0]
            assert dev < golden_threshold(diel, lattice), (path, key, dev)
            checked += 1
    # round-2's two chiral keys + round-3's crossdof sc_curv and
    # fast-lever fcc must all be present and compared
    assert checked >= 4, checked


def golden_threshold(diel: str, lattice: str) -> float:
    """Max |omega - omega_ref| allowed against a committed reference band
    library, per (dielectric type, lattice).

    Default 3.6e-3: the observed c64-solve + identical-discretization
    convergence-floor scale at N=120 (adjudicated on the committed libraries;
    worst accepted committed value 3.51e-3, chiral sc_curv).  The gyroid
    lattices get a documented exception: their near-degenerate doublet
    bands are under-converged in the COMMITTED reference data itself
    (reference TOL=1e-4 leaves the doublet splitting unresolved).  Round-4
    adjudication made this exact: a CONVERGED f64 solve of bcc_sg k=37
    (data/bcc_sg_k37_f64.json) matches the pcx c64 library row to ~1e-7
    on ALL TEN bands while the committed reference's band 7 is 8.96e-3
    above the f64 truth (wide doublet splitting, the under-convergence
    signature; 167 of 173 >2e-3 deviations have pcx BELOW ref — Ritz
    upper bounds).  The gyroid gate therefore bounds the REFERENCE's
    own error scale, 1.1e-2; pcx regressions on the gyroids are caught
    by test_bcc_sg_k37_matches_f64_ground_truth at 1e-5 instead.  A real
    5e-3 regression in any non-gyroid library still fails at 3.6e-3."""
    if lattice in ("bcc_sg", "bcc_dg", "bcc_single_gyroid",
                   "bcc_double_gyroid"):
        return 1.1e-2
    return 3.6e-3


def test_golden_threshold_rejects_synthetic_regression(tmp_path):
    """A synthetic 5e-3 perturbation of a non-gyroid library must trip the
    per-library gate (the round-3 blanket 8e-3 would have passed it)."""
    assert 5e-3 >= golden_threshold("chiral", "sc_curv")
    assert 5e-3 >= golden_threshold("pseudochiral_trivial", "fcc")
    # ... while the documented gyroid-doublet exception still stands.
    assert 5.2e-3 < golden_threshold("chiral", "bcc_sg")


def _rs_seg_solver(solver_opts=None, **kw):
    import jax.numpy as jnp
    from pcx.config import ProblemConfig
    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    base = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
                refine=False, segment_iters=4)
    base.update(kw)
    return bs.KPointSolver(cfg, solver_opts=solver_opts, **base)


def _random_block_like(x):
    import jax
    import jax.numpy as jnp
    return jax.random.normal(
        jax.random.PRNGKey(0), x.shape,
        dtype=jnp.float64).astype(jnp.complex128)


def test_doom_check_bails_stalled_warm_solve():
    """A warm solve whose tracked frequency-error bound is blatantly
    inadmissible at a segment boundary is cut there (status MAXITER,
    last_doom set) instead of burning to warm_maxiter — the round-4 bench
    lost ~50 s per warm rejection to exactly this (measured on a sweep)."""
    from pcx.solvers.lobpcg import Status
    solver = _rs_seg_solver(solver_opts={"warm_maxiter": 100}, maxiter=200)
    alpha = np.array([np.pi, 0, 0])
    cold = solver.solve(alpha, seed=1, validate_result=False)
    assert cold.iterations > 8
    warm = solver.solve(alpha, x0=_random_block_like(cold.x),
                        validate_result=False)
    assert warm.status == Status.MAXITER
    assert solver.last_doom is not None
    it_doom, bound = solver.last_doom
    assert warm.iterations <= 12, warm.iterations   # 1-2 segments, not 100
    assert bound > 1e-2                             # blatant violation


def test_doom_check_spares_healthy_warm_solves():
    """A genuinely warm solve (previous converged subspace) must pass
    untouched: no doom bail, terminal status from the solver itself."""
    from pcx.solvers.lobpcg import Status
    solver = _rs_seg_solver()
    alpha = np.array([np.pi, 0, 0])
    cold = solver.solve(alpha, seed=1, validate_result=False)
    warm = solver.solve(alpha, x0=cold.x, validate_result=False)
    assert warm.status in (Status.CONVERGED, Status.FLOOR)
    assert solver.last_doom is None


def test_doom_check_off_burns_warm_maxiter():
    """doom_check=0 restores the round-4 behavior: the stalled warm solve
    runs to the warm_maxiter cap."""
    from pcx.solvers.lobpcg import Status
    solver = _rs_seg_solver(solver_opts={"warm_maxiter": 12,
                                         "doom_check": 0}, maxiter=200)
    alpha = np.array([np.pi, 0, 0])
    cold = solver.solve(alpha, seed=1, validate_result=False)
    warm = solver.solve(alpha, x0=_random_block_like(cold.x),
                        validate_result=False)
    assert warm.status == Status.MAXITER
    assert warm.iterations == 12
    assert solver.last_doom is None


def test_precompile_buckets_compiles_and_preserves_solve():
    """precompile_buckets (bench warmup: kill the ~300 s mid-sweep bucket
    compile) must compile every non-full w_cap bucket program via no-op
    it_stop=0 runs and leave subsequent solves unchanged."""
    from pcx.solvers.lobpcg import Status
    solver = _rs_seg_solver(solver_opts={"w_cap": "auto"})
    alpha = np.array([np.pi, 0, 0])
    n_buckets = solver.precompile_buckets(alpha)
    assert n_buckets == 2, n_buckets   # m // 4 and m // 2 buckets
    r = solver.solve(alpha, seed=1, validate_result=False)
    assert r.status in (Status.CONVERGED, Status.FLOOR)


def test_heartbeat_touched_per_segment(tmp_path, monkeypatch):
    """PCX_HEARTBEAT liveness: every completed solver segment touches the
    file (the supervisor's heartbeat watchdog reads its mtime)."""
    hb = tmp_path / "beat"
    monkeypatch.setenv("PCX_HEARTBEAT", str(hb))
    solver = _rs_seg_solver()
    solver.solve(np.array([np.pi, 0, 0]), seed=1, validate_result=False)
    assert hb.exists()


def _f64_truth_files():
    """All committed f64 ground-truth pins (data/*_f64.json).

    Caveat: these truths are produced by pcx itself at the
    SAME discretization as the c64 rows they validate, so the pin proves
    CONVERGENCE quality (the c64 solve reached the f64 limit of this
    discretization), not correctness against an independent
    discretization — that arm is covered by the golden diffs against the
    committed reference libraries (independent code + discretization,
    looser gyroid gate for the reference's own under-convergence)."""
    import glob
    import json
    import os
    out = []
    for path in sorted(glob.glob(os.path.join(
            os.path.dirname(__file__), "..", "data", "*_f64.json"))):
        truth = json.load(open(path))
        # Legacy schema (round-4 bcc_sg file): no lattice/n metadata.
        truth.setdefault("lattice", "bcc_sg")
        truth.setdefault("n", 120)
        truth.setdefault("diel", "chiral")
        truth.setdefault("eps_opt", 0)
        out.append((os.path.basename(path), truth))
    return out


@pytest.mark.parametrize("name,truth", _f64_truth_files())
def test_library_rows_match_f64_ground_truth(name, truth):
    """The REAL accuracy gate for the gyroid libraries: each committed c64
    library row with a CONVERGED f64 ground-truth pin (e.g. bcc_sg k=37,
    the adjudicated worst point, where the committed REFERENCE is 8.96e-3
    above truth on band 7) must match the f64 truth to 1e-5 on all ten
    bands.  This is what the loosened gyroid golden_threshold delegates
    pcx-regression detection to.  Parameterized over data/*_f64.json so
    each completed gyroid library extends the pin by committing one
    converged f64 solve at its worst-deviation k-point
    (tools/f64_truth.py).  See _f64_truth_files for the shared-
    discretization caveat."""
    import json
    import os
    lat, n = truth["lattice"], truth["n"]
    suffix = str(truth["eps_opt"]) if truth["eps_opt"] else ""
    lib_path = os.path.join(os.path.dirname(__file__), "..", "output_c64",
                            truth["diel"], f"bandgap_{lat}{suffix}.json")
    if not os.path.exists(lib_path):
        pytest.skip(f"no committed library for {name}")
    lib = json.load(open(lib_path))
    iters = lib.get(f"{lat}_{n}_iterations")
    if iters is None:
        pytest.skip(f"library has no N={n} rows for {name}")
    k = truth["k"]
    if iters[k][0] <= 0:
        pytest.skip(f"k={k} not yet computed in the committed library")
    ours = np.asarray(lib[f"{lat}_{n}_frequencies"][k][:10], float)
    want = np.asarray(truth["omega_f64"][:10], float)
    np.testing.assert_allclose(ours, want, atol=1e-5)


@pytest.mark.slow
def test_live_c64_solve_matches_f64_ground_truth():
    """LIVE regression gate: the committed-vs-committed pin
    above only fires after a re-sweep re-commits the library, so a solver
    regression would hide until then.  This runs the actual c64 solver at
    a small N against a committed f64 truth generated at the SAME
    (lattice, N, k) — a solver regression fails here without any re-sweep.
    Gate 5e-5: the c64 convergence floor at N=24 (measured ~1e-6) plus
    margin; a genuine subspace/phantom regression is >1e-3."""
    import json
    import os
    truth_path = os.path.join(os.path.dirname(__file__), "..",
                              "data", "bcc_sg_n24_k37_f64.json")
    if not os.path.exists(truth_path):
        pytest.skip("small-N f64 truth not committed yet")
    truth = json.load(open(truth_path))
    import jax.numpy as jnp
    from pcx import lattices
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    alpha = lattices.k_path(truth["lattice"])[truth["k"]]
    np.testing.assert_allclose(
        np.asarray(alpha, float) / np.pi, truth["alpha_over_pi"],
        atol=1e-9)
    cfg = ProblemConfig(n=truth["n"], lattice=truth["lattice"],
                        diel_type=truth["diel"], eps_opt=truth["eps_opt"],
                        nev=10)
    solver = KPointSolver(cfg, dtype=jnp.complex64, solver_impl="rs",
                          real_boundary=True, refine=False,
                          solver_opts={"lam_tol": 2e-6, "floor_patience": 3,
                                       "col_patience": 3})
    res = solver.solve(alpha, seed=0)
    got = np.asarray(res.omega_re[:10], float)
    want = np.asarray(truth["omega_f64"][:10], float)
    np.testing.assert_allclose(got, want, atol=5e-5)
