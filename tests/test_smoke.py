"""Smoke tier: a <2-minute pre-flight (`pytest -m smoke`) so hardware
campaigns can gate on a cheap sanity pass instead of the ~30-min fast suite.

One tiny end-to-end solve per production-critical path (complex softlock,
pair-layout rs, Davidson, each dielectric type) plus the checkpoint/resume
and library-schema invariants.  Every solve is self-validating: penalized
vs recomputed frequencies must agree (reference gate,
paper_2/numerical_experiments.py:152-156).
"""

import json

import numpy as np
import pytest

from pcx.bandstructure import KPointSolver, bandgap, eigen_1p
from pcx.config import ProblemConfig

pytestmark = pytest.mark.smoke

ALPHA = np.array([np.pi, 0.0, 0.0])


def _check(res, nev):
    assert np.isfinite(np.asarray(res.omega[:nev])).all()
    dev = np.max(np.abs(np.asarray(res.omega[:nev])
                        - np.asarray(res.omega_re[:nev])))
    assert dev < 1e-3


def test_eigen_1p_chiral_softlock():
    res = eigen_1p(8, "sc_curv", ALPHA, nev=4, verbose=False)
    _check(res, 4)


def test_eigen_1p_pseudochiral_trivial():
    res = eigen_1p(8, "sc_curv", ALPHA, nev=4,
                   diel_type="pseudochiral_trivial", verbose=False)
    _check(res, 4)


def test_eigen_1p_pseudochiral_crossdof():
    res = eigen_1p(8, "sc_curv", ALPHA, nev=4,
                   diel_type="pseudochiral_crossdof", verbose=False)
    _check(res, 4)


def test_rs_pair_solver_path():
    # the accelerator production implementation, forced on CPU
    import jax.numpy as jnp
    s = KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                     dtype=jnp.complex128, solver_impl="rs")
    res = s.solve(ALPHA, verbose=False)
    _check(res, 4)


def test_davidson_path():
    s = KPointSolver(ProblemConfig(n=8, lattice="sc_curv", nev=4),
                     solver="davidson")
    res = s.solve(ALPHA, verbose=False)
    _check(res, 4)


def test_sweep_schema_resume_and_failed_row_retry(tmp_path):
    out = str(tmp_path)
    bandgap(n=8, lattice="sc_flat1", nev=4, gap=2, output_dir=out,
            indices=[0, 1])
    path = tmp_path / "chiral" / "bandgap_sc_flat1.json"
    lib = json.loads(path.read_text())
    # reference schema: <flag>_<N>_{iterations,frequencies}
    # (paper_2/numerical_experiments.py:355-366)
    it = lib["sc_flat1_8_iterations"]
    fq = lib["sc_flat1_8_frequencies"]
    assert len(it) == len(fq) == 8 and len(fq[0]) == 4
    assert it[0][0] > 0 and it[1][0] > 0 and it[2][0] == 0
    # corrupt one computed row to failed; resume must recompute exactly
    # the failed + pending rows (reference scan, num_exp.py:360-404)
    lib["sc_flat1_8_iterations"][1] = [-1, -1]
    path.write_text(json.dumps(lib))
    bandgap(n=8, lattice="sc_flat1", nev=4, gap=2, output_dir=out)
    lib = json.loads(path.read_text())
    rows = lib["sc_flat1_8_iterations"]
    assert all(r[0] > 0 for r in rows)
    assert np.isfinite(np.asarray(lib["sc_flat1_8_frequencies"])).all()
