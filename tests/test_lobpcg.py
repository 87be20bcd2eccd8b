"""LOBPCG unit tests on explicit matrices (decoupled from the PDE,
mirroring the reference's lobpcg_default usage, paper_2/lobpcg.py:28-61)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pcx.solvers import lobpcg as lob
from pcx.solvers.lobpcg import Status


def _random_hpd(n, rng, cond=50.0):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    d = np.geomspace(1.0, cond, n)
    return (q * d) @ q.conj().T


def test_smallest_eigs_dense(rng):
    n, nev = 120, 6
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    res = lob.lobpcg_default(jnp.asarray(a), nev=nev, rlx=4, maxiter=300,
                             tol=1e-8)
    assert int(res.status) == Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want, rtol=1e-6)


def test_largest_eigs_dense(rng):
    n, nev = 80, 3
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[-nev:][::-1]
    res = lob.lobpcg_default(jnp.asarray(a), nev=nev, rlx=4, maxmin="max",
                             maxiter=300, tol=1e-7)
    got = np.sort(np.asarray(res.lambdas))[::-1][:nev]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_locking_matches_nolock(rng):
    n, nev = 100, 5
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    h = lambda b: b @ jnp.asarray(a).T
    ident = lambda b: b
    r1 = lob.lobpcg_sep_softlock(h, ident, x0, nev, tol=1e-8, maxiter=300)
    r2 = lob.lobpcg_sep_nolock(h, ident, x0, nev, tol=1e-8, maxiter=300)
    np.testing.assert_allclose(np.asarray(r1.lambdas[:nev]), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(r2.lambdas[:nev]), want, rtol=1e-6)


def test_preconditioner_accelerates(rng):
    """Jacobi preconditioning must reduce iteration count on an
    ill-conditioned diagonal-dominant matrix."""
    n, nev = 200, 4
    d = np.geomspace(1, 1e4, n)
    a = np.diag(d) + 0.01 * _random_hpd(n, rng, cond=10)
    aj = jnp.asarray(a)
    h = lambda b: b @ aj.T
    dinv = jnp.asarray(1.0 / np.diag(a).real)
    prec = lambda b: b * dinv
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    r_plain = lob.lobpcg_sep_softlock(h, lambda b: b, x0, nev, tol=1e-6,
                                      maxiter=400)
    r_prec = lob.lobpcg_sep_softlock(h, prec, x0, nev, tol=1e-6, maxiter=400)
    assert int(r_prec.iterations) < int(r_plain.iterations)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    np.testing.assert_allclose(np.asarray(r_prec.lambdas[:nev]), want,
                               rtol=1e-5)


def test_gep_dense(rng):
    n, nev = 90, 4
    a = _random_hpd(n, rng)
    b = _random_hpd(n, rng, cond=50)
    import scipy.linalg as sla
    want = np.sort(sla.eigh(a, b, eigvals_only=True))[:nev]
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    res = lob.lobpcg_gep(lambda v: v @ aj.T, lambda v: v @ bj.T,
                         lambda v: v, x0, nev, tol=1e-7, maxiter=500)
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want, rtol=1e-5)


def test_shift_invariance(rng):
    n, nev = 60, 3
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    res = lob.lobpcg_sep_softlock(lambda v: v @ aj.T, lambda v: v, x0, nev,
                                  shift=2.5, tol=1e-8, maxiter=300)
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want, rtol=1e-6)


def test_jit_compilable(rng):
    """The whole solve must trace into a single jitted computation."""
    n, nev = 64, 3
    a = jnp.asarray(_random_hpd(n, rng))
    x0 = jnp.asarray(rng.normal(size=(nev + 3, n))
                     + 1j * rng.normal(size=(nev + 3, n)))

    @jax.jit
    def solve(x0):
        return lob.lobpcg_sep_softlock(lambda v: v @ a.T, lambda v: v,
                                       x0, nev, tol=1e-7, maxiter=200)

    res = solve(x0)
    want = np.sort(np.linalg.eigvalsh(np.asarray(a)))[:nev]
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want, rtol=1e-5)


def test_single_precision_converges(rng):
    """complex64 path (the GPU production dtype) must converge to ~1e-4."""
    n, nev = 150, 5
    a = _random_hpd(n, rng, cond=100.0).astype(np.complex64)
    want = np.sort(np.linalg.eigvalsh(a.astype(np.complex128)))[:nev]
    aj = jnp.asarray(a)
    x0 = jnp.asarray((rng.normal(size=(nev + 4, n))
                      + 1j * rng.normal(size=(nev + 4, n))).astype(np.complex64))
    res = lob.lobpcg_sep_softlock(lambda v: v @ aj.T, lambda v: v, x0, nev,
                                  tol=1e-4, maxiter=500)
    assert res.x.dtype == jnp.complex64
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-3, atol=1e-3)


def test_residual_history_monotone_tail(rng):
    n, nev = 100, 4
    a = _random_hpd(n, rng)
    res = lob.lobpcg_default(jnp.asarray(a), nev=nev, rlx=4, tol=1e-8,
                             maxiter=300)
    his = np.asarray(res.res_history)
    his = his[~np.isnan(his)]
    assert len(his) >= 3
    assert his[-1] < his[0]


def test_davidson_dense(rng):
    from pcx.solvers import davidson as dav
    n, nev = 100, 4
    a = _random_hpd(n, rng, cond=30)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 2, n))
                     + 1j * rng.normal(size=(nev + 2, n)))
    res = dav.davidson_sep(lambda v: v @ aj.T, lambda v: v, x0, nev,
                           tol=1e-4, maxiter=200, subspace=30)
    assert int(res.status) == 1  # CONVERGED at tol
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-3)


def test_jacobi_davidson_dense(rng):
    from pcx.solvers import davidson as dav
    n, nev = 100, 3
    a = _random_hpd(n, rng, cond=30)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 2, n))
                     + 1j * rng.normal(size=(nev + 2, n)))
    res = dav.jd_sep(lambda v: v @ aj.T, lambda v: v, x0, nev,
                     tol=1e-5, maxiter=150, subspace=30, inner_steps=4)
    assert int(res.status) == 1  # CONVERGED at tol
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-4)


def test_descent_dense(rng):
    from pcx.solvers.lobpcg import descent_sep
    n, nev = 80, 3
    a = _random_hpd(n, rng, cond=20)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 3, n))
                     + 1j * rng.normal(size=(nev + 3, n)))
    res = descent_sep(lambda v: v @ aj.T, lambda v: v, x0, nev,
                      tol=1e-7, maxiter=500)
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-5)


def test_lobpcg_svd_smallest(rng):
    from pcx.solvers.lobpcg import lobpcg_svd
    n = 60
    a = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    a = a + 3 * np.eye(n)  # keep sigma_min away from 0
    want = np.sort(np.linalg.svd(a, compute_uv=False))[:3]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(6, n)) + 1j * rng.normal(size=(6, n)))
    res = lobpcg_svd(lambda v: v @ aj.T, lambda v: v @ aj.conj(), x0, 3,
                     tol=1e-9, maxiter=400)
    np.testing.assert_allclose(np.asarray(res.lambdas[:3]), want, rtol=1e-4)


def test_pair_solver_matches_complex_dense(rng):
    """lobpcg_sep_rs (pair layout, the GPU production path) must reproduce
    the complex solver's eigenvalues on a dense Hermitian problem."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 100, 5
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    x0c = (rng.normal(size=(nev + 4, n))
           + 1j * rng.normal(size=(nev + 4, n)))
    ar = jnp.asarray(a.real, jnp.float64)
    ai = jnp.asarray(a.imag, jnp.float64)

    def h_pair(v):
        # pair form of the complex solver's h(v) = v @ a.T (rows = vectors)
        return (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)

    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    res = lobpcg_sep_rs(h_pair, ident, x0p, nev, tol=1e-8, maxiter=300)
    assert int(res.status) == 1
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-6)


def test_pair_solver_matches_complex_maxwell(rng):
    """End-to-end KPointSolver equivalence: solver_impl='rs' vs 'complex'
    on the Maxwell problem (c64, matmul DFT) for both dielectric families."""
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    alpha = np.array([np.pi, 0.0, 0.0])
    for diel in ("chiral", "pseudochiral_crossdof"):
        cfg = ProblemConfig(n=12, lattice="sc_curv", diel_type=diel, nev=4)
        sc = KPointSolver(cfg, dtype=jnp.complex64, solver_impl="complex",
                          fft_mode="matmul", refine=False)
        sr = KPointSolver(cfg, dtype=jnp.complex64, solver_impl="rs",
                          refine=False)
        rc = sc.solve(alpha, seed=0)
        rp = sr.solve(alpha, seed=0)
        assert np.abs(rp.omega - rp.omega_re).max() < 1e-3
        np.testing.assert_allclose(rp.omega_re, rc.omega_re, atol=2e-5)


def test_masked_svqb_drop_pair_matches_complex(rng):
    """Pair and complex SVQB agree on surviving spans and masks."""
    from pcx.solvers import rayleigh_ritz as rr
    m, d = 8, 300
    b = rng.normal(size=(m, d)) + 1j * rng.normal(size=(m, d))
    b[3] = b[1] * (2.0 + 1j) + 1e-12 * b[0]   # dependent row
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    mask = np.ones(m)
    qc, _, mc = rr.masked_svqb_drop(jnp.asarray(b), jnp.asarray(mask), 1e-5)
    qp, _, mp = rr.masked_svqb_drop_p(
        (jnp.asarray(b.real), jnp.asarray(b.imag)), jnp.asarray(mask), 1e-5)
    np.testing.assert_allclose(np.asarray(mc), np.asarray(mp))
    assert int(np.asarray(mc).sum()) == m - 1     # one direction dropped
    # surviving rows orthonormal
    q = np.asarray(qp[0]) + 1j * np.asarray(qp[1])
    g = q @ q.conj().T
    keep = np.asarray(mp).astype(bool)
    np.testing.assert_allclose(g[np.ix_(keep, keep)], np.eye(m - 1),
                               atol=1e-9)


def test_gep_embedding_pencil_matches_chol(rng):
    """The f64 real-embedding pencil solver inside lobpcg_gep agrees
    with the complex-Cholesky path, in c64 (forced) and c128 (forced)."""
    n, nev = 80, 4
    a = _random_hpd(n, rng)
    b = _random_hpd(n, rng, cond=30)
    import scipy.linalg as sla
    want = np.sort(sla.eigh(a, b, eigvals_only=True))[:nev]
    for cdt, rtol in ((jnp.complex64, 2e-3), (jnp.complex128, 1e-5)):
        aj, bj = jnp.asarray(a, cdt), jnp.asarray(b, cdt)
        x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                         + 1j * rng.normal(size=(nev + 4, n)), cdt)
        res = lob.lobpcg_gep(lambda v: v @ aj.T, lambda v: v @ bj.T,
                             lambda v: v, x0, nev, tol=1e-5, maxiter=500,
                             rr_pencil="embedding")
        np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                                   rtol=rtol)


def test_sep_max_embedding_pencil(rng):
    """Largest-eigenvalue mode through the embedding pencil (the
    Cholesky-free route for max-mode/condition-number studies)."""
    n, nev = 70, 3
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[-nev:][::-1]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    res = lob.lobpcg_sep_max(lambda v: v @ aj.T, x0, nev, tol=1e-7,
                             maxiter=600, rr_pencil="embedding")
    lam = np.sort(np.asarray(res.lambdas))[::-1][:nev]
    np.testing.assert_allclose(lam, want, rtol=1e-4)


def test_sep_max_loose_tol_no_false_convergence(rng):
    """Regression (round 4): at a LOOSE tolerance and a large spectral
    scale, max-mode must not stop at iteration ~1 with a wrong lambda_max.
    The inverse formulation's M-orthonormal columns have 2-norm
    ~ 1/sqrt(lambda) (~3e-3 here), so an ABSOLUTE residual test fires
    immediately; the per-column RELATIVE test keeps iterating.  Observed
    pre-fix: CONVERGED at iter 1, lambda 35% below truth (the N=24
    Maxwell operator showed the same signature via the smoke's
    power-method cross-check)."""
    n, nev = 80, 2
    a = _random_hpd(n, rng)
    a = a * (1e5 / np.max(np.linalg.eigvalsh(a)))  # lambda_max = 1e5
    want = np.sort(np.linalg.eigvalsh(a))[-nev:][::-1]
    aj = jnp.asarray(a)
    x0 = jnp.asarray(rng.normal(size=(nev + 4, n))
                     + 1j * rng.normal(size=(nev + 4, n)))
    res = lob.lobpcg_sep_max(lambda v: v @ aj.T, x0, nev, tol=1e-3,
                             maxiter=600)
    lam = np.sort(np.asarray(res.lambdas))[::-1][:nev]
    assert int(res.iterations) > 2
    np.testing.assert_allclose(lam, want, rtol=1e-2)


def test_floor_status_at_unattainable_tol():
    """With an unattainable tolerance the c64 production solver must stop
    via the scale-aware FLOOR gate soon after stagnating at its attainable
    accuracy — not burn maxiter — and the result must still pass the
    physical validation gate."""
    import numpy as np
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig

    cfg = ProblemConfig(n=16, lattice="sc_curv", nev=6)
    solver = KPointSolver(cfg, dtype=jnp.complex64, tol=1e-12, maxiter=300,
                          solver_impl="rs", real_boundary=True, refine=False)
    r = solver.solve(np.array([np.pi, 0, 0]), seed=0)
    assert r.status == 5, r.status          # Status.FLOOR
    assert r.iterations < 150, r.iterations  # patience fired, not maxiter
    # attainable accuracy still passes the physical gate
    assert float(np.abs(r.omega - r.omega_re).max()) < 1e-3


def test_rs_parts_segmented_matches_oneshot(rng):
    """Trampolined execution (rs_solver_parts with small it_stop segments,
    the accelerator production path) must reproduce the one-shot
    lobpcg_sep_rs exactly: same termination status, iteration count, and
    eigenvalues."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs, rs_solver_parts
    from pcx.solvers.lobpcg import Status
    n, nev = 100, 5
    a = _random_hpd(n, rng)
    x0c = (rng.normal(size=(nev + 4, n))
           + 1j * rng.normal(size=(nev + 4, n)))
    ar = jnp.asarray(a.real, jnp.float64)
    ai = jnp.asarray(a.imag, jnp.float64)

    def h_pair(v):
        return (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)

    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    one = lobpcg_sep_rs(h_pair, ident, x0p, nev, tol=1e-8, maxiter=300)

    init, run_to, finalize = rs_solver_parts(
        h_pair, ident, x0p[0].shape, x0p[0].dtype, nev,
        tol=1e-8, maxiter=300)
    state = init(x0p)
    it = 0
    for _ in range(300 // 7 + 3):
        state = run_to(state, min(it + 7, 300))
        it = int(state["it"])
        if int(state["status"]) != Status.RUNNING or it >= 300:
            break
    seg = finalize(state)

    assert int(seg.status) == int(one.status)
    assert int(seg.iterations) == int(one.iterations)
    np.testing.assert_allclose(np.asarray(seg.lambdas),
                               np.asarray(one.lambdas), rtol=1e-10)


def test_kpoint_solver_segmented_matches_oneshot():
    """KPointSolver(segment_iters=k) must match segment_iters=0 on the rs
    Maxwell path (frequencies and iteration count) — pins the sweep's
    trampolined driver to the tested one-shot trace."""
    import numpy as np
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig

    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    alpha = np.array([np.pi / 10, 0.0, 0.0])  # near-Gamma: the fault regime
    r_one = KPointSolver(cfg, segment_iters=0, **kw).solve(alpha, seed=2)
    r_seg = KPointSolver(cfg, segment_iters=5, **kw).solve(alpha, seed=2)
    assert r_seg.status == r_one.status
    assert r_seg.iterations == r_one.iterations
    np.testing.assert_allclose(r_seg.omega_re, r_one.omega_re, atol=1e-8)


def test_rs_w_cap_full_width_is_identical(rng):
    """w_cap == m must emit the unchanged production trace (bitwise-equal
    run: same status, iterations and Ritz values)."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 100, 5
    a = _random_hpd(n, rng)
    x0c = (rng.normal(size=(nev + 4, n))
           + 1j * rng.normal(size=(nev + 4, n)))
    ar, ai = jnp.asarray(a.real), jnp.asarray(a.imag)
    h = lambda v: (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    base = lobpcg_sep_rs(h, ident, x0p, nev, tol=1e-8, maxiter=300)
    capd = lobpcg_sep_rs(h, ident, x0p, nev, tol=1e-8, maxiter=300,
                         w_cap=nev + 4)
    assert int(capd.status) == int(base.status)
    assert int(capd.iterations) == int(base.iterations)
    np.testing.assert_array_equal(np.asarray(capd.lambdas),
                                  np.asarray(base.lambdas))


def test_rs_w_cap_compacted_converges(rng):
    """W/P width capped below m still converges to the same eigenvalues
    (more iterations, fewer FLOPs/iter) — the static-shape analog of the
    reference's n_loc = m + 2*n_act compaction (paper_2/lobpcg.py:423).
    Well-separated spectrum: capping below the ACTIVE count (which the
    auto trampoline never does — it picks the smallest bucket >= n_act)
    is the worst case, trading directions for iterations."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 100, 5
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    lam = np.linspace(1.0, 50.0, n)
    a = (q * lam) @ q.conj().T
    want = np.sort(lam)[:nev]
    x0c = (rng.normal(size=(nev + 4, n))
           + 1j * rng.normal(size=(nev + 4, n)))
    ar, ai = jnp.asarray(a.real), jnp.asarray(a.imag)
    h = lambda v: (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    for wc in (4, 2):
        res = lobpcg_sep_rs(h, ident, x0p, nev, tol=1e-8, maxiter=300,
                            w_cap=wc)
        assert int(res.status) == 1
        np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                                   rtol=1e-6)


def test_rs_w_cap_no_starvation_without_locking(rng):
    """Anti-starvation regression: with locking OFF the active set never
    shrinks, so a fixed w_cap < m must ROTATE its W/P slots across
    columns (residual-priority selection) — stable index order would
    hand the slots to columns 0..wc-1 forever and the rest would stall
    far above tol."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 100, 4
    q, _ = np.linalg.qr(rng.normal(size=(n, n))
                        + 1j * rng.normal(size=(n, n)))
    lam = np.linspace(1.0, 50.0, n)
    a = (q * lam) @ q.conj().T
    want = np.sort(lam)[:nev]
    x0c = (rng.normal(size=(nev + 2, n))
           + 1j * rng.normal(size=(nev + 2, n)))
    ar, ai = jnp.asarray(a.real), jnp.asarray(a.imag)
    h = lambda v: (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    res = lobpcg_sep_rs(h, ident, x0p, nev, tol=1e-8, maxiter=300,
                        locking=False, w_cap=2)
    assert int(res.status) == 1, int(res.status)
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-6)


def test_rs_parts_w_cap_bucket_switch(rng):
    """The trampoline may re-enter run_to through a DIFFERENT w_cap trace
    mid-solve (solver_opts {"w_cap": "auto"}): the state pytree is
    w_cap-independent, so shrinking the bucket between segments must keep
    the solve convergent and correct."""
    from pcx.solvers.lobpcg_rs import rs_solver_parts
    from pcx.solvers.lobpcg import Status
    n, nev = 100, 5
    m = nev + 4
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    x0c = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
    ar, ai = jnp.asarray(a.real), jnp.asarray(a.imag)
    h = lambda v: (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))

    mk = lambda wc: rs_solver_parts(h, ident, x0p[0].shape, x0p[0].dtype,
                                    nev, tol=1e-8, maxiter=400, w_cap=wc)
    init, _, finalize = mk(m)
    runs = {wc: mk(wc)[1] for wc in (m, m // 2, m // 4)}
    state = init(x0p)
    it, caps = 0, [m, m // 2, m // 4, m // 2, m]
    for seg in range(80):
        state = runs[caps[seg % len(caps)]](state, min(it + 6, 400))
        it = int(state["it"])
        if int(state["status"]) != Status.RUNNING or it >= 400:
            break
    res = finalize(state)
    assert int(res.status) == Status.CONVERGED
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=1e-6)


def test_rs_col_floor_locking_f32(rng):
    """Per-column floor locking (col_patience > 0): with an unattainable
    f32 tolerance the solve must still reach the attainable accuracy, end
    in FLOOR, and the state's active count must drop below m as columns
    hit their floors (the FLOP-savings signal for w_cap='auto')."""
    from pcx.solvers.lobpcg_rs import rs_solver_parts
    from pcx.solvers.lobpcg import Status
    n, nev = 100, 5
    m = nev + 4
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    x0c = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
    ar = jnp.asarray(a.real, jnp.float32)
    ai = jnp.asarray(a.imag, jnp.float32)
    h = lambda v: (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)
    ident = lambda v: v
    x0p = (jnp.asarray(x0c.real, jnp.float32),
           jnp.asarray(x0c.imag, jnp.float32))

    init, run_to, finalize = rs_solver_parts(
        h, ident, x0p[0].shape, jnp.float32, nev, tol=1e-12, maxiter=200,
        col_patience=5, floor_patience=8)
    state = init(x0p)
    it, min_act = 0, m
    for _ in range(60):
        state = run_to(state, min(it + 5, 200))
        it = int(state["it"])
        min_act = min(min_act, int(state["n_act"]))
        if int(state["status"]) != Status.RUNNING or it >= 200:
            break
    res = finalize(state)
    assert int(res.status) == Status.FLOOR
    assert min_act < m            # some columns actually floor-locked
    np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                               rtol=2e-4)


def test_kpoint_solver_w_cap_auto_matches_default():
    """solver_opts {"w_cap": "auto", "col_patience": k} on the segmented
    Maxwell path must reproduce the default-path frequencies: bucket
    selection only ever removes directions of INACTIVE columns, so
    physics is unchanged while W/P FLOPs shrink with locking."""
    import numpy as np
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig

    cfg = ProblemConfig(n=8, lattice="sc_flat1", nev=4)
    kw = dict(dtype=jnp.complex128, solver_impl="rs", real_boundary=True,
              refine=False)
    alpha = np.array([np.pi / 2, 0.0, 0.0])
    base = KPointSolver(cfg, segment_iters=5, **kw).solve(alpha, seed=3)
    auto = KPointSolver(cfg, segment_iters=5,
                        solver_opts={"w_cap": "auto", "col_patience": 6},
                        **kw).solve(alpha, seed=3)
    assert auto.status in (1, 5)
    np.testing.assert_allclose(auto.omega_re, base.omega_re, atol=1e-7)
    assert np.abs(auto.omega - auto.omega_re).max() < 1e-3


def test_rs_rank_deficient_start_no_phantom(rng):
    """A rank-deficient start block (duplicated column — possible from a
    degenerate warm start or a coarse-grid lift) must NOT inject a phantom
    below-spectrum Ritz value: init() decouples dropped columns ABOVE the
    spectrum, so the bottom nev eigenvalues stay correct."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 100, 5
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    x0c = (rng.normal(size=(nev + 4, n))
           + 1j * rng.normal(size=(nev + 4, n)))
    x0c[1] = x0c[0]          # exact duplicate -> SVQB drops one column
    ar = jnp.asarray(a.real, jnp.float64)
    ai = jnp.asarray(a.imag, jnp.float64)

    def h_pair(v):
        return (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)

    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    res = lobpcg_sep_rs(h_pair, lambda v: v, x0p, nev, tol=1e-8,
                        maxiter=300)
    lam = np.sort(np.asarray(res.lambdas))[:nev]
    np.testing.assert_allclose(lam, want, rtol=1e-6)
    assert lam[0] > 0.0  # no phantom theta=0 below the HPD spectrum


def test_rs_lam_patience_validation():
    from pcx.solvers.lobpcg_rs import rs_solver_parts
    with pytest.raises(ValueError, match="lam_patience"):
        rs_solver_parts(lambda v: v, lambda v: v, (4, 8), jnp.float64, 2,
                        lam_tol=1e-6, lam_patience=0)


def test_rs_xla9_full_and_mirror_match(rng):
    """rr_gram='xla9' (concat-free Gram) with and without triangle
    mirroring must match the default stacked Gram path."""
    from pcx.solvers.lobpcg_rs import lobpcg_sep_rs
    n, nev = 80, 4
    a = _random_hpd(n, rng)
    want = np.sort(np.linalg.eigvalsh(a))[:nev]
    ar = jnp.asarray(a.real, jnp.float64)
    ai = jnp.asarray(a.imag, jnp.float64)

    def h_pair(v):
        return (v[0] @ ar.T - v[1] @ ai.T, v[0] @ ai.T + v[1] @ ar.T)

    x0c = (rng.normal(size=(nev + 3, n))
           + 1j * rng.normal(size=(nev + 3, n)))
    x0p = (jnp.asarray(x0c.real), jnp.asarray(x0c.imag))
    for kw in ({"rr_gram": "xla9"},
               {"rr_gram": "xla9", "rr_mirror": True}):
        res = lobpcg_sep_rs(h_pair, lambda v: v, x0p, nev, tol=1e-8,
                            maxiter=300, **kw)
        assert int(res.status) == 1, kw
        np.testing.assert_allclose(np.asarray(res.lambdas[:nev]), want,
                                   rtol=1e-6, err_msg=str(kw))


# --- pair-layout GEP family (max/gep/descent_gep pair twins) --------------

def _pair_apply(mat, dt):
    mr = jnp.asarray(mat.real, dt)
    mi = jnp.asarray(mat.imag, dt)

    def f(v):
        # y = v @ mat.conj().T on pairs
        return (v[0] @ mr.T + v[1] @ mi.T, v[1] @ mr.T - v[0] @ mi.T)
    return f


def _gep_problem(rng, n=40, m=8):
    a = _random_hpd(n, rng)
    b = _random_hpd(n, rng) + 9.0 * np.eye(n)
    x0 = rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))
    import scipy.linalg as sla
    want = np.sort(sla.eigh(a, b, eigvals_only=True))
    return a, b, x0, want


def test_gep_rs_matches_complex_gep_f64(rng):
    """lobpcg_gep_rs reproduces the complex lobpcg_gep's pencil spectrum
    (reference lobpcg_gep_softlock, paper_2/lobpcg.py:688-838)."""
    from pcx.solvers.lobpcg_rs import lobpcg_gep_rs
    a, b, x0, want = _gep_problem(rng)
    nev = 4
    idp = lambda v: v
    x0p = (jnp.asarray(x0.real), jnp.asarray(x0.imag))
    r = lobpcg_gep_rs(_pair_apply(a, jnp.float64), _pair_apply(b, jnp.float64),
                      idp, x0p, nev, tol=1e-8, maxiter=300)
    assert int(r.status) in (1, 5)
    got = np.sort(np.asarray(r.lambdas))[:nev]
    np.testing.assert_allclose(got, want[:nev], rtol=1e-5)


def test_gep_rs_f32_floor_returns_best_lambdas(rng):
    """At f32 the noisy-Gram pencil corrupts CURRENT lambdas past the
    floor (measured: complex gep relerr 1.8e-3 at it=10 -> 17 at it=30);
    the pair solver's FLOOR stop must return the BEST-seen values."""
    from pcx.solvers.lobpcg import Status
    from pcx.solvers.lobpcg_rs import lobpcg_gep_rs
    a, b, x0, want = _gep_problem(rng)
    nev = 4
    x0p = (jnp.asarray(x0.real, jnp.float32),
           jnp.asarray(x0.imag, jnp.float32))
    r = lobpcg_gep_rs(_pair_apply(a, jnp.float32),
                      _pair_apply(b, jnp.float32),
                      lambda v: v, x0p, nev, tol=1e-6, maxiter=300)
    assert int(r.status) in (Status.CONVERGED, Status.FLOOR)
    got = np.sort(np.asarray(r.lambdas))[:nev]
    rel = np.abs(got - want[:nev]) / np.abs(want[:nev])
    assert rel.max() < 1e-3, rel


def test_max_rs_matches_dense_spectrum(rng):
    from pcx.solvers.lobpcg_rs import lobpcg_sep_max_rs
    a = _random_hpd(40, rng)
    x0 = rng.normal(size=(6, 40)) + 1j * rng.normal(size=(6, 40))
    x0p = (jnp.asarray(x0.real, jnp.float32),
           jnp.asarray(x0.imag, jnp.float32))
    r = lobpcg_sep_max_rs(_pair_apply(a, jnp.float32), x0p, 2,
                          tol=1e-4, maxiter=300)
    want = np.sort(np.linalg.eigvalsh(a))[-2:]
    got = np.sort(np.asarray(r.lambdas)[:2])
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 1e-3, rel


def test_descent_gep_rs_converges(rng):
    from pcx.solvers.lobpcg_rs import descent_gep_rs
    a, b, x0, want = _gep_problem(rng)
    nev = 4
    x0p = (jnp.asarray(x0.real, jnp.float32),
           jnp.asarray(x0.imag, jnp.float32))
    r = descent_gep_rs(_pair_apply(a, jnp.float32),
                       _pair_apply(b, jnp.float32),
                       lambda v: v, x0p, nev, tol=1e-4, maxiter=300,
                       floor_patience=20)
    got = np.sort(np.asarray(r.lambdas))[:nev]
    rel = np.abs(got - want[:nev]) / np.abs(want[:nev])
    assert rel.max() < 5e-3, rel


def test_eigh_pencil_whiten_matches_scipy(rng):
    """The whiten-path pencil (p x p pair GEMMs, no 2p embedding matmuls)
    agrees with scipy on a Hermitian-definite pencil, including the gep
    body's dead-coordinate convention (G_ii=1, T_ii=-dead_val)."""
    import scipy.linalg as sla
    from pcx.solvers import rayleigh_ritz as rr_mod
    m = 12
    a = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    bmat = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    t = a @ a.conj().T + np.eye(m)
    g = bmat @ bmat.conj().T + 10 * np.eye(m)
    th, v = jax.jit(rr_mod.eigh_pencil_whiten)(jnp.asarray(t),
                                               jnp.asarray(g))
    want = sla.eigh(t, g, eigvals_only=True)
    np.testing.assert_allclose(np.sort(np.asarray(th)), want, atol=1e-7)
    # dead convention
    mask = np.ones(m)
    mask[-3:] = 0
    keep = np.outer(mask, mask)
    gm = g * keep + np.diag(1 - mask)
    dead_val = np.linalg.norm(t) + 1
    tm = t * keep - dead_val * np.diag(1 - mask)
    th2, _ = jax.jit(rr_mod.eigh_pencil_whiten)(jnp.asarray(tm),
                                                jnp.asarray(gm))
    th2 = np.sort(np.asarray(th2))
    assert np.allclose(th2[:3], -dead_val, atol=1e-6)
    want2 = sla.eigh(t[:9, :9], g[:9, :9], eigvals_only=True)
    np.testing.assert_allclose(th2[3:], want2, atol=1e-6)
