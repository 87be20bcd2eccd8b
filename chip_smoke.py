#!/usr/bin/env python
"""Bring-up smoke of pcx on one NVIDIA GPU.

Drives the band solve through the user entry points (KPointSolver,
bandgap) at the reference's headline size and checks every result:

  1. device     platform, card, JAX setup; host<->device complex round
                trips, complex arithmetic inside a while_loop, complex128 FFT
  2. kernels    the operator's 3-D DFT and one operator apply, FFT route
                (cuFFT) against the matmul DFT, each against a complex128
                numpy FFT; the residual/preconditioner chain against its
                minimum traffic; precision of the f32 GEMMs over the grid
  3. main       SC-CURV chiral N=120, NEV=10 at alpha=(pi,0,0) on the
                default GPU path (status, iterations, compile and warm
                seconds, spurious-gate deviation, peak device memory),
                then `bandgap` FCC chiral N=120 on three consecutive path
                points, warm-started; every point must be accepted
  4. reference  complex128 solve of the same SC-CURV k-point (complex
                solver, jnp.fft, no real-boundary shim); max |d omega| over
                the ten bands must be <= 1e-5

``--four`` runs only the four-card phases, each against the same work on
one card: ``bandgap`` over a k-mesh of four FCC N=120 points, and the
grid-sharded SC-CURV N=120 solve over grid=4.

Every phase is a function of its sizes, so CPU tests call them at tiny N.
The script itself refuses to run without a GPU.  Output: one line per
measurement, the card's name and power limit, then a JSON line
{"ok": true, "device": {...}}.  Exit 0 only if every phase passed.

Usage: python chip_smoke.py [--n 120] [--phases device,kernels,main,reference]
                            [--four] [--out output/smoke] [--trace]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ALPHA = (np.pi, 0.0, 0.0)           # the reference's headline k-point
FCC_INDICES = (10, 11, 12)          # consecutive FCC path points
FOUR_INDICES = (10, 11, 12, 13)
OMEGA_TOL = 1e-5                    # c64 vs c128 frequencies (f64 pins)
GATE_TOL = 1e-3                     # spurious gate |omega - omega_re|
# cuFFT against a complex128 numpy FFT, relative to the largest output:
# a few f32 / f64 roundings times log2(N^3) stages
FFT_TOL = {"c64": 1e-6, "c128": 1e-13}
APPLY_TOL = 1e-5                    # FFT vs matmul-DFT operator apply (c64)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_power() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, from a
    child process (None without nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _timed(fn, *args, reps: int = 5):
    """(median seconds, output) of ``fn(*args)`` after one untimed call."""
    import jax
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _mem(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes") if hasattr(ma, k)}


def _bytes_accessed(compiled) -> float | None:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    return float(ca["bytes accessed"]) if ca and "bytes accessed" in ca \
        else None


def hlo_kernel_count(text: str) -> int:
    """Kernels the ENTRY computation of an optimized HLO module launches:
    its fusions and custom calls (cuFFT, cuBLAS)."""
    entry = text[text.index("\nENTRY"):] if "\nENTRY" in text else text
    entry = entry[:entry.find("\n}")]
    return sum(1 for ln in entry.splitlines()
               if " fusion(" in ln or " custom-call(" in ln)


def f32_gemm_precision(text: str) -> dict:
    """f32 matrix products in an optimized HLO module and how many of them
    run at full f32 precision (operand precision HIGHEST, no TF32
    algorithm).  A product at DEFAULT precision may use TF32 on the GPU."""
    n = full = 0
    for ln in text.splitlines():
        is_gemm = ("custom_call_target=\"__cublas$gemm\"" in ln
                   or "custom_call_target=\"__cublas$lt$matmul\"" in ln
                   or " dot(" in ln)
        if not is_gemm or "f32[" not in ln.split("=")[1][:40]:
            continue
        n += 1
        low = ln.lower()
        tf32 = "tf32" in low
        highest = ("highest" in low)
        full += int(highest and not tf32)
    return {"f32_gemms": n, "f32_gemms_full_precision": full}


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> dict:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from pcx.config import compile_cache_dir
    d = jax.devices()[0]
    rec = {"platform": d.platform, "device_kind": d.device_kind,
           "count": len(jax.devices()), "jax": jax.__version__,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "compile_cache": compile_cache_dir(ROOT),
           "card": card_name_and_power()}
    rng = np.random.default_rng(0)
    for dt in (np.complex64, np.complex128):
        z = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(dt)
        back = np.asarray(jax.device_put(z))
        if back.dtype != dt or not np.array_equal(back, z):
            raise AssertionError(f"{np.dtype(dt).name} host/device round trip")
    z0 = jnp.asarray(np.complex64(1.0 + 0.5j))
    zl = lax.while_loop(lambda c: c[0] < 10,
                        lambda c: (c[0] + 1, c[1] * (0.999 + 0.01j)),
                        (0, z0))[1]
    want = (1.0 + 0.5j) * (0.999 + 0.01j) ** 10
    if abs(complex(zl) - want) > 1e-5:
        raise AssertionError("complex arithmetic inside while_loop")
    x = rng.standard_normal((8, 8, 8)) + 1j * rng.standard_normal((8, 8, 8))
    got = np.asarray(jnp.fft.fftn(jnp.asarray(x)))
    err = np.abs(got - np.fft.fftn(x)).max() / np.abs(np.fft.fftn(x)).max()
    if not err < 1e-12:
        raise AssertionError(f"complex128 FFT error {err:.2e}")
    rec["fft_c128_rel_err"] = float(err)
    return rec


# -- phase 2 -----------------------------------------------------------------

def _rel_err_col0(got, x_host):
    """Relative max error of column (0, 0) of a 3-D DFT output against a
    complex128 numpy FFT of the same input."""
    ref = np.fft.fftn(x_host.astype(np.complex128))
    return float(np.abs(np.asarray(got[0, 0]) - ref).max()
                 / np.abs(ref).max())


def phase_kernels(n: int = 120, m: int = 16, reps: int = 5) -> dict:
    """Time the operator's 3-D DFT and one operator apply by both routes,
    the residual/preconditioner chain against its minimum traffic, and the
    Rayleigh-Ritz Gram with the precision of its f32 GEMMs."""
    import jax
    import jax.numpy as jnp
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.operators import dft as dft_mod
    from pcx.operators import maxwell, rs
    from pcx.solvers import rayleigh_ritz as rr

    out = {"n": n, "m": m}
    key = jax.random.PRNGKey(0)
    ax = (-3, -2, -1)
    for name, cdt, width in (("c64", jnp.complex64, m),
                             ("c128", jnp.complex128, 2)):
        x = maxwell.random_block(key, n, width, cdt)
        x_host = np.asarray(x[0, 0])
        w = jnp.asarray(dft_mod.dft_mats(n, np.dtype(cdt)).fwd)
        f_fft = jax.jit(lambda v: jnp.fft.fftn(v, axes=ax))
        f_mm = jax.jit(lambda v, w: dft_mod.dft3(v, w))
        t_fft, y_fft = _timed(f_fft, x, reps=reps)
        t_mm, y_mm = _timed(f_mm, x, w, reps=reps)
        out[f"dft_{name}"] = {
            "width": width,
            "fft_s": t_fft, "matmul_s": t_mm,
            "fft_rel_err": _rel_err_col0(y_fft, x_host),
            "matmul_rel_err": _rel_err_col0(y_mm, x_host),
            "fft_mem": _mem(f_fft.lower(x).compile()),
            "matmul_mem": _mem(f_mm.lower(x, w).compile()),
            "tolerance": FFT_TOL[name]}
        del x, y_fft, y_mm
        if not out[f"dft_{name}"]["fft_rel_err"] <= FFT_TOL[name]:
            raise AssertionError(f"{name} FFT error "
                                 f"{out[f'dft_{name}']['fft_rel_err']:.2e}")

    # one operator apply (complex operator, complex64 block of width m)
    cfg = ProblemConfig(n=n, lattice="sc_curv", nev=max(1, m * 10 // 16))
    solver = KPointSolver(cfg, dtype=jnp.complex64, solver_impl="complex",
                          refine=False)
    d_a, b, _inv, shift = solver.symbols_for(np.asarray(ALPHA))
    mats = jax.tree_util.tree_map(
        jnp.asarray, dft_mod.dft_mats(n, np.complex64))
    x = maxwell.random_block(key, n, m, jnp.complex64)
    apply = jax.jit(lambda v, d, b, diel, dft: maxwell.ama_bb(
        v, d, b, diel, shift=shift, dft=dft))
    t_fft, y_fft = _timed(apply, x, d_a, b, solver.diel, None, reps=reps)
    t_mm, y_mm = _timed(apply, x, d_a, b, solver.diel, mats, reps=reps)
    diff = float(jnp.max(jnp.abs(y_fft - y_mm)) / jnp.max(jnp.abs(y_mm)))
    out["apply_c64"] = {"fft_s": t_fft, "matmul_s": t_mm,
                        "fft_vs_matmul_rel": diff, "tolerance": APPLY_TOL}
    del y_fft, y_mm
    if not diff <= APPLY_TOL:
        raise AssertionError(f"operator apply FFT vs matmul {diff:.2e}")

    # residual + column norms + preconditioner, as the pair solver runs it
    xr, xi = x.real.reshape(m, -1), x.imag.reshape(m, -1)
    hx = apply(x, d_a, b, solver.diel, None)
    hr, hi = hx.real.reshape(m, -1), hx.imag.reshape(m, -1)
    del x, hx
    lam = jnp.linspace(1.0, 2.0, m, dtype=jnp.float32)
    inv_d = jnp.ones((3, n, n, n), jnp.float32)
    inv_s = (jnp.full((3, n, n, n), 0.1, jnp.float32),
             jnp.full((3, n, n, n), 0.05, jnp.float32))
    shape = (m, 3, n, n, n)

    def chain(xr, xi, hr, hi, lam, inv_d, inv_s):
        lc = lam[:, None]
        r = (lc * xr - hr, lc * xi - hi)
        res = rr.colnorms_p(r)
        act = (res > 1e-4).astype(jnp.float32)[:, None]
        w = rs.h_block_p((jnp.reshape(act * r[0], shape),
                          jnp.reshape(act * r[1], shape)), inv_d, inv_s)
        return w, res

    args = (xr, xi, hr, hi, lam, inv_d, inv_s)
    plane = m * 3 * n**3 * 4
    f_chain = jax.jit(chain)
    t_chain, _ = _timed(f_chain, *args, reps=reps)
    comp = f_chain.lower(*args).compile()
    out["resid_precond"] = {
        "s": t_chain, "kernels": hlo_kernel_count(comp.as_text()),
        "bytes_accessed": _bytes_accessed(comp),
        "min_bytes": 6 * plane, "mem": _mem(comp)}

    # Rayleigh-Ritz Gram over the stacked (3m, D) basis, f64-accumulated
    s3 = (jnp.concatenate((xr, xr, xr)), jnp.concatenate((xi, xi, xi)))
    hs3 = (jnp.concatenate((hr, hr, hr)), jnp.concatenate((hi, hi, hi)))
    f_gram = jax.jit(rr.gram_f64_p)
    t_gram, _ = _timed(f_gram, s3, hs3, reps=reps)
    comp = f_gram.lower(s3, hs3).compile()
    out["gram_3m"] = {"s": t_gram, **f32_gemm_precision(comp.as_text())}
    g = out["gram_3m"]
    if g["f32_gemms"] != g["f32_gemms_full_precision"]:
        raise AssertionError(f"Gram GEMMs below full f32: {g}")
    return out


# -- phase 3 -----------------------------------------------------------------

def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_main(n: int = 120, nev: int = 10, fcc_indices=FCC_INDICES,
               out_dir: str = "output/smoke",
               trace_dir: str | None = None) -> dict:
    import jax
    from pcx.bandstructure import KPointSolver, bandgap
    from pcx.config import ProblemConfig, device_policy
    from pcx.solvers.lobpcg import Status

    pol = device_policy()
    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=nev)
    solver = KPointSolver(cfg, dtype=pol.dtype)
    alpha = np.asarray(ALPHA)
    rec = {"n": n, "nev": nev, "dtype": np.dtype(pol.dtype).name,
           "impl": solver.impl, "real_boundary": solver.rb,
           "refine": solver.refine, "segment_iters": solver.segment_iters,
           "apply_chunk": solver.apply_chunk}
    t0 = time.perf_counter()
    first = solver.solve(alpha, seed=0)
    rec["first_call_s"] = time.perf_counter() - t0
    if trace_dir:
        jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    res = solver.solve(alpha, seed=0)
    rec["warm_s"] = time.perf_counter() - t0
    if trace_dir:
        jax.profiler.stop_trace()
    rec["solve_s"] = res.wall_time
    rec["compile_s"] = rec["first_call_s"] - rec["warm_s"]
    rec["status"] = Status(res.status).name
    rec["iterations"] = res.iterations
    rec["gate_dev"] = float(np.abs(np.asarray(res.omega)
                                   - np.asarray(res.omega_re)).max())
    rec["omega"] = [float(v) for v in res.omega_re]
    rec["first_iterations"] = first.iterations
    rec["peak_bytes_in_use"] = _peak_bytes()
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        raise AssertionError(f"main solve status {rec['status']}")
    if not rec["gate_dev"] < GATE_TOL:
        raise AssertionError(f"spurious gate deviation {rec['gate_dev']:.2e}")

    if solver.segment_iters > 0:
        # precision of the f32 GEMMs in the hot loop (segment program)
        m = solver.block_width(alpha)
        seg_init, seg_run, _ = solver._jitted_seg(m)
        sym_args = solver._seg_sym_args(alpha)
        x0 = solver._x0_cold(alpha, m, 0)
        state = seg_init(*sym_args, x0, solver.diel, solver.dft)
        stop = jax.numpy.asarray(0, jax.numpy.int32)
        text = seg_run.lower(*sym_args, state, solver.diel, solver.dft,
                             stop).compile().as_text()
        with open(os.path.join(out_dir, "seg_run.hlo.txt"), "w") as f:
            f.write(text)
        rec["seg_run"] = {"kernels": hlo_kernel_count(text),
                          **f32_gemm_precision(text)}
        del state, x0
    rec["solution"] = res
    del solver, first

    fcc = {"indices": list(fcc_indices)}
    t0 = time.perf_counter()
    failed = bandgap(n, "fcc", output_dir=out_dir, indices=list(fcc_indices),
                     dtype=pol.dtype, nev=nev, verbose=True)
    fcc["seconds"] = time.perf_counter() - t0
    path = os.path.join(out_dir, "chiral", "bandgap_fcc.json")
    with open(path) as f:
        lib = json.load(f)
    rows = lib[f"fcc_{n}_iterations"]
    fcc["points"] = [rows[i] for i in fcc_indices]
    fcc["failed"] = failed
    rec["fcc"] = fcc
    if failed:
        raise AssertionError(f"bandgap FCC rejected points {failed}")
    return rec


# -- phase 4 -----------------------------------------------------------------

def phase_reference(main: dict, n: int = 120, nev: int = 10) -> dict:
    import jax.numpy as jnp
    from pcx.bandstructure import KPointSolver
    from pcx.config import ProblemConfig
    from pcx.solvers.lobpcg import Status

    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=nev)
    ref = KPointSolver(cfg, dtype=jnp.complex128, solver_impl="complex",
                       real_boundary=False, refine=False)
    alpha = np.asarray(ALPHA)
    t0 = time.perf_counter()
    ref.solve(alpha, seed=0)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = ref.solve(alpha, seed=0)
    warm = time.perf_counter() - t0
    if r.status not in (Status.CONVERGED, Status.FLOOR):
        raise AssertionError(f"reference status {Status(r.status).name}")
    dw = float(np.abs(np.asarray(r.omega_re)
                      - np.asarray(main["omega"])).max())
    rec = {"status": Status(r.status).name, "iterations": r.iterations,
           "first_call_s": first, "warm_s": warm, "solve_s": r.wall_time,
           "main_warm_s": main["warm_s"], "max_domega": dw,
           "peak_bytes_in_use": _peak_bytes()}
    if not dw <= OMEGA_TOL:
        raise AssertionError(f"c64 vs c128 max |d omega| {dw:.2e}")
    return rec


# -- four cards --------------------------------------------------------------

def phase_four_bandgap(n: int = 120, nev: int = 10, indices=FOUR_INDICES,
                       out_dir: str = "output/smoke") -> dict:
    """bandgap over a 4-point k-mesh against the same 4-point batch on one
    card."""
    import jax
    from pcx.bandstructure import bandgap
    from pcx.config import device_policy
    from pcx.parallel.mesh import make_mesh

    dt = device_policy().dtype
    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 devices, found {len(devs)}")
    rec = {"indices": list(indices)}
    omegas = {}
    for tag, kw in (("mesh4", {"mesh": make_mesh(n_k=4, devices=devs[:4])}),
                    ("one_card", {"k_batch": len(indices)})):
        d = os.path.join(out_dir, tag)
        t0 = time.perf_counter()
        failed = bandgap(n, "fcc", output_dir=d, indices=list(indices),
                         dtype=dt, nev=nev, verbose=True, **kw)
        rec[f"{tag}_s"] = time.perf_counter() - t0
        log(f"#   four_bandgap {tag}: {rec[f'{tag}_s']:.1f}s")
        if failed:
            raise AssertionError(f"{tag}: rejected points {failed}")
        with open(os.path.join(d, "chiral", "bandgap_fcc.json")) as f:
            lib = json.load(f)
        omegas[tag] = np.asarray([lib[f"fcc_{n}_frequencies"][i]
                                  for i in indices])
    rec["max_domega"] = float(np.abs(omegas["mesh4"]
                                     - omegas["one_card"]).max())
    if not rec["max_domega"] <= OMEGA_TOL:
        raise AssertionError(f"k-mesh vs one card {rec['max_domega']:.2e}")
    return rec


def phase_four_sharded(n: int = 120, nev: int = 10) -> dict:
    """Grid-sharded solve over grid=4 against the same solve over one
    card (grid=1)."""
    import jax
    import jax.numpy as jnp
    from pcx import geometry
    from pcx.bandstructure import KPointSolver
    from pcx.config import CHIRAL_EPS_EG, ProblemConfig, block_width
    from pcx.operators import maxwell
    from pcx.parallel.mesh import make_mesh
    from pcx.parallel.solve import solve_kpoint_sharded

    dt = jnp.complex64
    cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type="chiral", nev=nev)
    alpha = np.asarray(ALPHA)
    host = KPointSolver(cfg, dtype=dt, solver_impl="complex", refine=False)
    d_a, b, inv, shift = host.symbols_for(alpha)
    m = block_width(nev)
    x0 = maxwell.random_block(jax.random.PRNGKey(0), n, m, dt)
    mask = geometry.edge_mask(n, "sc_curv")
    scale = jnp.asarray(np.where(mask, 1.0 / CHIRAL_EPS_EG["sc_curv"], 1.0),
                        jnp.float32)
    devs = jax.devices()
    rec = {}
    omegas = {}
    for tag, grid in (("grid4", 4), ("one_card", 1)):
        mesh = make_mesh(n_k=1, n_grid=grid, devices=devs[:grid])
        t0 = time.perf_counter()
        r = solve_kpoint_sharded(mesh, d_a, (b.diag, b.sdiag),
                                 (inv.diag, inv.sdiag), scale, shift, x0,
                                 nev)
        lam = np.asarray(r.lambdas)[:nev] - shift
        rec[f"{tag}_s"] = time.perf_counter() - t0
        rec[f"{tag}_iterations"] = int(r.iterations)
        rec[f"{tag}_status"] = int(r.status)
        log(f"#   four_sharded {tag}: {rec[f'{tag}_s']:.1f}s, "
            f"{rec[f'{tag}_iterations']} iterations")
        omegas[tag] = np.sqrt(np.maximum(lam, 0.0)) / (2 * np.pi)
    rec["max_domega"] = float(np.abs(omegas["grid4"]
                                     - omegas["one_card"]).max())
    if not rec["max_domega"] <= OMEGA_TOL:
        raise AssertionError(f"grid=4 vs one card {rec['max_domega']:.2e}")
    return rec


# -- main --------------------------------------------------------------------

def _print_rec(name: str, rec: dict) -> None:
    rec = {k: v for k, v in rec.items() if k != "solution"}
    log(f"# {name}: {json.dumps(rec, default=str)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--phases", default="device,kernels,main,reference")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "smoke"))
    ap.add_argument("--trace", action="store_true",
                    help="profile the warm main solve into <out>/trace")
    args = ap.parse_args(argv)

    import jax
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        print(f"chip_smoke: no GPU found ({e})", file=sys.stderr)
        return 1
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r}); "
              f"this smoke runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from pcx.config import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the pcx package is missing next to this script "
              f"({e})", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache(ROOT)
    os.makedirs(args.out, exist_ok=True)

    card = card_name_and_power()
    if args.four:
        plan = [("four_bandgap", lambda: phase_four_bandgap(
                    args.n, out_dir=args.out)),
                ("four_sharded", lambda: phase_four_sharded(args.n))]
    else:
        wanted = args.phases.split(",")
        state = {}
        trace = os.path.join(args.out, "trace") if args.trace else None
        plan = [("device", phase_device),
                ("kernels", lambda: phase_kernels(args.n)),
                ("main", lambda: state.setdefault("main", phase_main(
                    args.n, out_dir=args.out, trace_dir=trace))),
                ("reference", lambda: phase_reference(state["main"],
                                                      args.n))]
        plan = [p for p in plan if p[0] in wanted]
    results = {}
    ok = True
    for name, fn in plan:
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception as e:  # noqa: BLE001 — report and fail the run
            import traceback
            traceback.print_exc()
            log(f"# {name}: FAILED after {time.perf_counter() - t0:.1f}s: "
                f"{type(e).__name__}: {e}")
            ok = False
            break
        _print_rec(name, results[name])
        log(f"# {name}: passed in {time.perf_counter() - t0:.1f}s "
            f"[{card}]")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items() if kk != "solution"}
                   for k, v in results.items()}, f, indent=1, default=str)
    if not ok:
        return 1
    log(f"card: {card}")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
