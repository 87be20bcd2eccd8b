#!/usr/bin/env python
"""Summarize a jax.profiler trace of the GPU: device busy and idle share
over the traced window, and the device kernels ranked by total time.

Reads the ``*.trace.json.gz`` that ``jax.profiler`` writes under
``<dir>/plugins/profile/<time>/`` (``chip_smoke.py --trace`` writes one for
the warm N=120 solve).  Busy time is the union of the device events'
intervals; idle share is 1 - busy / window.

Usage: python tools/trace_summary.py <trace dir or .trace.json.gz> [--top 25]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def load(path: str) -> list:
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                                 recursive=True))
        if not found:
            raise FileNotFoundError(f"no *.trace.json.gz under {path}")
        path = found[-1]
    with gzip.open(path) as f:
        return json.load(f)["traceEvents"]


def summarize(events: list) -> dict:
    """{"window_s", "busy_s", "idle_share", "kernels": [(name, count,
    seconds), ...]} over the events of the GPU device planes."""
    dev_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "/device:GPU" in e["args"]["name"]}
    dev = sorted((e for e in events
                  if e.get("ph") == "X" and e["pid"] in dev_pids),
                 key=lambda e: e["ts"])
    if not dev:
        raise ValueError("no device events in the trace")
    t0 = dev[0]["ts"]
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for e in dev:
        s, end = e["ts"], e["ts"] + e["dur"]
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        per[e["name"]][0] += 1
        per[e["name"]][1] += e["dur"]
    kernels = sorted(((n, c, d * 1e-6) for n, (c, d) in per.items()),
                     key=lambda k: -k[2])
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "idle_share": 1.0 - busy / (t1 - t0), "kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    s = summarize(load(args.trace))
    total = sum(k[2] for k in s["kernels"])
    print(f"window {s['window_s']:.4f} s, device busy {s['busy_s']:.4f} s, "
          f"idle share {s['idle_share']:.4f}")
    for name, count, sec in s["kernels"][:args.top]:
        print(f"{sec * 1e3:10.2f} ms {100 * sec / total:5.1f}% {count:6d}  "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
