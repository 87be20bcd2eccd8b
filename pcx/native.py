"""ctypes binding for the native (C++/OpenMP) geometry engine.

The reference's only native code is two CUDA kernels (paper_2/_kernels.py);
pcx's device compute path is XLA, and the native runtime component here is
the host-side geometry preprocessing: flag evaluation over 3N^3 staggered
DoFs (reference cold path: dielectric.py:84-87, "<1 s for standard grids",
README.md:116).  The library is built from csrc/ at first use (it is not
tracked); without a compiler the numpy implementation runs instead.  The
first use reports which engine ran.

Build by hand: ``python -m pcx.native --build``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from typing import Optional

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_LIB_PATH = os.path.join(_CSRC, "libpcxgeom.so")

FLAG_IDS = {
    "sc_flat1": 0,
    "sc_flat2": 1,
    "sc_curv": 2,
    "bcc_sg": 3,
    "bcc_dg": 4,
    "fcc": 5,
}

_lib = None
_tried = False


def build(verbose: bool = False) -> Optional[str]:
    """Compile the shared library with ``$CXX`` (else g++ or c++); returns
    None on success, else why it failed.  The library is written under a
    temporary name and renamed into place, so concurrent first uses never
    load a half-written file."""
    cxx = (os.environ.get("CXX") or shutil.which("g++")
           or shutil.which("c++"))
    if not cxx:
        return "no C++ compiler"
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-march=native", "-fopenmp", "-fPIC", "-Wall",
           "-std=c++17", "-shared", "-o", tmp,
           os.path.join(_CSRC, "pcx_geometry.cpp")]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cxx}: {e}"
    if verbose:
        print(out.stdout, out.stderr)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        lines = out.stderr.strip().splitlines() or [""]
        first = next((ln for ln in lines if "error" in ln), lines[-1])
        return f"{cxx} exited {out.returncode}: {first.strip()}"
    os.replace(tmp, _LIB_PATH)
    return None


def _report(engine: str) -> None:
    print(f"pcx.native: geometry engine = {engine}", file=sys.stderr)


def load() -> Optional[ctypes.CDLL]:
    """Load (building on demand if sources are present)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        if not os.path.exists(os.path.join(_CSRC, "pcx_geometry.cpp")):
            _report("numpy (no csrc/ sources)")
            return None
        err = build()
        if err is not None:
            _report(f"numpy (building csrc/libpcxgeom.so failed: {err})")
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _report(f"numpy (loading csrc/libpcxgeom.so failed: {e})")
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f8p = ctypes.POINTER(ctypes.c_double)
    lib.pcx_edge_mask.argtypes = [ctypes.c_int, ctypes.c_int, f8p, u8p]
    lib.pcx_edge_mask.restype = ctypes.c_int
    lib.pcx_volume_mask.argtypes = [ctypes.c_int, ctypes.c_int, f8p, u8p]
    lib.pcx_volume_mask.restype = ctypes.c_int
    _lib = lib
    _report(f"native ({_LIB_PATH})")
    return lib


def available() -> bool:
    return load() is not None


def edge_mask(n: int, lattice: str, ct_inv_t: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None or lattice not in FLAG_IDS:
        return None
    out = np.empty(3 * n**3, dtype=np.uint8)
    m = np.ascontiguousarray(ct_inv_t, dtype=np.float64)
    rc = lib.pcx_edge_mask(
        n, FLAG_IDS[lattice],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out.reshape(3, n, n, n).astype(bool)


def volume_mask(n: int, lattice: str, ct_inv_t: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None or lattice not in FLAG_IDS:
        return None
    out = np.empty(n**3, dtype=np.uint8)
    m = np.ascontiguousarray(ct_inv_t, dtype=np.float64)
    rc = lib.pcx_volume_mask(
        n, FLAG_IDS[lattice],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out.reshape(n, n, n).astype(bool)


if __name__ == "__main__":
    if "--build" in sys.argv:
        err = build(verbose=True)
        print("built" if err is None else f"BUILD FAILED: {err}")
        sys.exit(0 if err is None else 1)
    print("available:", available())
