"""Native (C++) host components, loaded via ctypes.

The port's own copy of easysimp_tpu/native: the fixed-radius neighbour
search (the reference's NearestNeighbors.jl KD-tree equivalent) that builds
the unstructured filter cache.  It is host code in both packages.  Built at
first use with g++ (-O3 -fopenmp) into the port's `_build/` directory, under
a temporary name that is renamed into place, keyed by a hash of the source;
consumers fall back to scipy.cKDTree when the build is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "neighbor_search", "is_available"]

_SRC = Path(__file__).resolve().parent / "neighbor_search.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_lib = None
_tried = False


def _build(so: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    # second attempt without -march/-fopenmp (portability)
    for flags in (["-march=native", "-fopenmp"], []):
        cmd = ["g++", "-O3", *flags, "-fPIC", "-shared", str(_SRC),
               "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if res.returncode == 0 and tmp.exists():
            os.replace(tmp, so)
            return True
    return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    except OSError:
        return None
    so = _BUILD / f"neighbor_search_{digest}.so"
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.nbsearch_count.restype = ctypes.c_int64
    lib.nbsearch_count.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.nbsearch_fill.restype = None
    lib.nbsearch_fill.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return get_lib() is not None


def neighbor_search(centers: np.ndarray, radius: float):
    """All-pairs fixed-radius search: returns CSR (offsets, idx, weights).

    offsets: (n+1,) int64; idx: (total,) int32 neighbor ids;
    weights: (total,) float64 cone weights max(0, R - d).
    Raises RuntimeError if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native neighbor search unavailable")
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    n = centers.shape[0]
    offsets = np.zeros(n + 1, dtype=np.int64)
    cptr = centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    optr = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    total = lib.nbsearch_count(cptr, n, float(radius), optr)
    idx = np.empty(total, dtype=np.int32)
    weights = np.empty(total, dtype=np.float64)
    lib.nbsearch_fill(
        cptr, n, float(radius), optr,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return offsets, idx, weights
