"""ctypes binding of the native sweep-SAH BVH builder.

The port compiles rtjax's own C++ source (``rtjax/accel/cpp/bvh_builder.cpp``)
with the same flags into its build directory (kernels/_build.py), so both
packages build identical trees.  There is no NumPy fallback: a failed build
raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..constants import BVH_MAX_DEPTH
from ..kernels import _build
from .bvh import BuildResult

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.bvh_library()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.rtjax_build_bvh.restype = ctypes.c_int64
        lib.rtjax_build_bvh.argtypes = [
            f32p, f32p, f32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i64p, i32p,
        ]
        _lib = lib
        return lib


def build_bvh(tri_bmin, tri_bmax, centers=None,
              max_depth: int = BVH_MAX_DEPTH,
              max_leaf_size: int | None = None,
              min_leaf_size: int = 1) -> BuildResult:
    """Native sweep-SAH build over per-triangle bounds and centers."""
    lib = _load()
    bmin = np.ascontiguousarray(tri_bmin, np.float32)
    bmax = np.ascontiguousarray(tri_bmax, np.float32)
    if centers is None:
        centers = 0.5 * (bmin + bmax)
    centers = np.ascontiguousarray(centers, np.float32)
    n = len(bmin)

    cap = 2 * n
    out_bmin = np.empty((cap, 3), np.float32)
    out_bmax = np.empty((cap, 3), np.float32)
    out_left = np.empty(cap, np.int32)
    out_num = np.empty(cap, np.int32)
    out_perm = np.empty(n, np.int64)
    out_stats = np.zeros(2, np.int32)

    rc = lib.rtjax_build_bvh(
        bmin, bmax, centers, n, int(max_depth),
        0 if max_leaf_size is None else int(max_leaf_size),
        int(min_leaf_size),
        out_bmin, out_bmax, out_left, out_num, out_perm, out_stats)
    if rc < 0:
        raise RuntimeError(f"rtjax_build_bvh failed with code {rc}")
    return BuildResult(bmin=out_bmin, bmax=out_bmax, left_first=out_left,
                       num_prims=out_num, perm=out_perm,
                       num_nodes=int(out_stats[0]),
                       max_depth=int(out_stats[1]))
