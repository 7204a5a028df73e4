"""Acceleration structures: the sweep-SAH BVH builders, the flattened
binary BVH and the wide-node tables (port of rtjax.accel).

Two builders with identical outputs (the reference's bvh.cuh:30-219):
:mod:`.builder_cpp`, the native build of rtjax's C++ source and the fast
path for million-triangle scenes, and :mod:`.builder_np`, the NumPy
fallback and oracle.
"""

from __future__ import annotations

import numpy as np

from ..constants import BVH_MAX_DEPTH
from .builder_np import build_bvh as build_bvh_np
from .bvh import BuildResult, BvhArrays, validate


def build_bvh_best(bmin, bmax, centers=None, max_depth=BVH_MAX_DEPTH,
                   max_leaf_size=None, min_leaf_size=1,
                   which: str = "auto") -> BuildResult:
    """Build with the native builder, or with NumPy where it fails.

    ``which``: "auto" (native, then NumPy with a logged warning where the
    native build fails), "cpp" (native; a failure raises) or "numpy"."""
    if which not in ("auto", "cpp", "numpy"):
        raise ValueError(f"which must be 'auto', 'cpp' or 'numpy', got "
                         f"{which!r}")
    if which in ("auto", "cpp"):
        try:
            from .builder_cpp import build_bvh as build_bvh_cpp
            return build_bvh_cpp(bmin, bmax, centers, max_depth=max_depth,
                                 max_leaf_size=max_leaf_size,
                                 min_leaf_size=min_leaf_size)
        except Exception as e:
            if which == "cpp":
                raise
            from ..utils.log import logger
            logger.warning("C++ BVH builder unavailable (%s); falling back "
                           "to the NumPy builder — expect slow builds on "
                           "million-triangle scenes", e)
    return build_bvh_np(np.asarray(bmin), np.asarray(bmax),
                        None if centers is None else np.asarray(centers),
                        max_depth=max_depth, max_leaf_size=max_leaf_size,
                        min_leaf_size=min_leaf_size)


__all__ = ["BuildResult", "BvhArrays", "validate", "build_bvh_np",
           "build_bvh_best"]
