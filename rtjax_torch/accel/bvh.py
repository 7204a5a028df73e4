"""Flattened binary BVH: the host build result and its device arrays (port
of rtjax.accel.bvh).

Internal node children are adjacent (right = left + 1); a leaf's primitives
are the contiguous leaf-order triangles ``[left_first, left_first +
num_prims)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BvhArrays:
    bmin: torch.Tensor        # [M, 3] float32
    bmax: torch.Tensor        # [M, 3] float32
    left_first: torch.Tensor  # [M] int32
    num_prims: torch.Tensor   # [M] int32
    max_depth: int = 0        # depth of the build (bounds the walk stack)

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]


@dataclasses.dataclass
class BuildResult:
    """Host-side output of a BVH build (NumPy arrays + stats)."""

    bmin: np.ndarray
    bmax: np.ndarray
    left_first: np.ndarray
    num_prims: np.ndarray
    perm: np.ndarray        # [P] original-triangle index per leaf-order slot
    num_nodes: int
    max_depth: int

    def to_device(self, device) -> BvhArrays:
        """Device arrays, with a leaf root wrapped so that node 0 is always
        internal: root -> [real leaf, never-hit dummy leaf] (rtjax's
        BuildResult.to_device layout)."""
        m = self.num_nodes
        bmin, bmax = self.bmin[:m], self.bmax[:m]
        left_first, num_prims = self.left_first[:m], self.num_prims[:m]
        depth = int(self.max_depth)
        if num_prims[0] > 0:
            inf = np.float32(np.inf)
            bmin = np.concatenate([bmin[:1], bmin[:1], [[inf, inf, inf]]])
            bmax = np.concatenate([bmax[:1], bmax[:1], [[-inf, -inf, -inf]]])
            left_first = np.array([1, left_first[0], 0], np.int32)
            num_prims = np.array([0, num_prims[0], 1], np.int32)
            depth += 1
        t = lambda a, dt: torch.tensor(np.asarray(a, dt), device=device)
        return BvhArrays(bmin=t(bmin, np.float32), bmax=t(bmax, np.float32),
                         left_first=t(left_first, np.int32),
                         num_prims=t(num_prims, np.int32), max_depth=depth)
