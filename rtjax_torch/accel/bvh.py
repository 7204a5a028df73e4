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


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def validate(res: BuildResult, tri_bmin: np.ndarray,
             tri_bmax: np.ndarray) -> None:
    """Raise AssertionError unless the build keeps the structural
    invariants of the reference's BVH (bvh.cuh:5-13,153-154): every
    primitive in exactly one leaf, children adjacent (right = left + 1)
    and in range, every node's box containing its children's and its
    primitives' boxes (to 1e-6)."""
    m = res.num_nodes
    covered = np.zeros(len(res.perm), bool)
    stack = [(0, 0)]
    while stack:
        node, depth = stack.pop()
        _require(depth <= 64, "runaway depth")
        count = res.num_prims[node]
        if count > 0:
            first = res.left_first[node]
            _require(not covered[first:first + count].any(),
                     "primitive covered twice")
            covered[first:first + count] = True
            lo = tri_bmin[res.perm[first:first + count]]
            hi = tri_bmax[res.perm[first:first + count]]
            _require((res.bmin[node] <= lo.min(0) + 1e-6).all()
                     and (res.bmax[node] >= hi.max(0) - 1e-6).all(),
                     f"node {node}'s box misses its primitives")
        else:
            left = res.left_first[node]
            _require(0 < left and left + 1 < m, "child index out of range")
            for c in (left, left + 1):
                _require((res.bmin[node] <= res.bmin[c] + 1e-6).all()
                         and (res.bmax[node] >= res.bmax[c] - 1e-6).all(),
                         f"node {node}'s box misses child {c}'s")
            stack.append((left + 1, depth + 1))
            stack.append((left, depth + 1))
    _require(covered.all(), "some primitive not covered by any leaf")
