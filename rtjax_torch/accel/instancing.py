"""Two-level BVH records: instanced meshes sharing bottom-level structures
(port of rtjax.accel.instancing).

A mesh registered once is built once into its own BVH and wide tables in
its LOCAL frame (a BLAS, bottom-level acceleration structure); each
instance places it with a 3x4 affine transform.  Conventions shared with
rtjax:

- rays enter an instance's local frame by the world->local affine rows and
  the local direction is NOT renormalised, so the ray parameter t stays in
  world units and one tmax prunes across instances;
- a hit's world normal is the local ``cross(e1, e2)`` mapped by the
  cofactor matrix ``det(M) M^-T``, which equals ``cross(M e1, M e2)``;
- instanced triangles are never lights: emission and the shadow-ray
  exclusion apply to the base scene (source 0) only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.geometry import Triangles
from .bvh import BvhArrays


@dataclasses.dataclass(frozen=True)
class MeshBlas:
    """A unique mesh's bottom-level structures, in LOCAL space."""

    tris: Triangles   # leaf-ordered
    bvh: BvhArrays
    tables: object    # WideTables, or None when max_leaf_size > 8


@dataclasses.dataclass(frozen=True)
class InstanceTable:
    """Per-instance records (instance k is source k + 1 of a hit).

    ``fwd`` / ``inv``: local->world / world->local affine rows; ``nrm``: the
    cofactor that maps a local ``cross(e1, e2)`` to world space;
    ``aabb_lo`` / ``aabb_hi``: world bounds; ``material``: the instance's
    material id; ``mesh_id``: which BLAS each instance uses."""

    fwd: torch.Tensor       # [I, 3, 4] float32
    inv: torch.Tensor       # [I, 3, 4] float32
    nrm: torch.Tensor       # [I, 3, 3] float32
    aabb_lo: torch.Tensor   # [I, 3] float32
    aabb_hi: torch.Tensor   # [I, 3] float32
    material: torch.Tensor  # [I] int32
    mesh_id: tuple          # tuple[int], length I

    @property
    def num(self) -> int:
        return len(self.mesh_id)


def affine_rows(matrix) -> np.ndarray:
    """The 3x4 affine rows of a 4x4 matrix, as float32."""
    return np.asarray(matrix, np.float32)[:3, :4]


def apply_affine_point(rows, p) -> tuple:
    """``rows [..., 3, 4] @ [p, 1]`` for points ``p`` given as a component
    triple, returned as one.  Each component is summed left to right (x, y,
    z, translation), the operation order of the two-level kernels, so that
    rays moved into an instance's frame here match theirs bit for bit."""
    return tuple(rows[..., r, 0] * p[0] + rows[..., r, 1] * p[1]
                 + rows[..., r, 2] * p[2] + rows[..., r, 3] for r in range(3))


def apply_affine_vector(rows, v) -> tuple:
    """``rows[..., :3] @ v`` for a component triple ``v``, in the order of
    :func:`apply_affine_point`; a direction is not renormalised, so the ray
    parameter t stays in world units."""
    return tuple(rows[..., r, 0] * v[0] + rows[..., r, 1] * v[1]
                 + rows[..., r, 2] * v[2] for r in range(3))


def instance_world_aabb(mesh_bmin, mesh_bmax, matrix) -> tuple:
    """World AABB of a transformed local AABB (its 8 corners, in float64,
    then float32)."""
    corners = np.array([[mesh_bmin[i] if (k >> i) & 1 == 0 else mesh_bmax[i]
                         for i in range(3)] for k in range(8)])
    w = corners @ np.asarray(matrix)[:3, :3].T + np.asarray(matrix)[:3, 3]
    return w.min(0).astype(np.float32), w.max(0).astype(np.float32)
