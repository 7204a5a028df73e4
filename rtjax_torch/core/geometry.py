"""Triangles and the ray-triangle test (port of rtjax.core.geometry)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import vec
from .sampling import offset_ray_origin_v3


@dataclasses.dataclass(frozen=True)
class Triangles:
    """SoA triangle soup with precomputed edges: ``e1 = p0 - p1``,
    ``e2 = p2 - p0``, ``n = cross(e1, e2)`` (unnormalized), all ``[P, 3]``
    float32 tensors."""

    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def from_vertices(p0, p1, p2, device) -> "Triangles":
        """Edges and normal computed in float32 numpy on the host."""
        p0 = np.asarray(p0, np.float32)
        e1 = p0 - np.asarray(p1, np.float32)
        e2 = np.asarray(p2, np.float32) - p0
        n = np.cross(e1, e2)
        t = lambda a: torch.tensor(a, device=device)
        return Triangles(p0=t(p0), e1=t(e1), e2=t(e2), n=t(n))

    @property
    def num(self) -> int:
        return self.p0.shape[0]


def intersect_triangle_v3(origin, direction, tmax, p0, e1, e2, n):
    """Moeller-Trumbore variant with the reference's exact accept rule
    ``u >= 0, v >= 0, u + v <= 1, 0 < t <= tmax``; all vector arguments are
    component triples.  Returns ``(hit, t, u, v)``."""
    c = vec.sub(p0, origin)
    r = vec.cross(direction, c)
    inv_det = 1.0 / vec.dot(direction, n)
    u = inv_det * vec.dot(e2, r)
    v = inv_det * vec.dot(e1, r)
    t = inv_det * vec.dot(c, n)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & (t <= tmax)
    return hit, t, u, v


def spawn_offset_ray_v3(p, unit_n, unit_d, tmax=float("inf")):
    """Offset ray spawn: origin nudged off the surface; ``tmax`` broadcast
    to the lane shape."""
    if not torch.is_tensor(tmax):
        tmax = torch.full_like(p[0], tmax)
    return offset_ray_origin_v3(p, unit_n), unit_d, tmax
