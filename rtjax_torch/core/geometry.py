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


FLT_EPSILON = float(np.finfo(np.float32).eps)


def ray_slab_precompute(direction, origin):
    """Per-ray slab-test state of the binary walk: ``(inv_dir,
    scaled_origin, neg_dir)`` as component triples, with ``inv_dir`` the
    reciprocal of the direction clamped away from zero to +-FLT_EPSILON,
    ``scaled_origin = -origin * inv_dir`` and ``neg_dir`` True where the
    direction component is negative."""
    safe = [torch.where(torch.abs(c) < FLT_EPSILON,
                        torch.copysign(torch.full_like(c, FLT_EPSILON), c),
                        c) for c in direction]
    inv = tuple(1.0 / c for c in safe)
    return (inv, tuple(-o * i for o, i in zip(origin, inv)),
            tuple(c < 0.0 for c in direction))


def _max(a, b):
    return torch.where(a > b, a, b)


def _min(a, b):
    return torch.where(a < b, a, b)


def intersect_aabb(inv_dir, scaled_origin, neg_dir, box_min, box_max):
    """Slab test of rays against boxes (all component triples, broadcast):
    ``(overlap, entry)``, ``entry`` the largest per-axis entry distance.
    The infinite ray is tested (no clipping to ``[0, tmax]``), as in the
    reference.  The operation order is the CUDA kernel's
    (csrc/binary_traverse.cu): per axis ``inv * near + scaled``, then the
    maximum (minimum) over x, y, z as ``a > b ? a : b`` (``a < b``)."""
    e = [inv_dir[k] * torch.where(neg_dir[k], box_max[k], box_min[k])
         + scaled_origin[k] for k in range(3)]
    x = [inv_dir[k] * torch.where(neg_dir[k], box_min[k], box_max[k])
         + scaled_origin[k] for k in range(3)]
    entry = _max(_max(e[0], e[1]), e[2])
    exit_ = _min(_min(x[0], x[1]), x[2])
    return entry <= exit_, entry


def spawn_offset_ray_v3(p, unit_n, unit_d, tmax=float("inf")):
    """Offset ray spawn: origin nudged off the surface; ``tmax`` broadcast
    to the lane shape."""
    if not torch.is_tensor(tmax):
        tmax = torch.full_like(p[0], tmax)
    return offset_ray_origin_v3(p, unit_n), unit_d, tmax
