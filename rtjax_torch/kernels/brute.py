"""All-triangles intersection: the test oracle of the traversal kernels
(port of rtjax.kernels.brute).

Every ray is tested against every triangle with the Moeller-Trumbore test
of ``core/geometry.py``, so the result depends on no BVH.  It is plain
PyTorch, on no render path, and costs O(rays x triangles): the triangles
go in chunks of CHUNK_ELEMENTS / rays, so that a few thousand rays over
millions of triangles fit on a card.
"""

from __future__ import annotations

import torch

from ..core.geometry import Triangles, intersect_triangle_v3

# rays x triangles of one chunk's intermediates (2^25 floats: 128 MiB each)
CHUNK_ELEMENTS = 1 << 25


def _test(tris: Triangles, lo: int, hi: int, o, d, tmax):
    """``(hit, t, u, v)`` of rays ``[R]`` against triangles ``lo..hi - 1``
    as ``[R, hi - lo]`` tensors."""
    col = lambda a: tuple(a[:, k, None] for k in range(3))
    row = lambda a: tuple(a[None, lo:hi, k] for k in range(3))
    return intersect_triangle_v3(col(o), col(d), tmax[:, None],
                                 row(tris.p0), row(tris.e1), row(tris.e2),
                                 row(tris.n))


def _chunks(tris: Triangles, n_rays: int):
    step = max(1, CHUNK_ELEMENTS // max(n_rays, 1))
    return ((lo, min(lo + step, tris.num)) for lo in range(0, tris.num, step))


def closest_brute(tris: Triangles, origin, direction, tmax, active):
    """Closest hit of each ray over all triangles: ``(hit, t, u, v, prim,
    normal)``, ``origin`` / ``direction`` ``[N, 3]``, ``tmax`` ``[N]``,
    ``active`` ``[N]`` bool.  The kept triangle is the first of least t;
    as in rtjax, ``t``, ``u``, ``v`` and ``prim`` are computed for every
    ray (a miss takes triangle 0's raw values and prim -1), while ``hit``
    and ``normal`` are masked by ``active``."""
    n = origin.shape[0]
    dev = origin.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best = torch.zeros(n, dtype=torch.long, device=dev)
    for lo, hi in _chunks(tris, n):
        h, t, _, _ = _test(tris, lo, hi, origin, direction, tmax)
        tm = torch.where(h, t, float("inf"))
        ct, ci = torch.min(tm, dim=1)   # first index of the least value
        closer = ct < best_t            # an earlier chunk keeps its ties
        best_t = torch.where(closer, ct, best_t)
        best = torch.where(closer, ci + lo, best)
    g = lambda a: tuple(a[best, k] for k in range(3))
    h, t, u, v = intersect_triangle_v3(
        tuple(origin[:, k] for k in range(3)),
        tuple(direction[:, k] for k in range(3)), tmax,
        g(tris.p0), g(tris.e1), g(tris.e2), g(tris.n))
    prim = torch.where(h, best.to(torch.int32), -1)
    hit = h & active
    normal = torch.where(hit[:, None], tris.n[best], 0.0)
    return hit, t, u, v, prim, normal


def anyhit_brute(tris: Triangles, origin, direction, tmax, exclude, active):
    """Occlusion of each ray by any triangle but its ``exclude`` one
    (``[N]`` int32 prim, -1 for none), masked by ``active``."""
    n = origin.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=origin.device)
    for lo, hi in _chunks(tris, n):
        h, _, _, _ = _test(tris, lo, hi, origin, direction, tmax)
        idx = torch.arange(lo, hi, device=origin.device)
        occ |= (h & (idx[None, :] != exclude[:, None])).any(1)
    return occ & active
