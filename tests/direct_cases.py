"""Triangle soups, rays and activity masks for the direct pair's kernels
(kernels/direct.py), shared by the host-compiled checks in
tests/test_torch_direct.py and the card's in tests/test_torch_cuda.py.
Imports no JAX.

Each case is made from a seed with NumPy: a soup of ``n_tris`` triangles
with coincident copies (ties of equal t) and a shared edge, rays toward
centroids, edge midpoints (grazing edges) and vertices, ``tmax`` at a
hit's t and just below it on some lanes, ``exclude`` the lane's own
occluder on half of them, and one of :data:`MASKS`.
"""

import numpy as np
import torch

from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import direct

N_RAYS = 1024 + 77   # whole 256-lane windows and a ragged last one
# 0, 1, 12 (config 2's mesh), 64 (one shared-memory tile), 65 and 300
# (several)
TRI_COUNTS = (0, 1, 12, 64, 65, 300)
MASKS = ("all", "none", "scattered", "one_a_warp", "prefix")


def mask(kind, n, seed=0):
    """``[n]`` bool: every lane, none, 28% scattered, lane 5 of each warp
    of 32, or the first 40% of the lanes."""
    i = np.arange(n)
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "scattered": np.random.default_rng(seed).random(n) < 0.28,
            "one_a_warp": i % 32 == 5,
            "prefix": i < (2 * n) // 5}[kind]


def soup(n_tris):
    """``(p0, p1, p2)`` float32 ``[n_tris, 3]``: random triangles in
    [-1, 1]^3, the last eighth copies of the first (coincident), and
    triangle 1 sharing triangle 0's edge p0-p2."""
    rng = np.random.default_rng(100 + n_tris)
    p0 = rng.uniform(-1, 1, (n_tris, 3))
    p1 = p0 + rng.uniform(-0.6, 0.6, (n_tris, 3))
    p2 = p0 + rng.uniform(-0.6, 0.6, (n_tris, 3))
    if n_tris >= 2:
        p0[1], p1[1] = p2[0], p0[0]
    k = n_tris // 8
    for a in (p0, p1, p2):
        a[n_tris - k:] = a[:k]
    return tuple(a.astype(np.float32) for a in (p0, p1, p2))


def _v3(a, device):
    return tuple(torch.tensor(np.ascontiguousarray(a[:, k]), device=device)
                 for k in range(3))


def case(n_tris, kind, device, n=N_RAYS):
    """``(tris, o, d, tmax, active, exclude)`` on ``device``, the rays as
    component triples."""
    p0, p1, p2 = soup(n_tris)
    tris = Triangles.from_vertices(p0, p1, p2, device)
    rng = np.random.default_rng(7 * n_tris + len(kind))
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (n, 3))
    if n_tris:
        pick = rng.integers(0, n_tris, n)
        part = np.arange(n) % 4
        cen = (p0 + p1 + p2) / 3
        target = np.where((part == 0)[:, None], cen[pick], target)
        target = np.where((part == 1)[:, None], (p0[pick] + p2[pick]) / 2,
                          target)                       # grazing an edge
        target = np.where((part == 2)[:, None], p1[pick], target)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    # tmax at the closest hit's t, just below it, or unbounded
    cpu = Triangles.from_vertices(p0, p1, p2, "cpu")
    inf = torch.full((n,), float("inf"))
    hit, t, prim, _ = direct.direct_closest_ref(
        cpu, _v3(o, "cpu"), _v3(d, "cpu"), inf, torch.ones(n, dtype=bool))
    hit, t, prim = hit.numpy(), t.numpy(), prim.numpy()
    lane = np.arange(n) % 3
    tmax = np.full(n, np.inf, np.float32)
    tmax[hit & (lane == 1)] = t[hit & (lane == 1)]
    below = hit & (lane == 2)
    tmax[below] = np.nextafter(t[below], np.float32(0))
    exclude = np.where(np.arange(n) % 2 == 0, prim,
                       rng.integers(-1, max(n_tris, 1), n)).astype(np.int32)
    return (tris, _v3(o, device), _v3(d, device),
            torch.tensor(tmax, device=device),
            torch.tensor(mask(kind, n), device=device),
            torch.tensor(exclude, device=device))
