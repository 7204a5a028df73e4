"""The tiny-scene direct path: closest hit and any hit of every ray against
every triangle of a small mesh, no BVH -- the wrappers of the hand-written
CUDA kernels and their plain PyTorch versions.

``direct_closest`` / ``direct_anyhit`` replace rtjax/render/trace.py's
``_direct_closest`` / ``_direct_anyhit``, an unrolled all-triangles
Moeller-Trumbore loop that XLA fuses (no ``pallas_call``).  rtjax's
``_backend`` takes it for every single-level launch over a mesh of at most
``RenderConfig.direct_max_tris`` triangles (default 64); so does the port
(render/trace.py ``_backend``).  A CUDA tensor goes to the kernels in
``csrc/direct_traverse.cu`` (built at first use, bound with ctypes); a CPU
tensor goes to the plain version.  There is no fallback between them.

What both compute is rtjax's loop: per triangle in leaf order ``c = p0 -
o``, ``r = d x c``, ``inv_det = 1 / (d . n)``, then u, v and t
(core/geometry.py ``intersect_triangle_v3``), accepted when ``u >= 0, v >=
0, u + v <= 1, 0 < t <= tmax``.  Closest hit keeps the first triangle of
least t (a strict ``t < best``); any hit counts a triangle only if it is
not the ray's ``exclude`` prim.  Kernel and plain version agree bit for
bit (the build uses ``--fmad=false``).

Contract: ``tris`` the mesh's leaf-order :class:`Triangles`; rays are
component triples (or ``[N, 3]``) of float32 origin and direction, ``tmax
[N] f32``, ``active [N] bool`` and, for any hit, ``exclude [N] i32``.
Closest hit returns ``(hit, t, prim, normal)`` with the port's shared
contract for misses and inactive lanes: hit 0, t ``BIG``, prim -1, normal
0 (the normal is the hit triangle's unnormalised ``cross(e1, e2)``, in the
input's layout).  rtjax's loop leaves t and the normal of an inactive lane
unmasked; its engine never reads them.  Any hit returns ``occluded [N]
bool``.  ``with_stats=True`` appends rtjax's counts, ``(0, active.sum() *
T)`` as int64 0-d tensors on the rays' device: no node steps, every active
ray visiting every triangle.  The wrappers compute them; the kernels do
not count.

Designs (csrc/direct_traverse.cu): closest hit runs the first design (one
thread a ray, the triangles staged in shared memory), the fastest of those
tried in a captured config-2 frame; any hit compacts each block's live
lanes before the triangle loop, over triangle records staged in shared
memory.  The first design of any hit stays behind
:func:`direct_anyhit_v1`, which no render path calls, for same-run A/B
(``tools/direct_designs.py`` rebinds :func:`_anyhit_cuda` to time frames
on it).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.geometry import Triangles, intersect_triangle_v3
from . import _build
from .persist import BIG, _columns, _out_normal

# kernel launches (wrapper, CUDA path), by kernel
LAUNCHES = {"closest": 0, "anyhit": 0}
# launches of any hit's first design (the ``_v1`` entry point)
V1_LAUNCHES = {"anyhit": 0}

_lock = threading.Lock()
_lib = None


def _check(tris: Triangles, o, d, tmax, active, exclude=None):
    """Raise on rays and triangles the kernels do not take: device, dtype,
    shape and contiguity."""
    dev = tris.p0.device
    n = tmax.shape[0] if tmax.dim() == 1 else -1
    cols = [("origin", c, torch.float32) for c in o] + \
        [("direction", c, torch.float32) for c in d] + \
        [("tmax", tmax, torch.float32), ("active", active, torch.bool)]
    if exclude is not None:
        cols.append(("exclude", exclude, torch.int32))
    for name, c, dt in cols:
        if c.device != dev:
            raise ValueError(f"{name} is on {c.device}, the triangles on "
                             f"{dev}")
        if c.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"{name} must have shape [{n}], got "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for f in ("p0", "e1", "e2", "n"):
        a = getattr(tris, f)
        if a.device != dev or a.dtype != torch.float32 or \
                not a.is_contiguous() or a.dim() != 2 or a.shape[1] != 3:
            raise ValueError(f"tris.{f} must be a contiguous float32 tensor "
                             f"[*, 3] on {dev}")


def _counts(tris: Triangles, active):
    """rtjax's ``(node_steps, leaf_visits)`` of the direct loop."""
    return (torch.zeros((), dtype=torch.int64, device=active.device),
            active.sum(dtype=torch.int64) * tris.num)


# ------------------------------------------------------------- CUDA path

def bind(lib):
    """Set the argument types of the three entry points of a direct-path
    kernel library (``ctypes.CDLL``) and return it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtjax_direct_closest.argtypes = \
        [P] * 4 + [I] + [P] * 8 + [I] + [P] * 6 + [P]
    for name in ("anyhit", "anyhit_v1"):
        getattr(lib, f"rtjax_direct_{name}").argtypes = \
            [P] * 4 + [I] + [P] * 9 + [I, P, P]
    for name in ("closest", "anyhit", "anyhit_v1"):
        getattr(lib, f"rtjax_direct_{name}").restype = I
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.direct_library())))
        return _lib


def _on_card(t) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _tri_args(tris: Triangles):
    return (tris.p0.data_ptr(), tris.e1.data_ptr(), tris.e2.data_ptr(),
            tris.n.data_ptr(), tris.num)


def _launch(kind, args, counter=LAUNCHES):
    rc = getattr(_kernels(), f"rtjax_direct_{kind}")(*args)
    if rc != 0:
        raise RuntimeError(f"direct {kind} kernel launch failed: CUDA error "
                           f"{rc}")
    counter[kind.removesuffix("_v1")] += 1


def _closest_cuda(tris, o, d, tmax, active):
    n = tmax.shape[0]
    dev = tmax.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch("closest", (
        *_tri_args(tris), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(), n,
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(),
        *(c.data_ptr() for c in nrm), stream))
    return hit, t, prim, nrm


def _anyhit_launch(kind, counter, tris, o, d, tmax, exclude, active):
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmax.device)
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    _launch(kind, (
        *_tri_args(tris), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(),
        exclude.data_ptr(), n, occ.data_ptr(), stream), counter)
    return occ


def _anyhit_cuda(tris, o, d, tmax, exclude, active):
    return _anyhit_launch("anyhit", LAUNCHES, tris, o, d, tmax, exclude,
                          active)


def _anyhit_cuda_v1(tris, o, d, tmax, exclude, active):
    """:func:`_anyhit_cuda` in the first design."""
    return _anyhit_launch("anyhit_v1", V1_LAUNCHES, tris, o, d, tmax,
                          exclude, active)


def direct_anyhit_v1(tris: Triangles, origin, direction, tmax, exclude,
                     active):
    """Any hit's first design (CUDA tensors only): ``occluded`` as
    :func:`direct_anyhit` gives it."""
    o, d = _columns(origin), _columns(direction)
    _check(tris, o, d, tmax, active, exclude)
    if not _on_card(tmax):
        raise ValueError("the first design's kernel takes CUDA tensors")
    return _anyhit_cuda_v1(tris, o, d, tmax, exclude, active)


def direct_closest(tris: Triangles, origin, direction, tmax, active,
                   with_stats: bool = False):
    """Closest hit of every active ray over every triangle: ``(hit, t,
    prim, normal)``, and with ``with_stats`` a trailing ``(node_steps,
    leaf_visits)``."""
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    _check(tris, o, d, tmax, active)
    if _on_card(tmax):
        hit, t, prim, nrm = _closest_cuda(tris, o, d, tmax, active)
    else:
        hit, t, prim, nrm = direct_closest_ref(tris, o, d, tmax, active)
    out = (hit, t, prim, _out_normal(nrm, as_v3))
    return out + ((_counts(tris, active),) if with_stats else ())


def direct_anyhit(tris: Triangles, origin, direction, tmax, exclude, active,
                  with_stats: bool = False):
    """Occlusion of every active ray by any triangle but its ``exclude``
    one; with ``with_stats``, ``(occluded, (node_steps, leaf_visits))``."""
    o, d = _columns(origin), _columns(direction)
    _check(tris, o, d, tmax, active, exclude)
    if _on_card(tmax):
        occ = _anyhit_cuda(tris, o, d, tmax, exclude, active)
    else:
        occ = direct_anyhit_ref(tris, o, d, tmax, exclude, active)
    return (occ, _counts(tris, active)) if with_stats else occ


# ------------------------------------------------------ plain versions

def _row(a, k):
    return (a[k, 0], a[k, 1], a[k, 2])


def direct_closest_ref(tris: Triangles, origin, direction, tmax, active,
                       with_stats: bool = False):
    """Plain PyTorch version of :func:`direct_closest` (same contract, any
    device): rtjax's loop over the triangles in leaf order, each tested on
    the whole ray batch with ``intersect_triangle_v3``."""
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    best = torch.full_like(tmax, BIG)
    prim = torch.full(tmax.shape, -1, dtype=torch.int32, device=tmax.device)
    nrm = (torch.zeros_like(tmax),) * 3
    for k in range(tris.num):
        n_k = _row(tris.n, k)
        h, t, _, _ = intersect_triangle_v3(o, d, tmax, _row(tris.p0, k),
                                           _row(tris.e1, k),
                                           _row(tris.e2, k), n_k)
        closer = h & (t < best)
        best = torch.where(closer, t, best)
        prim = torch.where(closer, k, prim)
        nrm = tuple(torch.where(closer, c, x) for c, x in zip(n_k, nrm))
    hit = (prim >= 0) & active
    out = (hit, torch.where(active, best, BIG), torch.where(hit, prim, -1),
           _out_normal(tuple(torch.where(hit, c, 0.0) for c in nrm), as_v3))
    return out + ((_counts(tris, active),) if with_stats else ())


def direct_anyhit_ref(tris: Triangles, origin, direction, tmax, exclude,
                      active, with_stats: bool = False):
    """Plain PyTorch version of :func:`direct_anyhit` (same contract, any
    device)."""
    o, d = _columns(origin), _columns(direction)
    occ = torch.zeros(tmax.shape, dtype=torch.bool, device=tmax.device)
    for k in range(tris.num):
        h, _, _, _ = intersect_triangle_v3(o, d, tmax, _row(tris.p0, k),
                                           _row(tris.e1, k),
                                           _row(tris.e2, k), _row(tris.n, k))
        occ = occ | (h & (exclude != k))
    occ = occ & active
    return (occ, _counts(tris, active)) if with_stats else occ
