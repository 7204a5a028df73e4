"""Two-level (instanced) closest-hit and any-hit traversal over
InstancedTables: the wrappers of the hand-written CUDA kernels and their
plain PyTorch versions.

``wide_traverse_closest_inst`` / ``wide_traverse_anyhit_inst`` replace
rtjax/kernels/pallas_wide.py's functions of the same names (the Pallas
kernels ``_make_closest_inst_kernel`` and ``_make_anyhit_inst_kernel``).  A
CUDA tensor goes to the kernel in ``csrc/wide_inst_traverse.cu`` (built at
first use, bound with ctypes); a CPU tensor goes to the plain version.
There is no fallback between them.

The kernels are the persistent walkers' fetch design with an instance loop
around each lane's walk: they draw rays from the persist kernels' work
counter (``persist.work_buffer``, one per device and stream, shared with
them), keep the stack in shared memory (:func:`launch_shape`: the
concatenated tables' depth, the deepest of the base tree and every BLAS,
plus 1), and copy the instance records into shared memory where they fit
beside the stack (:func:`staged`), else read them from global memory.
``wide_traverse_*_inst_stride`` launch the first design of the same
kernels (a fixed share of the rays per thread, the records and a 64-entry
stack in global and local memory); they exist only to time both designs in
one run (``chip_smoke.py``, the card tests), are counted in
``STRIDE_LAUNCHES``, and no engine path calls them.

``with_stats=True`` appends ``(node_steps, leaf_visits)`` (int64 0-d
tensors on the rays' device): the node visits and leaf rows of every BLAS
walk, the plain walk's ``node_visits`` and ``leaf_rows``.  A CUDA tensor
then goes to the kernels' stats instances (counted in ``STATS_LAUNCHES``),
a CPU tensor to the plain walk with a work count, as persist.py's
``with_stats`` does.

Contract (rtjax's): rays as component triples (or ``[N, 3]``) of float32
world origin and direction, ``tmax [N] f32``, ``active [N] bool`` and, for
any-hit, ``exclude [N] i32``: a base-scene (instance 0) leaf-order prim
that never occludes; instanced geometry is never excluded.  Closest hit
returns ``hit [N] bool``, world ``t [N] f32`` (BIG on a miss or an
inactive lane), ``prim [N] i32`` (leaf order within the hit mesh; -1 on a
miss), ``inst [N] i32`` (0 = base scene, k = instance k; 0 on a miss) and
the LOCAL unnormalised normal ``cross(e1, e2)`` of the hit triangle (zero
on a miss); the caller maps it to world space by the instance's cofactor.
Any-hit returns ``occluded [N] bool``.

Both versions visit each ray's instances in the same order: by the entry
distance of the ray into the instance's world box (computed against the
ray's tmax on entry; culled instances are left out), lowest instance
index on equal distances; each visit is re-culled against the current
best t, then the ray is moved into the instance's frame by its affine rows
(not renormalised, so t stays in world units) and walks the BLAS from the
instance's root with the persistent walkers' visit order.  Kernel and
plain version therefore agree bit for bit, ties included.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..accel.instancing import apply_affine_point, apply_affine_vector
from ..accel.wide import InstancedTables
from . import _build
from .persist import (BIG, _check, _check_aligned, _columns, _launch,
                      _out_normal, _stats_buffer, _table_ptrs, _walk,
                      _work_pair, anyhit_leaf, closest_leaf, new_work, slab,
                      slab_pre, stack_len, work_buffer)

AFF = 18  # per instance: 12 world->local affine floats, 6 world-AABB floats
RECORD_BYTES = 4 * (AFF + 1)  # an instance's record staged: floats and root
FETCH_BLOCK = 128  # threads per block of the fetch kernels (kFetchBlock)
# the card's shared memory per block, opted in (H100: 227 KB)
SMEM_OPTIN = 232_448

# kernel launches (wrapper, CUDA path) and plain-version calls, by kernel
LAUNCHES = {"closest": 0, "anyhit": 0}
REF_CALLS = {"closest": 0, "anyhit": 0}
# launches of the first design (the ``_stride`` wrappers), by kernel
STRIDE_LAUNCHES = {"closest": 0, "anyhit": 0}
# launches of the stats instances (``with_stats=True``), by kernel
STATS_LAUNCHES = {"closest": 0, "anyhit": 0}

_lock = threading.Lock()
_lib = None


def _check_inst(tabs: InstancedTables, o, d, tmax, active, exclude=None):
    _check(tabs.wide, o, d, tmax, active, exclude)
    dev = tabs.wide.node_bounds.device
    n_inst = tabs.root.shape[0]
    if tabs.root.dtype != torch.int32 or tabs.affine.dtype != torch.float32:
        raise TypeError("root must be int32 and affine float32")
    if tabs.affine.shape != (n_inst * AFF,):
        raise ValueError(f"affine must have shape [{n_inst * AFF}], got "
                         f"{tuple(tabs.affine.shape)}")
    for name, a in (("root", tabs.root), ("affine", tabs.affine)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, the tables on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ------------------------------------------------------------- CUDA path

def smem_bytes(tabs: InstancedTables, records: bool) -> int:
    """Dynamic shared memory per block of a fetch launch: the stack
    (``persist.stack_len`` entries of node and mask per thread) and, with
    ``records``, every instance's record."""
    stack = 2 * 4 * stack_len(tabs.wide) * FETCH_BLOCK
    return stack + (RECORD_BYTES * tabs.num_instances if records else 0)


def staged(tabs: InstancedTables) -> bool:
    """Whether the fetch kernels copy the instance records into shared
    memory: where they fit beside the stack in the card's shared memory per
    block; else they read them from global memory."""
    return smem_bytes(tabs, True) <= SMEM_OPTIN


def launch_shape(tabs: InstancedTables) -> tuple[int, bool]:
    """``(stack length, records staged)`` of a fetch launch over ``tabs``;
    raises on tables that are not 16-byte aligned.  (A stack beyond
    ``persist.STACK`` is refused before, by every wrapper.)"""
    _check_aligned(tabs.wide)
    return stack_len(tabs.wide), staged(tabs)


def bind(lib):
    """Set the argument types of the six entry points of a two-level
    kernel library (``ctypes.CDLL``) and return it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    head = [I, P, P, P, P, P, P, I] + [P] * 8
    lib.rtjax_inst_closest.argtypes = head + [I] + [P] * 7 + [P, I, I, P]
    lib.rtjax_inst_anyhit.argtypes = head + [P, I, P] + [P, I, I, P]
    lib.rtjax_inst_closest_stats.argtypes = \
        head + [I] + [P] * 7 + [P, I, I, P, P]
    lib.rtjax_inst_anyhit_stats.argtypes = head + [P, I, P] + [P, I, I, P, P]
    lib.rtjax_inst_closest_stride.argtypes = head + [I] + [P] * 7 + [P]
    lib.rtjax_inst_anyhit_stride.argtypes = head + [P, I, P] + [P]
    for name in ("closest", "anyhit", "closest_stats", "anyhit_stats",
                 "closest_stride", "anyhit_stride"):
        getattr(lib, f"rtjax_inst_{name}").restype = I
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.wide_inst_library())))
        return _lib


def _inst_ptrs(tabs: InstancedTables):
    return (tabs.wide.width, *_table_ptrs(tabs.wide),
            tabs.root.data_ptr(), tabs.affine.data_ptr(), tabs.num_instances)


def _launch_args(tabs, stream, stride, stats=None):
    """``(trailing arguments of an entry point, work counter or None)``:
    the work counter, the stack length and the staging flag, then the
    stats buffer of a stats instance, then the stream (the stride design
    takes the stream alone)."""
    if stride:
        return (stream,), None
    stack, stage = launch_shape(tabs)
    work = work_buffer(tabs.wide.node_bounds.device, stream)
    tail = (work.data_ptr(), stack, int(stage))
    if stats is not None:
        tail += (stats.data_ptr(),)
    return tail + (stream,), work


def _entry(kind, stride, stats):
    """The entry point's name and the launch count it adds to."""
    if stride:
        return f"rtjax_inst_{kind}_stride", STRIDE_LAUNCHES
    if stats is not None:
        return f"rtjax_inst_{kind}_stats", STATS_LAUNCHES
    return f"rtjax_inst_{kind}", LAUNCHES


def _closest_cuda(tabs, o, d, tmax, active, stride, stats=None):
    n = tmax.shape[0]
    dev = tmax.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry, counts = _entry("closest", stride, stats)
    tail, work = _launch_args(tabs, stream, stride, stats)
    _launch(getattr(_kernels(), entry), (
        *_inst_ptrs(tabs), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(), n,
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(), inst.data_ptr(),
        *(c.data_ptr() for c in nrm), *tail), "two-level closest-hit", work)
    counts["closest"] += 1
    return hit, t, prim, inst, nrm


def _anyhit_cuda(tabs, o, d, tmax, exclude, active, stride, stats=None):
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmax.device)
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    entry, counts = _entry("anyhit", stride, stats)
    tail, work = _launch_args(tabs, stream, stride, stats)
    _launch(getattr(_kernels(), entry), (
        *_inst_ptrs(tabs), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(),
        exclude.data_ptr(), n, occ.data_ptr(), *tail), "two-level any-hit",
        work)
    counts["anyhit"] += 1
    return occ


def _closest(tabs, origin, direction, tmax, active, stride,
             with_stats=False):
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    _check_inst(tabs, o, d, tmax, active)
    if tmax.device.type == "cuda":
        stats = _stats_buffer(tmax.device) if with_stats else None
        hit, t, prim, inst, nrm = _closest_cuda(tabs, o, d, tmax, active,
                                                stride, stats)
        st = () if stats is None else ((stats[0], stats[1]),)
    elif tmax.device.type == "cpu":
        hit, t, prim, inst, nrm, *st = wide_traverse_closest_inst_ref(
            tabs, o, d, tmax, active, with_stats=with_stats)
    else:
        raise ValueError(f"unsupported device {tmax.device}")
    return (hit, t, prim, inst, _out_normal(nrm, as_v3), *st)


def _anyhit(tabs, origin, direction, tmax, exclude, active, stride,
            with_stats=False):
    o, d = _columns(origin), _columns(direction)
    _check_inst(tabs, o, d, tmax, active, exclude)
    if tmax.device.type == "cuda":
        if not with_stats:
            return _anyhit_cuda(tabs, o, d, tmax, exclude, active, stride)
        stats = _stats_buffer(tmax.device)
        occ = _anyhit_cuda(tabs, o, d, tmax, exclude, active, stride, stats)
        return occ, (stats[0], stats[1])
    if tmax.device.type == "cpu":
        return wide_traverse_anyhit_inst_ref(tabs, o, d, tmax, exclude,
                                             active, with_stats=with_stats)
    raise ValueError(f"unsupported device {tmax.device}")


def wide_traverse_closest_inst(tabs: InstancedTables, origin, direction,
                               tmax, active, with_stats: bool = False):
    """Two-level closest hit: ``(hit, t, prim, inst, normal_local)``, and
    with ``with_stats`` a trailing ``(node_steps, leaf_visits)``."""
    return _closest(tabs, origin, direction, tmax, active, False, with_stats)


def wide_traverse_anyhit_inst(tabs: InstancedTables, origin, direction,
                              tmax, exclude, active, with_stats: bool = False):
    """Two-level occlusion; ``exclude`` applies within instance 0 only.
    With ``with_stats``, ``(occluded, (node_steps, leaf_visits))``."""
    return _anyhit(tabs, origin, direction, tmax, exclude, active, False,
                   with_stats)


def wide_traverse_closest_inst_stride(tabs: InstancedTables, origin,
                                      direction, tmax, active):
    """:func:`wide_traverse_closest_inst` by the first design (for timing
    both designs in one run; counted in ``STRIDE_LAUNCHES``)."""
    return _closest(tabs, origin, direction, tmax, active, True)


def wide_traverse_anyhit_inst_stride(tabs: InstancedTables, origin,
                                     direction, tmax, exclude, active):
    """:func:`wide_traverse_anyhit_inst` by the first design."""
    return _anyhit(tabs, origin, direction, tmax, exclude, active, True)


# ------------------------------------------------------ plain versions

def _visit_order(tabs, o, d, tmax):
    """Per ray: the instances in visit order ``order [N, I]``, their entry
    distances ``dist [N, I]`` (BIG when culled), the affine table ``[I,
    18]`` and the world slab precompute."""
    aff = tabs.affine.view(-1, AFF)
    inv, sc = slab_pre(o, d)
    entry, exit_ = slab(aff[None, :, 12:18],
                        [c[:, None] for c in inv], [c[:, None] for c in sc])
    hit = (entry <= exit_) & (exit_ >= 0.0) & (entry <= tmax[:, None])
    # max(entry, 0) with +0 for -0: a radix sort orders -0 before +0, the
    # kernel's compares do not
    dist = torch.where(hit, torch.where(entry > 0.0, entry, 0.0), BIG)
    dist, order = torch.sort(dist, dim=1, stable=True)
    return order, dist, aff, inv, sc


def _visits(tabs, o, d, tmax, active, live, work=None):
    """Yield, for each visit round j, ``(pending [N], k [N], o_l, d_l)``:
    the rays whose j-th instance is not culled (against the running
    ``live()`` tmax) and their rays in that instance's frame.  ``work``,
    when given, counts the instance box tests: one per active ray and
    instance, then a re-cull per candidate visit."""
    order, dist, aff, inv, sc = _visit_order(tabs, o, d, tmax)
    if work is not None:
        work.setdefault("inst_tests", 0)
        work.setdefault("inst_visits", 0)
        work["inst_tests"] += int(active.sum()) * order.shape[1]
    for j in range(order.shape[1]):
        dj = dist[:, j]
        more = active & (dj < BIG)
        if not bool(more.any()):
            return
        k = order[:, j]
        a = aff[k]
        entry, exit_ = slab(a[:, 12:18], inv, sc)
        pending = more & (torch.clamp(entry, min=0.0)
                          <= torch.minimum(exit_, live()))
        if work is not None:
            work["inst_tests"] += int(more.sum())
        rows = a[:, :12].view(-1, 3, 4)
        yield (pending, k, apply_affine_point(rows, o),
               apply_affine_vector(rows, d))


def wide_traverse_closest_inst_ref(tabs: InstancedTables, origin, direction,
                                   tmax, active, work=None, with_stats=False):
    """Plain PyTorch version of :func:`wide_traverse_closest_inst` (same
    contract, same visit order, any device); ``work``
    (``persist.new_work``), when given, counts its work.  ``with_stats``
    appends the walks' ``(node_steps, leaf_visits)``."""
    REF_CALLS["closest"] += 1
    if with_stats and work is None:
        work = new_work()
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    n = tmax.shape[0]
    dev = tmax.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    best_n = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    cur_t = tmax.clone()
    for pending, k, o_l, d_l in _visits(tabs, o, d, tmax, active,
                                        lambda: cur_t, work):
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        if work is not None:
            work["inst_visits"] += int(pending.sum())
        _walk(tabs.wide, o_l, d_l, cur_t, pending,
              closest_leaf(best_t, best_p, best_n, found),
              root=tabs.root[k], work=work)
        best_i = torch.where(found, k.to(torch.int32), best_i)
        cur_t = torch.where(found, best_t, cur_t)
    hit = best_p >= 0
    nrm = (best_n[:, 0], best_n[:, 1], best_n[:, 2])
    out = (hit, best_t, best_p, best_i, _out_normal(nrm, as_v3))
    return out + ((_work_pair(work, dev),) if with_stats else ())


def wide_traverse_anyhit_inst_ref(tabs: InstancedTables, origin, direction,
                                  tmax, exclude, active, work=None,
                                  with_stats=False):
    """Plain PyTorch version of :func:`wide_traverse_anyhit_inst`;
    ``with_stats`` as in :func:`wide_traverse_closest_inst_ref`."""
    REF_CALLS["anyhit"] += 1
    if with_stats and work is None:
        work = new_work()
    o, d = _columns(origin), _columns(direction)
    occ = torch.zeros(tmax.shape[0], dtype=torch.bool, device=tmax.device)
    for pending, k, o_l, d_l in _visits(tabs, o, d, tmax, active,
                                        lambda: tmax, work):
        ex = torch.where(k == 0, exclude, -1)
        if work is not None:
            work["inst_visits"] += int((pending & ~occ).sum())
        _walk(tabs.wide, o_l, d_l, tmax, pending & ~occ, anyhit_leaf(occ),
              ex, root=tabs.root[k], work=work)
    if with_stats:
        return occ, _work_pair(work, tmax.device)
    return occ
