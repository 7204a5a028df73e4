"""Closest-hit and any-hit traversal of the binary BVH: the wrappers of the
hand-written CUDA kernels and their plain PyTorch versions (port of
rtjax/kernels/traversal.py).

``traverse_closest`` / ``traverse_anyhit`` replace rtjax's functions of the
same names, a ``vmap``-ped ``lax.while_loop`` that XLA fuses into one
device loop (no ``pallas_call``).  A CUDA tensor goes to the kernels in
``csrc/binary_traverse.cu`` (built at first use, bound with ctypes); a CPU
tensor goes to the plain version.  There is no fallback between them.

The kernels (the fetch design) read the tree and the triangles as
records (:class:`BinaryRecords`, :func:`binary_records`): one 64-byte
record per node pair (both children's boxes and words, the word of an
internal child being its own children's pair), one 48-byte record per
triangle, built once per (BVH, triangles) on their device and kept while
both live.  They draw rays from the persist kernels' per-stream work
counter (``persist.work_buffer``) on a grid of the card's resident
blocks.  ``traverse_*_thread`` launch the first design (one thread a ray,
the arrays as they are); they exist only to time both designs in one run
(``chip_smoke.py``, the card tests), and no engine path calls them.

Both walk each ray in rtjax's visit order (the reference's,
bvh.cuh:221-357), over the pair of children ``(cur, cur + 1)`` of the
current node:

- both children are slab-tested, on the infinite ray (no clipping to
  ``[0, tmax]``; core/geometry.py ``intersect_aabb``);
- a hit leaf child is consumed at once, the left one before the right, its
  triangles in leaf order; a closest-hit ray's tmax shrinks on every hit
  (``t <= tmax`` accepts, so of equal t the later triangle wins); an
  any-hit ray stops at the first hit that is not its excluded prim, and the
  right leaf is not tested once the left one occluded;
- of two hit internal children the nearer entry is descended and the
  farther pushed (``entry_l > entry_r`` pushes the left one); one hit
  internal child is descended; with none the next pair is popped, and the
  walk ends on an empty stack (or, any hit, on occlusion).

The stack holds ``max(stack_size, bvh.max_depth + 1)`` entries per ray
(:func:`stack_len`), as rtjax sizes it; a walk never holds more than the
tree's depth.  No push is dropped: the plain version raises and the kernel
traps should a push find its stack full, and the wrappers refuse a stack
beyond the kernels' largest (``MAX_STACK``) with ValueError.

``with_stats=True`` appends ``(node_pair_steps, leaf_visits)`` as rtjax
counts them (int64 0-d tensors on the rays' device): one step per loop
iteration of a ray, one leaf visit per hit leaf child, both leaves of a
step counted before any occlusion.  A CUDA tensor then goes to the
kernels' stats instances (counted in ``STATS_LAUNCHES``).  The plain
versions count more when given a ``work`` dict (:func:`new_work`): the
triangles tested and which node pairs and triangles the walk read, which a
launch's bound is computed from.

Contract (rtjax's): rays are component triples (or ``[N, 3]``) of float32
origin and direction, ``tmax [N] f32``, ``active [N] bool`` and, for any
hit, ``exclude [N] i32`` (a leaf-order prim that never occludes).  Closest
hit returns ``(hit, t, u, v, prim, normal)``: on a miss or an inactive lane
t is inf, u = v = 0, prim -1 and the normal zero; the normal is the hit
triangle's unnormalised ``cross(e1, e2)`` in the input's layout.  Any hit
returns ``occluded [N] bool``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref

import torch

from ..accel.bvh import BvhArrays
from ..constants import BVH_MAX_DEPTH
from ..core.geometry import (Triangles, intersect_aabb, intersect_triangle_v3,
                             ray_slab_precompute)
from . import _build
from .persist import _columns, _out_normal, _stats_buffer, work_buffer

BLOCK = 128                # threads a block of the kernels, one ray each
SMEM_MAX = 232448          # dynamic shared memory a block may use (bytes)
MAX_STACK = SMEM_MAX // (4 * BLOCK)   # the kernels' largest stack: 454

PAIR_WORDS = 16            # a node-pair record: 12 f32 box words, 4 i32
TRI_WORDS = 12             # a triangle record: p0, e1, e2, n

# kernel launches (wrapper, CUDA path), plain-version calls, launches of
# the stats instances (``with_stats=True``) and of the first design (the
# ``_thread`` wrappers), by kernel
LAUNCHES = {"closest": 0, "anyhit": 0}
REF_CALLS = {"closest": 0, "anyhit": 0}
STATS_LAUNCHES = {"closest": 0, "anyhit": 0}
THREAD_LAUNCHES = {"closest": 0, "anyhit": 0}

_lock = threading.Lock()
_lib = None


def stack_len(bvh: BvhArrays, stack_size: int = BVH_MAX_DEPTH) -> int:
    """Stack entries per ray: ``max(stack_size, bvh.max_depth + 1)``."""
    return max(int(stack_size), bvh.max_depth + 1)


def _check(bvh: BvhArrays, tris: Triangles, o, d, tmax, active,
           exclude=None):
    """Raise on rays, BVH arrays and triangles the kernels do not take:
    device, dtype, shape and contiguity."""
    dev = bvh.bmin.device
    n = tmax.shape[0] if tmax.dim() == 1 else -1
    cols = [("origin", c, torch.float32) for c in o] + \
        [("direction", c, torch.float32) for c in d] + \
        [("tmax", tmax, torch.float32), ("active", active, torch.bool)]
    if exclude is not None:
        cols.append(("exclude", exclude, torch.int32))
    for name, c, dt in cols:
        if c.device != dev:
            raise ValueError(f"{name} is on {c.device}, the BVH on {dev}")
        if c.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"{name} must have shape [{n}], got "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    arrays = [("bvh.bmin", bvh.bmin, torch.float32, 3),
              ("bvh.bmax", bvh.bmax, torch.float32, 3),
              ("bvh.left_first", bvh.left_first, torch.int32, None),
              ("bvh.num_prims", bvh.num_prims, torch.int32, None)] + \
        [(f"tris.{f}", getattr(tris, f), torch.float32, 3)
         for f in ("p0", "e1", "e2", "n")]
    for name, a, dt, cols3 in arrays:
        if a.device != dev or a.dtype != dt or not a.is_contiguous() or \
                (cols3 is not None and (a.dim() != 2 or a.shape[1] != 3)):
            raise ValueError(f"{name} must be a contiguous {dt} tensor"
                             f"{' [*, 3]' if cols3 else ''} on {dev}")


def stack_len_checked(bvh: BvhArrays, stack_size: int) -> int:
    """:func:`stack_len`, refused with ValueError beyond ``MAX_STACK``."""
    n_stack = stack_len(bvh, stack_size)
    if smem_bytes(n_stack) > SMEM_MAX:
        raise ValueError(
            f"BVH depth {bvh.max_depth} (stack size {stack_size}) needs "
            f"{n_stack} stack entries a ray; the binary-walk kernels hold "
            f"at most {MAX_STACK}")
    return n_stack


def smem_bytes(n_stack: int) -> int:
    """Dynamic shared memory of a block of either design: ``n_stack``
    stack entries (int32) for each of its ``BLOCK`` thread slots."""
    return 4 * n_stack * BLOCK


# ------------------------------------------------------------- records

@dataclasses.dataclass(frozen=True)
class BinaryRecords:
    """The fetch kernels' view of a binary BVH and its triangles.

    ``pairs [P, 16]`` f32: one record per node pair ``(L, L + 1)`` (the
    children of an internal node), in the order of ``L``: the left box
    (lo xyz, hi xyz), the right box, then four int32 words as bits, per
    child ``(word, num_prims)``: a leaf's ``(left_first, num_prims)``, an
    internal child's ``(its children's pair, 0)``.  ``pair_left [P]``
    int64 is ``L`` of each pair (the map from pairs to node ids), ``root``
    the pair of the root's children.  ``tris [T, 12]`` f32: ``p0, e1, e2,
    n`` of each leaf-order triangle."""

    pairs: torch.Tensor
    pair_left: torch.Tensor
    root: int
    tris: torch.Tensor

    @property
    def nbytes(self) -> int:
        return (self.pairs.numel() + self.tris.numel()) * 4


def pack_records(bvh: BvhArrays, tris: Triangles) -> BinaryRecords:
    """Build the records on the BVH's device (every index in int64)."""
    lf = bvh.left_first.long()
    npr = bvh.num_prims
    inner = npr == 0
    left = torch.sort(lf[inner]).values
    pair_of = torch.full((bvh.num_nodes,), -1, dtype=torch.long,
                         device=lf.device)
    pair_of[left] = torch.arange(left.shape[0], device=lf.device)

    def words(x):
        leaf = npr[x] > 0
        return torch.where(leaf, lf[x], pair_of[torch.where(leaf, 0, lf[x])])

    right = left + 1
    w = torch.stack([words(left), npr[left].long(), words(right),
                     npr[right].long()], 1).to(torch.int32)
    pairs = torch.cat([bvh.bmin[left], bvh.bmax[left], bvh.bmin[right],
                       bvh.bmax[right], w.view(torch.float32)], 1)
    return BinaryRecords(
        pairs=pairs.contiguous(), pair_left=left,
        root=int(pair_of[lf[0]]),
        tris=torch.cat([tris.p0, tris.e1, tris.e2, tris.n], 1).contiguous())


_records: dict = {}   # (id(bvh), id(tris)) -> BinaryRecords


def binary_records(bvh: BvhArrays, tris: Triangles) -> BinaryRecords:
    """The records of ``(bvh, tris)``: packed at the first call (the
    frame's first, eager step on the card) and kept while both live."""
    key = (id(bvh), id(tris))
    with _lock:
        rec = _records.get(key)
    if rec is None:
        rec = pack_records(bvh, tris)
        with _lock:
            _records[key] = rec
        for owner in (bvh, tris):
            weakref.finalize(owner, _records.pop, key, None)
    return rec


# ------------------------------------------------------------- CUDA path

def bind(lib):
    """Set the argument types of the four entry points of a binary-walk
    kernel library (``ctypes.CDLL``) and return it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtjax_binary_closest.argtypes = \
        [P, P, I] + [P] * 6 + [P, P, I] + [P] * 8 + [I, P, P, P]
    lib.rtjax_binary_anyhit.argtypes = \
        [P, P, I] + [P] * 6 + [P, P, P, I, P, I, P, P, P]
    lib.rtjax_binary_closest_thread.argtypes = \
        [P] * 8 + [P] * 6 + [P, P, I] + [P] * 8 + [I, P, P]
    lib.rtjax_binary_anyhit_thread.argtypes = \
        [P] * 8 + [P] * 6 + [P, P, P, I, P, I, P, P]
    for name in ("closest", "anyhit", "closest_thread", "anyhit_thread"):
        getattr(lib, f"rtjax_binary_{name}").restype = I
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.binary_library())))
        return _lib


def _scene_args(bvh, tris, thread, stream):
    """``(leading arguments, work counter or None)`` of an entry point:
    the first design's eight arrays, or the fetch design's records (16-byte
    aligned), root pair and the stream's work counter."""
    if thread:
        return (bvh.bmin.data_ptr(), bvh.bmax.data_ptr(),
                bvh.left_first.data_ptr(), bvh.num_prims.data_ptr(),
                tris.p0.data_ptr(), tris.e1.data_ptr(), tris.e2.data_ptr(),
                tris.n.data_ptr()), None
    rec = binary_records(bvh, tris)
    for name in ("pairs", "tris"):
        if getattr(rec, name).data_ptr() % 16:
            raise ValueError(f"records.{name} must be 16-byte aligned")
    return ((rec.pairs.data_ptr(), rec.tris.data_ptr(), rec.root),
            work_buffer(bvh.bmin.device, stream))


def _launch(kind, args, thread, stats, work):
    """Call the entry point; raise on a CUDA error code, first zeroing the
    work counter (a refused launch may have left it drawn)."""
    name = f"rtjax_binary_{kind}" + ("_thread" if thread else "")
    rc = getattr(_kernels(), name)(*args)
    if rc != 0:
        if work is not None:
            work.zero_()
        raise RuntimeError(f"binary {kind} kernel launch failed: CUDA error "
                           f"{rc}")
    counts = THREAD_LAUNCHES if thread else (
        LAUNCHES if stats is None else STATS_LAUNCHES)
    counts[kind] += 1


def _tail(n_stack, work, stats, stream):
    return (n_stack,) + (() if work is None else (work.data_ptr(),)) + (
        None if stats is None else stats.data_ptr(), stream)


def _closest_cuda(bvh, tris, o, d, tmax, active, n_stack, stats,
                  thread=False):
    n = tmax.shape[0]
    dev = tmax.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(3))
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    head, work = _scene_args(bvh, tris, thread, stream)
    _launch("closest", (
        *head, *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), n, hit.data_ptr(), t.data_ptr(),
        u.data_ptr(), v.data_ptr(), prim.data_ptr(),
        *(c.data_ptr() for c in nrm), *_tail(n_stack, work, stats, stream)),
        thread, stats, work)
    return hit, t, u, v, prim, nrm


def _anyhit_cuda(bvh, tris, o, d, tmax, exclude, active, n_stack, stats,
                 thread=False):
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmax.device)
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    head, work = _scene_args(bvh, tris, thread, stream)
    _launch("anyhit", (
        *head, *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), exclude.data_ptr(), n,
        occ.data_ptr(), *_tail(n_stack, work, stats, stream)),
        thread, stats, work)
    return occ


def traverse_closest(bvh: BvhArrays, tris: Triangles, origin, direction,
                     tmax, active, stack_size: int = BVH_MAX_DEPTH,
                     with_stats: bool = False):
    """Closest hit of every active ray: ``(hit, t, u, v, prim, normal)``,
    and with ``with_stats`` a trailing ``(node_pair_steps,
    leaf_visits)``."""
    return _closest(bvh, tris, origin, direction, tmax, active, stack_size,
                    with_stats, False)


def traverse_anyhit(bvh: BvhArrays, tris: Triangles, origin, direction,
                    tmax, exclude, active, stack_size: int = BVH_MAX_DEPTH,
                    with_stats: bool = False):
    """Occlusion of every active ray, ignoring its ``exclude`` prim; with
    ``with_stats``, ``(occluded, (node_pair_steps, leaf_visits))``."""
    return _anyhit(bvh, tris, origin, direction, tmax, exclude, active,
                   stack_size, with_stats, False)


def traverse_closest_thread(bvh: BvhArrays, tris: Triangles, origin,
                            direction, tmax, active,
                            stack_size: int = BVH_MAX_DEPTH,
                            with_stats: bool = False):
    """:func:`traverse_closest` through the first design's kernels (one
    thread a ray, counted in ``THREAD_LAUNCHES``); the plain version on the
    CPU."""
    return _closest(bvh, tris, origin, direction, tmax, active, stack_size,
                    with_stats, True)


def traverse_anyhit_thread(bvh: BvhArrays, tris: Triangles, origin,
                           direction, tmax, exclude, active,
                           stack_size: int = BVH_MAX_DEPTH,
                           with_stats: bool = False):
    """:func:`traverse_anyhit` through the first design's kernels."""
    return _anyhit(bvh, tris, origin, direction, tmax, exclude, active,
                   stack_size, with_stats, True)


def _closest(bvh, tris, origin, direction, tmax, active, stack_size,
             with_stats, thread):
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    _check(bvh, tris, o, d, tmax, active)
    n_stack = stack_len_checked(bvh, stack_size)
    if tmax.device.type == "cuda":
        stats = _stats_buffer(tmax.device) if with_stats else None
        *res, nrm = _closest_cuda(bvh, tris, o, d, tmax, active, n_stack,
                                  stats, thread)
        st = () if stats is None else ((stats[0], stats[1]),)
    elif tmax.device.type == "cpu":
        *res, nrm, st = _closest_ref(bvh, tris, o, d, tmax, active, n_stack,
                                     new_work() if with_stats else None)
        st = () if st is None else (st,)
    else:
        raise ValueError(f"unsupported device {tmax.device}")
    return (*res, _out_normal(nrm, as_v3), *st)


def _anyhit(bvh, tris, origin, direction, tmax, exclude, active, stack_size,
            with_stats, thread):
    o, d = _columns(origin), _columns(direction)
    _check(bvh, tris, o, d, tmax, active, exclude)
    n_stack = stack_len_checked(bvh, stack_size)
    if tmax.device.type == "cuda":
        stats = _stats_buffer(tmax.device) if with_stats else None
        occ = _anyhit_cuda(bvh, tris, o, d, tmax, exclude, active, n_stack,
                           stats, thread)
        return (occ, (stats[0], stats[1])) if with_stats else occ
    if tmax.device.type == "cpu":
        occ, st = _anyhit_ref(bvh, tris, o, d, tmax, exclude, active,
                              n_stack, new_work() if with_stats else None)
        return (occ, st) if with_stats else occ
    raise ValueError(f"unsupported device {tmax.device}")


# ------------------------------------------------------ plain versions

def new_work() -> dict:
    """An empty work count for the plain walks' ``work`` argument:
    ``steps`` (node-pair steps), ``leafs`` (leaf visits), ``tri_tests``
    (triangles tested), ``rounds`` (the longest walk's node-pair steps: the
    batched walk's rounds) and the ``pair_seen`` / ``tri_seen`` masks of
    the node pairs and triangles read (made at the first walk)."""
    return {"steps": 0, "leafs": 0, "tri_tests": 0, "rounds": 0,
            "pair_seen": None, "tri_seen": None}


def _pair(work, device):
    """``(node_pair_steps, leaf_visits)`` of a counted walk, as int64 0-d
    tensors on ``device``."""
    return (torch.tensor(work["steps"], dtype=torch.int64, device=device),
            torch.tensor(work["leafs"], dtype=torch.int64, device=device))


class _Walk:
    """Per-ray walk state of the live rays (compacted as rays finish)."""

    _FIELDS = ("ids", "tm", "ex", "cur", "sp", "stack", "t", "u", "v",
               "prim")

    def __init__(self, bvh, o, d, tmax, active, exclude, n_stack):
        ids = torch.nonzero(active).squeeze(1)
        k, dev = ids.shape[0], ids.device
        self.ids = ids
        self.o = [c[ids] for c in o]
        self.d = [c[ids] for c in d]
        self.inv, self.sc, self.neg = ray_slab_precompute(self.d, self.o)
        self.tm = tmax[ids].clone()
        self.ex = None if exclude is None else exclude[ids]
        self.cur = bvh.left_first[0].long().expand(k).clone()
        self.sp = torch.zeros(k, dtype=torch.long, device=dev)
        self.stack = torch.full((k, n_stack), -1, dtype=torch.long,
                                device=dev)
        self.t = torch.full((k,), float("inf"), dtype=torch.float32,
                            device=dev)
        self.u = torch.zeros(k, dtype=torch.float32, device=dev)
        self.v = torch.zeros(k, dtype=torch.float32, device=dev)
        self.prim = torch.full((k,), -1, dtype=torch.int32, device=dev)

    def keep(self, m):
        for f in self._FIELDS:
            x = getattr(self, f)
            if x is not None:
                setattr(self, f, x[m])
        for f in ("o", "d", "inv", "sc", "neg"):
            setattr(self, f, [c[m] for c in getattr(self, f)])


def _rows(a, idx):
    """Rows ``idx`` of an ``[M, 3]`` tensor as a component triple."""
    r = a[idx]
    return (r[:, 0], r[:, 1], r[:, 2])


def _leaf(w, tris, rr, first, count, anyhit, occ, work):
    """Test the triangles ``first + i`` (``i < count``) of one leaf for the
    live rays ``rr``, in leaf order; a closest-hit ray's tmax shrinks on
    each hit, an any-hit ray stops at its first occluding triangle."""
    for i in range(int(count.max())):
        m = i < count
        if anyhit:
            m = m & ~occ[rr]
        sel = rr[m]
        if sel.numel() == 0:
            break
        ti = (first[m] + i).long()
        if work is not None:
            work["tri_tests"] += int(sel.numel())
            work["tri_seen"][ti] = True
        h, tt, uu, vv = intersect_triangle_v3(
            [c[sel] for c in w.o], [c[sel] for c in w.d], w.tm[sel],
            _rows(tris.p0, ti), _rows(tris.e1, ti), _rows(tris.e2, ti),
            _rows(tris.n, ti))
        if anyhit:
            occ[sel] = h & (ti != w.ex[sel])
            continue
        s = sel[h]
        w.tm[s] = tt[h]
        w.t[s] = tt[h]
        w.u[s] = uu[h]
        w.v[s] = vv[h]
        w.prim[s] = ti[h].to(torch.int32)


def _walk(bvh, tris, o, d, tmax, active, n_stack, exclude, work, finish):
    """The batched masked walk of both plain versions.  Each loop step
    runs one node-pair step of every live ray; rays that end are handed
    to ``finish(w, m)`` (``m`` the mask of the ending rays) and dropped.
    ``exclude`` None: closest hit, else any hit."""
    anyhit = exclude is not None
    w = _Walk(bvh, o, d, tmax, active, exclude, n_stack)
    lf, npr = bvh.left_first, bvh.num_prims
    if work is not None and work["pair_seen"] is None:
        work["pair_seen"] = torch.zeros(bvh.num_nodes, dtype=torch.bool,
                                        device=tmax.device)
        work["tri_seen"] = torch.zeros(tris.num, dtype=torch.bool,
                                       device=tmax.device)
    while w.cur.shape[0]:
        k = w.cur.shape[0]
        left, right = w.cur, w.cur + 1
        ok_l, e_l = intersect_aabb(w.inv, w.sc, w.neg, _rows(bvh.bmin, left),
                                   _rows(bvh.bmax, left))
        ok_r, e_r = intersect_aabb(w.inv, w.sc, w.neg,
                                   _rows(bvh.bmin, right),
                                   _rows(bvh.bmax, right))
        np_l, np_r = npr[left], npr[right]
        leaf_l, leaf_r = np_l > 0, np_r > 0
        if work is not None:
            work["steps"] += k
            work["rounds"] += 1
            work["leafs"] += int((ok_l & leaf_l).sum()) + \
                int((ok_r & leaf_r).sum())
            work["pair_seen"][left] = True
        c_l, c_r = lf[left], lf[right]
        occ = torch.zeros(k, dtype=torch.bool, device=tmax.device) \
            if anyhit else None
        for hit_leaf, first, cnt in ((ok_l & leaf_l, c_l, np_l),
                                     (ok_r & leaf_r, c_r, np_r)):
            rr = torch.nonzero(hit_leaf & ~occ if anyhit else hit_leaf
                               ).squeeze(1)
            if rr.numel():
                _leaf(w, tris, rr, first[rr], cnt[rr], anyhit, occ, work)

        live_l, live_r = ok_l & ~leaf_l, ok_r & ~leaf_r
        both = live_l & live_r
        pop = ~live_l & ~live_r
        end = pop & (w.sp == 0)
        if anyhit:
            both = both & ~occ
            end = end | occ
        l_far = e_l > e_r
        nxt = torch.where(both, torch.where(l_far, c_r, c_l),
                          torch.where(live_l, c_l, c_r)).long()
        pb = torch.nonzero(both).squeeze(1)
        if pb.numel():
            if bool((w.sp[pb] >= n_stack).any()):
                raise RuntimeError(f"a push found its {n_stack}-entry stack "
                                   "full: the tree is deeper than "
                                   "bvh.max_depth says")
            w.stack[pb, w.sp[pb]] = torch.where(l_far, c_l, c_r)[pb].long()
            w.sp[pb] += 1
        popping = torch.nonzero(pop & ~end).squeeze(1)
        if popping.numel():
            w.sp[popping] -= 1
            nxt[popping] = w.stack[popping, w.sp[popping]]
        w.cur = nxt
        if bool(end.any()):
            finish(w, end, occ)
            w.keep(~end)


def _closest_ref(bvh, tris, o, d, tmax, active, n_stack, work=None):
    """Plain version of the closest-hit kernel on columns ``o`` / ``d``:
    ``(hit, t, u, v, prim, normal columns, counts or None)``."""
    REF_CALLS["closest"] += 1
    n, dev = tmax.shape[0], tmax.device
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def finish(w, m, _):
        g = w.ids[m]
        t[g], u[g], v[g], prim[g] = w.t[m], w.u[m], w.v[m], w.prim[m]

    _walk(bvh, tris, o, d, tmax, active, n_stack, None, work, finish)
    hit = prim >= 0
    nrm = torch.where(hit[:, None], tris.n[prim.clamp(min=0).long()], 0.0)
    st = None if work is None else _pair(work, dev)
    return hit, t, u, v, prim, (nrm[:, 0], nrm[:, 1], nrm[:, 2]), st


def _anyhit_ref(bvh, tris, o, d, tmax, exclude, active, n_stack, work=None):
    """Plain version of the any-hit kernel: ``(occluded, counts or
    None)``."""
    REF_CALLS["anyhit"] += 1
    occ_out = torch.zeros(tmax.shape[0], dtype=torch.bool,
                          device=tmax.device)

    def finish(w, m, occ):
        occ_out[w.ids[m & occ]] = True

    _walk(bvh, tris, o, d, tmax, active, n_stack, exclude, work, finish)
    return occ_out, None if work is None else _pair(work, tmax.device)


def traverse_closest_ref(bvh: BvhArrays, tris: Triangles, origin, direction,
                         tmax, active, stack_size: int = BVH_MAX_DEPTH,
                         with_stats: bool = False, work=None):
    """Plain PyTorch version of :func:`traverse_closest` (same contract,
    same visit order, any device); ``work`` (:func:`new_work`), when
    given, counts the walk's work."""
    as_v3 = isinstance(origin, (tuple, list))
    if with_stats and work is None:
        work = new_work()
    *res, nrm, st = _closest_ref(bvh, tris, _columns(origin),
                                 _columns(direction), tmax, active,
                                 stack_len_checked(bvh, stack_size), work)
    out = (*res, _out_normal(nrm, as_v3))
    return out + ((st,) if with_stats else ())


def traverse_anyhit_ref(bvh: BvhArrays, tris: Triangles, origin, direction,
                        tmax, exclude, active, stack_size: int = BVH_MAX_DEPTH,
                        with_stats: bool = False, work=None):
    """Plain PyTorch version of :func:`traverse_anyhit`; ``work`` as in
    :func:`traverse_closest_ref`."""
    if with_stats and work is None:
        work = new_work()
    occ, st = _anyhit_ref(bvh, tris, _columns(origin), _columns(direction),
                          tmax, exclude, active,
                          stack_len_checked(bvh, stack_size), work)
    return (occ, st) if with_stats else occ
