"""Packet closest-hit and any-hit BVH traversal over the wide tables: the
wrappers of the hand-written CUDA group-walk kernels and their plain
PyTorch version.

``wide_traverse_closest`` / ``wide_traverse_anyhit`` replace
rtjax/kernels/pallas_wide.py's functions of the same names (the Pallas
kernels ``_make_closest_kernel`` and ``_make_anyhit_kernel``); the lane
wrappers (kernels/lane.py) run the same walk with smaller groups.  A CUDA
tensor goes to the kernel in ``csrc/packet_traverse.cu`` (built at first
use, bound with ctypes); a CPU tensor goes to the plain version.  There is
no fallback between them.

Contract: persist.py's (rtjax's), at any tree depth: the group's stack is
sized from ``tables.depth``.

The group walk (``csrc/group_walk.cuh`` walks the same order): rays go in
groups of ``group`` consecutive rays, the last one partial, and one cursor
walks the tree for the whole group.  At a node every live ray slab-tests
every non-empty child against its own tmax and Moeller-Trumbore-tests the
leaf children its own slab accepted, in ascending slot order (persist.py's
per-ray rule, so the hits are the persistent walkers' hits; only the prim
at an equal-t tie may differ).  The internal children that any live ray
accepted form the group's mask; the cursor descends into the mask's first
child in the node's build-time axis order, reversed when the group's octant
points down that axis, and pushes the rest as one (node, remaining-mask)
entry; it pops when the mask is empty.  The octant is an integer vote: bit
k is set when more than half of the group's active rays point down axis k.
Any hit: an occluded ray stops, and the group stops when none of its rays is
live.  A group without an active ray walks nothing.

rtjax's packet kernel decides its tile's octant by the sign of a float sum
of directions, which two implementations round differently, and its leaf
drain tests every ray of the tile against a queued leaf, not only the rays
whose slab accepted the leaf's box: a ray may find a triangle there that
its own slab test would have skipped.  Neither is carried over.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..accel.wide import WideTables
from . import _build
from .persist import (BIG, _columns, _out_normal, _pick, _raise_on,
                      _table_ptrs, anyhit_leaf, check_rays, closest_leaf,
                      slab, slab_pre)

PACKET = 256  # rays per packet: one CTA (csrc/packet_traverse.cu kPacket)

# kernel launches (wrapper, CUDA path), by kernel
LAUNCHES = {"closest": 0, "anyhit": 0}
# plain group-walk calls by kind, at any group size (the lane wrappers' too)
REF_CALLS = {"closest": 0, "anyhit": 0}

_lock = threading.Lock()
_lib = None


# ------------------------------------------------------------- CUDA path

def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.packet_library()))
            P, I = ctypes.c_void_p, ctypes.c_int
            for name in ("packet", "lane"):
                closest = getattr(lib, f"rtjax_{name}_closest")
                closest.argtypes = [I, I, I] + [P] * 12 + [I] + [P] * 7
                closest.restype = I
                anyhit = getattr(lib, f"rtjax_{name}_anyhit")
                anyhit.argtypes = [I, I, I] + [P] * 13 + [I] + [P] * 2
                anyhit.restype = I
            _lib = lib
        return _lib


def _closest_cuda(name, group, tables, o, d, tmax, active):
    n = tmax.shape[0]
    dev = tmax.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_kernels(), f"rtjax_{name}_closest")(
        tables.width, group, tables.depth + 1, *_table_ptrs(tables),
        *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), n,
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(),
        *(c.data_ptr() for c in nrm), stream)
    _raise_on(rc, f"{name} closest-hit")
    return hit, t, prim, nrm


def _anyhit_cuda(name, group, tables, o, d, tmax, exclude, active):
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmax.device)
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    rc = getattr(_kernels(), f"rtjax_{name}_anyhit")(
        tables.width, group, tables.depth + 1, *_table_ptrs(tables),
        *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), exclude.data_ptr(), n,
        occ.data_ptr(), stream)
    _raise_on(rc, f"{name} any-hit")
    return occ


def group_closest(name, group, launches, tables: WideTables, origin,
                  direction, tmax, active):
    """Closest hit by ``group``-ray group walks: the kernels ``name``
    ("packet" or "lane") for CUDA tensors, counted in ``launches``, the
    plain version for CPU tensors."""
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    check_rays(tables, o, d, tmax, active)
    if tmax.device.type == "cuda":
        hit, t, prim, nrm = _closest_cuda(name, group, tables, o, d, tmax,
                                          active)
        launches["closest"] += 1
    elif tmax.device.type == "cpu":
        hit, t, prim, nrm = group_traverse_closest_ref(tables, o, d, tmax,
                                                       active, group)
    else:
        raise ValueError(f"unsupported device {tmax.device}")
    return hit, t, prim, _out_normal(nrm, as_v3)


def group_anyhit(name, group, launches, tables: WideTables, origin,
                 direction, tmax, exclude, active):
    """Occlusion by ``group``-ray group walks (see :func:`group_closest`)."""
    o, d = _columns(origin), _columns(direction)
    check_rays(tables, o, d, tmax, active, exclude)
    if tmax.device.type == "cuda":
        occ = _anyhit_cuda(name, group, tables, o, d, tmax, exclude, active)
        launches["anyhit"] += 1
        return occ
    if tmax.device.type == "cpu":
        return group_traverse_anyhit_ref(tables, o, d, tmax, exclude, active,
                                         group)
    raise ValueError(f"unsupported device {tmax.device}")


def wide_traverse_closest(tables: WideTables, origin, direction, tmax,
                          active):
    """Closest hit of every active ray by packets: ``(hit, t, prim,
    normal)``."""
    return group_closest("packet", PACKET, LAUNCHES, tables, origin,
                         direction, tmax, active)


def wide_traverse_anyhit(tables: WideTables, origin, direction, tmax,
                         exclude, active):
    """Occlusion of every active ray by packets, ignoring its ``exclude``
    prim."""
    return group_anyhit("packet", PACKET, LAUNCHES, tables, origin,
                        direction, tmax, exclude, active)


# ------------------------------------------------------- plain version

class _Groups:
    """Walk state of the live groups: per ray (flat, ``group`` rays per
    group, compacted by whole groups as groups finish) and per group (the
    cursor, the stack and the octant)."""

    _RAY = ("ids", "live", "tm", "ex")
    _RAY3 = ("o", "d", "inv", "sc")
    _GROUP = ("cur", "sp", "stn", "stm", "octv")

    def __init__(self, tables, o, d, tmax, active, exclude, group):
        n = tmax.shape[0]
        dev = tmax.device
        ng = -(-n // group)
        pad = ng * group - n

        def grid(x, fill):
            return torch.cat([x, x.new_full((pad,), fill)]) if pad else x

        self.group = group
        self.ids = grid(torch.arange(n, device=dev), 0)
        self.live = grid(active, False)
        self.o = [grid(c, 0.0) for c in o]
        self.d = [grid(c, 1.0) for c in d]
        self.inv, self.sc = slab_pre(self.o, self.d)
        self.tm = grid(tmax, 0.0).clone()
        self.ex = None if exclude is None else grid(exclude, -1)
        act = self.live.view(ng, group)
        count = act.sum(1)
        self.octv = sum(((2 * ((c.view(ng, group) < 0) & act).sum(1)
                          > count).long() << k) for k, c in enumerate(self.d))
        depth = tables.depth + 1
        self.cur = torch.zeros(ng, dtype=torch.long, device=dev)
        self.sp = torch.zeros(ng, dtype=torch.long, device=dev)
        self.stn = torch.zeros(ng, depth, dtype=torch.long, device=dev)
        self.stm = torch.zeros(ng, depth, dtype=torch.long, device=dev)
        self.keep(count > 0)

    def keep(self, m):
        rays = m.repeat_interleave(self.group)
        for f in self._RAY:
            v = getattr(self, f)
            if v is not None:
                setattr(self, f, v[rays])
        for f in self._RAY3:
            setattr(self, f, [c[rays] for c in getattr(self, f)])
        for f in self._GROUP:
            setattr(self, f, getattr(self, f)[m])


def _group_walk(tables: WideTables, o, d, tmax, active, group, on_leaf,
                exclude=None):
    """The batched group walk of the plain version.  Each step pops the
    groups whose cursor is empty, drops the finished groups, and visits one
    node per remaining group with all of its rays.  ``on_leaf(w, rr,
    rows)`` is persist.py's: it tests leaf rows for the rays ``rr`` (flat
    indices) and returns a [R] bool of rays that are finished (any-hit
    occlusion)."""
    width = tables.width
    nb, lt, ni = tables.node_bounds, tables.leaf_tris, tables.node_info
    cm = tables.child_meta.view(-1, width)
    lane = torch.arange(width, device=tmax.device)
    w = _Groups(tables, o, d, tmax, active, exclude, group)
    while True:
        r = torch.nonzero((w.cur < 0) & (w.sp > 0)).squeeze(1)
        if r.numel():
            top = w.sp[r] - 1
            pnode, pm = w.stn[r, top], w.stm[r, top]
            m, rev = pm >> 1, pm & 1
            first = _pick(m, rev, lane)
            rest = m & ~(1 << first)
            w.stm[r, top] = (rest << 1) | rev
            w.sp[r] = torch.where(rest == 0, top, w.sp[r])
            w.cur[r] = (cm[pnode, first] >> 4).long()
        walking = w.cur >= 0
        if not bool(walking.all()):
            w.keep(walking)
        k = w.cur.shape[0]
        if k == 0:
            return

        rows = nb[w.cur]
        meta = cm[w.cur].long()
        info = ni[w.cur].long()
        lm = info & ((1 << width) - 1)
        axis = (info >> width) & 3
        lbit = ((lm[:, None] >> lane) & 1) == 1
        b = rows[:, :6 * width].reshape(k, 1, width, 6)
        entry, exit_ = slab(b, [c.view(k, group, 1) for c in w.inv],
                            [c.view(k, group, 1) for c in w.sc])
        # persist.py's accept rule, for the live rays only
        hitc = (torch.clamp(entry, min=0.0)
                <= torch.minimum(exit_, w.tm.view(k, group, 1))) \
            & ~(lbit & ((meta & 15) == 0))[:, None] \
            & w.live.view(k, group, 1)
        hitc = hitc.view(k * group, width)
        lbit_r = lbit.repeat_interleave(group, 0)

        leafhit = hitc & lbit_r
        done = torch.zeros(k * group, dtype=torch.bool, device=tmax.device)
        for c in torch.nonzero(leafhit.any(0)).squeeze(1).tolist():
            rr = torch.nonzero(leafhit[:, c] & ~done).squeeze(1)
            if rr.numel() == 0:
                continue
            done[rr] = on_leaf(w, rr, lt[meta[rr // group, c] >> 4])
        w.live &= ~done

        inner = (((hitc & ~lbit_r & ~done[:, None]).view(k, group, width)
                  .any(1).long()) << lane).sum(1)
        has = inner != 0
        rev = (w.octv >> axis) & 1
        first = _pick(inner, rev, lane)
        rest = inner & ~(1 << first)
        rp = torch.nonzero(has & (rest != 0)).squeeze(1)
        if rp.numel():
            spp = w.sp[rp]
            w.stn[rp, spp] = w.cur[rp]
            w.stm[rp, spp] = (rest[rp] << 1) | rev[rp]
            w.sp[rp] = spp + 1
        nxt = meta.gather(1, first[:, None]).squeeze(1) >> 4
        w.cur = torch.where(has, nxt, -1)
        # a group none of whose rays is live stops (any-hit occlusion)
        w.sp = torch.where(w.live.view(k, group).any(1), w.sp, 0)


def group_traverse_closest_ref(tables: WideTables, origin, direction, tmax,
                               active, group):
    """Plain PyTorch version of the group-walk closest hit (the packet
    kernel at ``group`` = PACKET, the lane kernel at lane.LANE): same
    contract, same visit order, any device."""
    REF_CALLS["closest"] += 1
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    n = tmax.shape[0]
    dev = tmax.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    _group_walk(tables, o, d, tmax, active, group,
                closest_leaf(best_t, best_p, best_n))
    hit = best_p >= 0
    nrm = (best_n[:, 0], best_n[:, 1], best_n[:, 2])
    return hit, best_t, best_p, _out_normal(nrm, as_v3)


def group_traverse_anyhit_ref(tables: WideTables, origin, direction, tmax,
                              exclude, active, group):
    """Plain PyTorch version of the group-walk any hit."""
    REF_CALLS["anyhit"] += 1
    o, d = _columns(origin), _columns(direction)
    occ = torch.zeros(tmax.shape[0], dtype=torch.bool, device=tmax.device)
    _group_walk(tables, o, d, tmax, active, group, anyhit_leaf(occ),
                exclude)
    return occ
