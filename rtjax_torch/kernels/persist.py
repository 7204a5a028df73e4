"""Closest-hit and any-hit BVH traversal over the wide tables: the wrappers
of the hand-written CUDA persistent-walker kernels and their plain PyTorch
versions.

``persist_traverse_closest`` / ``persist_traverse_anyhit`` replace
rtjax/kernels/pallas_lane_persist.py's functions of the same names (the
Pallas kernels ``_make_persist_closest_kernel`` and
``_make_persist_anyhit_kernel``).  A CUDA tensor goes to the kernel in
``csrc/persist_traverse.cu`` (built at first use, bound with ctypes); a CPU
tensor goes to the plain version.  There is no fallback between them.

The kernels draw rays from a work counter: two words per device and
stream (:func:`work_buffer`), zeroed once and left zeroed by every launch.
Their stack holds ``tables.depth + 1`` entries per ray in shared memory
(:func:`stack_len`).  ``persist_traverse_*_stride`` launch the first
design of the same kernels (a fixed share of the rays per thread, a
64-entry local-memory stack); they exist only to time both designs in one
run (``chip_smoke.py``, the card tests), and no engine path calls them.

The plain walk counts its work when given a ``work`` dict
(:func:`new_work`): node visits, non-empty child slab tests, leaf rows and
triangle slots tested, and which node and leaf rows it read.  The count is
what a kernel's bound is computed from; it leaves the results as they are.

Contract (rtjax's): rays are component triples (or ``[N, 3]``) of float32
origin and direction, ``tmax [N] f32``, ``active [N] bool`` and, for any-hit,
``exclude [N] i32`` (a leaf-order prim id that never occludes).  Closest hit
returns ``hit [N] bool``, ``t [N] f32`` (BIG on a miss or an inactive lane),
leaf-order ``prim [N] i32`` (-1 on a miss or an inactive lane) and the
unnormalised normal ``cross(e1, e2)`` (zero on a miss or an inactive lane)
in the input's layout; any-hit returns ``occluded [N] bool``.

Both versions walk each ray with the same visit order: at a node, slab-test
every non-empty child against the current tmax; Moeller-Trumbore-test the
hit leaf children in ascending slot order (all 8 slots of a leaf row
against the row's entry tmax, the closest strictly-smaller hit wins, then
tmax shrinks to it); descend into the first hit internal child in the
node's build-time axis order (reversed when the ray points down that axis)
and push the rest as one (node, remaining-mask) stack entry; pop when
nothing was hit.  Any order is exact, because tmax prunes; one shared order
makes kernel and plain version agree bit for bit, ties included.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..accel.wide import MAX_LEAF, PID_BASE, WideTables
from . import _build

STACK = 64                 # the kernels' per-ray stack depth (entries)
BIG = 3.4e38               # t of a miss / an inactive lane
_EPS = 2.0 ** -23          # float32 machine epsilon (slab direction clamp)

# kernel launches (wrapper, CUDA path) and plain-version calls, by kernel
LAUNCHES = {"closest": 0, "anyhit": 0}
REF_CALLS = {"closest": 0, "anyhit": 0}
# launches of the first design (the ``_stride`` wrappers), by kernel
STRIDE_LAUNCHES = {"closest": 0, "anyhit": 0}
WORK_WORDS = 2             # the work counter: next ray, blocks finished
_work: dict = {}           # (device, stream) -> the counter

_lock = threading.Lock()
_lib = None


def _columns(v):
    """Component triple or ``[N, 3]`` tensor -> three ``[N]`` columns."""
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return tuple(c.contiguous() for c in v.unbind(-1))


def _check(tables: WideTables, o, d, tmax, active, exclude=None):
    if tables.depth + 1 > STACK:
        raise ValueError(
            f"BVH depth {tables.depth} needs {tables.depth + 1} stack "
            f"entries; the persistent walkers hold {STACK} (the engine sends "
            "deeper trees to the packet kernel, kernels/wide.py)")
    check_rays(tables, o, d, tmax, active, exclude)


def check_rays(tables: WideTables, o, d, tmax, active, exclude=None):
    """Raise on rays the kernels do not take: device, dtype, shape and
    contiguity of every column, and the table width."""
    dev = tables.node_bounds.device
    n = tmax.shape[0] if tmax.dim() == 1 else -1
    cols = [("origin", c, torch.float32) for c in o] + \
        [("direction", c, torch.float32) for c in d] + \
        [("tmax", tmax, torch.float32), ("active", active, torch.bool)]
    if exclude is not None:
        cols.append(("exclude", exclude, torch.int32))
    for name, c, dt in cols:
        if c.device != dev:
            raise ValueError(f"{name} is on {c.device}, the tables on {dev}")
        if c.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"{name} must have shape [{n}], got "
                             f"{tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tables.width not in (8, 16):
        raise ValueError(f"table width must be 8 or 16, got {tables.width}")


def _out_normal(nrm, as_v3):
    return nrm if as_v3 else torch.stack(nrm, dim=-1)


# ------------------------------------------------------------- CUDA path

def bind(lib):
    """Set the argument types of the four entry points of a persist
    kernel library (``ctypes.CDLL``) and return it."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rtjax_persist_closest.argtypes = \
        [I, P, P, P, P] + [P] * 8 + [I] + [P] * 6 + [P, I, P]
    lib.rtjax_persist_anyhit.argtypes = \
        [I, P, P, P, P] + [P] * 9 + [I] + [P] + [P, I, P]
    lib.rtjax_persist_closest_stride.argtypes = \
        [I, P, P, P, P] + [P] * 8 + [I] + [P] * 6 + [P]
    lib.rtjax_persist_anyhit_stride.argtypes = \
        [I, P, P, P, P] + [P] * 9 + [I] + [P] + [P]
    for name in ("closest", "anyhit", "closest_stride", "anyhit_stride"):
        getattr(lib, f"rtjax_persist_{name}").restype = I
    return lib


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.persist_library())))
        return _lib


def stack_len(tables: WideTables) -> int:
    """Stack entries per ray of the kernels: one per level of the binary
    build plus the root's, as the plain walk holds."""
    return tables.depth + 1


def work_buffer(device, stream: int) -> torch.Tensor:
    """The kernels' work counter on ``device`` for launches on ``stream``:
    ``WORK_WORDS`` int32 zeros, made once and reused, so two streams never
    share one.

    Invariant: the counter is zero between launches.  A launch that runs
    to its end leaves it so (its last block resets it); a launch that the
    wrapper sees fail is followed by a reset (:func:`_launch`).  A launch
    that fails later, on the card, leaves the context in a sticky error,
    so no later launch on it returns results."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), stream)
    with _lock:
        buf = _work.get(key)
        if buf is None:
            buf = _work[key] = torch.zeros(WORK_WORDS, dtype=torch.int32,
                                           device=device)
    return buf


def _table_ptrs(tables: WideTables):
    return (tables.node_bounds.data_ptr(), tables.child_meta.data_ptr(),
            tables.node_info.data_ptr(), tables.leaf_tris.data_ptr())


def _check_aligned(tables: WideTables):
    """The kernels read node rows, metas and leaf rows in 16-byte words."""
    for name in ("node_bounds", "child_meta", "leaf_tris"):
        if getattr(tables, name).data_ptr() % 16:
            raise ValueError(f"tables.{name} must be 16-byte aligned")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch(entry, args, name: str, work=None):
    """Call the entry point ``entry`` with ``args``; raise on a CUDA error
    code, first zeroing the work counter ``work`` (a launch that was
    refused, or stopped before its last block, may have left it drawn)."""
    rc = entry(*args)
    if rc != 0 and work is not None:
        work.zero_()
    _raise_on(rc, name)


def _launch_args(tables, stream, stride):
    """``(trailing arguments of an entry point, work counter or None)``:
    the work counter and the stack length, then the stream (the stride
    design takes the stream alone)."""
    if stride:
        return (stream,), None
    _check_aligned(tables)
    work = work_buffer(tables.node_bounds.device, stream)
    return (work.data_ptr(), stack_len(tables), stream), work


def _closest_cuda(tables, o, d, tmax, active, stride):
    n = tmax.shape[0]
    dev = tmax.device
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = "rtjax_persist_closest" + ("_stride" if stride else "")
    tail, work = _launch_args(tables, stream, stride)
    _launch(getattr(_kernels(), entry), (
        tables.width, *_table_ptrs(tables),
        *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), n,
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(),
        *(c.data_ptr() for c in nrm), *tail), "persist closest-hit", work)
    (STRIDE_LAUNCHES if stride else LAUNCHES)["closest"] += 1
    return hit, t, prim, nrm


def _anyhit_cuda(tables, o, d, tmax, exclude, active, stride):
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmax.device)
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    entry = "rtjax_persist_anyhit" + ("_stride" if stride else "")
    tail, work = _launch_args(tables, stream, stride)
    _launch(getattr(_kernels(), entry), (
        tables.width, *_table_ptrs(tables),
        *(c.data_ptr() for c in o), *(c.data_ptr() for c in d),
        tmax.data_ptr(), active.data_ptr(), exclude.data_ptr(), n,
        occ.data_ptr(), *tail), "persist any-hit", work)
    (STRIDE_LAUNCHES if stride else LAUNCHES)["anyhit"] += 1
    return occ


def _closest(tables: WideTables, origin, direction, tmax, active, stride):
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    _check(tables, o, d, tmax, active)
    if tmax.device.type == "cuda":
        hit, t, prim, nrm = _closest_cuda(tables, o, d, tmax, active, stride)
    elif tmax.device.type == "cpu":
        hit, t, prim, nrm = persist_traverse_closest_ref(tables, o, d, tmax,
                                                         active)
    else:
        raise ValueError(f"unsupported device {tmax.device}")
    return hit, t, prim, _out_normal(nrm, as_v3)


def _anyhit(tables: WideTables, origin, direction, tmax, exclude, active,
            stride):
    o, d = _columns(origin), _columns(direction)
    _check(tables, o, d, tmax, active, exclude)
    if tmax.device.type == "cuda":
        return _anyhit_cuda(tables, o, d, tmax, exclude, active, stride)
    if tmax.device.type == "cpu":
        return persist_traverse_anyhit_ref(tables, o, d, tmax, exclude,
                                           active)
    raise ValueError(f"unsupported device {tmax.device}")


def persist_traverse_closest(tables: WideTables, origin, direction, tmax,
                             active):
    """Closest hit of every active ray: ``(hit, t, prim, normal)``."""
    return _closest(tables, origin, direction, tmax, active, False)


def persist_traverse_anyhit(tables: WideTables, origin, direction, tmax,
                            exclude, active):
    """Occlusion of every active ray, ignoring its ``exclude`` prim."""
    return _anyhit(tables, origin, direction, tmax, exclude, active, False)


def persist_traverse_closest_stride(tables: WideTables, origin, direction,
                                    tmax, active):
    """:func:`persist_traverse_closest` by the first design (for timing
    both designs in one run; counted in ``STRIDE_LAUNCHES``)."""
    return _closest(tables, origin, direction, tmax, active, True)


def persist_traverse_anyhit_stride(tables: WideTables, origin, direction,
                                   tmax, exclude, active):
    """:func:`persist_traverse_anyhit` by the first design."""
    return _anyhit(tables, origin, direction, tmax, exclude, active, True)


# ------------------------------------------------------ plain versions

def _pick(mask, rev, lane):
    """Next child slot: the lowest set bit of ``mask``, or the highest when
    ``rev`` (``lane`` = arange(width); 0 for an empty mask)."""
    bits = ((mask[:, None] >> lane) & 1).to(torch.int32)
    low = torch.argmax(bits, dim=1)                      # first set bit
    high = lane.shape[0] - 1 - torch.argmax(bits.flip(1), dim=1)
    return torch.where(rev != 0, high, low)


def slab_pre(o, d):
    """Per-ray slab precompute: the epsilon-clamped ``1 / d`` and
    ``-o / d`` (as ``-o * (1 / d)``), component lists."""
    safe = [torch.where(torch.abs(c) < _EPS,
                        torch.copysign(torch.full_like(c, _EPS), c), c)
            for c in d]
    inv = [1.0 / c for c in safe]
    return inv, [-oc * ic for oc, ic in zip(o, inv)]


def slab(b, inv, sc):
    """Slab entry and exit of rays against boxes ``b [..., 6]`` (lo, hi),
    broadcast against the ray columns ``inv`` / ``sc``, in the kernels'
    operation order."""
    e = [b[..., j] * inv[j] + sc[j] for j in range(3)]
    x = [b[..., 3 + j] * inv[j] + sc[j] for j in range(3)]
    entry = torch.maximum(torch.maximum(torch.minimum(e[0], x[0]),
                                        torch.minimum(e[1], x[1])),
                          torch.minimum(e[2], x[2]))
    exit_ = torch.minimum(torch.minimum(torch.maximum(e[0], x[0]),
                                        torch.maximum(e[1], x[1])),
                          torch.maximum(e[2], x[2]))
    return entry, exit_


def _mt8(rows, o, d):
    """All 8 slots of each ray's leaf row: ``(u, v, t, tri)`` as [R, 8]
    tensors (tri is the [R, 8, 12] slot view), in the kernels' operation
    order."""
    r = rows.shape[0]
    tri = rows[:, :12 * MAX_LEAF].reshape(r, MAX_LEAF, 12)
    p0x, p0y, p0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    nx, ny, nz = tri[..., 9], tri[..., 10], tri[..., 11]
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)
    cx = p0x - ox
    cy = p0y - oy
    cz = p0z - oz
    rx = dy * cz - dz * cy
    ry = dz * cx - dx * cz
    rz = dx * cy - dy * cx
    inv_det = 1.0 / (dx * nx + dy * ny + dz * nz)
    u = inv_det * (e2x * rx + e2y * ry + e2z * rz)
    v = inv_det * (e1x * rx + e1y * ry + e1z * rz)
    t = inv_det * (cx * nx + cy * ny + cz * nz)
    return u, v, t, tri


def new_work() -> dict:
    """An empty work count for the plain walks' ``work`` argument: node
    visits (one per live ray and node), non-empty child slab tests, leaf
    rows tested, triangle slots tested (a leaf row's real slots; an any-hit
    row up to its first occluding slot, where the kernels stop), and the
    ``node_seen`` / ``leaf_seen`` masks of the table rows read (made at
    the first walk).  The two-level walks add ``inst_tests`` (instance box
    slab tests) and ``inst_visits`` (rays moved into an instance)."""
    return {"node_visits": 0, "slab_tests": 0, "leaf_rows": 0,
            "tri_slots": 0, "node_seen": None, "leaf_seen": None}


def count_visits(work, tables: WideTables, cur, nonempty):
    """Add one step of node visits to ``work``: ``cur [K]`` the visited
    nodes, ``nonempty [K, width]`` the slots each visit slab-tests."""
    if work["node_seen"] is None:
        work["node_seen"] = torch.zeros(tables.num_wide_nodes,
                                        dtype=torch.bool, device=cur.device)
        work["leaf_seen"] = torch.zeros(tables.num_leaf_rows,
                                        dtype=torch.bool, device=cur.device)
    work["node_visits"] += int(nonempty.shape[0])
    work["slab_tests"] += int(nonempty.sum())
    work["node_seen"][cur] = True


def count_leaves(work, leaf_rows):
    """Add leaf-row tests (``leaf_rows [R]`` row indices) to ``work``."""
    work["leaf_rows"] += int(leaf_rows.shape[0])
    work["leaf_seen"][leaf_rows] = True


def work_table_bytes(work, tables: WideTables) -> int:
    """Bytes of the tables that the counted walks need, each read once: of
    every node visited, its ``width`` child boxes (6 floats each), its
    ``width`` metas and its info word; of every leaf row tested, its real
    triangles (12 floats and the prim id each).  The rows' padding is not
    counted."""
    if work["node_seen"] is None:
        return 0
    nodes = int(work["node_seen"].sum())
    tris = int(_real_slots(tables.leaf_tris[work["leaf_seen"]]).sum())
    return nodes * 4 * (7 * tables.width + 1) + tris * 4 * 13


class _Walk:
    """Per-ray walk state of the live rays (compacted as rays finish)."""

    def __init__(self, tables, o, d, tmax, active, exclude, root,
                 work=None):
        ids = torch.nonzero(active).squeeze(1)
        self.work = work
        self.ids = ids
        self.o = [c[ids] for c in o]
        self.d = [c[ids] for c in d]
        self.inv, self.sc = slab_pre(self.o, self.d)
        self.octv = ((self.d[0] < 0).long() | ((self.d[1] < 0).long() << 1)
                     | ((self.d[2] < 0).long() << 2))
        self.tm = tmax[ids].clone()
        self.ex = None if exclude is None else exclude[ids]
        k = ids.shape[0]
        depth = tables.depth + 1
        self.cur = torch.zeros(k, dtype=torch.long, device=ids.device) \
            if root is None else root[ids].long()
        self.sp = torch.zeros(k, dtype=torch.long, device=ids.device)
        self.stn = torch.zeros(k, depth, dtype=torch.long, device=ids.device)
        self.stm = torch.zeros(k, depth, dtype=torch.long, device=ids.device)

    _FIELDS = ("ids", "octv", "tm", "ex", "cur", "sp", "stn", "stm")

    def keep(self, m):
        for f in self._FIELDS:
            v = getattr(self, f)
            if v is not None:
                setattr(self, f, v[m])
        for f in ("o", "d", "inv", "sc"):
            setattr(self, f, [c[m] for c in getattr(self, f)])


def _walk(tables: WideTables, o, d, tmax, active, on_leaf, exclude=None,
          root=None, work=None):
    """The batched masked walk shared by the plain versions.  Each step
    pops the rays whose cursor is empty, drops the finished rays, and
    visits one node per remaining ray.  ``on_leaf(w, rr, rows)`` tests leaf
    rows for the live rays ``rr`` and returns a [R] bool of rays that are
    finished (any-hit occlusion).  Each ray starts at node 0, or at its
    ``root [N]`` entry (a BLAS root in concatenated two-level tables).
    ``work`` (:func:`new_work`), when given, counts the walk's work."""
    width = tables.width
    nb, lt, ni = tables.node_bounds, tables.leaf_tris, tables.node_info
    cm = tables.child_meta.view(-1, width)
    lane = torch.arange(width, device=tmax.device)
    w = _Walk(tables, o, d, tmax, active, exclude, root, work)
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
        live = w.cur >= 0
        if not bool(live.all()):
            w.keep(live)
        k = w.cur.shape[0]
        if k == 0:
            return

        rows = nb[w.cur]
        meta = cm[w.cur].long()
        info = ni[w.cur].long()
        lm = info & ((1 << width) - 1)
        axis = (info >> width) & 3
        lbit = ((lm[:, None] >> lane) & 1) == 1
        b = rows[:, :6 * width].reshape(k, width, 6)
        entry, exit_ = slab(b, [c[:, None] for c in w.inv],
                            [c[:, None] for c in w.sc])
        # the fused accept rule of rtjax's _slab: max(entry, 0) <=
        # min(exit, tmax); empty slots (leaf bit, count 0) never hit
        nonempty = ~(lbit & ((meta & 15) == 0))
        hitc = (torch.clamp(entry, min=0.0)
                <= torch.minimum(exit_, w.tm[:, None])) & nonempty
        if work is not None:
            count_visits(work, tables, w.cur, nonempty)

        leafhit = hitc & lbit
        done = torch.zeros(k, dtype=torch.bool, device=tmax.device)
        for c in range(width):
            rr = torch.nonzero(leafhit[:, c] & ~done).squeeze(1)
            if rr.numel() == 0:
                continue
            if work is not None:
                count_leaves(work, meta[rr, c] >> 4)
            done[rr] = on_leaf(w, rr, lt[meta[rr, c] >> 4])

        inner = ((hitc & ~lbit).long() << lane).sum(1)
        has = (inner != 0) & ~done
        rev = (w.octv >> axis) & 1
        first = _pick(inner, rev, lane)
        rest = inner & ~(1 << first)
        rp = torch.nonzero(has & (rest != 0)).squeeze(1)
        if rp.numel():
            spp = w.sp[rp]
            w.stn[rp, spp] = w.cur[rp]
            w.stm[rp, spp] = (rest[rp] << 1) | rev[rp]
            w.sp[rp] = spp + 1
        nxt = (meta.gather(1, first[:, None]).squeeze(1) >> 4)
        w.cur = torch.where(has, nxt, -1)
        w.sp = torch.where(done, 0, w.sp)


def _real_slots(rows):
    """Per leaf row, its triangles: the slots with a prim id (padding slots
    hold -1, ``accel/wide.pack_leaf_rows``)."""
    return (rows[:, PID_BASE:PID_BASE + MAX_LEAF] >= 0).sum(1)


def closest_leaf(best_t, best_p, best_n, found=None):
    """``on_leaf`` of the closest-hit walks: the closest accepted slot of
    each ray's leaf row (the first of equal t) shrinks the ray's tmax and
    becomes its best ``(t, prim, normal [N, 3])``; ``found [N]``, when
    given, marks the rays that got a hit."""

    def on_leaf(w, rr, rows):
        dev = rows.device
        if w.work is not None:
            w.work["tri_slots"] += int(_real_slots(rows).sum())
        u, v, t, tri = _mt8(rows, [c[rr] for c in w.o], [c[rr] for c in w.d])
        h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & \
            (t <= w.tm[rr][:, None]) & (t < BIG)
        tt = torch.where(h, t, float("inf"))
        j = torch.argmin(tt, dim=1)          # first of the smallest
        ok = h.any(dim=1)
        sel, j = rr[ok], j[ok]
        row_t = tt[ok].gather(1, j[:, None]).squeeze(1)
        w.tm[sel] = row_t
        gid = w.ids[sel]
        best_t[gid] = row_t
        best_p[gid] = rows[ok].gather(1, (PID_BASE + j)[:, None]).squeeze(1) \
            .to(torch.int32)
        best_n[gid] = tri[ok][torch.arange(sel.shape[0], device=dev), j, 9:12]
        if found is not None:
            found[gid] = True
        return torch.zeros(rr.shape[0], dtype=torch.bool, device=dev)

    return on_leaf


def anyhit_leaf(occ):
    """``on_leaf`` of the any-hit walks: a ray is occluded (and finished)
    by any accepted slot whose prim is not its excluded one."""

    def on_leaf(w, rr, rows):
        u, v, t, _ = _mt8(rows, [c[rr] for c in w.o], [c[rr] for c in w.d])
        pid = rows[:, PID_BASE:PID_BASE + MAX_LEAF].to(torch.int32)
        h = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0) & \
            (t <= w.tm[rr][:, None]) & (pid != w.ex[rr][:, None])
        hit = h.any(dim=1)
        if w.work is not None:
            # the kernels stop at the first occluding slot
            first = torch.argmax(h.to(torch.int32), dim=1) + 1
            w.work["tri_slots"] += int(
                torch.where(hit, first, _real_slots(rows)).sum())
        occ[w.ids[rr[hit]]] = True
        return hit

    return on_leaf


def persist_traverse_closest_ref(tables: WideTables, origin, direction, tmax,
                                 active, work=None):
    """Plain PyTorch version of :func:`persist_traverse_closest` (same
    contract, same visit order, any device); ``work`` as in :func:`_walk`."""
    REF_CALLS["closest"] += 1
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    n = tmax.shape[0]
    dev = tmax.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_n = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    _walk(tables, o, d, tmax, active, closest_leaf(best_t, best_p, best_n),
          work=work)
    hit = best_p >= 0
    nrm = (best_n[:, 0], best_n[:, 1], best_n[:, 2])
    return hit, best_t, best_p, _out_normal(nrm, as_v3)


def persist_traverse_anyhit_ref(tables: WideTables, origin, direction, tmax,
                                exclude, active, work=None):
    """Plain PyTorch version of :func:`persist_traverse_anyhit`."""
    REF_CALLS["anyhit"] += 1
    o, d = _columns(origin), _columns(direction)
    occ = torch.zeros(tmax.shape[0], dtype=torch.bool, device=tmax.device)
    _walk(tables, o, d, tmax, active, anyhit_leaf(occ), exclude, work=work)
    return occ
