"""Lane closest-hit and any-hit BVH traversal over the wide tables: the
wrappers of the hand-written CUDA lane kernels and their plain PyTorch
version.

``lane_traverse_closest`` / ``lane_traverse_anyhit`` replace
rtjax/kernels/pallas_lane.py's functions of the same names (the Pallas
kernels ``_make_lane_closest_kernel`` and ``_make_lane_anyhit_kernel``),
whose 128-ray sublanes each walk the tree on their own cursor.  They
compute the packet kernels' function with smaller groups: here a lane
group is one warp of LANE rays.  A CUDA tensor goes to the lane design in
``csrc/lane_walk.cuh`` (the ``rtjax_lane_*`` entries of
``csrc/packet_traverse.cu``, built at first use, bound with ctypes by
kernels/wide.py); a CPU tensor goes to the plain group walk of
kernels/wide.py at ``group`` = LANE.  There is no fallback between them.

Contract: persist.py's, at any tree depth whose warp's shared memory fits
a block (:func:`fits`): each warp keeps a child-id stack of
:func:`lane_stack_len` entries.  A block holds LANE_WARPS warps where
their shared memory fits the card's opt-in limit, fewer for deeper trees
(:func:`launch_shape`).  The warps draw their groups from the persist
kernels' work counter (``persist.work_buffer``), which every launch leaves
zeroed.

Any hit takes the packet kernels' rule (``decide_first`` True in the plain
walk): a warp decides its next node before the leaf tests, so that the
next node's loads overlap them.  rtjax's lane rule (decide after them)
visits ~1% fewer nodes and was slower on the H100; occlusion is the same
under both.

``with_stats=True`` appends ``(node_steps, leaf_visits)`` as the packet
wrappers do (kernels/wide.py): a CUDA tensor goes to the lane kernels'
stats instances (``rtjax_lane_*_stats``, counted in ``STATS_LAUNCHES``), a
CPU tensor to the plain group walk at LANE with a work count.

``lane_traverse_*_group`` launch the lane kernels' first design (the
leader design of kernels/wide.py at one warp, ``rtjax_lane_group_*``,
counted in ``GROUP_LAUNCHES``); they exist only to time both designs in
one run (``chip_smoke.py``, the card tests), and no engine path calls
them.
"""

from __future__ import annotations

import torch

from ..accel.wide import PID_BASE, WideTables
from .persist import (_check_aligned, _columns, _launch, _out_normal,
                      _stats_buffer, _table_ptrs, check_rays, work_buffer)
from .wide import (_kernels, group_anyhit, group_closest,
                   group_traverse_anyhit_ref, group_traverse_closest_ref)
from .wide_inst import SMEM_OPTIN

LANE = 32  # rays per lane group: one warp (csrc/lane_walk.cuh kLane)
LANE_WARPS = 8  # warps a block where their stacks fit (kLaneWarps)
LANE_ROWS = 4  # leaf rows a warp stages at a time (kLaneRows)

# kernel launches (wrapper, CUDA path), by kernel; the plain version's calls
# count in kernels/wide.py REF_CALLS
LAUNCHES = {"closest": 0, "anyhit": 0}
# launches of the first design (the ``_group`` wrappers), by kernel
GROUP_LAUNCHES = {"closest": 0, "anyhit": 0}
# launches of the stats instances (``with_stats=True``), by kernel
STATS_LAUNCHES = {"closest": 0, "anyhit": 0}


def lane_stack_len(tables: WideTables) -> int:
    """Child-id stack entries per warp of the lane kernels: at most
    ``width - 1`` ids pushed at each of the ``depth + 1`` levels the
    (node, mask) stack of the plain walk holds."""
    return (tables.depth + 1) * (tables.width - 1)


def warp_bytes(tables: WideTables) -> int:
    """Shared memory of one warp of a lane-kernel block
    (``csrc/lane_walk.cuh`` ``lane_warp_bytes``): its ``LaneShared`` (two
    node rows of 7 words a child slot, LANE_ROWS leaf rows of 104 words)
    and its child-id stack, 16-byte aligned."""
    shared = 4 * (2 * 7 * tables.width + LANE_ROWS * (PID_BASE + 8))
    return shared + -(-4 * lane_stack_len(tables) // 16) * 16


def fits(tables: WideTables) -> bool:
    """Whether one warp's shared memory fits a block: the deepest tree the
    lane kernels take (depth 3,830 at width 16, 8,225 at width 8)."""
    return warp_bytes(tables) <= SMEM_OPTIN


def launch_shape(tables: WideTables) -> tuple[int, int, int]:
    """``(stack length, warps a block, shared-memory bytes a block)`` of a
    lane launch over ``tables``, as ``csrc/packet_traverse.cu``'s
    ``launch_lane`` takes them; raises where one warp does not fit a
    block."""
    per = warp_bytes(tables)
    if per > SMEM_OPTIN:
        raise ValueError(
            f"BVH depth {tables.depth} needs {per} B of shared memory per "
            f"lane-kernel warp; a block holds at most {SMEM_OPTIN}")
    warps = min(LANE_WARPS, SMEM_OPTIN // per)
    return lane_stack_len(tables), warps, warps * per


def _launch_args(tables, dev, stats=None):
    """``(leading arguments, trailing arguments, work counter)`` of a lane
    entry point on ``dev``: width, group and stack length; the counter, a
    stats instance's buffer and the stream."""
    _check_aligned(tables)
    stack, _, _ = launch_shape(tables)
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = work_buffer(dev, stream)
    tail = (work.data_ptr(),)
    if stats is not None:
        tail += (stats.data_ptr(),)
    return (tables.width, LANE, stack), tail + (stream,), work


def _entry(kind, stats):
    """The lane entry point of ``kind`` and the launch count it adds to."""
    if stats is None:
        return getattr(_kernels(), f"rtjax_lane_{kind}"), LAUNCHES
    return getattr(_kernels(), f"rtjax_lane_{kind}_stats"), STATS_LAUNCHES


def lane_traverse_closest(tables: WideTables, origin, direction, tmax,
                          active, with_stats: bool = False):
    """Closest hit of every active ray by lane groups: ``(hit, t, prim,
    normal)``, and with ``with_stats`` a trailing ``(node_steps,
    leaf_visits)``."""
    as_v3 = isinstance(origin, (tuple, list))
    o, d = _columns(origin), _columns(direction)
    check_rays(tables, o, d, tmax, active)
    n = tmax.shape[0]
    dev = tmax.device
    if dev.type == "cpu":
        hit, t, prim, nrm, *st = group_traverse_closest_ref(
            tables, o, d, tmax, active, LANE, with_stats=with_stats)
        return (hit, t, prim, _out_normal(nrm, as_v3), *st)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    stats = _stats_buffer(dev) if with_stats else None
    lead, tail, work = _launch_args(tables, dev, stats)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    nrm = tuple(torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(3))
    entry, counts = _entry("closest", stats)
    _launch(entry, (
        *lead, *_table_ptrs(tables), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(), n,
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(),
        *(c.data_ptr() for c in nrm), *tail), "lane closest-hit", work)
    counts["closest"] += 1
    st = () if stats is None else ((stats[0], stats[1]),)
    return (hit, t, prim, _out_normal(nrm, as_v3), *st)


def lane_traverse_anyhit(tables: WideTables, origin, direction, tmax,
                         exclude, active, with_stats: bool = False):
    """Occlusion of every active ray by lane groups, ignoring its
    ``exclude`` prim; with ``with_stats``, ``(occluded, (node_steps,
    leaf_visits))``."""
    o, d = _columns(origin), _columns(direction)
    check_rays(tables, o, d, tmax, active, exclude)
    dev = tmax.device
    if dev.type == "cpu":
        return group_traverse_anyhit_ref(tables, o, d, tmax, exclude, active,
                                         LANE, with_stats=with_stats)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    stats = _stats_buffer(dev) if with_stats else None
    lead, tail, work = _launch_args(tables, dev, stats)
    n = tmax.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    entry, counts = _entry("anyhit", stats)
    _launch(entry, (
        *lead, *_table_ptrs(tables), *(c.data_ptr() for c in o),
        *(c.data_ptr() for c in d), tmax.data_ptr(), active.data_ptr(),
        exclude.data_ptr(), n, occ.data_ptr(), *tail), "lane any-hit", work)
    counts["anyhit"] += 1
    return occ if stats is None else (occ, (stats[0], stats[1]))


def lane_traverse_closest_group(tables: WideTables, origin, direction, tmax,
                                active):
    """:func:`lane_traverse_closest` by the first design (for timing both
    designs in one run; counted in ``GROUP_LAUNCHES``)."""
    return group_closest("lane_group", LANE, GROUP_LAUNCHES, tables, origin,
                         direction, tmax, active)


def lane_traverse_anyhit_group(tables: WideTables, origin, direction, tmax,
                               exclude, active):
    """:func:`lane_traverse_anyhit` by the first design."""
    return group_anyhit("lane_group", LANE, GROUP_LAUNCHES, tables, origin,
                        direction, tmax, exclude, active)
