"""Wide-node (8- or 16-child) traversal tables, built in NumPy on the host
and placed as tensors (port of the host half of rtjax.kernels.pallas_wide).

Layout, shared with rtjax so that both packages trace identical tables:

- ``node_bounds [M, 128] f32``: child c's (bmin, bmax) at lanes 6c..6c+5;
  empty child slots are NaN boxes; child meta mirrored as exact f32 at
  lanes 6W..7W-1 and the node info at lane 7W.  The mirror is kept only so
  that the tables are array-equal to rtjax's: no walk of the port, kernel
  or plain version, reads it (they read ``child_meta`` and ``node_info``).
  Where a meta would not be exact as f32 (META_CAP wide nodes or leaf
  rows and beyond), the mirror lanes hold NaN and the tables are built
  all the same.
- ``child_meta [M * W] i32``: ``(value << 4) | count``; count > 0 is a leaf
  (value = leaf row), count == 0 an internal child (value = wide node) or,
  with the child's leaf bit set, an empty slot.
- ``node_info [M] i32``: ``(axis << W) | leaf_mask``; children are sorted
  along ``axis`` at build time.
- ``leaf_tris [L + 1, 128] f32``: 8 triangles (p0, e1, e2, n) at lanes
  12j..12j+11 and their 8 prim ids as exact f32 at lanes 96..103; the last
  row is all zero (it rejects every ray).  Prim ids are exact as f32 below
  PRIM_CAP triangles; a mesh with more gets no wide tables
  (:func:`prims_fit`) and renders on the binary walk, as in rtjax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh import BuildResult

WIDTH = 8
WIDTH16 = 16
MAX_LEAF = 8          # triangles per leaf row
PID_BASE = 12 * MAX_LEAF
MAX_NODES16 = 1 << 14  # 16-wide node cap of rtjax's stack-entry packing
# a meta ``(value << 4) | count`` is exact as f32 below 2^24, so its f32
# mirror in the node rows is exact below this many wide nodes or leaf rows
META_CAP = 1 << 20
# prim ids ride the leaf rows as f32, exact below 2^24 triangles
PRIM_CAP = 1 << 24
# beyond this many binary nodes the O(M * W^2) DP collapse gets heavy on the
# host; the greedy collapse takes over
DP_COLLAPSE_CAP = 3_000_000


@dataclasses.dataclass(frozen=True)
class WideTables:
    node_bounds: torch.Tensor  # [M, 128] float32
    child_meta: torch.Tensor   # [M * width] int32
    node_info: torch.Tensor    # [M] int32
    leaf_tris: torch.Tensor    # [L + 1, 128] float32
    width: int = WIDTH
    depth: int = 0             # depth of the binary build; bounds the walk
                               # stack (wide depth <= binary depth)

    @property
    def num_wide_nodes(self) -> int:
        return self.node_bounds.shape[0]

    @property
    def num_leaf_rows(self) -> int:
        return self.leaf_tris.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.node_bounds, self.child_meta, self.node_info,
                    self.leaf_tris))

    @staticmethod
    def from_arrays(arrays: dict, width: int, depth: int,
                    device) -> "WideTables":
        """Tables from NumPy arrays (``node_bounds``, ``child_meta``,
        ``node_info``, ``leaf_tris``)."""
        t = lambda k, dt: torch.tensor(
            np.ascontiguousarray(arrays[k], dt), device=device)
        return WideTables(node_bounds=t("node_bounds", np.float32),
                          child_meta=t("child_meta", np.int32).reshape(-1),
                          node_info=t("node_info", np.int32),
                          leaf_tris=t("leaf_tris", np.float32),
                          width=int(width), depth=int(depth))


def collapse_wide(bmin, bmax, left_first, num_prims, width=WIDTH):
    """Greedy top-down binary -> wide collapse: each wide node absorbs the
    internal candidate with the largest surface area until ``width``
    children.  Returns ``(children, axes)``: per wide node the list of
    ``(bin_node, ref, is_leaf)`` sorted along its dominant axis."""
    is_leaf_a = np.asarray(num_prims) > 0
    if is_leaf_a[0]:
        return [[(0, 0, True)]], [0]

    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    d = np.maximum(bmax - bmin, 0)
    area = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
            + d[:, 2] * d[:, 0]).tolist()
    cent = (0.5 * (bmin + bmax))
    cents = (cent[:, 0].tolist(), cent[:, 1].tolist(), cent[:, 2].tolist())
    left = np.asarray(left_first).tolist()
    is_leaf = is_leaf_a.tolist()

    children: list = [None]
    axes: list[int] = [0]
    pending: list[tuple[int, int]] = [(0, 0)]  # (binary node, wide index)
    while pending:
        b, wi = pending.pop()
        grp = [left[b], left[b] + 1]
        while len(grp) < width:
            best, best_a = -1, -1.0
            for j, g in enumerate(grp):
                if not is_leaf[g] and area[g] > best_a:
                    best, best_a = j, area[g]
            if best < 0:
                break
            g = grp.pop(best)
            grp.extend((left[g], left[g] + 1))
        spans = [max(c[g] for g in grp) - min(c[g] for g in grp)
                 for c in cents]
        axis = spans.index(max(spans))
        ca = cents[axis]
        grp.sort(key=lambda g: ca[g])  # stable
        children[wi] = _entries(grp, is_leaf, children, axes, pending)
        axes[wi] = axis
    return children, axes


def _entries(grp, is_leaf, children, axes, pending):
    """Wide-node child entries; internal children get fresh wide slots."""
    entry = []
    for g in grp:
        if is_leaf[g]:
            entry.append((g, g, True))
        else:
            ref = len(children)
            children.append(None)
            axes.append(0)
            pending.append((g, ref))
            entry.append((g, ref, False))
    return entry


def collapse_wide_dp(bmin, bmax, left_first, num_prims, width=WIDTH):
    """Optimal binary -> wide collapse by bottom-up dynamic programming,
    minimising the sum of half-areas of the wide-node roots (the flat-cost
    case of Ylitie et al. 2017).  Same return contract as
    :func:`collapse_wide`."""
    is_leaf_a = np.asarray(num_prims) > 0
    if is_leaf_a[0]:
        return [[(0, 0, True)]], [0]

    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    d = np.maximum(bmax - bmin, 0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    left = np.asarray(left_first, np.int64)
    m = len(left)

    levels = [np.array([0], np.int64)]
    while True:
        ints = levels[-1][~is_leaf_a[levels[-1]]]
        if ints.size == 0:
            break
        lo = left[ints]
        levels.append(np.concatenate([lo, lo + 1]))

    INF = np.float32(3e38)
    G = np.zeros((m, width + 1), np.float32)  # G[x, s]: subtree x in s slots
    F = np.zeros(m, np.float32)               # F[x]: x as a wide-node root
    for lev in reversed(levels):
        ints = lev[~is_leaf_a[lev]]
        if ints.size == 0:
            continue
        A = G[left[ints]]
        B = G[left[ints] + 1]
        E = np.full((len(ints), width + 1), INF, np.float32)
        for s in range(2, width + 1):
            E[:, s] = (A[:, 1:s] + B[:, s - 1:0:-1]).min(axis=1)
        F[ints] = area[ints] + E[:, width]
        G[ints, 1] = F[ints]
        for s in range(2, width + 1):
            G[ints, s] = np.minimum(F[ints], E[:, s])

    cent = 0.5 * (bmin + bmax)

    def frontier(x, s, out):
        stack = [(int(x), int(s))]
        while stack:
            x, s = stack.pop()
            if is_leaf_a[x] or s == 1 or G[x, s] == F[x]:
                out.append(x)
                continue
            lo = int(left[x])
            ks = np.arange(1, s)
            k = int(ks[np.argmin(G[lo, 1:s] + G[lo + 1, s - 1:0:-1])])
            stack.append((lo, k))
            stack.append((lo + 1, s - k))

    is_leaf = is_leaf_a.tolist()
    children: list = [None]
    axes: list[int] = [0]
    pending: list[tuple[int, int]] = [(0, 0)]
    while pending:
        b, wi = pending.pop()
        lo = int(left[b])
        ks = np.arange(1, width)
        k = int(ks[np.argmin(G[lo, 1:width] + G[lo + 1, width - 1:0:-1])])
        grp: list[int] = []
        frontier(lo, k, grp)
        frontier(lo + 1, width - k, grp)
        spans = [cent[grp, a].max() - cent[grp, a].min() for a in range(3)]
        axis = int(np.argmax(spans))
        grp.sort(key=lambda g: cent[g, axis])  # stable
        children[wi] = _entries(grp, is_leaf, children, axes, pending)
        axes[wi] = axis
    return children, axes


def prims_fit(num_tris: int) -> bool:
    """Whether a mesh of ``num_tris`` triangles can have wide tables: its
    prim ids must be exact as f32 in the leaf rows (below PRIM_CAP)."""
    return num_tris < PRIM_CAP


def _meta_mirror(node_bounds, child_meta, node_info, width, leaf_rows):
    """Write the f32 mirror of the metas and node info into the node rows:
    exact below META_CAP wide nodes and ``leaf_rows``, NaN at and beyond
    (no walk reads the mirror; it keeps the tables array-equal to rtjax's
    where rtjax has them)."""
    exact = len(node_bounds) < META_CAP and leaf_rows < META_CAP
    node_bounds[:, 6 * width:7 * width] = (
        child_meta.reshape(-1, width).astype(np.float32) if exact else np.nan)
    node_bounds[:, 7 * width] = node_info.astype(np.float32) if exact \
        else np.nan


def pack_leaf_rows(leaves, left_first, num_prims, p0, e1, e2, n_vec,
                   prim_ids=None):
    """Binary-BVH leaves -> ``[L + 1, 128]`` rows: 8 x 12 triangle floats +
    8 prim ids as exact f32; short leaves pad with all-zero triangles, and
    one all-zero row is appended."""
    n_leaves = len(leaves)
    tri_rows = np.zeros((max(n_leaves, 1) + 1, 128), np.float32)
    pid_rows = np.full((max(n_leaves, 1), MAX_LEAF), -1, np.int32)
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    n_vec = np.asarray(n_vec, np.float32)
    if prim_ids is None:
        prim_ids = np.arange(len(p0), dtype=np.int32)
    if not prims_fit(len(p0)):
        raise ValueError(f"prim ids must be exact as f32 (< {PRIM_CAP} "
                         "triangles)")

    first = np.asarray(left_first)[leaves]
    count = np.asarray(num_prims)[leaves]
    if count.max(initial=1) > MAX_LEAF:
        raise ValueError(f"leaves hold at most {MAX_LEAF} triangles")
    for j in range(MAX_LEAF):
        has = count > j
        src = np.where(has, first + j, 0)
        base = 12 * j
        for off, arr in ((0, p0), (3, e1), (6, e2), (9, n_vec)):
            tri_rows[:n_leaves, base + off:base + off + 3] = np.where(
                has[:, None], arr[src], 0.0)
        pid_rows[:n_leaves, j] = np.where(has, prim_ids[src], -1)
    tri_rows[:-1, PID_BASE:PID_BASE + MAX_LEAF] = pid_rows.astype(np.float32)
    return tri_rows


def build_wide_tables(res: BuildResult, p0, e1, e2, n_vec, device,
                      prim_ids=None, width: int = WIDTH) -> WideTables:
    """Collapse a binary build + leaf-ordered triangles into wide tables
    (``width`` 8 or 16; a 16-wide tree over MAX_NODES16 nodes falls back to
    8-wide, as in rtjax)."""
    if width not in (WIDTH, WIDTH16):
        raise ValueError(f"width must be 8 or 16, got {width}")
    m = res.num_nodes
    bmin = np.asarray(res.bmin[:m], np.float32)
    bmax = np.asarray(res.bmax[:m], np.float32)
    left_first = np.asarray(res.left_first[:m], np.int64)
    num_prims = np.asarray(res.num_prims[:m], np.int64)

    collapse = collapse_wide_dp if m <= DP_COLLAPSE_CAP else collapse_wide
    children, axes = collapse(bmin, bmax, left_first, num_prims, width=width)
    if width != WIDTH and len(children) > MAX_NODES16:
        width = WIDTH
        children, axes = collapse(bmin, bmax, left_first, num_prims,
                                  width=width)
    n_wide = len(children)

    leaf_nodes = [g for grp in children for (g, _, lf) in grp if lf]
    leaf_row_of = {g: i for i, g in enumerate(leaf_nodes)}
    leaf_tris = pack_leaf_rows(np.asarray(leaf_nodes, np.int64), left_first,
                               num_prims, p0, e1, e2, n_vec, prim_ids)

    node_bounds = np.full((n_wide, 128), np.nan, np.float32)
    child_meta = np.zeros((n_wide, width), np.int32)
    node_info = np.zeros(n_wide, np.int32)
    fi, fc, fg, fm = [], [], [], []
    flm = np.zeros(n_wide, np.int64)
    for i, grp in enumerate(children):
        lm = 0
        for c, (g, ref, lf) in enumerate(grp):
            fi.append(i)
            fc.append(c)
            fg.append(g)
            if lf:
                lm |= 1 << c
                fm.append((leaf_row_of[g] << 4) | int(num_prims[g]))
            else:
                fm.append(ref << 4)
        for c in range(len(grp), width):
            lm |= 1 << c  # empty: leaf-marked, count 0, NaN box
        flm[i] = lm
    fi = np.asarray(fi)
    fc = np.asarray(fc)
    fg = np.asarray(fg)
    lo, hi = bmin[fg], bmax[fg]
    for k in range(3):
        node_bounds[fi, 6 * fc + k] = lo[:, k]
        node_bounds[fi, 6 * fc + 3 + k] = hi[:, k]
    child_meta[fi, fc] = np.asarray(fm, np.int32)
    node_info[:] = (np.asarray(axes, np.int64) << width) | flm

    _meta_mirror(node_bounds, child_meta, node_info, width, len(leaf_nodes))
    return WideTables.from_arrays(
        dict(node_bounds=node_bounds, child_meta=child_meta,
             node_info=node_info, leaf_tris=leaf_tris),
        width=width, depth=res.max_depth, device=device)


# ---------------------------------------------- two-level (instanced) tables

@dataclasses.dataclass(frozen=True)
class InstancedTables:
    """Concatenated wide tables + per-instance records for the two-level
    kernels (port of rtjax.kernels.pallas_wide.InstancedTables).

    ``wide``: the base scene's tables and every unique mesh's tables,
    concatenated with child refs re-offset.  ``root [I] i32``: each
    instance's BLAS root node.  ``affine [I * 18] f32``: per instance 12
    world->local affine floats then 6 world-AABB floats (lo, hi).  Instance
    0 is the base scene: identity transform, root 0."""

    wide: WideTables
    root: torch.Tensor
    affine: torch.Tensor

    @property
    def num_instances(self) -> int:
        return self.root.shape[0]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def concat_wide_tables(parts, device):
    """Concatenate WideTables, re-offsetting child refs: leaf entries
    (count > 0) get the leaf-row offset, internal entries (count 0, value >
    0) the node offset, empty slots (0) stay 0.  The bounds-row meta mirror
    lanes follow the re-offset meta (NaN where the concatenation reaches
    META_CAP, as in :func:`build_wide_tables`).  Returns ``(tables,
    node_offsets, leaf_offsets)``."""
    width = parts[0].width
    if any(t.width != width for t in parts):
        raise ValueError("concat_wide_tables needs a uniform node width")
    node_off, leaf_off = [], []
    nb, cm, ni, lt = [], [], [], []
    n_nodes = n_leaves = 0
    for t in parts:
        node_off.append(n_nodes)
        leaf_off.append(n_leaves)
        cmk = _host(t.child_meta)
        count = cmk & 15
        value = cmk >> 4
        value = np.where(count > 0, value + n_leaves,
                         np.where(value > 0, value + n_nodes, 0))
        cmk2 = ((value << 4) | count).astype(np.int32)
        cm.append(cmk2)
        nb.append(_host(t.node_bounds))
        ni.append(_host(t.node_info))
        lt.append(_host(t.leaf_tris))
        n_nodes += t.num_wide_nodes
        n_leaves += t.num_leaf_rows
    node_bounds, child_meta = np.concatenate(nb), np.concatenate(cm)
    node_info = np.concatenate(ni)
    _meta_mirror(node_bounds, child_meta, node_info, width, n_leaves)
    tables = WideTables.from_arrays(
        dict(node_bounds=node_bounds, child_meta=child_meta,
             node_info=node_info, leaf_tris=np.concatenate(lt)),
        width=width, depth=max(t.depth for t in parts), device=device)
    return tables, node_off, leaf_off


def build_instanced_tables(base: WideTables, base_lo, base_hi, blas_tables,
                           instances, device) -> InstancedTables | None:
    """Assemble the two-level kernel tables; None when a table is missing,
    the widths differ, or a 16-wide concatenation reaches MAX_NODES16 (the
    scene builder rebuilds 8-wide first, so both packages build the same
    tables)."""
    if base is None or any(t is None for t in blas_tables):
        return None
    parts = [base] + list(blas_tables)
    if len({t.width for t in parts}) != 1:
        return None
    if parts[0].width != WIDTH and \
            sum(t.num_wide_nodes for t in parts) >= MAX_NODES16:
        return None
    wide, node_off, _ = concat_wide_tables(parts, device)

    inv = _host(instances.inv).astype(np.float32).reshape(instances.num, 12)
    lo = _host(instances.aabb_lo).astype(np.float32)
    hi = _host(instances.aabb_hi).astype(np.float32)
    ident = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32)

    n_inst = 1 + instances.num
    aff = np.zeros((n_inst, 18), np.float32)
    root = np.zeros(n_inst, np.int32)
    aff[0, :12] = ident
    aff[0, 12:15] = np.asarray(base_lo, np.float32)
    aff[0, 15:18] = np.asarray(base_hi, np.float32)
    for i in range(instances.num):
        aff[1 + i, :12] = inv[i]
        aff[1 + i, 12:15] = lo[i]
        aff[1 + i, 15:18] = hi[i]
        root[1 + i] = node_off[1 + instances.mesh_id[i]]
    return InstancedTables(wide=wide,
                           root=torch.tensor(root, device=device),
                           affine=torch.tensor(aff.reshape(-1),
                                               device=device))
