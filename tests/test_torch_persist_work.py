"""rtjax_torch's persistent walkers: the work count of the plain walks and
the Python side of the fetch kernels' launch.

- the work count (node visits, non-empty child slab tests, leaf rows,
  triangle slots, the rows read) on a hand-built three-level scene whose
  counts follow from its boxes, and on a random soup, where the group walk
  at a group of one ray must count exactly what the persist walk counts;
- results with counting on equal results with it off, bit for bit, for the
  persist, group and two-level plain walks;
- the launch's rules: stack length from the depth, one zeroed work counter
  per device and stream, zeroed again after a failed launch,
  16-byte-aligned tables; the ptxas report read from a build log; and the
  source patches of tools/persist_variants.py (persist, two-level, packet
  and lane).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.wide import PID_BASE, WideTables, build_wide_tables
from rtjax_torch.kernels import _build
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, rotate, translate

W = 8
NAN = float("nan")


def _tri(p0, p1, p2):
    """12 leaf-slot floats: p0, e1 = p0 - p1, e2 = p2 - p0, e1 x e2."""
    p0, p1, p2 = (np.asarray(p, np.float32) for p in (p0, p1, p2))
    e1, e2 = p0 - p1, p2 - p0
    return np.concatenate([p0, e1, e2, np.cross(e1, e2)])


def _hand_tables():
    """Three 8-wide nodes.  Node 0: leaf A (x in [0, 1], one triangle at
    z = 0.5) and internal node 1 (x in [2, 4]).  Node 1: internal node 2
    (x in [2, 3]) and leaf B (x in [3, 4], triangles at z = 0.5 and 0.7).
    Node 2: leaf C (x in [2, 3], one triangle at z = 0.5).  Every box
    spans y and z in [0, 1]; the other slots are empty."""
    nb = np.full((3, 128), NAN, np.float32)
    cm = np.zeros((3, W), np.int32)
    lm = np.full(3, (1 << W) - 1, np.int64)   # empty slots are leaf-marked

    def child(node, slot, x0, x1, meta, leaf):
        nb[node, 6 * slot:6 * slot + 6] = [x0, 0, 0, x1, 1, 1]
        cm[node, slot] = meta
        if not leaf:
            lm[node] &= ~(1 << slot)

    child(0, 0, 0, 1, (0 << 4) | 1, True)    # leaf A: row 0, 1 triangle
    child(0, 1, 2, 4, 1 << 4, False)         # node 1
    child(1, 0, 2, 3, 2 << 4, False)         # node 2
    child(1, 1, 3, 4, (1 << 4) | 2, True)    # leaf B: row 1, 2 triangles
    child(2, 0, 2, 3, (2 << 4) | 1, True)    # leaf C: row 2, 1 triangle
    lt = np.zeros((4, 128), np.float32)      # three rows + the zero row
    lt[:3, PID_BASE:PID_BASE + 8] = -1
    lt[0, :12] = _tri((0, 0, 0.5), (1, 0, 0.5), (0, 1, 0.5))
    lt[1, :12] = _tri((3, 0, 0.5), (4, 0, 0.5), (3, 1, 0.5))
    lt[1, 12:24] = _tri((3, 0, 0.7), (4, 0, 0.7), (3, 1, 0.7))
    lt[2, :12] = _tri((2, 0, 0.5), (3, 0, 0.5), (2, 1, 0.5))
    lt[0, PID_BASE] = 10
    lt[1, PID_BASE:PID_BASE + 2] = [11, 12]
    lt[2, PID_BASE] = 13
    return WideTables.from_arrays(
        dict(node_bounds=nb, child_meta=cm, node_info=lm.astype(np.int32),
             leaf_tris=lt), width=W, depth=3, device="cpu")


# origin (x, y, z = -1), direction +z; per ray: node visits, slab tests,
# leaf rows, triangle slots (closest hit, any hit), hit prim
HAND_RAYS = [
    ((0.5, 5.0), (1, 2, 0, 0, 0), -1),   # above every box: the root alone
    ((0.3, 0.3), (1, 2, 1, 1, 1), 10),   # leaf A under the root
    ((2.5, 0.3), (3, 5, 1, 1, 1), 13),   # node 1, node 2, leaf C
    ((3.2, 0.2), (2, 4, 1, 2, 1), 11),   # node 1, leaf B: 2 slots, any 1
]


def chain_tables(width, levels, device="cpu"):
    """A chain of ``levels`` wide nodes whose children are all internal:
    child 0 of node i is node i + 1, the others (all children of the last)
    a terminal node with one leaf of one triangle (z = 0.5, x and y in the
    unit triangle).  Every box holds the scene, so a packet of rays down +z
    that meet the triangle pushes ``width - 1`` child ids at every level:
    ``levels * (width - 1)`` before its first pop, the full child-id stack
    of tables of depth ``levels - 1``."""
    end = levels
    nb = np.full((levels + 1, 128), NAN, np.float32)
    cm = np.zeros((levels + 1, width), np.int32)
    info = np.zeros(levels + 1, np.int64)     # axis 0, no leaf children
    box = [-1, -1, -1, 2, 2, 2]
    for i in range(levels):
        for c in range(width):
            nb[i, 6 * c:6 * c + 6] = box
            cm[i, c] = (i + 1 if c == 0 and i + 1 < levels else end) << 4
    nb[end, :6] = box
    cm[end, 0] = (0 << 4) | 1                 # leaf row 0, one triangle
    info[end] = (1 << width) - 1              # empty slots are leaf-marked
    lt = np.zeros((2, 128), np.float32)
    lt[0, PID_BASE:PID_BASE + 8] = -1
    lt[0, :12] = _tri((0, 0, 0.5), (1, 0, 0.5), (0, 1, 0.5))
    lt[0, PID_BASE] = 7
    return WideTables.from_arrays(
        dict(node_bounds=nb, child_meta=cm, node_info=info.astype(np.int32),
             leaf_tris=lt), width=width, depth=levels - 1, device=device)


def chain_rays(n, device="cpu"):
    """``(origin, direction, active, exclude)`` of ``n`` rays down +z from
    z = -1 that meet :func:`chain_tables`' triangle, all active, no
    exclusion."""
    g = torch.Generator().manual_seed(4)
    xy = torch.rand(2, n, generator=g) * 0.45 + 0.02
    o = (xy[0].contiguous(), xy[1].contiguous(), torch.full((n,), -1.0))
    d = (torch.zeros(n), torch.zeros(n), torch.ones(n))
    return (tuple(c.to(device) for c in o), tuple(c.to(device) for c in d),
            torch.ones(n, dtype=torch.bool, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device))


def _hand_rays(sel):
    xy = torch.tensor([HAND_RAYS[i][0] for i in sel], dtype=torch.float32)
    n = len(sel)
    o = (xy[:, 0].contiguous(), xy[:, 1].contiguous(), torch.full((n,), -1.0))
    d = (torch.zeros(n), torch.zeros(n), torch.ones(n))
    return o, d, torch.full((n,), float("inf")), torch.ones(n,
                                                            dtype=torch.bool)


@pytest.mark.parametrize("sel", [[0], [1], [2], [3], [0, 1, 2, 3]],
                         ids=["miss", "leaf", "two-levels", "two-slots",
                              "all"])
def test_work_count_of_a_hand_built_scene(sel):
    tables = _hand_tables()
    o, d, tmax, act = _hand_rays(sel)
    want = np.sum([HAND_RAYS[i][1] for i in sel], axis=0)
    wc, wa = P.new_work(), P.new_work()
    hit, t, prim, _ = P.persist_traverse_closest_ref(tables, o, d, tmax, act,
                                                     work=wc)
    occ = P.persist_traverse_anyhit_ref(
        tables, o, d, tmax, torch.full((len(sel),), -1, dtype=torch.int32),
        act, work=wa)
    assert prim.tolist() == [HAND_RAYS[i][2] for i in sel]
    assert occ.tolist() == [HAND_RAYS[i][2] >= 0 for i in sel]
    assert bool((t[hit] == 1.5).all())
    for work, slots in ((wc, want[3]), (wa, want[4])):
        assert [work[k] for k in ("node_visits", "slab_tests", "leaf_rows",
                                  "tri_slots")] == [*want[:3], slots]
    # rows read: the nodes visited and the leaf rows tested, once each
    nodes = {0} | ({1} if {2, 3} & set(sel) else set()) \
        | ({2} if 2 in sel else set())
    leaves = {r for i, r in ((1, 0), (2, 2), (3, 1)) if i in sel}
    assert set(torch.nonzero(wc["node_seen"]).squeeze(1).tolist()) == nodes
    assert set(torch.nonzero(wc["leaf_seen"]).squeeze(1).tolist()) == leaves
    # bytes needed: per node its 8 boxes, 8 metas and info word; per leaf
    # row its real triangles (12 floats and a prim id each)
    tris = {0: 1, 1: 2, 2: 1}
    assert P.work_table_bytes(wc, tables) == \
        len(nodes) * (8 * 24 + 8 * 4 + 4) + sum(tris[r] for r in leaves) * 52


def test_any_hit_counts_slots_up_to_the_excluded_prim():
    """An excluded prim does not occlude: the walk tests on to the next
    slot, and the count follows it."""
    tables = _hand_tables()
    o, d, tmax, act = _hand_rays([3])
    work = P.new_work()
    occ = P.persist_traverse_anyhit_ref(
        tables, o, d, tmax, torch.tensor([11], dtype=torch.int32), act,
        work=work)
    assert occ.tolist() == [True] and work["tri_slots"] == 2


def _soup(width):
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    res = build_bvh(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0,
                    max_leaf_size=8, min_leaf_size=8)
    pp0, e1, e2 = p0[res.perm], (p0 - p1)[res.perm], (p2 - p0)[res.perm]
    return build_wide_tables(res, pp0, e1, e2, np.cross(e1, e2), "cpu",
                             width=width)


def _soup_rays(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    o = tuple(torch.rand(n, generator=g) * 4 - 2 for _ in range(3))
    d = torch.randn(3, n, generator=g)
    d = d / d.norm(dim=0)
    active = torch.rand(n, generator=g) > 0.1
    exclude = torch.randint(-1, 300, (n,), generator=g, dtype=torch.int32)
    tmax = torch.where(torch.rand(n, generator=g) > 0.5, float("inf"), 1.5)
    return o, tuple(d[k].contiguous() for k in range(3)), tmax, active, \
        exclude


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_counting_leaves_results_unchanged(width):
    tables = _soup(width)
    o, d, tmax, act, ex = _soup_rays(1500)
    counted = {}
    for name, fn in (
            ("persist closest", lambda **k: P.persist_traverse_closest_ref(
                tables, o, d, tmax, act, **k)),
            ("persist anyhit", lambda **k: P.persist_traverse_anyhit_ref(
                tables, o, d, tmax, ex, act, **k)),
            ("lane closest", lambda **k: WD.group_traverse_closest_ref(
                tables, o, d, tmax, act, 32, **k)),
            ("packet anyhit", lambda **k: WD.group_traverse_anyhit_ref(
                tables, o, d, tmax, ex, act, 256, **k))):
        work = P.new_work()
        assert _equal(fn(work=work), fn()), name
        assert work["node_visits"] >= int(act.sum()), name
        assert 0 < work["tri_slots"] <= 8 * work["leaf_rows"], name
        counted[name] = work
    # any hit stops early: it never does more than closest hit would
    assert counted["persist anyhit"]["leaf_rows"] > 0


@pytest.mark.parametrize("kind", ["closest", "anyhit"])
@pytest.mark.parametrize("decide_first", [True, False],
                         ids=["packet", "leader"])
def test_group_walk_of_one_ray_counts_the_persist_walk(kind, decide_first):
    """A group of one ray walks exactly the persist walk's order, so both
    count the same work, under either any-hit rule: a ray occluded at a
    node may lead its group on (the packet rule), but a step with no live
    ray counts nothing and reads no row."""
    tables = _soup(8)
    o, d, tmax, act, ex = _soup_rays(700, seed=5)
    wp, wg = P.new_work(), P.new_work()
    if kind == "closest":
        P.persist_traverse_closest_ref(tables, o, d, tmax, act, work=wp)
        WD.group_traverse_closest_ref(tables, o, d, tmax, act, 1, work=wg)
    else:
        P.persist_traverse_anyhit_ref(tables, o, d, tmax, ex, act, work=wp)
        WD.group_traverse_anyhit_ref(tables, o, d, tmax, ex, act, 1, work=wg,
                                     decide_first=decide_first)
    for k in ("node_visits", "slab_tests", "leaf_rows", "tri_slots"):
        assert wp[k] == wg[k], k
    for k in ("node_seen", "leaf_seen"):
        assert torch.equal(wp[k], wg[k]), k


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_any_hit_rules_agree_and_deciding_first_does_more(width):
    """Deciding a packet's next node before its leaf tests changes no
    occlusion, and visits at least the nodes the leader design visits."""
    tables = _soup(width)
    o, d, tmax, act, ex = _soup_rays(1500, seed=9)
    counts = {}
    occ = {}
    for first in (True, False):
        work = P.new_work()
        occ[first] = WD.group_traverse_anyhit_ref(
            tables, o, d, tmax, ex, act, 128, work=work, decide_first=first)
        counts[first] = work
    assert torch.equal(occ[True], occ[False]) and bool(occ[True].any())
    assert torch.equal(occ[True], P.persist_traverse_anyhit_ref(
        tables, o, d, tmax, ex, act))
    for k in ("node_visits", "slab_tests"):
        assert counts[True][k] >= counts[False][k] > 0, k


def test_packet_stack_holds_a_full_chain(monkeypatch):
    """A tree deeper than the persist stack (patched down to 8 entries): a
    chain that fills the packet's child-id stack to its (depth + 1) *
    (width - 1) entries; the packet wrapper on CPU tensors walks it with the
    plain version and finds the persist walk's hits."""
    monkeypatch.setattr(P, "STACK", 8)
    tables = chain_tables(8, 12)
    assert tables.depth + 1 > P.STACK
    assert WD.packet_stack_len(tables) == 12 * 7
    n = 2 * WD.PACKET + 9
    o, d, act, ex = chain_rays(n)
    tmax = torch.full((n,), float("inf"))
    work = P.new_work()
    hit, t, prim, _ = WD.group_traverse_closest_ref(tables, o, d, tmax, act,
                                                    WD.PACKET, work=work)
    assert work["stack_peak"] == WD.packet_stack_len(tables)
    assert bool(hit.all()) and bool((prim == 7).all())
    ph, pt, _, _ = P.persist_traverse_closest_ref(tables, o, d, tmax, act)
    got = WD.wide_traverse_closest(tables, o, d, tmax, act)
    assert torch.equal(got[0], ph) and torch.equal(got[1], pt)
    assert torch.equal(got[1], t)
    assert bool(WD.wide_traverse_anyhit(tables, o, d, tmax, ex, act).all())


@pytest.mark.parametrize("width, depth, ok", [
    (16, 18, True), (16, 840, True), (16, 841, False), (8, 1937, True),
    (8, 1938, False)])
def test_packet_block_fits_shared_memory(width, depth, ok):
    """A packet-kernel block holds each packet's shared state (7,616 B at
    width 16, 3,840 B at width 8, as ptxas counts it) and its child-id
    stack; a depth whose block passes the card's opt-in limit is refused
    before launch."""
    tables = WideTables(*(torch.zeros(1) for _ in range(4)), width=width,
                        depth=depth)
    shared = {16: 7616, 8: 3840}[width]
    assert WD.packet_smem_bytes(tables) == WD.PACKETS * (
        shared + 4 * (depth + 1) * (width - 1))
    if ok:
        assert WD._stack_len("packet", tables) == WD.packet_stack_len(tables)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            WD._stack_len("packet", tables)
    assert WD._stack_len("lane", tables) == depth + 1


def test_two_level_counting_leaves_results_unchanged():
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    rng = np.random.default_rng(5)
    v = rng.uniform(-0.3, 0.3, (150, 3)) + [0.0, 0.35, 0.0]
    mid = b.register_mesh(v, np.arange(150).reshape(50, 3))
    for i in range(5):
        t = Transform(rotate([0, 1, 0], 0.61 * i))
        t.composite(translate(i * 0.9 - 1.8, 0.0, 0.0))
        b.add_instance(mid, white, t)
    it = b.build("cpu").inst_tables
    o, d, tmax, act, _ = _soup_rays(800, seed=7)
    o = (o[0], o[1].abs() * 0.4 + 0.02, o[2])
    ex = torch.randint(-1, 3, (800,), generator=torch.Generator()
                       .manual_seed(2), dtype=torch.int32)
    wc, wa = P.new_work(), P.new_work()
    assert _equal(WI.wide_traverse_closest_inst_ref(it, o, d, tmax, act,
                                                    work=wc),
                  WI.wide_traverse_closest_inst_ref(it, o, d, tmax, act))
    assert _equal(WI.wide_traverse_anyhit_inst_ref(it, o, d, tmax, ex, act,
                                                   work=wa),
                  WI.wide_traverse_anyhit_inst_ref(it, o, d, tmax, ex, act))
    n_inst = it.root.shape[0]
    for work in (wc, wa):
        assert work["inst_tests"] >= int(act.sum()) * n_inst
        assert 0 < work["inst_visits"] <= work["inst_tests"]
        assert work["node_visits"] >= work["inst_visits"]


def test_stack_length_follows_the_depth():
    base = _hand_tables()
    for depth in (0, 3, 18, P.STACK - 1):
        tables = WideTables(base.node_bounds, base.child_meta,
                            base.node_info, base.leaf_tris, width=W,
                            depth=depth)
        assert P.stack_len(tables) == depth + 1


def test_work_counter_one_per_device_and_stream():
    a = P.work_buffer("cpu", 7)
    assert a.dtype == torch.int32 and a.shape == (P.WORK_WORDS,)
    assert not bool(a.any())
    assert P.work_buffer(torch.device("cpu"), 7) is a
    assert P.work_buffer("cpu", 8) is not a


@pytest.mark.parametrize("rc", [0, 700], ids=["ok", "failed"])
def test_failed_launch_zeroes_the_work_counter(rc):
    """A launch that returns an error may leave the counter drawn: the
    wrapper zeroes it before raising, so the next launch starts at 0."""
    work = torch.tensor([1234, 7], dtype=torch.int32)

    def entry(*args):
        assert args == (1, 2)
        return rc

    if rc:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            P._launch(entry, (1, 2), "test", work)
        assert not bool(work.any())
    else:
        P._launch(entry, (1, 2), "test", work)
        assert work.tolist() == [1234, 7]


def _variants_tool():
    import importlib.util
    path = _build.REPO_ROOT / "tools" / "persist_variants.py"
    spec = importlib.util.spec_from_file_location("persist_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernels", ["persist", "two-level", "packet",
                                     "lane"])
def test_variant_patches_match_the_kernel_source(kernels):
    """Every variant of tools/persist_variants.py replaces text that occurs
    once in the kernel source and its walk header together, so a change of
    either cannot leave a variant building the design unchanged; a packet
    variant that changes the packet size names it."""
    tool = _variants_tool()
    src = tool.sources(kernels)
    assert set(src) == {
        "persist": {"fetch_walk.cuh", "persist_traverse.cu"},
        "two-level": {"fetch_walk.cuh", "wide_inst_traverse.cu"},
        "packet": {"packet_walk.cuh", "packet_traverse.cu"},
        "lane": {"lane_walk.cuh", "packet_traverse.cu"}}[kernels]
    table = {"persist": tool.VARIANTS, "two-level": tool.INST_VARIANTS,
             "packet": tool.PACKET_VARIANTS,
             "lane": tool.LANE_VARIANTS}[kernels]
    for name, edits in tool.PACKET_VARIANTS.items():
        sizes = [new for old, new in edits
                 if old == f"kPacket = {WD.PACKET};"]
        assert [f"kPacket = {tool.PACKET_GROUPS[name]};"] == sizes \
            if name in tool.PACKET_GROUPS else not sizes, name
    assert f"kPacket = {WD.PACKET};" in src.get("packet_walk.cuh", "") \
        or kernels != "packet"
    for name, edits in table.items():
        out = tool.patched(src, edits)
        assert (out == src) == (not edits), name
    with pytest.raises(ValueError, match="not once"):
        tool.patched(src, [("no such text", "")])
    with pytest.raises(ValueError, match="2 times"):
        tool.patched(src, [("#include <cuda_runtime.h>", "")])


def test_kernels_refuse_unaligned_tables():
    base = _hand_tables()
    P._check_aligned(base)
    storage = torch.zeros(base.node_bounds.numel() + 1)
    shifted = storage[1:].view_as(base.node_bounds)
    bad = WideTables(shifted, base.child_meta, base.node_info,
                     base.leaf_tris, width=W, depth=3)
    with pytest.raises(ValueError, match="16-byte aligned"):
        P._check_aligned(bad)


def test_ptxas_report_reads_the_build_log(tmp_path):
    lib = tmp_path / "libk.so"
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4kernA' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4kernA\n"
        "    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 62 registers, 380 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z4kernB' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    assert _build.ptxas_report(lib) == [
        ("_Z4kernA", "512 bytes stack frame, 0 bytes spill stores, 0 bytes "
                     "spill loads; Used 62 registers, 380 bytes cmem[0]"),
        ("_Z4kernB", "Used 40 registers")]
    assert _build.ptxas_report(tmp_path / "missing.so") == []
