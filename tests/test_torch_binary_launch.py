"""Launch rules of rtjax_torch's binary-BVH walk (kernels/traversal.py),
on the CPU, with no JAX (tests/test_torch_cuda.py imports the trees here):

- the stack: ``max(stack_size, max_depth + 1)`` entries; on a hand-built
  tree that pushes one entry a level for 40 levels the walk holds every
  push and finds the closest hit, closest and any hit; a BVH that
  under-reports its depth makes the plain walk raise on the push that
  finds its stack full, never drop it; the wrappers refuse a stack beyond
  the kernels' largest (``MAX_STACK``) with ValueError naming the depth
  and take one entry fewer;
- the wrappers' input checks;
- the engine's routing: "auto" takes the kernels on a scene with wide
  tables and the binary walk on one without, "xla" the binary walk,
  "pallas" on a scene without wide tables raises.
"""

import numpy as np
import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.bvh import BvhArrays
from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import traversal as T
from rtjax_torch.render import trace
from rtjax_torch.scene.scene import SceneBuilder

LEVELS = 40
NEAR_LEVEL = 35
DEEP_T = 45.0    # the closest hit of down_rays() on deep_bvh()


def deep_tree(levels=LEVELS, near_level=NEAR_LEVEL):
    """A binary BVH whose walk pushes one entry a level: pair k holds the
    chain node A_k (children: pair k + 1) and a side node B_k (children:
    two one-triangle leaves); every box holds the whole scene, so a ray
    down +z visits every node and, the entries being equal, descends A_k
    and pushes B_k.  The triangles of B_k's leaves lie across the ray at
    z = 100 + k, those of ``near_level`` at z = -5, the bottom pair's at
    z = 200.  Returns ``(bmin, bmax, left_first, num_prims, p0, e1, e2, n,
    depth)`` as NumPy arrays and the tree's depth."""
    lf, npr, zs = [0], [0], []

    def alloc():
        lf.extend([0, 0])
        npr.extend([0, 0])
        return len(lf) - 2

    def leaf_pair(z):
        q = alloc()
        for j in range(2):
            lf[q + j], npr[q + j] = len(zs), 1
            zs.append(z + 0.01 * j)
        return q

    pair = alloc()
    lf[0] = pair
    for k in range(levels):
        a, b = pair, pair + 1
        lf[b] = leaf_pair(-5.0 if k == near_level else 100.0 + k)
        if k + 1 < levels:
            pair = alloc()
            lf[a] = pair
        else:
            lf[a] = leaf_pair(200.0)
    m = len(lf)
    bmin = np.full((m, 3), -1000.0, np.float32)
    bmax = np.full((m, 3), 1000.0, np.float32)
    z = np.asarray(zs, np.float32)
    one = np.ones_like(z)
    p0 = np.stack([-one, -one, z], 1)
    p1 = np.stack([3 * one, -one, z], 1)
    p2 = np.stack([-one, 3 * one, z], 1)
    e1, e2 = p0 - p1, p2 - p0
    return (bmin, bmax, np.asarray(lf, np.int32), np.asarray(npr, np.int32),
            p0, e1, e2, np.cross(e1, e2), levels + 1)


def deep_bvh(device="cpu", max_depth=None, **kw):
    """:func:`deep_tree` as the port's ``(BvhArrays, Triangles)`` on
    ``device``; ``max_depth`` overrides the depth the BVH reports."""
    *arrays, depth = deep_tree(**kw)
    t = lambda a: torch.tensor(a, device=device)
    bvh = BvhArrays(*(t(a) for a in arrays[:4]),
                    max_depth=depth if max_depth is None else max_depth)
    return bvh, Triangles(*(t(a) for a in arrays[4:]))


def down_rays(n=4):
    """``n`` rays down +z through the deep tree's triangles."""
    o = np.tile(np.float32([[0.2, 0.3, -50.0]]), (n, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (n, 1))
    return o, d


def _args(device="cpu", n=4):
    o, d = down_rays(n)
    return (torch.tensor(o, device=device), torch.tensor(d, device=device),
            torch.full((n,), np.inf, device=device))


def test_deep_tree_holds_every_push():
    bvh, tris = deep_bvh()
    assert bvh.max_depth == LEVELS + 1
    assert T.stack_len(bvh, 30) == LEVELS + 2
    active = torch.ones(4, dtype=torch.bool)
    work = T.new_work()
    hit, t, _, _, prim, _, st = T.traverse_closest_ref(
        bvh, tris, *_args(), active, stack_size=30, with_stats=True,
        work=work)
    assert bool(hit.all())
    np.testing.assert_allclose(t.numpy(), DEEP_T)
    assert bool((tris.p0[prim.long(), 2] == -5.0).all())
    # a ray steps down the 40 chain pairs, into the bottom leaf pair, then
    # pops the 40 side nodes and steps into each one's leaf pair: 81 steps
    # and 41 leaf pairs
    assert (work["steps"], work["leafs"]) == (4 * (2 * LEVELS + 1),
                                              4 * 2 * (LEVELS + 1))
    assert (int(st[0]), int(st[1])) == (work["steps"], work["leafs"])
    occ = T.traverse_anyhit(bvh, tris, *_args()[:2],
                            torch.full((4,), DEEP_T + 1.0),
                            torch.full((4,), -1, dtype=torch.int32),
                            active, stack_size=30)
    assert bool(occ.all())
    short = T.traverse_anyhit(bvh, tris, *_args()[:2],
                              torch.full((4,), DEEP_T - 1.0),
                              torch.full((4,), -1, dtype=torch.int32),
                              active, stack_size=30)
    assert not bool(short.any())


def test_push_beyond_the_stack_raises():
    """A BVH that under-reports its depth: the plain walk raises on the
    push that finds its stack full rather than dropping it."""
    bvh, tris = deep_bvh(max_depth=20)
    with pytest.raises(RuntimeError, match="stack full"):
        T.traverse_closest(bvh, tris, *_args(),
                           torch.ones(4, dtype=torch.bool), stack_size=30)


def test_wrappers_refuse_a_stack_beyond_the_kernels():
    bvh, tris = deep_bvh(max_depth=T.MAX_STACK)
    active = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match=f"depth {T.MAX_STACK}"):
        T.traverse_closest(bvh, tris, *_args(), active)
    with pytest.raises(ValueError, match=f"depth {T.MAX_STACK}"):
        T.traverse_anyhit(bvh, tris, *_args(),
                          torch.full((4,), -1, dtype=torch.int32), active)
    with pytest.raises(ValueError, match="stack size 500"):
        T.traverse_closest(*deep_bvh(), *_args(), active, stack_size=500)
    # one entry fewer is taken
    bvh, tris = deep_bvh(max_depth=T.MAX_STACK - 1)
    assert T.stack_len_checked(bvh, 30) == T.MAX_STACK == 454
    assert bool(T.traverse_closest(bvh, tris, *_args(), active)[0].all())


def _soup(n=64, seed=7, max_leaf=4):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.4, 0.4, (n, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.4, 0.4, (n, 3))).astype(np.float32)
    res = build_bvh(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0,
                    max_leaf_size=max_leaf)
    pp0, pp1, pp2 = p0[res.perm], p1[res.perm], p2[res.perm]
    return res.to_device("cpu"), Triangles.from_vertices(pp0, pp1, pp2,
                                                         "cpu")


def test_wrappers_reject_bad_inputs():
    bvh, tris = _soup()
    o, d, tmax = _args(n=16)
    active = torch.ones(16, dtype=torch.bool)
    with pytest.raises(TypeError):
        T.traverse_closest(bvh, tris, o.double(), d, tmax, active)
    with pytest.raises(ValueError, match="shape"):
        T.traverse_closest(bvh, tris, o, d, tmax[:8], active)
    with pytest.raises(TypeError):
        T.traverse_anyhit(bvh, tris, o, d, tmax,
                          torch.zeros(16, dtype=torch.int64), active)
    with pytest.raises(ValueError, match="tris.n"):
        bad = Triangles(tris.p0, tris.e1, tris.e2, tris.n.t().contiguous())
        T.traverse_closest(bvh, bad, o, d, tmax, active)


def _quad_scene(**build):
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    return b.build("cpu", **build)


@pytest.mark.parametrize("traversal, leaf, mode", [
    ("auto", 8, "pallas"), ("pallas", 8, "pallas"), ("xla", 8, "xla"),
    ("auto", None, "xla"), ("xla", None, "xla")])
def test_traversal_modes_resolve(traversal, leaf, mode):
    scene = _quad_scene(max_leaf_size=leaf)
    assert trace.resolve_mode(scene, RenderConfig(traversal=traversal)) \
        == mode


def test_pallas_without_wide_tables_raises():
    scene = _quad_scene(max_leaf_size=None)
    with pytest.raises(ValueError, match="max_leaf_size <= 8"):
        trace.resolve_mode(scene, RenderConfig(traversal="pallas"))


# ------------------------------------------------- the fetch design (records)

def shifted_bvh(bvh, tris):
    """``bvh`` with one unused leaf inserted at node 1, so that every pair
    starts at an even id: the walk is the same, the records need the map
    from pairs to node ids."""
    lf, npr = bvh.left_first.clone(), bvh.num_prims
    lf[npr == 0] += 1
    pad = lambda a, v: torch.cat([a[:1], v, a[1:]])
    return BvhArrays(pad(bvh.bmin, torch.full((1, 3), 7.0)),
                     pad(bvh.bmax, torch.full((1, 3), 8.0)),
                     pad(lf, torch.zeros(1, dtype=torch.int32)),
                     pad(npr, torch.ones(1, dtype=torch.int32)),
                     max_depth=bvh.max_depth), tris


def unpack(rec, num_nodes):
    """The node arrays the records hold, back in node ids: ``(bmin, bmax,
    left_first, num_prims)`` with the rows of nodes in no pair (the root,
    unused nodes) NaN / -1, and ``(p0, e1, e2, n)``."""
    bits = rec.pairs.view(torch.int32)
    left = rec.pair_left
    bmin = torch.full((num_nodes, 3), float("nan"))
    bmax = torch.full((num_nodes, 3), float("nan"))
    lf = torch.full((num_nodes,), -1, dtype=torch.int32)
    npr = torch.full((num_nodes,), -1, dtype=torch.int32)
    for side in (0, 1):
        node = left + side
        bmin[node] = rec.pairs[:, 6 * side:6 * side + 3]
        bmax[node] = rec.pairs[:, 6 * side + 3:6 * side + 6]
        word, count = bits[:, 12 + 2 * side], bits[:, 13 + 2 * side]
        npr[node] = count
        inner = left[torch.where(count > 0, 0, word).long()]
        lf[node] = torch.where(count > 0, word, inner.to(torch.int32))
    lf[0] = left[rec.root]
    tri = rec.tris.view(-1, 4, 3)
    return (bmin, bmax, lf, npr), tuple(tri[:, k] for k in range(4))


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _trees():
    return {"soup leaf 1": _soup(max_leaf=1), "soup leaf 4": _soup(),
            "soup leaf 8": _soup(n=300, max_leaf=8),
            "deep": deep_bvh(), "deep shifted": shifted_bvh(*deep_bvh()),
            "soup shifted": shifted_bvh(*_soup(n=200))}


@pytest.mark.parametrize("name", list(_trees()))
def test_records_unpack_to_the_arrays(name):
    """Every pair record holds its children's boxes and words bit for bit
    (an internal child's word mapped back through ``pair_left``), the root
    word its children's pair, every triangle record p0, e1, e2, n; every
    index in int64."""
    bvh, tris = _trees()[name]
    rec = T.pack_records(bvh, tris)
    inner = bvh.num_prims == 0
    assert rec.pairs.shape == (int(inner.sum()), T.PAIR_WORDS)
    assert rec.tris.shape == (tris.num, T.TRI_WORDS)
    assert rec.pair_left.dtype == torch.int64
    assert torch.equal(rec.pair_left,
                       torch.sort(bvh.left_first[inner].long()).values)
    (bmin, bmax, lf, npr), tri = unpack(rec, bvh.num_nodes)
    in_pair = torch.zeros(bvh.num_nodes, dtype=torch.bool)
    in_pair[rec.pair_left] = True
    in_pair[rec.pair_left + 1] = True
    assert _same_bits(bmin[in_pair], bvh.bmin[in_pair])
    assert _same_bits(bmax[in_pair], bvh.bmax[in_pair])
    assert torch.equal(npr[in_pair], bvh.num_prims[in_pair])
    assert torch.equal(lf[in_pair], bvh.left_first[in_pair])
    assert int(lf[0]) == int(bvh.left_first[0])
    for got, want in zip(tri, (tris.p0, tris.e1, tris.e2, tris.n)):
        assert _same_bits(got.contiguous(), want)
    shifted = name.endswith("shifted")
    assert bool((rec.pair_left % 2 == 0).all()) == shifted
    assert bool((rec.pair_left % 2 == 1).all()) != shifted


def test_shifted_tree_walks_the_same():
    """The shifted tree is the same tree: the plain walks agree with the
    original's, hits and counts."""
    bvh, tris = _soup(n=200)
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.uniform(-2, 2, (256, 3)).astype(np.float32))
    d = torch.tensor(rng.normal(size=(256, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    tmax, active = torch.full((256,), np.inf), torch.ones(256, dtype=bool)
    want = T.traverse_closest(bvh, tris, o, d, tmax, active,
                              with_stats=True)
    got = T.traverse_closest(*shifted_bvh(bvh, tris), o, d, tmax, active,
                             with_stats=True)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    assert [int(v) for v in got[6]] == [int(v) for v in want[6]]
    assert bool(want[0].any())


def test_records_are_packed_once_and_dropped_with_the_tree():
    bvh, tris = _soup()
    rec = T.binary_records(bvh, tris)
    assert T.binary_records(bvh, tris) is rec
    key = (id(bvh), id(tris))
    assert T._records[key] is rec
    del bvh
    assert key not in T._records
    assert rec.nbytes == (rec.pairs.numel() + rec.tris.numel()) * 4


def test_records_of_a_scene_past_the_prim_cap(monkeypatch):
    """A mesh past ``accel.wide.PRIM_CAP`` (patched small) has no wide
    tables and takes the binary walk: its records, the scene's and the
    BLAS's, unpack to their arrays."""
    from rtjax_torch.accel import wide
    from rtjax_torch.scene.transform import Transform, translate
    monkeypatch.setattr(wide, "PRIM_CAP", 8)
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    rng = np.random.default_rng(2)
    for _ in range(12):
        p = rng.uniform(-1, 1, (3, 3))
        b.add_triangles(p[0], p[1], p[2], white)
    v = rng.uniform(-0.2, 0.2, (30, 3))
    mid = b.register_mesh(v, np.arange(30).reshape(10, 3))
    b.add_instance(mid, white, Transform(translate(0.3, 0, 0)))
    scene = b.build("cpu")
    assert scene.tables is None and scene.blas[0].tables is None
    assert trace.resolve_mode(scene, RenderConfig()) == "xla"
    for bvh, tris in ((scene.bvh, scene.tris),
                      (scene.blas[0].bvh, scene.blas[0].tris)):
        rec = T.binary_records(bvh, tris)
        (bmin, _, lf, npr), tri = unpack(rec, bvh.num_nodes)
        kids = torch.cat([rec.pair_left, rec.pair_left + 1])
        assert torch.equal(lf[kids], bvh.left_first[kids])
        assert torch.equal(npr[kids], bvh.num_prims[kids])
        assert _same_bits(bmin[kids], bvh.bmin[kids])
        assert _same_bits(tri[3].contiguous(), tris.n)


@pytest.mark.parametrize("n_stack", [1, 31, 96, T.MAX_STACK])
def test_launch_shared_memory_holds_the_stack(n_stack):
    """A block of either design holds ``n_stack`` int32 entries for each of
    its 128 thread slots, within the card's 227 KB a block; ``MAX_STACK``
    is the most that fit, and the wrappers refuse more."""
    assert T.smem_bytes(n_stack) == 4 * n_stack * 128
    assert T.smem_bytes(n_stack) <= T.SMEM_MAX
    assert T.smem_bytes(T.MAX_STACK + 1) > T.SMEM_MAX
    bvh, _ = deep_bvh(max_depth=n_stack - 1)
    assert T.stack_len_checked(bvh, 1) == n_stack


def test_thread_wrappers_take_the_plain_version_on_cpu():
    bvh, tris = _soup()
    o, d, tmax = _args(n=16)
    active = torch.ones(16, dtype=torch.bool)
    before = dict(T.REF_CALLS)
    want = T.traverse_closest(bvh, tris, o, d, tmax, active)
    got = T.traverse_closest_thread(bvh, tris, o, d, tmax, active)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = T.traverse_anyhit_thread(bvh, tris, o, d, tmax,
                                   torch.full((16,), -1, dtype=torch.int32),
                                   active)
    assert occ.dtype == torch.bool
    assert T.REF_CALLS["closest"] == before["closest"] + 2
    assert T.REF_CALLS["anyhit"] == before["anyhit"] + 1
    assert T.THREAD_LAUNCHES == {"closest": 0, "anyhit": 0}
