"""rtjax_torch on a CUDA device: the hand-written kernels (persistent
walkers, two-level, packet and lane group walks) against their plain
PyTorch versions, and the engine's main path through the kernels,
single-level and instanced, under every walker.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernel and plain version walk the same visit order and round the same
operations (the kernels build with --fmad=false), so they must agree bit
for bit, ties included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.wide import build_wide_tables
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.render.wavefront import render_frame
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, rotate, scale, translate
from rtjax_torch.scenes import cornell_planes

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _soup_tables(width, device):
    """Wide tables of 300 random triangles."""
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    res = build_bvh(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0,
                    max_leaf_size=8, min_leaf_size=8)
    pp0, e1, e2 = p0[res.perm], (p0 - p1)[res.perm], (p2 - p0)[res.perm]
    return build_wide_tables(res, pp0, e1, e2, np.cross(e1, e2), device,
                             width=width)


def _rays(n, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    o = tuple(torch.rand(n, generator=g, device=device) * 4 - 2
              for _ in range(3))
    d = torch.randn(3, n, generator=g, device=device)
    d = d / d.norm(dim=0)
    active = torch.rand(n, generator=g, device=device) > 0.1
    exclude = torch.randint(-1, 300, (n,), generator=g, device=device,
                            dtype=torch.int32)
    return o, tuple(d[k].contiguous() for k in range(3)), active, exclude


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("tmax_v", [float("inf"), 0.7], ids=["inf", "0.7"])
def test_kernels_equal_plain_versions(cuda, width, tmax_v):
    tables = _soup_tables(width, cuda)
    assert tables.width == width
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), tmax_v, device=cuda)
    args = (tables, o, d, tmax, active)
    k_out = P.persist_traverse_closest(*args)
    p_out = P.persist_traverse_closest_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(k_out[:3] + k_out[3], p_out[:3] + p_out[3]):
        assert torch.equal(a, b)
    assert int(k_out[0].sum()) > 300
    args = (tables, o, d, tmax, exclude, active)
    occ = P.persist_traverse_anyhit(*args)
    assert torch.equal(occ, P.persist_traverse_anyhit_ref(*args))
    assert not bool(occ[~active].any())


GROUP_WALKS = {
    "packet": (WD.PACKET, WD.wide_traverse_closest, WD.wide_traverse_anyhit),
    "lane": (L.LANE, L.lane_traverse_closest, L.lane_traverse_anyhit),
}


@pytest.mark.parametrize("walk", ["packet", "lane"])
@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("tmax_v", [float("inf"), 0.7], ids=["inf", "0.7"])
def test_group_kernels_equal_plain_version(cuda, walk, width, tmax_v):
    """The packet and lane kernels against the plain group walk at their
    group size: 6,444 rays end in a partial group of either size, 10% of
    them dead, and a whole dead packet."""
    group, closest, anyhit = GROUP_WALKS[walk]
    tables = _soup_tables(width, cuda)
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    active[256:512] = False
    tmax = torch.full((n,), tmax_v, device=cuda)
    launches = dict(WD.LAUNCHES), dict(L.LAUNCHES)
    k_out = closest(tables, o, d, tmax, active)
    p_out = WD.group_traverse_closest_ref(tables, o, d, tmax, active, group)
    torch.cuda.synchronize()
    for a, b in zip(k_out[:3] + k_out[3], p_out[:3] + p_out[3]):
        assert torch.equal(a, b)
    assert int(k_out[0].sum()) > 300
    dead = ~active
    assert not bool(k_out[0][dead].any())
    assert bool((k_out[1][dead] == P.BIG).all())
    assert bool((k_out[2][dead] == -1).all())
    # hits and t are the persistent walkers' (the prim of a tie may differ)
    want = P.persist_traverse_closest(tables, o, d, tmax, active)
    assert torch.equal(k_out[0], want[0]) and torch.equal(k_out[1], want[1])
    args = (tables, o, d, tmax, exclude, active)
    occ = anyhit(*args)
    assert torch.equal(occ, WD.group_traverse_anyhit_ref(*args, group))
    assert torch.equal(occ, P.persist_traverse_anyhit(*args))
    assert not bool(occ[dead].any())
    count = WD.LAUNCHES if walk == "packet" else L.LAUNCHES
    before = launches[0] if walk == "packet" else launches[1]
    assert count == {k: v + 1 for k, v in before.items()}


def test_group_kernels_take_any_depth(cuda):
    """A stack sized beyond the persist walkers' (the group's stack lives
    in shared memory, sized from the tree depth)."""
    tables = dataclasses.replace(_soup_tables(8, cuda), depth=4 * P.STACK)
    n = 2048
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    for group, closest, anyhit in GROUP_WALKS.values():
        k_out = closest(tables, o, d, tmax, active)
        p_out = WD.group_traverse_closest_ref(tables, o, d, tmax, active,
                                              group)
        torch.cuda.synchronize()
        assert torch.equal(k_out[1], p_out[1])
        args = (tables, o, d, tmax, exclude, active)
        assert torch.equal(anyhit(*args),
                           WD.group_traverse_anyhit_ref(*args, group))


@pytest.mark.parametrize("walker, anyhit_walker", [
    ("packet", "packet"), ("lane", "auto")])
def test_walkers_run_through_their_kernels(cuda, walker, anyhit_walker):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, walker=walker,
                       anyhit_walker=anyhit_walker)
    counters = (P.LAUNCHES, WD.LAUNCHES, L.LAUNCHES)
    before = [dict(c) for c in counters]
    refs = dict(P.REF_CALLS), dict(WD.REF_CALLS)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert (P.REF_CALLS, WD.REF_CALLS) == refs
    its = stats["iterations"]
    ran = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
    if walker == "packet":
        assert ran == [{"closest": 0, "anyhit": 0},
                       {"closest": its, "anyhit": its},
                       {"closest": 0, "anyhit": 0}]
    else:
        assert ran == [{"closest": 0, "anyhit": its},
                       {"closest": 0, "anyhit": 0},
                       {"closest": its, "anyhit": 0}]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())


def test_kernels_refuse_mixed_devices(cuda):
    tables = _soup_tables(8, cuda)
    o, d, active, _ = _rays(64, torch.device("cpu"))
    with pytest.raises(ValueError, match="tables on cuda"):
        P.persist_traverse_closest(tables, o, d, torch.ones(64), active)


def test_main_path_runs_through_the_kernels(cuda):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096)
    launches, refs = dict(P.LAUNCHES), dict(P.REF_CALLS)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert P.REF_CALLS == refs
    for k in ("closest", "anyhit"):
        assert P.LAUNCHES[k] - launches[k] == stats["iterations"]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert stats["rays_traced"] >= 32 * 32 * 8


def _instanced(device, n_inst=24):
    """A floor and light under ``n_inst`` placements (rotated, scaled) of
    one 300-triangle soup."""
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    mats = [b.make_matte((0.6, 0.1, 0.1)), b.make_matte((0.1, 0.5, 0.2))]
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_triangles([-3, 0, 3], [-3, 0, -3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    v = rng.uniform(-0.3, 0.3, (900, 3)) + [0.0, 0.35, 0.0]
    mid = b.register_mesh(v, np.arange(900).reshape(300, 3))
    for i in range(n_inst):
        t = Transform(scale(1.0, 0.5 + 0.1 * (i % 5), 1.0))
        t.composite(rotate([0, 1, 0], 0.61 * i))
        t.composite(translate((i % 6) * 0.9 - 2.25, 0.0,
                              (i // 6) * 0.9 - 1.35))
        b.add_instance(mid, mats[i % 2], t)
    return b.build(device)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_two_level_kernels_equal_plain_versions(cuda, monkeypatch, width):
    if width == 8:
        # a 16-wide node cap below the concatenated node count: base and
        # BLAS rebuild 8-wide
        monkeypatch.setattr("rtjax_torch.accel.wide.MAX_NODES16", 2)
        monkeypatch.setattr("rtjax_torch.scene.scene.MAX_NODES16", 2)
    it = _instanced(cuda).inst_tables
    assert it.wide.width == width and it.num_instances == 25
    n = 3 * 2048 + 300
    o, d, active, _ = _rays(n, cuda)
    o = (o[0] * 1.5, o[1].abs() * 0.4 + 0.02, o[2] * 1.5)
    g = torch.Generator(device=cuda).manual_seed(9)
    exclude = torch.randint(-1, 3, (n,), generator=g, device=cuda,
                            dtype=torch.int32)
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        args = (it, o, d, tmax, active)
        k_out = WI.wide_traverse_closest_inst(*args)
        p_out = WI.wide_traverse_closest_inst_ref(*args)
        torch.cuda.synchronize()
        for a, b in zip(k_out[:4] + k_out[4], p_out[:4] + p_out[4]):
            assert torch.equal(a, b)
        assert int((k_out[3] > 0).sum()) > 300
        assert not bool(k_out[0][~active].any())
        args = (it, o, d, tmax, exclude, active)
        occ = WI.wide_traverse_anyhit_inst(*args)
        assert torch.equal(occ, WI.wide_traverse_anyhit_inst_ref(*args))
        assert int(occ.sum()) > 300 and not bool(occ[~active].any())


def test_two_level_kernels_refuse_mixed_devices(cuda):
    it = _instanced(cuda, n_inst=2).inst_tables
    o, d, active, _ = _rays(64, torch.device("cpu"))
    with pytest.raises(ValueError, match="tables on cuda"):
        WI.wide_traverse_closest_inst(it, o, d, torch.ones(64), active)
    cpu_root = dataclasses.replace(it, root=it.root.cpu())
    o, d, active, _ = _rays(64, cuda)
    with pytest.raises(ValueError, match="root is on cpu"):
        WI.wide_traverse_closest_inst(cpu_root, o, d,
                                      torch.ones(64, device=cuda), active)


@pytest.mark.parametrize("strategy", ["auto", "repass", "kernel"])
def test_instanced_render_runs_through_the_kernels(cuda, strategy):
    scene = _instanced(cuda)
    cam = Camera.make((0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, two_level=strategy)
    counts = lambda: (dict(P.LAUNCHES), dict(WI.LAUNCHES),
                      dict(P.REF_CALLS), dict(WI.REF_CALLS))
    p0, w0, pr0, wr0 = counts()
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    p1, w1, pr1, wr1 = counts()
    assert (pr1, wr1) == (pr0, wr0)  # no plain version ran
    its = stats["iterations"]
    for k in ("closest", "anyhit"):
        if strategy == "kernel":
            assert w1[k] - w0[k] == its and p1[k] == p0[k]
        else:
            # one base launch per iteration, then the BLAS passes
            assert p1[k] - p0[k] > its and w1[k] == w0[k]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert stats["rays_traced"] >= 32 * 32 * 8
