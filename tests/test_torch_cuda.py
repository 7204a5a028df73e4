"""rtjax_torch on a CUDA device: the hand-written kernels (persistent
walkers, two-level, packet and lane kernels, each in both designs, the
binary-BVH walk, the tiny-scene direct pair, the step's stable key sort
and the TPU probes' counterparts) against their plain PyTorch versions,
and the engine's main path through the kernels,
single-level and instanced, under every walker, under
``traversal="xla"`` and on the direct path; and the frame loop's captured
CUDA graph against the same loop run op by op.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Kernel and plain version walk the same visit order and round the same
operations (the kernels build with --fmad=false), so they must agree bit
for bit, ties included.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtjax_torch import RenderConfig
from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.wide import build_wide_tables
from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import _build
from rtjax_torch.kernels import direct as D
from rtjax_torch.kernels import probes as PR
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import traversal as T
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import sort as SO
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.probes import micro_kernel as PMK
from rtjax_torch.probes import stage_bench as PSB
from rtjax_torch.render import trace
from rtjax_torch.render.wavefront import render_frame
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, rotate, scale, translate
from rtjax_torch.scenes import cornell_planes

import direct_cases
from test_torch_binary_launch import DEEP_T, deep_bvh, down_rays
from test_torch_persist_work import chain_rays, chain_tables

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import sort_designs  # noqa: E402

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
    # the first design still computes the same
    k_out = P.persist_traverse_closest_stride(tables, o, d, tmax, active)
    for a, b in zip(k_out[:3] + k_out[3], p_out[:3] + p_out[3]):
        assert torch.equal(a, b)
    assert torch.equal(P.persist_traverse_anyhit_stride(*args), occ)


def _counter_zeroed(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    torch.cuda.synchronize()
    return not bool(P.work_buffer(device, stream).any())


def _check_persist(tables, o, d, tmax, active, exclude):
    """Both fetch kernels and both stride kernels against the plain
    versions, bit for bit, dead lanes included; the work counter zero
    after every launch."""
    args = (tables, o, d, tmax, active)
    want = P.persist_traverse_closest_ref(*args)
    for fn in (P.persist_traverse_closest, P.persist_traverse_closest_stride):
        got = fn(*args)
        assert _counter_zeroed(tmax.device)
        for a, b in zip(got[:3] + got[3], want[:3] + want[3]):
            assert torch.equal(a, b)
    dead = ~active
    assert not bool(want[0][dead].any())
    assert bool((want[1][dead] == P.BIG).all())
    assert bool((want[2][dead] == -1).all())
    assert not any(bool(c[dead].any()) for c in want[3])
    args = (tables, o, d, tmax, exclude, active)
    want = P.persist_traverse_anyhit_ref(*args)
    for fn in (P.persist_traverse_anyhit, P.persist_traverse_anyhit_stride):
        assert torch.equal(fn(*args), want)
        assert _counter_zeroed(tmax.device)
    assert not bool(want[dead].any())


def _resident_threads():
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("size", ["one", "ragged", "refill"])
def test_fetch_kernels_equal_plain_versions(cuda, width, size):
    """One ray; a count that is not a multiple of 32; more rays than four
    times the resident threads, so lanes draw again and again.  Inactive
    rays scattered (10%) and in long runs (the first 4,097 and a run in
    the middle)."""
    tables = _soup_tables(width, cuda)
    n = {"one": 1, "ragged": 5 * 2048 + 17,
         "refill": 4 * _resident_threads() + 4099}[size]
    o, d, active, exclude = _rays(n, cuda)
    if n > 1:
        active[:4097] = False
        active[n // 2:n // 2 + 3001] = False
    else:
        active[:] = True
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        _check_persist(tables, o, d, tmax, active, exclude)


def test_fetch_counter_resets_itself(cuda):
    """Back-to-back launches on one stream with no synchronisation between
    them: each finds the work counter zeroed by the one before."""
    tables = _soup_tables(16, cuda)
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    want_c = P.persist_traverse_closest_ref(tables, o, d, tmax, active)
    want_a = P.persist_traverse_anyhit_ref(tables, o, d, tmax, exclude,
                                           active)
    outs = []
    for _ in range(3):
        outs.append(P.persist_traverse_closest(tables, o, d, tmax, active))
        outs.append(P.persist_traverse_anyhit(tables, o, d, tmax, exclude,
                                              active))
    torch.cuda.synchronize()
    for c, a in zip(outs[::2], outs[1::2]):
        assert torch.equal(c[1], want_c[1]) and torch.equal(c[2], want_c[2])
        assert torch.equal(a, want_a)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not bool(P.work_buffer(cuda, stream).any())


def test_fetch_kernels_take_every_stack_length(cuda):
    """Stacks of 1-64 entries: the shared-memory stack grows with
    tables.depth, past the default 48 KB of shared memory at 64; then back
    down and up again, so that a launch must find its shared-memory cap
    raised for its own size, not lowered by a smaller one before it."""
    base = _soup_tables(8, cuda)
    n = 4096
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    for depth in (base.depth, 40, P.STACK - 1, 49, P.STACK - 1):
        tables = dataclasses.replace(base, depth=depth)
        assert P.stack_len(tables) == depth + 1
        _check_persist(tables, o, d, tmax, active, exclude)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("size", ["ragged", "refill"])
def test_stats_kernels_count_the_plain_walk(cuda, width, size):
    """The stats instances: node visits and leaf rows equal to the plain
    walk's work count as integers, results bit for bit those of the
    default instances, for closest and any hit, with rays drawn again and
    again (refill) and inactive runs; launches counted in STATS_LAUNCHES
    alone; the work counter zero after every launch."""
    tables = _soup_tables(width, cuda)
    n = {"ragged": 5 * 2048 + 17,
         "refill": 4 * _resident_threads() + 4099}[size]
    o, d, active, exclude = _rays(n, cuda)
    active[n // 2:n // 2 + 3001] = False
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        args = (tables, o, d, tmax, active)
        work = P.new_work()
        P.persist_traverse_closest_ref(*args, work=work)
        base = P.persist_traverse_closest(*args)
        before = dict(P.LAUNCHES), dict(P.STATS_LAUNCHES)
        *got, (steps, leafs) = P.persist_traverse_closest(*args,
                                                          with_stats=True)
        assert _counter_zeroed(cuda)
        assert P.LAUNCHES == before[0]
        assert P.STATS_LAUNCHES["closest"] == before[1]["closest"] + 1
        assert steps.dtype == torch.int64 and steps.device == tmax.device
        assert (int(steps), int(leafs)) == (work["node_visits"],
                                            work["leaf_rows"])
        for a, b in zip(got[:3] + list(got[3]), base[:3] + base[3]):
            assert torch.equal(a, b)
        args = (tables, o, d, tmax, exclude, active)
        work = P.new_work()
        P.persist_traverse_anyhit_ref(*args, work=work)
        occ = P.persist_traverse_anyhit(*args)
        occ2, (steps, leafs) = P.persist_traverse_anyhit(*args,
                                                         with_stats=True)
        assert _counter_zeroed(cuda)
        assert torch.equal(occ, occ2) and bool(occ.any())
        assert (int(steps), int(leafs)) == (work["node_visits"],
                                            work["leaf_rows"])


def test_stats_kernels_count_nothing_for_no_rays(cuda):
    """An all-inactive batch takes no step: zero counts, dead results."""
    tables = _soup_tables(16, cuda)
    o, d, active, exclude = _rays(700, cuda)
    active[:] = False
    tmax = torch.full((700,), float("inf"), device=cuda)
    hit, t, prim, _, (steps, leafs) = P.persist_traverse_closest(
        tables, o, d, tmax, active, with_stats=True)
    assert int(steps) == int(leafs) == 0 and not bool(hit.any())
    occ, (steps, leafs) = P.persist_traverse_anyhit(
        tables, o, d, tmax, exclude, active, with_stats=True)
    assert int(steps) == int(leafs) == 0 and not bool(occ.any())


def test_detailed_stats_frame_runs_the_stats_kernels(cuda):
    """A detailed_stats frame launches only the stats instances, renders
    the default frame's image at the same seed within atomics' reordering
    of the framebuffer sums, and its histogram sums to the path rays."""
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0)
    launches, stats_l = dict(P.LAUNCHES), dict(P.STATS_LAUNCHES)
    fb, st = render_frame(scene, cam, dataclasses.replace(
        cfg, detailed_stats=True), torch.Generator(device=cuda).manual_seed(1))
    assert P.LAUNCHES == launches
    for k in ("closest", "anyhit"):
        assert P.STATS_LAUNCHES[k] - stats_l[k] == st["iterations"]
    fb0, st0 = render_frame(scene, cam, cfg,
                            torch.Generator(device=cuda).manual_seed(1))
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-6)
    assert st0["rays_traced"] == st["rays_traced"]
    assert st["node_steps"] > st["anyhit_steps"] > 0
    assert st["leaf_visits"] > st["anyhit_visits"] > 0
    assert int(st["bounce_histogram"][0]) == 32 * 32 * 8


# name -> (group, closest, any hit, any-hit rule of the plain walk, launches)
GROUP_WALKS = {
    "packet": (WD.PACKET, WD.wide_traverse_closest, WD.wide_traverse_anyhit,
               True, WD.LAUNCHES),
    "leader": (WD.LEADER_PACKET, WD.wide_traverse_closest_leader,
               WD.wide_traverse_anyhit_leader, False, WD.LEADER_LAUNCHES),
    "lane": (L.LANE, L.lane_traverse_closest, L.lane_traverse_anyhit, True,
             L.LAUNCHES),
    "lane_group": (L.LANE, L.lane_traverse_closest_group,
                   L.lane_traverse_anyhit_group, False, L.GROUP_LAUNCHES),
}


def _check_group(walk, tables, o, d, tmax, active, exclude):
    """One group-walk kernel pair against the plain group walk, bit for
    bit, dead lanes included, and against the persist plain versions' hits,
    t and occlusion; each kernel launched once; the work counter zero after
    the lane design's launches."""
    group, closest, anyhit, first, launches = GROUP_WALKS[walk]
    before = dict(launches)
    k_out = closest(tables, o, d, tmax, active)
    p_out = WD.group_traverse_closest_ref(tables, o, d, tmax, active, group)
    torch.cuda.synchronize()
    assert _counter_zeroed(tmax.device)
    for a, b in zip(k_out[:3] + k_out[3], p_out[:3] + p_out[3]):
        assert torch.equal(a, b)
    dead = ~active
    assert not bool(k_out[0][dead].any())
    assert bool((k_out[1][dead] == P.BIG).all())
    assert bool((k_out[2][dead] == -1).all())
    assert not any(bool(c[dead].any()) for c in k_out[3])
    # hits and t are the persistent walk's (the prim of a tie may differ)
    want = P.persist_traverse_closest_ref(tables, o, d, tmax, active)
    assert torch.equal(k_out[0], want[0]) and torch.equal(k_out[1], want[1])
    args = (tables, o, d, tmax, exclude, active)
    occ = anyhit(*args)
    assert torch.equal(occ, WD.group_traverse_anyhit_ref(
        *args, group, decide_first=first))
    assert torch.equal(occ, P.persist_traverse_anyhit_ref(*args))
    assert not bool(occ[dead].any())
    assert _counter_zeroed(tmax.device)
    assert launches == {k: v + 1 for k, v in before.items()}
    return k_out, occ


@pytest.mark.parametrize("walk", ["packet", "leader", "lane", "lane_group"])
@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("tmax_v", [float("inf"), 0.7], ids=["inf", "0.7"])
def test_group_kernels_equal_plain_version(cuda, walk, width, tmax_v):
    """The packet and lane kernels (both designs of each) against the
    plain group walk at their group size: 6,444 rays end in a partial group
    of either size, 10% of them dead, and a whole dead packet."""
    tables = _soup_tables(width, cuda)
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    active[256:512] = False
    tmax = torch.full((n,), tmax_v, device=cuda)
    k_out, _ = _check_group(walk, tables, o, d, tmax, active, exclude)
    assert int(k_out[0].sum()) > 300


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("n", [1, 127, 129, 700, 5 * 256 + 3])
def test_packet_kernels_take_ragged_batches(cuda, width, n):
    """Partial last packets, and dead packets: rays 256-511 inactive (whole
    packets at 64, 128 and 256 rays), and at 700 rays every ray past 600."""
    tables = _soup_tables(width, cuda)
    o, d, active, exclude = _rays(n, cuda, seed=7)
    active[256:512] = False
    if n == 700:
        active[600:] = False
    tmax = torch.full((n,), float("inf"), device=cuda)
    _check_group("packet", tables, o, d, tmax, active, exclude)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_packet_kernels_fill_the_stack(cuda, width):
    """A chain of 80 wide nodes (past the persist stack's 64 levels) that
    fills the packet's child-id stack to its (depth + 1) * (width - 1)
    entries before the first pop."""
    tables = chain_tables(width, 80, cuda)
    assert tables.depth + 1 > P.STACK
    n = 3 * WD.PACKET + 5
    o, d, act, ex = chain_rays(n, cuda)
    work = P.new_work()
    WD.group_traverse_closest_ref(tables, o, d, torch.full(
        (n,), float("inf"), device=cuda), act, WD.PACKET, work=work)
    assert work["stack_peak"] == WD.packet_stack_len(tables)
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        k_out, occ = _check_group("packet", tables, o, d, tmax, act, ex)
        # the triangle lies at t = 1.5
        assert bool(k_out[0].all()) == bool(occ.all()) == (tmax_v > 1.5)
        assert bool(k_out[0].any()) == (tmax_v > 1.5)


def test_group_kernels_take_any_depth(cuda):
    """Stacks sized beyond the persist walkers' (each group's stack lives
    in shared memory, sized from the tree depth): large, small, larger (the
    packet stacks past 48 KB at depth 700), small and larger again, so that
    a launch must find its shared-memory cap raised for its own size; a
    depth whose packet block passes the card's shared memory is refused
    before launch, and the next launch runs."""
    base = _soup_tables(16, cuda)
    n = 2048
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    for depth in (4 * P.STACK, base.depth, 700, base.depth, 700):
        tables = dataclasses.replace(base, depth=depth)
        for walk in GROUP_WALKS:
            _check_group(walk, tables, o, d, tmax, active, exclude)
    assert 48 * 1024 < WD.packet_smem_bytes(tables) <= WD.SMEM_OPTIN
    deep = dataclasses.replace(base, depth=1000)
    with pytest.raises(ValueError, match="shared memory"):
        WD.wide_traverse_closest(deep, o, d, tmax, active)
    _check_group("packet", base, o, d, tmax, active, exclude)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
@pytest.mark.parametrize("n", [1, 31, 33, 700, 5 * 256 + 3])
def test_lane_kernels_take_ragged_batches(cuda, width, n):
    """Partial last groups, dead groups (rays 256-511 inactive: eight whole
    warps), and at 700 rays every ray past 600; more groups than one
    block's warps, so warps draw again."""
    tables = _soup_tables(width, cuda)
    o, d, active, exclude = _rays(n, cuda, seed=7)
    active[256:512] = False
    if n == 700:
        active[600:] = False
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        _check_group("lane", tables, o, d, tmax, active, exclude)


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_lane_kernels_fill_the_stack(cuda, width):
    """A chain of 80 wide nodes that fills each warp's child-id stack to
    its (depth + 1) * (width - 1) entries before the first pop."""
    tables = chain_tables(width, 80, cuda)
    n = 3 * L.LANE + 5
    o, d, act, ex = chain_rays(n, cuda)
    work = P.new_work()
    WD.group_traverse_closest_ref(tables, o, d, torch.full(
        (n,), float("inf"), device=cuda), act, L.LANE, work=work)
    assert work["stack_peak"] == L.lane_stack_len(tables)
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        k_out, occ = _check_group("lane", tables, o, d, tmax, act, ex)
        assert bool(k_out[0].all()) == bool(occ.all()) == (tmax_v > 1.5)
        assert bool(k_out[0].any()) == (tmax_v > 1.5)


def test_lane_kernels_take_any_depth_they_hold(cuda):
    """Stacks that leave a block its LANE_WARPS warps (depth 440 at width
    16), seven (441) and one (3,830, the deepest a block holds), small
    again and deep again, so that a launch must find its shared-memory cap
    raised for its own size; one level deeper is refused before launch, and
    the next launch runs."""
    base = _soup_tables(16, cuda)
    n = 2048
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    for depth, warps in ((440, L.LANE_WARPS), (441, 7), (3830, 1),
                         (base.depth, L.LANE_WARPS), (3830, 1)):
        tables = dataclasses.replace(base, depth=depth)
        assert L.launch_shape(tables)[1] == warps
        _check_group("lane", tables, o, d, tmax, active, exclude)
    deep = dataclasses.replace(base, depth=3831)
    assert not L.fits(deep)
    with pytest.raises(ValueError, match="shared memory"):
        L.lane_traverse_closest(deep, o, d, tmax, active)
    assert _counter_zeroed(cuda)
    _check_group("lane", base, o, d, tmax, active, exclude)


def test_lane_walker_past_its_depth_takes_the_packet_kernels(cuda,
                                                             monkeypatch):
    """Where a warp's stack does not fit a block (the limit lowered here),
    ``walker="lane"`` warns and traces with the packet kernels, which find
    the persist walk's hits."""
    import types
    tables = _soup_tables(16, cuda)
    monkeypatch.setattr(L, "SMEM_OPTIN", L.warp_bytes(tables) - 16)
    assert not L.fits(tables)
    n = 3000
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    # the soup's 300 triangles, above direct_max_tris
    sc = types.SimpleNamespace(instances=None, tables=tables,
                               tris=types.SimpleNamespace(num=300))
    before = dict(L.LAUNCHES), dict(WD.LAUNCHES)
    with pytest.warns(UserWarning, match="packet walker"):
        hit, t, *_ = trace.trace_closest(sc, RenderConfig(walker="lane"), o,
                                         d, tmax, active)
    assert (dict(L.LAUNCHES), WD.LAUNCHES["closest"]) == \
        (before[0], before[1]["closest"] + 1)
    want = P.persist_traverse_closest_ref(tables, o, d, tmax, active)
    assert torch.equal(hit, want[0]) and torch.equal(t[hit], want[1][hit])


def test_lane_persist_and_two_level_share_the_counter(cuda):
    """Lane, persist and two-level launches interleaved on one stream with
    no synchronisation between them: each finds the shared work counter
    zeroed by the one before."""
    scene = _instanced(cuda)
    it, base = scene.inst_tables, scene.tables
    n = 3 * 2048 + 300
    o, d, active, exclude = _inst_rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    lc = WD.group_traverse_closest_ref(base, o, d, tmax, active, L.LANE)
    la = P.persist_traverse_anyhit_ref(base, o, d, tmax, exclude, active)
    pc = P.persist_traverse_closest_ref(base, o, d, tmax, active)
    ic = WI.wide_traverse_closest_inst_ref(it, o, d, tmax, active)
    outs = []
    for _ in range(3):
        outs.append(L.lane_traverse_closest(base, o, d, tmax, active))
        outs.append(P.persist_traverse_closest(base, o, d, tmax, active))
        outs.append(L.lane_traverse_anyhit(base, o, d, tmax, exclude,
                                           active))
        outs.append(WI.wide_traverse_closest_inst(it, o, d, tmax, active))
    torch.cuda.synchronize()
    for k in range(3):
        c, p, a, i = outs[4 * k:4 * k + 4]
        assert torch.equal(c[1], lc[1]) and torch.equal(c[2], lc[2])
        assert torch.equal(p[1], pc[1]) and torch.equal(a, la)
        assert torch.equal(i[1], ic[1]) and torch.equal(i[3], ic[3])
    assert _counter_zeroed(cuda)


@pytest.mark.parametrize("walker, anyhit_walker", [
    ("packet", "packet"), ("lane", "auto")])
def test_walkers_run_through_their_kernels(cuda, walker, anyhit_walker):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, walker=walker,
                       anyhit_walker=anyhit_walker, direct_max_tris=0)
    counters = (P.LAUNCHES, WD.LAUNCHES, L.LAUNCHES, WD.LEADER_LAUNCHES,
                L.GROUP_LAUNCHES)
    before = [dict(c) for c in counters]
    refs = dict(P.REF_CALLS), dict(WD.REF_CALLS)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert (P.REF_CALLS, WD.REF_CALLS) == refs
    its = stats["iterations"]
    ran = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
    none = {"closest": 0, "anyhit": 0}
    if walker == "packet":
        assert ran == [none, {"closest": its, "anyhit": its}, none, none,
                       none]
    else:
        assert ran == [{"closest": 0, "anyhit": its}, none,
                       {"closest": its, "anyhit": 0}, none, none]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())


def test_kernels_refuse_mixed_devices(cuda):
    tables = _soup_tables(8, cuda)
    o, d, active, _ = _rays(64, torch.device("cpu"))
    with pytest.raises(ValueError, match="tables on cuda"):
        P.persist_traverse_closest(tables, o, d, torch.ones(64), active)


def test_main_path_runs_through_the_kernels(cuda):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0)
    launches, refs = dict(P.LAUNCHES), dict(P.REF_CALLS)
    stride = dict(P.STRIDE_LAUNCHES)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert P.REF_CALLS == refs and P.STRIDE_LAUNCHES == stride
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


def _check_two_level(it, o, d, tmax, active, exclude):
    """Both two-level kernels in the fetch design and in the first (stride)
    design against the plain versions, bit for bit in hit, t, prim, inst,
    normal and occlusion, dead lanes included; the work counter zero after
    every launch.  Returns the plain closest-hit results and occlusion."""
    args = (it, o, d, tmax, active)
    want = WI.wide_traverse_closest_inst_ref(*args)
    for fn in (WI.wide_traverse_closest_inst,
               WI.wide_traverse_closest_inst_stride):
        got = fn(*args)
        assert _counter_zeroed(tmax.device)
        for a, b in zip(got[:4] + got[4], want[:4] + want[4]):
            assert torch.equal(a, b)
    dead = ~active
    assert not bool(want[0][dead].any())
    assert bool((want[1][dead] == P.BIG).all())
    assert bool((want[2][dead] == -1).all())
    assert not bool(want[3][dead].any())
    assert not any(bool(c[dead].any()) for c in want[4])
    args = (it, o, d, tmax, exclude, active)
    occ = WI.wide_traverse_anyhit_inst_ref(*args)
    for fn in (WI.wide_traverse_anyhit_inst,
               WI.wide_traverse_anyhit_inst_stride):
        assert torch.equal(fn(*args), occ)
        assert _counter_zeroed(tmax.device)
    assert not bool(occ[dead].any())
    return want, occ


def _inst_rays(n, device, seed=3, spread=1.5):
    o, d, active, _ = _rays(n, device, seed)
    o = (o[0] * spread, o[1].abs() * 0.4 + 0.02, o[2] * spread)
    g = torch.Generator(device=device).manual_seed(seed + 6)
    exclude = torch.randint(-1, 3, (n,), generator=g, device=device,
                            dtype=torch.int32)
    return o, d, active, exclude


@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_two_level_kernels_equal_plain_versions(cuda, monkeypatch, width):
    """Both designs at both widths on a base and a BLAS of other depths,
    10% of the rays dead and a run of 500 dead in the middle."""
    if width == 8:
        # a 16-wide node cap below the concatenated node count: base and
        # BLAS rebuild 8-wide
        monkeypatch.setattr("rtjax_torch.accel.wide.MAX_NODES16", 2)
        monkeypatch.setattr("rtjax_torch.scene.scene.MAX_NODES16", 2)
    scene = _instanced(cuda)
    it = scene.inst_tables
    assert it.wide.width == width and it.num_instances == 25
    assert scene.tables.depth != scene.blas[0].tables.depth
    assert WI.launch_shape(it)[1]
    n = 3 * 2048 + 300
    o, d, active, exclude = _inst_rays(n, cuda)
    active[3000:3500] = False
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        want, occ = _check_two_level(it, o, d, tmax, active, exclude)
        assert int((want[3] > 0).sum()) > 300
        assert int(occ.sum()) > 300


def test_two_level_kernels_take_every_stack_length(cuda):
    """Stacks from the smallest that fits to 64 entries (past the default
    48 KB of shared memory), then back down and up again: a launch must
    find its shared-memory cap raised for its own size."""
    it = _instanced(cuda, n_inst=6).inst_tables
    n = 4096
    o, d, active, exclude = _inst_rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    for depth in (it.wide.depth, 40, P.STACK - 1, 49, P.STACK - 1):
        deeper = dataclasses.replace(
            it, wide=dataclasses.replace(it.wide, depth=depth))
        assert WI.launch_shape(deeper)[0] == depth + 1
        _check_two_level(deeper, o, d, tmax, active, exclude)


def test_two_level_kernels_resolve_ties(cuda):
    """Coincident instances: equal entry distances (visited in index
    order) and equal t in several instances (the last visited keeps the
    hit), as the plain versions resolve them."""
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    v = np.random.default_rng(5).uniform(-0.3, 0.3, (900, 3)) + [0, 0.35, 0]
    mid = b.register_mesh(v, np.arange(900).reshape(300, 3))
    for i in range(6):
        b.add_instance(mid, white, Transform(translate(0.0, 0.0, 0.0)))
    it = b.build(cuda).inst_tables
    n = 4096
    o, d, active, exclude = _inst_rays(n, cuda, spread=0.2)
    tmax = torch.full((n,), float("inf"), device=cuda)
    want, _ = _check_two_level(it, o, d, tmax, active, exclude)
    assert int((want[3] == it.num_instances - 1).sum()) > 100


@pytest.mark.parametrize("n_inst, staged", [(2400, True), (3100, False)],
                         ids=["staged", "global"])
def test_two_level_kernels_take_any_instance_count(cuda, n_inst, staged):
    """Records staged in shared memory up to the card's opt-in limit per
    block (2,400 need 182 KB), read from global memory past it (3,100
    need 236 KB)."""
    b = SceneBuilder()
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    v = np.random.default_rng(5).uniform(-0.05, 0.05, (60, 3))
    mid = b.register_mesh(v, np.arange(60).reshape(20, 3))
    for i in range(n_inst):
        b.add_instance(mid, white, Transform(translate(
            (i % 50) * 0.12 - 3.0, 0.1 + 0.05 * (i // 50 % 4),
            (i // 50) * 0.09 - 3.0)))
    it = b.build(cuda).inst_tables
    assert WI.launch_shape(it)[1] == staged
    assert (WI.smem_bytes(it, True) > 48 * 1024) and \
        (WI.smem_bytes(it, True) > WI.SMEM_OPTIN) == (not staged)
    n = 4096
    o, d, active, exclude = _inst_rays(n, cuda, spread=3.0)
    tmax = torch.full((n,), float("inf"), device=cuda)
    want, _ = _check_two_level(it, o, d, tmax, active, exclude)
    assert int((want[3] > 0).sum()) > 200


def test_persist_and_two_level_share_the_counter(cuda):
    """Persist and two-level launches interleaved on one stream with no
    synchronisation between them: each finds the shared work counter
    zeroed by the one before."""
    scene = _instanced(cuda)
    it, base = scene.inst_tables, scene.tables
    n = 3 * 2048 + 300
    o, d, active, exclude = _inst_rays(n, cuda)
    tmax = torch.full((n,), float("inf"), device=cuda)
    pc = P.persist_traverse_closest_ref(base, o, d, tmax, active)
    pa = P.persist_traverse_anyhit_ref(base, o, d, tmax, exclude, active)
    ic = WI.wide_traverse_closest_inst_ref(it, o, d, tmax, active)
    ia = WI.wide_traverse_anyhit_inst_ref(it, o, d, tmax, exclude, active)
    outs = []
    for _ in range(3):
        outs.append(P.persist_traverse_closest(base, o, d, tmax, active))
        outs.append(WI.wide_traverse_closest_inst(it, o, d, tmax, active))
        outs.append(P.persist_traverse_anyhit(base, o, d, tmax, exclude,
                                              active))
        outs.append(WI.wide_traverse_anyhit_inst(it, o, d, tmax, exclude,
                                                 active))
    torch.cuda.synchronize()
    for k in range(3):
        c, i, a, ia_ = outs[4 * k:4 * k + 4]
        assert torch.equal(c[1], pc[1]) and torch.equal(c[2], pc[2])
        assert torch.equal(i[1], ic[1]) and torch.equal(i[3], ic[3])
        assert torch.equal(a, pa) and torch.equal(ia_, ia)
    assert _counter_zeroed(cuda)


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
                       num_working_paths=4096, two_level=strategy,
                       direct_max_tris=0)
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


# ------------------------------------------------------ binary-BVH walk

def _soup_bvh(device, max_leaf=4):
    """The binary BVH and leaf-order triangles of _soup_tables' 300
    triangles, built with ``max_leaf``."""
    from rtjax_torch.core.geometry import Triangles
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.4, 0.4, (300, 3))).astype(np.float32)
    res = build_bvh(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0,
                    max_leaf_size=max_leaf)
    p = res.perm
    return res.to_device(device), Triangles.from_vertices(p0[p], p1[p],
                                                          p2[p], device)


def _binary_equal(bvh, tris, o, d, tmax, active, exclude):
    """Both binary kernels (the fetch design), their stats instances and
    the first design's kernels against the plain versions, bit for bit;
    the counts equal; the stream's work counter left zeroed."""
    work = T.new_work()
    ref = T.traverse_closest_ref(bvh, tris, o, d, tmax, active, work=work)
    got = T.traverse_closest(bvh, tris, o, d, tmax, active)
    sgot = T.traverse_closest(bvh, tris, o, d, tmax, active, with_stats=True)
    first = T.traverse_closest_thread(bvh, tris, o, d, tmax, active)
    for a, b, c, e in zip(got[:5], ref[:5], sgot[:5], first[:5]):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, e)
    for a, b, c, e in zip(got[5], ref[5], sgot[5], first[5]):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, e)
    assert (int(sgot[6][0]), int(sgot[6][1])) == (work["steps"],
                                                  work["leafs"])
    dead = ~active
    assert not bool(got[0][dead].any()) and bool(torch.isinf(got[1][dead])
                                                 .all())
    assert bool((got[4][dead] == -1).all())
    work = T.new_work()
    occ_ref = T.traverse_anyhit_ref(bvh, tris, o, d, tmax, exclude, active,
                                    work=work)
    occ = T.traverse_anyhit(bvh, tris, o, d, tmax, exclude, active)
    occ_s, st = T.traverse_anyhit(bvh, tris, o, d, tmax, exclude, active,
                                  with_stats=True)
    occ_t = T.traverse_anyhit_thread(bvh, tris, o, d, tmax, exclude, active)
    assert torch.equal(occ, occ_ref) and torch.equal(occ, occ_s)
    assert torch.equal(occ, occ_t)
    assert (int(st[0]), int(st[1])) == (work["steps"], work["leafs"])
    assert not bool(occ[dead].any())
    stream = torch.cuda.current_stream(tmax.device).cuda_stream
    assert not bool(P.work_buffer(tmax.device, stream).any())
    return got, occ


@pytest.mark.parametrize("max_leaf", [1, 4, None], ids=str)
@pytest.mark.parametrize("tmax_v", [float("inf"), 0.7], ids=["inf", "0.7"])
def test_binary_kernels_equal_plain_versions(cuda, max_leaf, tmax_v):
    bvh, tris = _soup_bvh(cuda, max_leaf)
    n = 5 * T.BLOCK + 77
    o, d, active, exclude = _rays(n, cuda)
    tmax = torch.full((n,), tmax_v, device=cuda)
    calls = dict(T.LAUNCHES), dict(T.STATS_LAUNCHES)
    got, occ = _binary_equal(bvh, tris, o, d, tmax, active, exclude)
    assert bool(got[0].any()) and bool(occ.any())
    assert T.LAUNCHES == {k: v + 1 for k, v in calls[0].items()}
    assert T.STATS_LAUNCHES == {k: v + 1 for k, v in calls[1].items()}


@pytest.mark.parametrize("n", [1, 31, 127, 129, 3000])
def test_binary_kernels_take_ragged_batches(cuda, n):
    bvh, tris = _soup_bvh(cuda)
    o, d, active, exclude = _rays(n, cuda, seed=5)
    _binary_equal(bvh, tris, o, d, torch.full((n,), 1.5, device=cuda),
                  active, exclude)


@pytest.mark.parametrize("levels", [40, 300])
def test_binary_kernels_hold_every_push(cuda, levels):
    """The deep tree pushes one entry a level: 42 and 302 entries of stack
    (the second above 48 KB of shared memory a block)."""
    bvh, tris = deep_bvh(cuda, levels=levels)
    assert T.stack_len(bvh) == levels + 2
    o, d = down_rays(200)
    args = (torch.tensor(o, device=cuda), torch.tensor(d, device=cuda),
            torch.full((200,), float("inf"), device=cuda))
    active = torch.ones(200, dtype=torch.bool, device=cuda)
    hit, t, *_ = T.traverse_closest(bvh, tris, *args, active)
    torch.cuda.synchronize()
    assert bool(hit.all()) and bool((t == DEEP_T).all())
    _binary_equal(bvh, tris, *args, active,
                  torch.full((200,), -1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("tree", ["deep", "soup"])
def test_binary_kernels_walk_a_tree_whose_pairs_need_the_map(cuda, tree):
    """Pairs at even node ids (an unused node at 1): the records map them,
    and both designs still equal the plain versions."""
    from rtjax_torch.accel.bvh import BvhArrays
    from rtjax_torch.core.geometry import Triangles
    from test_torch_binary_launch import shifted_bvh
    if tree == "deep":
        bvh, tris = shifted_bvh(*deep_bvh())
        o, d = (torch.tensor(a, device=cuda) for a in down_rays(300))
        active = torch.ones(300, dtype=torch.bool, device=cuda)
        exclude = torch.full((300,), -1, dtype=torch.int32, device=cuda)
    else:
        bvh, tris = shifted_bvh(*_soup_bvh("cpu"))
        o, d, active, exclude = _rays(700, cuda, seed=9)
    bvh = BvhArrays(*(a.to(cuda) for a in (bvh.bmin, bvh.bmax,
                                           bvh.left_first, bvh.num_prims)),
                    max_depth=bvh.max_depth)
    tris = Triangles(*(a.to(cuda) for a in (tris.p0, tris.e1, tris.e2,
                                            tris.n)))
    assert bool((T.binary_records(bvh, tris).pair_left % 2 == 0).all())
    n = active.shape[0]
    got, _ = _binary_equal(bvh, tris, o, d,
                           torch.full((n,), float("inf"), device=cuda),
                           active, exclude)
    assert bool(got[0].any())


def test_binary_and_persist_launches_share_one_work_counter(cuda):
    """Fetch-design binary launches between persist launches on one
    stream: each draws from the stream's counter and leaves it zeroed."""
    bvh, tris = _soup_bvh(cuda)
    tables = _soup_tables(8, cuda)
    n = 4000
    o, d, active, exclude = _rays(n, cuda, seed=4)
    tmax = torch.full((n,), float("inf"), device=cuda)
    want = T.traverse_closest_ref(bvh, tris, o, d, tmax, active)
    for _ in range(3):
        P.persist_traverse_closest(tables, o, d, tmax, active)
        got = T.traverse_closest(bvh, tris, o, d, tmax, active)
        assert all(torch.equal(a, b) for a, b in zip(got[:5], want[:5]))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    torch.cuda.synchronize()
    assert not bool(P.work_buffer(cuda, stream).any())


def test_binary_kernels_refuse_deeper_trees(cuda):
    bvh, tris = deep_bvh(cuda, max_depth=T.MAX_STACK)
    o, d = down_rays()
    with pytest.raises(ValueError, match=f"depth {T.MAX_STACK}"):
        T.traverse_closest(bvh, tris, torch.tensor(o, device=cuda),
                           torch.tensor(d, device=cuda),
                           torch.full((4,), float("inf"), device=cuda),
                           torch.ones(4, dtype=torch.bool, device=cuda))


def test_xla_frame_runs_through_the_binary_kernels(cuda):
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, traversal="xla")
    before = dict(T.LAUNCHES), dict(P.LAUNCHES)
    refs = dict(T.REF_CALLS), dict(P.REF_CALLS)
    fb, stats = render_frame(scene, cam, cfg,
                             torch.Generator(device=cuda).manual_seed(1))
    assert (dict(T.REF_CALLS), dict(P.REF_CALLS)) == refs
    assert P.LAUNCHES == before[1]
    for k in ("closest", "anyhit"):
        assert T.LAUNCHES[k] - before[0][k] == stats["iterations"]
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())


# ------------------------------------- stats instances of the group walks

# walk -> (group, closest, any hit, stats launches)
STATS_WALKS = {
    "packet": (WD.PACKET, WD.wide_traverse_closest, WD.wide_traverse_anyhit,
               WD.STATS_LAUNCHES),
    "lane": (L.LANE, L.lane_traverse_closest, L.lane_traverse_anyhit,
             L.STATS_LAUNCHES),
}


def _counts_equal(got, work):
    steps, leafs = got
    assert steps.dtype == torch.int64 and steps.device.type == "cuda"
    assert (int(steps), int(leafs)) == (work["node_visits"],
                                        work["leaf_rows"])


@pytest.mark.parametrize("walk", ["packet", "lane"])
@pytest.mark.parametrize("width", [8, 16], ids=["w8", "w16"])
def test_group_stats_kernels_count_the_plain_walk(cuda, walk, width):
    """The packet and lane kernels' stats instances: node visits and leaf
    rows equal to the plain group walk's work count, results bit for bit
    the default instances', a partial last group and a dead run included;
    launches counted in STATS_LAUNCHES alone."""
    group, closest, anyhit, stats_launches = STATS_WALKS[walk]
    launches = GROUP_WALKS[walk][4]
    tables = _soup_tables(width, cuda)
    n = 3 * 2048 + 300
    o, d, active, exclude = _rays(n, cuda)
    active[256:512] = False
    for tmax_v in (float("inf"), 0.7):
        tmax = torch.full((n,), tmax_v, device=cuda)
        args = (tables, o, d, tmax, active)
        work = P.new_work()
        WD.group_traverse_closest_ref(*args, group, work=work)
        base = closest(*args)
        before = dict(launches), dict(stats_launches)
        *got, st = closest(*args, with_stats=True)
        assert _counter_zeroed(cuda)
        assert launches == before[0]
        assert stats_launches["closest"] == before[1]["closest"] + 1
        _counts_equal(st, work)
        for a, b in zip(got[:3] + list(got[3]), base[:3] + base[3]):
            assert torch.equal(a, b)
        args = (tables, o, d, tmax, exclude, active)
        work = P.new_work()
        WD.group_traverse_anyhit_ref(*args, group, work=work)
        occ, st = anyhit(*args, with_stats=True)
        assert _counter_zeroed(cuda)
        assert stats_launches["anyhit"] == before[1]["anyhit"] + 1
        assert torch.equal(occ, anyhit(*args)) and bool(occ.any())
        _counts_equal(st, work)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "global"])
def test_two_level_stats_kernels_count_the_plain_walk(cuda, monkeypatch,
                                                      staged):
    """The two-level kernels' stats instances, records staged and read from
    global memory (the opt-in limit lowered below them): node visits and
    leaf rows of every BLAS walk equal to the plain two-level walk's,
    results bit for bit the default instances'."""
    it = _instanced(cuda).inst_tables
    if not staged:
        monkeypatch.setattr(WI, "SMEM_OPTIN", WI.smem_bytes(it, False))
    assert WI.launch_shape(it)[1] == staged
    n = 3 * 2048 + 300
    o, d, active, exclude = _inst_rays(n, cuda)
    active[3000:3500] = False
    tmax = torch.full((n,), float("inf"), device=cuda)
    args = (it, o, d, tmax, active)
    work = P.new_work()
    WI.wide_traverse_closest_inst_ref(*args, work=work)
    base = WI.wide_traverse_closest_inst(*args)
    before = dict(WI.LAUNCHES), dict(WI.STATS_LAUNCHES)
    *got, st = WI.wide_traverse_closest_inst(*args, with_stats=True)
    assert _counter_zeroed(cuda)
    assert WI.LAUNCHES == before[0]
    assert WI.STATS_LAUNCHES["closest"] == before[1]["closest"] + 1
    _counts_equal(st, work)
    for a, b in zip(got[:4] + list(got[4]), base[:4] + base[4]):
        assert torch.equal(a, b)
    args = (it, o, d, tmax, exclude, active)
    work = P.new_work()
    WI.wide_traverse_anyhit_inst_ref(*args, work=work)
    occ, st = WI.wide_traverse_anyhit_inst(*args, with_stats=True)
    assert _counter_zeroed(cuda)
    assert torch.equal(occ, WI.wide_traverse_anyhit_inst(*args))
    _counts_equal(st, work)


@pytest.mark.parametrize("change, runs", [
    (dict(walker="packet", anyhit_walker="packet"),
     {"packet_stats": ("closest", "anyhit")}),
    (dict(walker="lane"), {"lane_stats": ("closest",),
                           "persist_stats": ("anyhit",)}),
    (dict(two_level="kernel"), {"two_level_stats": ("closest", "anyhit")}),
], ids=["packet", "lane", "two_level"])
def test_detailed_stats_frames_run_the_walkers_stats_kernels(cuda, change,
                                                             runs):
    """A detailed_stats frame under each walker (and under the two-level
    kernels) launches only its kernels' stats instances, once an
    iteration, and renders the default frame's image within atomics'
    reordering of the framebuffer sums."""
    counters = {"persist": P.LAUNCHES, "persist_stats": P.STATS_LAUNCHES,
                "packet": WD.LAUNCHES, "packet_stats": WD.STATS_LAUNCHES,
                "lane": L.LAUNCHES, "lane_stats": L.STATS_LAUNCHES,
                "two_level": WI.LAUNCHES,
                "two_level_stats": WI.STATS_LAUNCHES}
    if "two_level" in change:
        scene = _instanced(cuda)
        cam = Camera.make((0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0,
                          device=cuda)
    else:
        scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0, **change)
    before = {k: dict(c) for k, c in counters.items()}
    fb, st = render_frame(scene, cam, dataclasses.replace(
        cfg, detailed_stats=True), torch.Generator(device=cuda).manual_seed(1))
    its = st["iterations"]
    for k, c in counters.items():
        for kind in ("closest", "anyhit"):
            want = its if kind in runs.get(k, ()) else 0
            assert c[kind] - before[k][kind] == want, (k, kind)
    fb0, st0 = render_frame(scene, cam, cfg,
                            torch.Generator(device=cuda).manual_seed(1))
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-6)
    assert st0["rays_traced"] == st["rays_traced"]
    assert st["node_steps"] > st["anyhit_steps"] > 0
    assert st["leaf_visits"] > st["anyhit_visits"] > 0


def test_sharded_world_of_one_on_the_card(cuda):
    """rtjax_torch.parallel without a process group on the card: the
    unsharded frame from the same seed, bit for bit in its counts."""
    from rtjax_torch.parallel import make_mesh, render_frame_sharded
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096)
    mesh = make_mesh()
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())
    fb, st = render_frame_sharded(scene, cam, cfg,
                                  torch.Generator(device=cuda).manual_seed(3),
                                  mesh)
    fb0, st0 = render_frame(scene, cam, cfg,
                            torch.Generator(device=cuda).manual_seed(3))
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-6)
    assert st == {"iterations": st0["iterations"],
                  "rays_traced": st0["rays_traced"]}


# ------------------------------------ the all-triangles oracle, big scenes

def _brute_scene(device):
    """Wide tables, binary BVH and leaf-order triangles of one 3,000-
    triangle soup, built by the scene builder."""
    b = SceneBuilder()
    mat = b.make_matte((0.5, 0.5, 0.5))
    rng = np.random.default_rng(11)
    p0 = rng.uniform(-1, 1, (3000, 3))
    b.add_triangles(p0, p0 + rng.uniform(-0.3, 0.3, (3000, 3)),
                    p0 + rng.uniform(-0.3, 0.3, (3000, 3)), mat)
    return b.build(device)


def _ties_ok(tris, o, d, tmax, got_prim, want_prim, want_t):
    """Where two prims differ, the one kept also hits at the oracle's t."""
    from rtjax_torch.core.geometry import intersect_triangle_v3
    diff = got_prim != want_prim
    p = got_prim[diff].long()
    g = lambda a: tuple(a[p, k] for k in range(3))
    h, t, _, _ = intersect_triangle_v3(
        tuple(o[diff, k] for k in range(3)),
        tuple(d[diff, k] for k in range(3)), tmax[diff],
        g(tris.p0), g(tris.e1), g(tris.e2), g(tris.n))
    return bool(h.all()) and torch.equal(t, want_t[diff])


@pytest.mark.parametrize("walk", ["persist", "packet", "lane", "binary"])
def test_kernels_match_the_brute_oracle(cuda, walk):
    """Every traversal kernel against rtjax_torch.kernels.brute over all
    triangles: hit, t and occlusion equal, prim equal but at ties of
    equal t."""
    from rtjax_torch.kernels import brute
    scene = _brute_scene(cuda)
    n = 4096
    o3, d3, active, _ = _rays(n, cuda)
    o, d = torch.stack(o3, 1), torch.stack(d3, 1)
    tmax = torch.where(torch.arange(n, device=cuda) % 3 == 0, 0.7,
                       float("inf"))
    bh, bt, _, _, bp, _ = brute.closest_brute(scene.tris, o, d, tmax,
                                              active)
    kernels = {"persist": (P.persist_traverse_closest,
                           P.persist_traverse_anyhit, P.LAUNCHES),
               "packet": (WD.wide_traverse_closest, WD.wide_traverse_anyhit,
                          WD.LAUNCHES),
               "lane": (L.lane_traverse_closest, L.lane_traverse_anyhit,
                        L.LAUNCHES)}
    calls = dict(P.REF_CALLS), dict(WD.REF_CALLS), dict(T.REF_CALLS)
    if walk == "binary":
        before = dict(T.LAUNCHES)
        h, t, _, _, p, _ = T.traverse_closest(scene.bvh, scene.tris, o, d,
                                              tmax, active)
        partial_anyhit = lambda ex: T.traverse_anyhit(
            scene.bvh, scene.tris, o, d, tmax, ex, active)
        counter = T.LAUNCHES
    else:
        closest, anyhit_fn, counter = kernels[walk]
        before = dict(counter)
        h, t, p, _ = closest(scene.tables, o, d, tmax, active)
        partial_anyhit = lambda ex: anyhit_fn(scene.tables, o, d, tmax, ex,
                                              active)
    assert torch.equal(h, bh) and int(h.sum()) > 500
    assert torch.equal(t[h], bt[h])
    assert _ties_ok(scene.tris, o[h], d[h], tmax[h], p[h], bp[h], bt[h])
    exclude = torch.where(torch.arange(n, device=cuda) % 2 == 0, bp, -1)
    occ = partial_anyhit(exclude)
    assert torch.equal(occ, brute.anyhit_brute(scene.tris, o, d, tmax,
                                               exclude, active))
    assert counter == {k: v + 1 for k, v in before.items()}
    assert (dict(P.REF_CALLS), dict(WD.REF_CALLS), dict(T.REF_CALLS)) \
        == calls


def test_scene_past_the_meta_cap_renders_on_the_kernels(cuda, monkeypatch):
    """The meta cap patched below the Cornell planes' rows: the mirror
    lanes are NaN and the frame runs through the persist kernels with the
    unpatched scene's iterations and rays."""
    from rtjax_torch.accel import wide
    full, cam = cornell_planes(cuda)
    monkeypatch.setattr(wide, "META_CAP", 1)
    cut, _ = cornell_planes(cuda)
    w = cut.tables.width
    assert bool(torch.isnan(cut.tables.node_bounds[:, 6 * w:7 * w + 1]).all())
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0)
    runs = []
    for scene in (full, cut):
        launches, refs = dict(P.LAUNCHES), dict(P.REF_CALLS)
        fb, stats = render_frame(scene, cam, cfg,
                                 torch.Generator(device=cuda).manual_seed(1))
        assert P.REF_CALLS == refs
        for k in ("closest", "anyhit"):
            assert P.LAUNCHES[k] - launches[k] == stats["iterations"]
        assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
        runs.append((fb, stats))
    same = ("iterations", "rays_traced", "avg_occupancy")
    assert [{k: r[1][k] for k in same} for r in runs[1:]] == \
        [{k: runs[0][1][k] for k in same}]
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-4, atol=1e-5)


# ------------------------------------------------- the direct pair

def _direct_soup(n_tris, device):
    """``n_tris`` random triangles in [-1, 1]^3, the last few copies of
    the first (coincident: ties at equal t)."""
    rng = np.random.default_rng(n_tris)
    p0 = rng.uniform(-1, 1, (n_tris, 3))
    p1 = p0 + rng.uniform(-0.6, 0.6, (n_tris, 3))
    p2 = p0 + rng.uniform(-0.6, 0.6, (n_tris, 3))
    k = n_tris // 8
    for a in (p0, p1, p2):
        a[n_tris - k:] = a[:k]
    return Triangles.from_vertices(p0, p1, p2, device)


@pytest.mark.parametrize("n_tris", [1, 14, 64, 300])
def test_direct_kernels_equal_plain_versions(cuda, n_tris):
    """The direct pair bit for bit against its plain versions on every
    lane (hit, t, prim, normal, occlusion; dead lanes by the shared
    contract), with one tile (T <= 64) and several (300); a ragged batch;
    one launch counted a call; the counts ``(0, active x T)``."""
    tris = _direct_soup(n_tris, cuda)
    for n in (4096 + 77, 1):
        o, d, active, _ = _rays(n, cuda)
        g = torch.Generator(device=cuda).manual_seed(n_tris)
        exclude = torch.randint(-1, n_tris, (n,), generator=g, device=cuda,
                                dtype=torch.int32)
        tmax = torch.where(torch.arange(n, device=cuda) % 3 == 0, 0.9,
                           float("inf"))
        before = dict(D.LAUNCHES)
        hit, t, prim, nrm, (steps, leafs) = D.direct_closest(
            tris, o, d, tmax, active, with_stats=True)
        occ = D.direct_anyhit(tris, o, d, tmax, exclude, active)
        torch.cuda.synchronize()
        assert D.LAUNCHES == {k: v + 1 for k, v in before.items()}
        want = D.direct_closest_ref(tris, o, d, tmax, active)
        for a, b in zip((hit, t, prim) + nrm, want[:3] + want[3]):
            assert torch.equal(a, b)
        assert torch.equal(occ, D.direct_anyhit_ref(tris, o, d, tmax,
                                                    exclude, active))
        assert (int(steps), int(leafs)) == (0, int(active.sum()) * n_tris)
        assert not hit[~active].any() and not occ[~active].any()
        assert bool((t[~active] == 3.4e38).all())
        assert bool((prim[~active] == -1).all())


def test_direct_kernels_match_the_brute_oracle(cuda):
    """The direct pair keeps the oracle's triangle, ties included (both
    keep the first of least t), and its occlusion."""
    from rtjax_torch.kernels import brute
    tris = _direct_soup(64, cuda)
    n = 8192
    o3, d3, active, _ = _rays(n, cuda)
    o, d = torch.stack(o3, 1), torch.stack(d3, 1)
    tmax = torch.full((n,), float("inf"), device=cuda)
    hit, t, prim, _ = D.direct_closest(tris, o3, d3, tmax, active)
    bh, bt, _, _, bp, _ = brute.closest_brute(tris, o, d, tmax, active)
    assert torch.equal(hit, bh) and int(hit.sum()) > 500
    assert torch.equal(t[hit], bt[hit]) and torch.equal(prim[hit], bp[hit])
    exclude = torch.where(torch.arange(n, device=cuda) % 2 == 0, bp, -1)
    assert torch.equal(D.direct_anyhit(tris, o3, d3, tmax, exclude, active),
                       brute.anyhit_brute(tris, o, d, tmax, exclude, active))


@pytest.mark.parametrize("kind", direct_cases.MASKS)
@pytest.mark.parametrize("n_tris", direct_cases.TRI_COUNTS)
def test_direct_designs_equal_plain_versions_on_masks(cuda, n_tris, kind):
    """Closest hit, any hit and any hit's first design bit for bit against
    the plain versions (run on the card) on every lane, on
    tests/direct_cases.py's soups (ties, a shared edge, grazing rays,
    ``tmax`` at a hit's t, ``exclude`` the own occluder) at 0 to 300
    triangles (one shared-memory tile up to 64, several above) and under
    each activity mask: all, none, 28% scattered, one lane a warp, a live
    prefix."""
    tris, o, d, tmax, active, exclude = direct_cases.case(n_tris, kind,
                                                          cuda)
    want = D.direct_closest_ref(tris, o, d, tmax, active)
    want_occ = D.direct_anyhit_ref(tris, o, d, tmax, exclude, active)
    before = dict(D.LAUNCHES), dict(D.V1_LAUNCHES)
    got = D.direct_closest(tris, o, d, tmax, active)
    occ = D.direct_anyhit(tris, o, d, tmax, exclude, active)
    occ_v1 = D.direct_anyhit_v1(tris, o, d, tmax, exclude, active)
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x
    for a, b in zip(got[:3] + got[3], want[:3] + want[3], strict=True):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(occ, want_occ) and torch.equal(occ_v1, want_occ)
    assert D.LAUNCHES == {k: v + 1 for k, v in before[0].items()}
    assert D.V1_LAUNCHES == {k: v + 1 for k, v in before[1].items()}


def test_direct_anyhit_in_a_captured_graph(cuda):
    """The any-hit kernel (its window compaction and shared-memory tiles)
    captured in a CUDA graph and replayed on other rays gives the plain
    version's occlusion for them."""
    tris, o, d, tmax, active, exclude = direct_cases.case(300, "scattered",
                                                          cuda)
    _, o2, d2, tmax2, active2, exclude2 = direct_cases.case(
        300, "one_a_warp", cuda)
    occ = D.direct_anyhit(tris, o, d, tmax, exclude, active)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = D.direct_anyhit(tris, o, d, tmax, exclude, active)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, occ)
    for a, b in zip((*o, *d, tmax, active, exclude),
                    (*o2, *d2, tmax2, active2, exclude2)):
        a.copy_(b)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, D.direct_anyhit_ref(tris, o2, d2, tmax2,
                                                exclude2, active2))


def test_direct_kernels_refuse_mixed_devices(cuda):
    tris = _direct_soup(14, cuda)
    o, d, active, _ = _rays(64, torch.device("cpu"))
    with pytest.raises(ValueError, match="triangles on cuda"):
        D.direct_closest(tris, o, d, torch.ones(64), active)


def test_cornell_planes_frame_runs_through_the_direct_kernels(cuda):
    """Eval config 2's scene (12 triangles) at the default config: the
    direct pair once an iteration and no walker; under
    ``direct_max_tris=0`` the persist kernels, the rays traced and the
    image equal but for ties."""
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096)
    runs = []
    for change in ({}, dict(direct_max_tris=0)):
        before = dict(D.LAUNCHES), dict(P.LAUNCHES), dict(P.REF_CALLS)
        fb, st = render_frame(scene, cam, dataclasses.replace(cfg, **change),
                              torch.Generator(device=cuda).manual_seed(1))
        its = st["iterations"]
        direct = {k: D.LAUNCHES[k] - before[0][k] for k in D.LAUNCHES}
        persist = {k: P.LAUNCHES[k] - before[1][k] for k in P.LAUNCHES}
        assert P.REF_CALLS == before[2]
        on = not change
        assert direct == {k: its if on else 0 for k in direct}
        assert persist == {k: 0 if on else its for k in persist}
        assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
        runs.append((fb, st))
    # the same hits but at ties of equal t (a quad's diagonal), where the
    # walks may keep the other triangle of the quad
    (fb0, st0), (fb1, st1) = runs
    assert abs(st1["rays_traced"] / st0["rays_traced"] - 1) < 1e-3
    assert float((fb1 - fb0).abs().mean()) < 1e-3 * float(fb0.mean())


# ------------------------------------------- the captured frame loop

def _graph_vs_eager(scene, cam, cfg, seed=1):
    """A frame through the captured graph and one through the eager loop,
    same seed: both ``(fb, stats, launches, generator state)``."""
    from rtjax_torch.kernels import counts
    out = []
    for graph in (True, False):
        gen = torch.Generator(device=scene.device).manual_seed(seed)
        before = counts.snapshot()
        fb, st = render_frame(scene, cam, cfg, gen, graph=graph)
        out.append((fb, st, counts.delta(before, counts.snapshot()),
                    gen.get_state()))
    return out


def _graph_scene(kind, device):
    if kind == "instanced":
        return _instanced(device), Camera.make(
            (0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0, device=device)
    return cornell_planes(device)


@pytest.mark.parametrize("kind, change", [
    ("planes", dict(direct_max_tris=0)),
    ("planes", {}),                                   # the direct pair
    ("planes", dict(direct_max_tris=0, traversal="xla")),
    ("planes", dict(direct_max_tris=0, sort_rays=False)),
    ("planes", dict(direct_max_tris=0, sort_key="prim")),
    ("planes", dict(direct_max_tris=0, walker="packet",
                    anyhit_walker="packet")),
    ("planes", dict(direct_max_tris=0, walker="lane")),
    ("planes", dict(direct_max_tris=0, reference_parity=True)),
    ("planes", dict(direct_max_tris=0, one_sample_mis=True)),
    ("planes", dict(direct_max_tris=0, detailed_stats=True)),
    ("planes", dict(direct_max_tris=0, sort_every=3, max_iterations=13)),
    ("instanced", dict(direct_max_tris=0, two_level="kernel")),
    ("instanced", dict(direct_max_tris=0, traversal="xla")),
], ids=str)
def test_graph_frame_equals_the_eager_loop(cuda, kind, change):
    """The captured step replayed against the same loop run op by op, on
    one seed: the same iterations, rays, occupancy, counts and launches,
    the generator left in the same state, the framebuffers within the
    atomic adds' reordering (rtol 1e-5)."""
    scene, cam = _graph_scene(kind, cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, **change)
    (fb, st, ran, gs), (fb0, st0, ran0, gs0) = _graph_vs_eager(scene, cam,
                                                               cfg)
    assert st["graphed"] and not st0["graphed"]
    for k in st0:
        if k not in ("graphed", "host_reads", "bounce_histogram"):
            assert st[k] == st0[k], k
    if cfg.detailed_stats:
        assert torch.equal(st["bounce_histogram"], st0["bounce_histogram"])
    assert ran == ran0 and ran
    assert torch.equal(gs, gs0)
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(fb).all()) and float(fb.sum()) > 0


@pytest.mark.parametrize("change", [
    dict(two_level="auto"), dict(two_level="repass"),
    dict(two_level="kernel", two_level_anyhit="repass")], ids=str)
def test_repass_renders_captured(cuda, change):
    """Repass's step is captured like every other mode's, its passes as
    CUDA-graph while nodes: the graph frame against the eager loop (G
    masked passes a mesh group) on one seed, the same iterations, rays
    and occupancy, the framebuffers within rtol 1e-5; the graph launched
    fewer pass kernels (it skips the passes with no pending ray) and the
    same of every other."""
    scene, cam = _graph_scene("instanced", cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0, **change)
    (fb, st, ran, gs), (fb0, st0, ran0, gs0) = _graph_vs_eager(scene, cam,
                                                               cfg)
    assert st["graphed"] is True and st["capture_s"] > 0
    assert not st0["graphed"]
    for k in ("iterations", "rays_traced", "avg_occupancy"):
        assert st[k] == st0[k], k
    assert ran and set(ran) == set(ran0)
    assert all(0 < ran[k] <= ran0[k] for k in ran)
    assert sum(ran.values()) < sum(ran0.values())
    # beyond the first, eager step's G passes a channel, the replays'
    # while nodes counted as they ran (their device counters)
    assert any(n > scene.instances.num for (k, _), n in ran.items()
               if k == ("persist", "LAUNCHES"))
    assert torch.equal(gs, gs0)
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(fb).all()) and float(fb.sum()) > 0


@pytest.mark.parametrize("cap", [100, 3])
def test_device_loop_is_a_while_node(cuda, cap):
    """A device loop captured into a graph runs its body while the
    condition holds, at most ``n`` times a replay, and counts its runs;
    the body's temporaries come from the recorder's pool."""
    from rtjax_torch.render import device_loop
    x = torch.zeros(4, device=cuda)
    pend = torch.zeros(4, dtype=torch.bool, device=cuda)
    rec = device_loop.Recorder(cuda)
    stream = torch.cuda.Stream(cuda)
    g = torch.cuda.CUDAGraph()
    with rec.recording(), torch.cuda.graph(g, stream=stream):
        torch.lt(x, 5.0, out=pend)
        for _ in device_loop.passes(pend, cap):
            x.copy_(x + 1.0)
            torch.lt(x, 5.0, out=pend)
        y = x * 2.0
    rec.start()
    (runs, body), = rec.loops
    total = 0
    for start in (0.0, 3.0, 10.0):
        x.fill_(start)
        g.replay()
        torch.cuda.synchronize()
        want = max(start, min(5.0, start + cap))
        total += int(want - start)
        assert x.tolist() == [want] * 4 and y.tolist() == [2 * want] * 4
        assert int(runs) == total
    assert body == {}
    assert device_loop.body_stream(cuda) is rec.body_stream
    assert rec.body_stream.cuda_stream != stream.cuda_stream
    del g
    rec.release()


def test_capture_refuses_a_host_read(cuda, monkeypatch):
    """A step that reads the device from the host makes the capture raise;
    the frame is not rendered another way, and the card stays usable."""
    from rtjax_torch.render import graph
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0)
    inner = trace.persist_traverse_closest

    def reads(tables, o, d, tmax, active, **kw):
        if bool(active.any()):
            pass
        return inner(tables, o, d, tmax, active, **kw)

    graph.clear_graphs()
    monkeypatch.setattr(trace, "persist_traverse_closest", reads)
    launches = dict(P.LAUNCHES)
    with pytest.raises(RuntimeError):
        render_frame(scene, cam, cfg,
                     torch.Generator(device=cuda).manual_seed(1))
    # the eager first step ran; no replay, no eager loop after it
    assert P.LAUNCHES["closest"] - launches["closest"] == 1
    assert graph.cached().graph is None
    monkeypatch.undo()
    graph.clear_graphs()
    torch.cuda.synchronize()
    fb, st = render_frame(scene, cam, cfg,
                          torch.Generator(device=cuda).manual_seed(1))
    assert st["graphed"] and bool(torch.isfinite(fb).all())


def test_frames_after_clear_graphs_agree(cuda):
    """A captured frame, a frame replaying the cached graph and a frame
    after ``clear_graphs()`` (captured again) agree on one seed."""
    from rtjax_torch.render import graph
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096)
    graph.clear_graphs()
    frames = []
    for clear in (False, False, True):
        if clear:
            graph.clear_graphs()
        frames.append(render_frame(
            scene, cam, cfg, torch.Generator(device=cuda).manual_seed(2)))
    caps = [st["capture_s"] for _, st in frames]
    assert caps[0] > 0 and caps[1] == 0 and caps[2] > 0
    assert frames[0][1]["graph_pool_bytes"] > 0
    fb0, st0 = frames[0]
    for fb, st in frames[1:]:
        for k in ("iterations", "rays_traced", "avg_occupancy"):
            assert st[k] == st0[k], k
        torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    # the returned framebuffers are the caller's: a later frame leaves
    # them as they were
    assert not frames[0][0].data_ptr() == frames[1][0].data_ptr()


@pytest.mark.parametrize("spr", [1, 3, 16])
def test_graph_frame_at_any_chunk(cuda, monkeypatch, spr):
    """The replayed loop at STEPS_PER_READ 1, 3 and 16, also under a
    max_iterations that ends a chunk early: the eager loop's counts, and
    at most one blocking read a chunk besides the stats'."""
    import math
    from rtjax_torch.render import wavefront
    scene, cam = cornell_planes(cuda)
    monkeypatch.setattr(wavefront, "STEPS_PER_READ", spr)
    for cap in (None, 7):
        cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                           num_working_paths=2048, max_iterations=cap)
        (fb, st, ran, gs), (fb0, st0, ran0, gs0) = _graph_vs_eager(
            scene, cam, cfg, seed=4)
        assert st["graphed"] and st["iterations"] == st0["iterations"]
        assert cap is None or st["iterations"] == cap
        assert st["rays_traced"] == st0["rays_traced"] and ran == ran0
        assert torch.equal(gs, gs0)
        assert st["host_reads"] == math.ceil(st["iterations"] / spr) + 1
        torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)


# ------------------------------------------------ the fused step kernels

def _step_scene(device, env=(0.2, 0.3, 0.4), point_lights=2):
    """Matte, mirror and glass triangles, point lights and an area light,
    and an environment light: every branch of the step kernels."""
    b = SceneBuilder()
    mats = (b.make_matte((0.7, 0.6, 0.5)), b.make_mirror((0.9, 0.8, 0.9)),
            b.make_glass(1.5))
    rng = np.random.default_rng(3)
    for m in mats + mats:
        p0 = rng.uniform(-1, 1, (8, 3))
        b.add_triangles(p0, p0 + rng.uniform(-0.6, 0.6, (8, 3)),
                        p0 + rng.uniform(-0.6, 0.6, (8, 3)), m)
    for q in range(point_lights):
        b.add_point_light((0.3 * q, 1.5, 0.3), (5.0, 4.0, 3.0))
    b.add_area_light([-0.3, 1.2, -0.3], [0.3, 1.2, -0.3], [0.0, 1.2, 0.3],
                     (8, 8, 8), mats[0])
    b.set_environment(env)
    return b.build(device)


def _synthetic_state(scene, cfg, gen, device):
    """A pool of random lanes of every kind: hits and misses, dead lanes,
    dirty dead lanes (radiance still held), camera-ray hits on the light,
    lanes past max_bounces and lanes whose throughput is inf or NaN."""
    from rtjax_torch.constants import DEAD_BOUNCES
    from rtjax_torch.render.wavefront import PathState
    n = cfg.pool_size
    u = lambda: torch.rand(n, generator=gen, device=device)
    ri = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen,
                                      device=device, dtype=torch.int32)
    d = torch.randn(3, n, generator=gen, device=device)
    d = d / d.norm(dim=0)
    bounces = torch.where(u() < 0.15, DEAD_BOUNCES,
                          ri(0, cfg.max_bounces + 2))
    beta = [u() * 1.5 for _ in range(3)]
    beta[0] = torch.where(u() < 0.02, float("inf"), beta[0])
    beta[1] = torch.where(u() < 0.02, float("nan"), beta[1])
    num_src = 1 + (scene.instances.num if scene.instances is not None
                   else 0)
    return PathState(
        pixel=ri(0, cfg.num_pixels),
        ray_o=tuple(u() * 2 - 1 for _ in range(3)),
        ray_d=tuple(d[k].contiguous() for k in range(3)),
        hit=u() < 0.7, t=u() * 3,
        normal=tuple(torch.randn(n, generator=gen, device=device)
                     for _ in range(3)),
        prim=ri(-1, scene.tris.num), src=ri(0, num_src), bounces=bounces,
        beta=tuple(beta),
        acc=tuple(torch.where(u() < 0.5, 0.0, u()) for _ in range(3)))


def _bits_equal(a, b):
    """Equal bit for bit, every NaN equal to every NaN."""
    if a.dtype.is_floating_point:
        same = a.view(torch.int32) == b.view(torch.int32) if \
            a.dtype == torch.float32 else a.view(torch.int64) == \
            b.view(torch.int64)
        return bool((same | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _flat(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [c for v in x for c in _flat(v)]
    return [x]


def _check_step_stages(scene, cam, cfg, state, words, fb, it, cam_start):
    """Route, shade and resolve against their plain versions on one
    state: every output bit for bit, the framebuffer within the atomic
    adds' reordering.  The first design (route_v1, shade_v1) too, and
    shade against shade_v1."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as wf
    k = wf.resolve_sort_every(scene, cfg)
    want = S.route_ref(scene, cfg, state, words)
    got = S.route(scene, cfg, state, words)
    for name, x, y in zip(("keys", "bundle", "counts"), got, want):
        assert _bits_equal(x, y), name
    got_v1 = S.route_v1(scene, cfg, state, words)
    for name, x, y in zip(("keys", "bundle", "counts"), got_v1,
                          S.route_v1_ref(scene, cfg, state, words)):
        assert _bits_equal(x, y), ("v1", name)
    order = torch.sort(want[0], stable=True).indices
    fb0, fb1, fb2 = fb.clone(), fb.clone(), fb.clone()
    sh0 = S.shade_ref(scene, cam, cfg, state, fb0, words, order, want[1],
                      want[2], it, cam_start, k)
    copy = lambda st: dataclasses.replace(st, **{
        f: tuple(c.clone() for c in v) if isinstance(v, tuple) else v.clone()
        for f, v in vars(st).items()})
    sh1 = S.shade(scene, cam, cfg, copy(state), fb1, words, order, want[1],
                  want[2].clone(), it, cam_start, k)
    sh2 = S.shade_v1(scene, cam, cfg, copy(state), fb2, words, order,
                     got_v1[1], want[2].clone(), it, cam_start, k)
    for f in ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
              "trace_mask", "counts", "shadow", "ah_L", "chs_L"):
        a, b = _flat(getattr(sh1, f)), _flat(getattr(sh0, f))
        assert len(a) == len(b), f
        for j, (x, y, z) in enumerate(zip(a, b, _flat(getattr(sh2, f)))):
            assert _bits_equal(x, y), (f, j)
            assert _bits_equal(z, y), ("v1", f, j)
    torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(fb2, fb0, rtol=1e-5, atol=1e-7)
    g = torch.Generator(device=fb.device).manual_seed(9)
    n = state.pixel.shape[0]
    occ = None if sh0.shadow is None else \
        torch.rand(2 * n, generator=g, device=fb.device) < 0.3
    rays = torch.tensor(7.0, dtype=torch.float64, device=fb.device)
    occ_sum = torch.tensor(0.5, dtype=torch.float64, device=fb.device)
    r0 = S.resolve_ref(cfg, sh0, occ, it, k, cam_start, rays, occ_sum)
    sh0.acc = tuple(c.clone() for c in sh0.acc)
    r1 = S.resolve(cfg, sh0, occ, it, k, cam_start, rays, occ_sum)
    for j, (x, y) in enumerate(zip(_flat(r1), _flat(r0))):
        assert _bits_equal(x, y), ("resolve", j)
    return sh0


@pytest.mark.parametrize("change", [
    {}, dict(sort_key="adaptive"), dict(sort_key="prim"),
    dict(sort_key="morton"), dict(sort_every=1), dict(num_samples=16),
    dict(sort_every=3)], ids=str)
def test_step_kernels_equal_plain_versions(cuda, change):
    """The three step kernels bit for bit against their plain versions
    on a synthetic pool of every lane kind (every material, point and
    area lights, the environment light), and on the states of a frame's
    first iterations (sorted and sort_every skip iterations)."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as wf
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = RenderConfig(**{**dict(width=40, height=30, num_samples=4,
                                 max_bounces=5, num_working_paths=3000,
                                 direct_max_tris=0), **change})
    assert wf.step_kernels_cover(scene, cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    n = cfg.pool_size
    fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
    words = lambda: torch.randint(0, 1 << 32, (5, n), generator=g,
                                  device=cuda, dtype=torch.int64)
    before, before_v1 = dict(S.LAUNCHES), dict(S.V1_LAUNCHES)
    for it in (0, 1, 2, 5):
        _check_step_stages(scene, cam, cfg, _synthetic_state(scene, cfg, g,
                                                             cuda),
                           words(), fb, torch.tensor(it, device=cuda),
                           torch.tensor(it * 997, device=cuda))
    carry = wf.initial_carry(cfg, cuda)
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64, device=cuda),) \
        + carry[4:]
    for it in range(6):
        w = words()
        _check_step_stages(scene, cam, cfg, carry[0], w, carry[1], carry[3],
                           carry[2])
        carry = wf.wavefront_step(scene, cam, cfg, w, carry,
                                  step_kernels=False)
    # ten states, each kernel once a state
    assert {k: S.LAUNCHES[k] - before[k] for k in S.LAUNCHES
            if S.LAUNCHES[k] != before[k]} == dict(route=10, shade=10,
                                                   resolve=10)
    assert all(S.V1_LAUNCHES[k] - before_v1[k] == 10 for k in S.V1_LAUNCHES)


@pytest.mark.parametrize("change", [
    dict(sort_rays=False), dict(traversal="xla"),
    dict(reference_parity=True, rr_start=0),
    dict(reference_parity=True, rr_start=0, sort_rays=False)], ids=str)
def test_full_mode_kernels_equal_plain_versions(cuda, change):
    """The unsorted engine's and ``reference_parity``'s route, shade and
    resolve (kernels/step.py ``route_full`` / ``shade_full`` /
    ``resolve_full``; on the unsorted engine route and shade in one
    kernel, ``route_shade_unsorted``) bit for bit against their plain
    versions on synthetic pools of every lane kind, limbo lanes under
    parity, the framebuffer within the atomic adds' reordering; the scan
    buffer left zero for the next launch."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as wf
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = RenderConfig(width=40, height=30, num_samples=4, max_bounces=5,
                       num_working_paths=3000, direct_max_tris=0, **change)
    assert wf.step_kernels_cover(scene, cfg)
    mode = S.step_mode(scene, cfg)
    n = cfg.pool_size
    g = torch.Generator(device=cuda).manual_seed(4)
    copy = lambda v: tuple(c.clone() for c in v) if isinstance(v, tuple) \
        else v.clone()
    limbo = 0
    for it in range(3):
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
        fb0, fb1 = fb.clone(), fb.clone()
        cam_start = torch.tensor(it * 997, device=cuda)
        state1 = dataclasses.replace(state, **{
            f: copy(v) for f, v in vars(state).items()})
        if mode == "unsorted":
            sh0 = S.route_shade_unsorted_ref(scene, cam, cfg, state, fb0,
                                             words, cam_start)
            sh1 = S.route_shade_unsorted(scene, cam, cfg, state1, fb1, words,
                                         cam_start)
        else:
            want = S.route_full_ref(scene, cfg, state, words, mode)
            got = S.route_full(scene, cfg, state, words, mode)
            for x, y in zip(got, want, strict=True):
                assert (x is None and y is None) or _bits_equal(x, y)
            keys, record, counts = want
            limbo += int(counts[4])
            order = None if keys is None else \
                torch.sort(keys, stable=True).indices
            sh0 = S.shade_full_ref(scene, cam, cfg, fb0, words, order,
                                   record, counts, cam_start, mode)
            sh1 = S.shade_full(scene, cam, cfg, state1, fb1, words, order,
                               record, counts.clone(), cam_start, mode)
        fields = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
                  "trace_mask", "counts", "shadow", "ah_L", "chs_L") + \
            ("limbo",) * mode.startswith("parity")
        for f in fields:
            a, b = _flat(getattr(sh1, f)), _flat(getattr(sh0, f))
            assert len(a) == len(b), f
            for j, (x, y) in enumerate(zip(a, b)):
                assert _bits_equal(x, y), (f, j)
        torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
        assert not S.scan_buffer(cuda, torch.cuda.current_stream(
            cuda).cuda_stream, n).any()
        occ = torch.rand(2 * n, generator=g, device=cuda) < 0.3
        hits = (torch.rand(n, generator=g, device=cuda) < 0.5,
                torch.rand(n, generator=g, device=cuda),
                tuple(torch.randn(n, generator=g, device=cuda)
                      for _ in range(3)),
                torch.randint(-1, 9, (n,), generator=g, device=cuda,
                              dtype=torch.int32),
                torch.zeros(n, dtype=torch.int32, device=cuda))
        rays = torch.tensor(7.0, dtype=torch.float64, device=cuda)
        occ_sum = torch.tensor(0.5, dtype=torch.float64, device=cuda)
        if mode == "unsorted":
            acc, *rest = S.resolve_ref(cfg, sh0, occ, 0, 1, cam_start, rays,
                                       occ_sum)
            r0 = (acc, hits, *rest)
        else:
            r0 = S.resolve_full_ref(cfg, sh0, occ, hits, cam_start, rays,
                                    occ_sum, mode)
        sh0.acc = copy(sh0.acc)
        r1 = S.resolve_full(cfg, sh0, occ, tuple(copy(v) for v in hits),
                            cam_start, rays, occ_sum, mode)
        for j, (x, y) in enumerate(zip(_flat(r1), _flat(r0), strict=True)):
            assert _bits_equal(x, y), ("resolve", j)
    assert (limbo > 0) == mode.startswith("parity")


def _parity_cfg(n, sort_rays=True):
    return RenderConfig(width=256, height=256, num_samples=16,
                        max_bounces=5, num_working_paths=n,
                        direct_max_tris=0, reference_parity=True, rr_start=0,
                        sort_rays=sort_rays)


def _copy_state(st):
    return dataclasses.replace(st, **{
        f: tuple(c.clone() for c in v) if isinstance(v, tuple) else v.clone()
        for f, v in vars(st).items()})


_SHADE_FIELDS = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
                 "trace_mask", "counts", "shadow", "ah_L", "chs_L", "limbo")


@pytest.mark.parametrize("log2", [17, 18, 19])
@pytest.mark.parametrize("engine", ["parity", "parity_unsorted"])
def test_parity_designs_equal_plain_versions(cuda, engine, log2):
    """``reference_parity``'s route (the camera rank in the record) and
    shade (the rank read from it), and their first design
    (``route_parity_v1``: no rank; ``shade_parity_v1``: the rank by
    shade's look-back scan), each bit for bit against its plain version on
    synthetic pools of 2^17-2^19 lanes with limbo lanes, the framebuffer
    within the atomic adds' reordering, both designs' shade outputs equal;
    the record's rank ``torch.cumsum``'s in slot order."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = _parity_cfg(1 << log2, engine == "parity")
    assert S.step_mode(scene, cfg) == engine
    n = cfg.pool_size
    g = torch.Generator(device=cuda).manual_seed(log2)
    state = _synthetic_state(scene, cfg, g, cuda)
    words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                          dtype=torch.int64)
    fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
    cam_start = torch.tensor(12345, device=cuda)
    before = dict(S.PARITY_V1_LAUNCHES)
    outs = {}
    for design in ("record", "v1"):
        ref = S.route_full_ref if design == "record" else S.route_full_v1_ref
        route = S.route_full if design == "record" else S.route_full_v1
        want, got = ref(scene, cfg, state, words, engine), \
            route(scene, cfg, state, words, engine)
        for x, y in zip(got, want, strict=True):
            assert (x is None and y is None) or _bits_equal(x, y), design
        keys, record, counts = want
        r = S.unpack_full(record)
        rank = S.camera_rank(r["mat"], r["limbo"]) if design == "record" \
            else torch.zeros_like(r["rank"])
        assert torch.equal(r["rank"], rank) and int(counts[4]) > 0
        order = None if keys is None else SO.stable_order(keys)
        fb0, fb1 = fb.clone(), fb.clone()
        plain = S.shade_full_ref if design == "record" else \
            S.shade_full_v1_ref
        sh0 = plain(scene, cam, cfg, fb0, words, order, record, counts,
                    cam_start, engine)
        shade = S.shade_full if design == "record" else S.shade_full_v1
        sh1 = shade(scene, cam, cfg, _copy_state(state), fb1, words, order,
                    record, counts.clone(), cam_start, engine)
        for f in _SHADE_FIELDS:
            for j, (x, y) in enumerate(zip(_flat(getattr(sh1, f)),
                                           _flat(getattr(sh0, f)),
                                           strict=True)):
                assert _bits_equal(x, y), (design, f, j)
        torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
        outs[design] = sh1
    for f in _SHADE_FIELDS:
        for x, y in zip(_flat(getattr(outs["record"], f)),
                        _flat(getattr(outs["v1"], f)), strict=True):
            assert _bits_equal(x, y), f
    kernels = S.MODE_KERNELS[engine]
    assert {k: S.PARITY_V1_LAUNCHES[k] - before[k]
            for k in S.PARITY_V1_LAUNCHES} == {
        v: int(k in kernels) for k, v in S.PARITY_V1.items()}


def test_parity_rank_scratch_over_interleaved_sizes(cuda):
    """Twelve consecutive parity route launches at two interleaved sizes,
    each size on its persistent rank scratch, never zeroed: every record
    bit for bit the plain version's, and after each launch the ticket is 0
    or the block count (wrapping every second launch on a scratch) and
    every status word a published inclusive prefix of the launch's
    parity."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    seen = {}
    for k in range(12):
        n = ((1 << 17) + 5, (1 << 18) - 3)[k % 2]
        cfg = _parity_cfg(n, k % 3 != 0)
        engine = S.step_mode(scene, cfg)
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        got = S.route_full(scene, cfg, state, words, engine)
        want = S.route_full_ref(scene, cfg, state, words, engine)
        for x, y in zip(got, want, strict=True):
            assert (x is None and y is None) or _bits_equal(x, y), k
        r = S.unpack_full(got[1])
        gen = ~r["mat"] & ~r["limbo"]
        blocks = S.rank_blocks(n)
        parity = seen.get(blocks, 0) % 2
        seen[blocks] = seen.get(blocks, 0) + 1
        scratch = S.rank_scratch(cuda, n)
        assert int(scratch[0]) == (0 if parity else blocks)
        status = scratch[1:].to(torch.int64) & 0xFFFFFFFF
        ends = torch.cumsum(gen, 0)[torch.clamp(
            torch.arange(1, blocks + 1, device=cuda) * S.RANK_BLOCK,
            max=n) - 1]
        assert torch.equal(status & ((1 << 30) - 1), ends)
        assert bool((status >> 30).eq(3 - 2 * parity).all())
    assert sorted(seen.values()) == [6, 6]


_UNSORTED_FIELDS = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
                    "trace_mask", "counts", "shadow", "ah_L", "chs_L",
                    "chs_mask")


def _unsorted_cfg(n, one):
    return RenderConfig(width=256, height=256, num_samples=16,
                        max_bounces=5, num_working_paths=n,
                        direct_max_tris=0, sort_rays=False,
                        one_sample_mis=one)


@pytest.mark.parametrize("n", [3000, (1 << 17) + 5, 1 << 18])
@pytest.mark.parametrize("one", [False, True], ids=["mis", "one_sample"])
def test_unsorted_designs_equal_plain_versions(cuda, one, n):
    """The unsorted engine's route and shade (``route_shade_unsorted`` and
    ``_1s``: the camera rank taken after the shading on the rank's
    persistent scratch) and its first design (``_v1``: the look-back scan
    before the shading) each bit for bit against the plain version on
    synthetic pools at sizes that are and are not multiples of SCAN_BLOCK,
    the frame's last camera rays among them on a second pool; the
    framebuffer within the atomic adds' reordering; the two designs'
    outputs equal; each wrapper launched its own kernel."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = _unsorted_cfg(n, one)
    kernel = S.MODE_KERNELS[S.step_mode(scene, cfg)][0]
    g = torch.Generator(device=cuda).manual_seed(n % 1000 + one)
    before, before_v1 = dict(S.LAUNCHES), dict(S.UNSORTED_V1_LAUNCHES)
    for first in (12345, cfg.total_camera_rays - n // 4):
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
        cam_start = torch.tensor(first, device=cuda)
        fb0 = fb.clone()
        sh0 = S.route_shade_unsorted_ref(scene, cam, cfg, state, fb0, words,
                                         cam_start)
        outs = {}
        for design, step in (("record", S.route_shade_unsorted),
                             ("v1", S.route_shade_unsorted_v1)):
            fb1 = fb.clone()
            sh1 = step(scene, cam, cfg, _copy_state(state), fb1, words,
                       cam_start)
            for f in _UNSORTED_FIELDS:
                for j, (x, y) in enumerate(zip(_flat(getattr(sh1, f)),
                                               _flat(getattr(sh0, f)),
                                               strict=True)):
                    assert _bits_equal(x, y), (design, f, j)
            torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
            outs[design] = sh1
        for f in _UNSORTED_FIELDS:
            for x, y in zip(_flat(getattr(outs["record"], f)),
                            _flat(getattr(outs["v1"], f)), strict=True):
                assert _bits_equal(x, y), f
    # the second pool's camera lanes past the frame's end took no ray
    assert int(sh0.counts[1]) < n
    assert S.LAUNCHES[kernel] - before[kernel] == 2
    assert {k: v - before_v1[k] for k, v in S.UNSORTED_V1_LAUNCHES.items()} \
        == {v: 2 * (k == kernel) for k, v in S.UNSORTED_V1.items()}


def test_unsorted_rank_scratch_over_interleaved_sizes(cuda, monkeypatch):
    """Twelve consecutive route-and-shade launches of the unsorted engine
    at two interleaved sizes, each on its persistent rank scratch of
    SCAN_BLOCK-lane blocks (made fresh for the test), never zeroed, one
    of them shared with parity route launches of as many blocks between
    them: every output bit for bit the plain version's, and after each
    launch the ticket 0 or the block count and every status word a
    published inclusive prefix of the launch's parity."""
    from rtjax_torch.kernels import step as S
    monkeypatch.setattr(S, "_ranks", {})
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    small, large = (1 << 17) + 5, (1 << 18) - 3
    # the parity route's blocks of RANK_BLOCK slots at 2x the lanes
    assert S.rank_blocks(2 * small) == S.rank_blocks(small, S.SCAN_BLOCK)
    assert S.rank_scratch(cuda, 2 * small) is \
        S.rank_scratch(cuda, small, S.SCAN_BLOCK)
    seen = {}
    for k in range(12):
        n = (small, large)[k % 2]
        blocks = S.rank_blocks(n, S.SCAN_BLOCK)
        scratch = S.rank_scratch(cuda, n, S.SCAN_BLOCK)
        if k % 4 == 0:
            # a parity route on the shared scratch
            cfg = _parity_cfg(2 * small, False)
            st = _synthetic_state(scene, cfg, g, cuda)
            w = torch.randint(0, 1 << 32, (5, cfg.pool_size), generator=g,
                              device=cuda, dtype=torch.int64)
            got = S.route_full(scene, cfg, st, w, "parity_unsorted")
            want = S.route_full_ref(scene, cfg, st, w, "parity_unsorted")
            for x, y in zip(got, want, strict=True):
                assert (x is None and y is None) or _bits_equal(x, y), k
            key = S.rank_blocks(small, S.SCAN_BLOCK)
            seen[key] = seen.get(key, 0) + 1
        cfg = _unsorted_cfg(n, k % 3 == 1)
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
        cam_start = torch.tensor(100 * k, device=cuda)
        fb0, fb1 = fb.clone(), fb.clone()
        sh0 = S.route_shade_unsorted_ref(scene, cam, cfg, state, fb0, words,
                                         cam_start)
        sh1 = S.route_shade_unsorted(scene, cam, cfg, _copy_state(state),
                                     fb1, words, cam_start)
        for f in _UNSORTED_FIELDS:
            for j, (x, y) in enumerate(zip(_flat(getattr(sh1, f)),
                                           _flat(getattr(sh0, f)),
                                           strict=True)):
                assert _bits_equal(x, y), (k, f, j)
        torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
        parity = seen.get(blocks, 0) % 2
        seen[blocks] = seen.get(blocks, 0) + 1
        gen = ~S.unpack_full(S._route_full(scene, cfg, state, words,
                                           "unsorted")[1])["mat"]
        assert int(scratch[0]) == (0 if parity else blocks)
        status = scratch[1:].to(torch.int64) & 0xFFFFFFFF
        cams = torch.cumsum(gen, 0)[torch.clamp(
            torch.arange(1, blocks + 1, device=cuda) * S.SCAN_BLOCK,
            max=n) - 1]
        assert torch.equal(status & ((1 << 30) - 1), cams), k
        assert bool((status >> 30).eq(3 - 2 * parity).all())
    assert sorted(seen.values()) == [6, 9]


@pytest.mark.parametrize("design", ["record", "v1"])
@pytest.mark.parametrize("change", [dict(sort_rays=False),
                                    dict(traversal="xla"),
                                    dict(sort_rays=False,
                                         one_sample_mis=True)], ids=str)
def test_unsorted_frame_captured_equals_the_eager_loop(cuda, monkeypatch,
                                                       change, design):
    """A captured frame of the unsorted engine (the rank's scratch made by
    the frame's eager first step, outside the capture) against the same
    loop run eagerly, under each design: the same iterations, rays,
    occupancy, counts and launches (the design's route-and-shade once an
    iteration, the other never), the framebuffers within the atomic adds'
    reordering."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import graph as G
    monkeypatch.setattr(S, "DESIGN", design)
    monkeypatch.setattr(S, "_ranks", {})
    G.clear_graphs()
    scene, cam = _graph_scene("planes", cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0, **change)
    assert S.engine_of(S.step_mode(scene, cfg)) == "unsorted"
    kernel = S.MODE_KERNELS[S.step_mode(scene, cfg)][0]
    launches, firsts = dict(S.LAUNCHES), dict(S.UNSORTED_V1_LAUNCHES)
    (fb, st, ran, gs), (fb0, st0, ran0, gs0) = _graph_vs_eager(scene, cam,
                                                               cfg)
    G.clear_graphs()
    assert st["graphed"] and not st0["graphed"]
    for k in st0:
        if k not in ("graphed", "host_reads", "bounce_histogram"):
            assert st[k] == st0[k], k
    assert ran == ran0 and ran and torch.equal(gs, gs0)
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(fb).all()) and float(fb.sum()) > 0
    ours = S.LAUNCHES[kernel] - launches[kernel]
    theirs = S.UNSORTED_V1_LAUNCHES[S.UNSORTED_V1[kernel]] - \
        firsts[S.UNSORTED_V1[kernel]]
    assert (ours > 0, theirs > 0) == (design == "record", design == "v1")


def test_parity_kernels_replay_in_a_captured_graph(cuda):
    """Parity's route, the key sort and shade captured in a CUDA graph
    (the rank's and the sort's scratches made by an eager launch first,
    never zeroed): four replays on new pools, each bit for bit the eager
    launches' outputs on the same pool."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = _parity_cfg(1 << 18)
    n = cfg.pool_size
    g = torch.Generator(device=cuda).manual_seed(8)
    draw = lambda: (_synthetic_state(scene, cfg, g, cuda),
                    torch.randint(0, 1 << 32, (5, n), generator=g,
                                  device=cuda, dtype=torch.int64))

    def step(st_in, st_out, words, fb, cam_start):
        keys, record, counts = S.route_full(scene, cfg, st_in, words,
                                            "parity")
        order = SO.stable_order(keys)
        return S.shade_full(scene, cam, cfg, st_out, fb, words, order,
                            record, counts, cam_start, "parity")

    st_in, words = draw()
    st_out = _copy_state(st_in)
    fb = torch.zeros(cfg.num_pixels, 3, device=cuda)
    cam_start = torch.tensor(7, device=cuda)
    step(st_in, _copy_state(st_in), words, fb.clone(), cam_start)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        sh = step(st_in, st_out, words, fb, cam_start)
    for _ in range(4):
        new, w = draw()
        for f, v in vars(new).items():
            for x, y in zip(_flat(getattr(st_in, f)), _flat(v)):
                x.copy_(y)
            for x, y in zip(_flat(getattr(st_out, f)), _flat(v)):
                x.copy_(y)
        words.copy_(w)
        fb.zero_()
        graph.replay()
        torch.cuda.synchronize()
        fb1 = torch.zeros_like(fb)
        eager = step(new, _copy_state(new), w, fb1, cam_start)
        for f in _SHADE_FIELDS:
            for j, (x, y) in enumerate(zip(_flat(getattr(sh, f)),
                                           _flat(getattr(eager, f)),
                                           strict=True)):
                assert _bits_equal(x, y), (f, j)
        torch.testing.assert_close(fb, fb1, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("change", [
    dict(max_bounces=126), dict(one_sample_mis=True),
    dict(one_sample_mis=True, sort_rays=False),
    dict(one_sample_mis=True, max_bounces=126), dict(detailed_stats=True),
    dict(detailed_stats=True, reference_parity=True, rr_start=0),
    dict(detailed_stats=True, one_sample_mis=True),
    dict(detailed_stats=True, one_sample_mis=True, max_bounces=126,
         traversal="xla")], ids=str)
def test_flag_mode_kernels_equal_plain_versions(cuda, change):
    """The sorted engine's wide bundle (``route_wide`` / ``shade_wide``;
    126 bounces are past the compact bundle's range), the one-sample MIS
    instances (``shade_1s``, ``route_shade_unsorted_1s``,
    ``shade_wide_1s``, ``resolve_1s``) and the ``detailed_stats`` ones
    (``resolve_stats``, ``resolve_parity_stats``, ``resolve_1s_stats``)
    bit for bit against their plain versions on synthetic pools of every
    lane kind, dirty lanes on the sorted engine, limbo lanes under
    parity, the framebuffer within the atomic adds' reordering; resolve's
    one-sample channel on the plain version's closest hits, the bounce
    histogram exact."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as wf
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    cfg = RenderConfig(**{**dict(width=40, height=30, num_samples=4,
                                 max_bounces=5, num_working_paths=3000,
                                 direct_max_tris=0), **change})
    assert wf.step_kernels_cover(scene, cfg)
    mode = S.step_mode(scene, cfg)
    engine = S.engine_of(mode)
    n = cfg.pool_size
    g = torch.Generator(device=cuda).manual_seed(5)
    copy = lambda v: None if v is None else tuple(copy(c) for c in v) \
        if isinstance(v, tuple) else v.clone()
    before, marked = dict(S.LAUNCHES), 0
    for it in range(3):
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
        fb0, fb1 = fb.clone(), fb.clone()
        cam_start = torch.tensor(it * 997, device=cuda)
        state1 = dataclasses.replace(state, **{
            f: copy(v) for f, v in vars(state).items()})
        if engine == "unsorted":
            sh0 = S.route_shade_unsorted_ref(scene, cam, cfg, state, fb0,
                                             words, cam_start)
            sh1 = S.route_shade_unsorted(scene, cam, cfg, state1, fb1, words,
                                         cam_start)
        else:
            route, route_ref = (S.route, S.route_ref) \
                if engine == "default" else (
                    lambda *a: S.route_full(*a, mode),
                    lambda *a: S.route_full_ref(*a, mode))
            want = route_ref(scene, cfg, state, words)
            for x, y in zip(route(scene, cfg, state, words), want,
                            strict=True):
                assert (x is None and y is None) or _bits_equal(x, y)
            keys, record, counts = want
            marked += int(counts[4])   # dirty or limbo lanes
            order = torch.sort(keys, stable=True).indices
            if engine == "default":
                sh0 = S.shade_ref(scene, cam, cfg, state, fb0, words, order,
                                  record, counts, it, cam_start, 1)
                sh1 = S.shade(scene, cam, cfg, state1, fb1, words, order,
                              record, counts.clone(), it, cam_start, 1)
            else:
                sh0 = S.shade_full_ref(scene, cam, cfg, fb0, words, order,
                                       record, counts, cam_start, mode)
                sh1 = S.shade_full(scene, cam, cfg, state1, fb1, words,
                                   order, record, counts.clone(), cam_start,
                                   mode)
        fields = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
                  "trace_mask", "counts", "shadow", "ah_L", "chs_L",
                  "chs_mask") + ("limbo",) * engine.startswith("parity")
        for f in fields:
            a, b = _flat(getattr(sh1, f)), _flat(getattr(sh0, f))
            assert len(a) == len(b), f
            for j, (x, y) in enumerate(zip(a, b)):
                assert _bits_equal(x, y), (f, j)
        assert (sh0.chs_mask is not None) == cfg.one_sample_mis
        torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
        occ = torch.rand(sh0.shadow[4].shape[0], generator=g,
                         device=cuda) < 0.3
        inf = torch.full((n,), float("inf"), device=cuda)
        hit, t, prim, src, nrm = trace.trace_closest(
            scene, cfg, sh0.ray_o, sh0.ray_d, inf, sh0.trace_mask)
        hits = (hit, t, nrm, prim, src)
        hist = torch.randint(0, 99, (cfg.max_bounces + 1,), generator=g,
                             device=cuda) if cfg.detailed_stats else None
        rays = torch.tensor(7.0, dtype=torch.float64, device=cuda)
        occ_sum = torch.tensor(0.5, dtype=torch.float64, device=cuda)
        if engine.startswith("parity"):
            r0 = S.resolve_full_ref(cfg, sh0, occ, hits, cam_start, rays,
                                    occ_sum, mode, copy(hist))
        else:
            r_it = it if engine == "default" else 0
            acc, *rest = S.resolve_ref(cfg, sh0, occ, r_it, 1, cam_start,
                                       rays, occ_sum, hits, copy(hist))
            r0 = (acc, hits, *rest)
        sh0.acc = copy(sh0.acc)
        if engine == "default":
            acc, *rest = S.resolve(cfg, sh0, occ, it, 1, cam_start, rays,
                                   occ_sum, copy(hits), copy(hist))
            r1 = (acc, hits, *rest)
        else:
            r1 = S.resolve_full(cfg, sh0, occ, copy(hits), cam_start, rays,
                                occ_sum, mode, copy(hist))
        for j, (x, y) in enumerate(zip(_flat(r1), _flat(r0), strict=True)):
            assert _bits_equal(x, y), ("resolve", j)
        if hist is not None:
            assert int(r1[-1].sum() - hist.sum()) == int(
                sh0.trace_mask.sum())
    assert (marked > 0) == (engine != "unsorted")
    assert {k: S.LAUNCHES[k] - before[k] for k in S.LAUNCHES
            if S.LAUNCHES[k] != before[k]} == {
                k: 3 for k in S.MODE_KERNELS[mode]}


def test_step_kernels_on_an_instanced_scene(cuda):
    """Instance materials (src > 0) and a light-less scene with only the
    environment: route, shade and resolve bit for bit."""
    scene = _instanced(cuda, n_inst=12)
    cam = Camera.make((0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    dark = _step_scene(cuda, point_lights=0)
    dark = dataclasses.replace(dark, num_lights=0)
    for sc, change in ((scene, dict(two_level="kernel")), (scene, {}),
                       (dark, {})):
        cfg = RenderConfig(**{**dict(width=24, height=24, num_samples=4,
                                     max_bounces=4, num_working_paths=2048,
                                     direct_max_tris=0), **change})
        g = torch.Generator(device=cuda).manual_seed(2)
        words = torch.randint(0, 1 << 32, (5, 2048), generator=g,
                              device=cuda, dtype=torch.int64)
        fb = torch.zeros(cfg.num_pixels, 3, device=cuda)
        sh = _check_step_stages(sc, cam, cfg,
                                _synthetic_state(sc, cfg, g, cuda), words,
                                fb, 3, torch.tensor(100, device=cuda))
        assert (sh.shadow is None) == (sc.num_lights == 0)


@pytest.mark.parametrize("kind, change", [
    ("planes", {}), ("planes", dict(direct_max_tris=0, sort_every=1)),
    ("planes", dict(direct_max_tris=0, sort_key="adaptive")),
    ("instanced", dict(direct_max_tris=0, two_level="kernel")),
    ("instanced", dict(direct_max_tris=0)),
    ("planes", dict(direct_max_tris=0, sort_rays=False)),
    ("planes", dict(direct_max_tris=0, traversal="xla")),
    ("planes", dict(direct_max_tris=0, reference_parity=True, rr_start=0)),
    ("planes", dict(direct_max_tris=0, reference_parity=True,
                    traversal="xla")),
    ("instanced", dict(direct_max_tris=0, reference_parity=True)),
    ("planes", dict(direct_max_tris=0, detailed_stats=True)),
    ("planes", dict(detailed_stats=True, reference_parity=True)),
    ("instanced", dict(direct_max_tris=0, detailed_stats=True,
                       two_level="kernel")),
    ("planes", dict(direct_max_tris=0, one_sample_mis=True)),
    ("planes", dict(direct_max_tris=0, one_sample_mis=True,
                    sort_rays=False)),
    ("planes", dict(direct_max_tris=0, max_bounces=126)),
    ("planes", dict(max_bounces=126, one_sample_mis=True,
                    detailed_stats=True))],
    ids=str)
def test_step_kernel_frame_equals_the_op_by_op_step(cuda, kind, change):
    """A captured frame through the step kernels against one through the
    op-by-op step (``step_kernels=False``), one seed: the same
    iterations, rays, occupancy and traversal launches, under
    ``detailed_stats`` the same bounce histogram and traversal sums, the
    mode's step kernels, and on a sorted engine the key sort, launched
    once an iteration (none in the other), framebuffers within the
    atomic adds' reordering."""
    from rtjax_torch.kernels import counts
    from rtjax_torch.kernels import step as S
    scene, cam = _graph_scene(kind, cuda)
    cfg = RenderConfig(**{**dict(width=32, height=32, num_samples=8,
                                 max_bounces=4, num_working_paths=4096),
                          **change})
    out = []
    for sk in (True, False):
        before = counts.snapshot()
        fb, st = render_frame(scene, cam, cfg, torch.Generator(
            device=cuda).manual_seed(3), step_kernels=sk)
        out.append((fb, st, counts.delta(before, counts.snapshot())))
    (fb, st, ran), (fb0, st0, ran0) = out
    assert st["graphed"] and st0["graphed"]
    for k in ("iterations", "rays_traced", "avg_occupancy") + (
            "node_steps", "leaf_visits", "anyhit_steps",
            "anyhit_visits") * cfg.detailed_stats:
        assert st[k] == st0[k], k
    if cfg.detailed_stats:
        assert torch.equal(st["bounce_histogram"], st0["bounce_histogram"])
        assert int(st["bounce_histogram"].sum()) > 0
    mode = S.step_mode(scene, cfg)
    steps = {k: v for k, v in ran.items() if k[0][0] in ("step", "sort")}
    sorts = S.engine_of(mode) in ("default", "wide", "parity")
    assert steps == {(("step", "LAUNCHES"), name): st["iterations"]
                     for name in S.MODE_KERNELS[mode]} | (
        {(("sort", "LAUNCHES"), "key_sort"): st["iterations"]} if sorts
        else {})
    assert {k: v for k, v in ran.items()
            if k[0][0] not in ("step", "sort")} == ran0
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(fb).all()) and float(fb.sum()) > 0


def test_graph_follows_the_step_design(cuda, monkeypatch):
    """Frames of one seed under the record design, then the first design,
    then the record design again, with no ``clear_graphs`` between them:
    each frame launches its own design's kernels once an iteration (the
    cached graph is captured anew when the design changes), and the
    framebuffers agree within the atomic adds' reordering."""
    from rtjax_torch.kernels import counts
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import graph
    scene, cam = cornell_planes(cuda)
    cfg = RenderConfig(width=48, height=48, num_samples=16, max_bounces=5,
                       num_working_paths=8192, direct_max_tris=0)
    graph.clear_graphs()
    frames = []
    for design in ("record", "v1", "record"):
        monkeypatch.setattr(S, "DESIGN", design)
        before = counts.snapshot()
        fb, st = render_frame(scene, cam, cfg, torch.Generator(
            device=cuda).manual_seed(6))
        ran = counts.delta(before, counts.snapshot())
        table = "V1_LAUNCHES" if design == "v1" else "LAUNCHES"
        assert ran.get((("step", table), "shade"), 0) == st["iterations"]
        assert graph.cached().key[4] == design
        frames.append(fb)
    graph.clear_graphs()
    for fb in frames[1:]:
        torch.testing.assert_close(fb, frames[0], rtol=1e-5, atol=1e-7)
    assert float(frames[0].sum()) > 0


def test_repass_runs_g_masked_passes_on_the_card(cuda):
    """Outside a capture on the card (the eager loop) repass's passes are
    all G of a mesh group, masked on the device with no host read; the
    CPU stops where rtjax does (tests/test_torch_repass_device.py)."""
    scene = _instanced(cuda, n_inst=12)
    rng = np.random.default_rng(4)
    n = 4096
    o = tuple(torch.tensor(c, device=cuda) for c in np.stack([
        rng.uniform(-2, 2, n), np.full(n, 2.5), rng.uniform(-2, 2, n)
    ]).astype(np.float32))
    d = np.stack([rng.uniform(-0.2, 0.2, n), -np.ones(n),
                  rng.uniform(-0.2, 0.2, n)])
    d = tuple(torch.tensor(c, device=cuda)
              for c in (d / np.linalg.norm(d, axis=0)).astype(np.float32))
    active = torch.ones(n, dtype=torch.bool, device=cuda)
    runs = {}

    def body(blas, pend, src, *_):
        runs[id(blas)] = runs.get(id(blas), 0) + 1

    trace._repass_passes(scene, o, d, active,
                         lambda ent: torch.zeros_like(ent, dtype=torch.bool),
                         body)
    for grp in scene.instances.groups:
        assert runs[id(scene.blas[grp.mesh_id])] == grp.size


# ------------------------- the step's stable key sort (csrc/key_sort.cu)

@pytest.mark.parametrize("log2", [17, 18, 19, 20])
@pytest.mark.parametrize("keyset", sort_designs.SETS)
def test_key_sort_equals_torch_sort(cuda, keyset, log2):
    """The radix sort's order is ``torch.sort(keys, stable=True).indices``
    bit for bit on tools/sort_designs.py's key sets at 2^17-2^20 keys."""
    keys = torch.from_numpy(sort_designs.synthetic_keys(
        keyset, 1 << log2, log2)).to(cuda)
    got = SO.stable_order(keys)
    assert torch.equal(got, torch.sort(keys, stable=True).indices)


@pytest.mark.parametrize("n", [1, 2, 1000, 2047, 2049, 4095, 4097,
                               (1 << 17) - 3])
def test_key_sort_odd_sizes(cuda, n):
    """Partial tiles and sizes below one tile."""
    for keyset in ("random_int32", "dead_pair", "two_keys"):
        keys = torch.from_numpy(sort_designs.synthetic_keys(
            keyset, n, n)).to(cuda)
        assert torch.equal(SO.stable_order(keys),
                           torch.sort(keys, stable=True).indices)


@pytest.mark.parametrize("log2", [17, 18, 19, 20])
def test_key_sort_skip_launch_leaves_the_order(cuda, log2):
    """On a ``sort_every`` skip iteration every kernel returns at once:
    the order as it was, the device tally counting both launches as
    returned at once and the sorting one as sorted."""
    r = sort_designs.check_skip(1 << log2)
    assert r["untouched"] and r["sorts"] and r["tally"] == [1, 2]


@pytest.mark.parametrize("log2", [17, 18, 19, 20])
@pytest.mark.parametrize("keyset", sort_designs.SETS)
def test_key_sort_v1_equals_torch_sort(cuda, keyset, log2):
    """the first design (``stable_order_v1``, kept for timing in turns) is
    ``torch.sort(keys, stable=True).indices`` bit for bit too."""
    keys = torch.from_numpy(sort_designs.synthetic_keys(
        keyset, 1 << log2, log2)).to(cuda)
    got = SO.stable_order_v1(keys)
    assert torch.equal(got, torch.sort(keys, stable=True).indices)


def test_key_sort_sizes_interleaved_on_their_scratches(cuda):
    """Launches at two sizes in turns, queued back to back with no
    synchronisation between them, each on its size's persistent scratch
    (never zeroed again): every order is torch.sort's."""
    got = []
    for r in range(4):
        for n in (1 << 17, (1 << 19) + 3):
            keys = torch.from_numpy(sort_designs.synthetic_keys(
                sort_designs.SETS[(r * 3 + n) % len(sort_designs.SETS)], n,
                r)).to(cuda)
            got.append((keys, SO.stable_order(keys)))
    torch.cuda.synchronize()
    for keys, order in got:
        assert torch.equal(order, torch.sort(keys, stable=True).indices)


def test_key_sort_if_node_in_a_captured_step(cuda):
    """A captured launch with a cadence (render/device_loop.py's
    recorder, as the captured step records it) goes under a CUDA-graph if
    node: replayed with new keys and alternating iterations, a skip
    leaves the order untouched and counts as skipped in the tally, a sort
    orders the new keys; under the profiler a skip replay runs the
    condition kernel and no sort kernel and no memset, a sorting one the
    upsweep and four passes and no memset."""
    from torch.profiler import ProfilerActivity, profile

    from rtjax_torch.render import device_loop
    n = 1 << 18
    keys = torch.zeros(n, dtype=torch.int32, device=cuda)
    counts = torch.tensor([n, 0, 0, 0, 0], device=cuda)
    it = torch.zeros((), dtype=torch.int64, device=cuda)
    order = torch.full((n,), -7, dtype=torch.int64, device=cuda)
    SO.sort_into(keys, order, (counts, it, 2))   # made outside: the tally,
    stream = torch.cuda.Stream()                 # the scratch, the library
    stream.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    rec = device_loop.Recorder(cuda)
    try:
        with rec.recording(), torch.cuda.graph(g, stream=stream):
            SO.sort_into(keys, order, (counts, it, 2))
        for i, keyset in enumerate(("random31", "mostly_dead", "two_keys",
                                    "random_int32", "all_equal")):
            keys.copy_(torch.from_numpy(sort_designs.synthetic_keys(
                keyset, n, i)).to(cuda))
            it.fill_(i)
            order.fill_(-7)
            before = SO.tally(cuda).clone()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                g.replay()
                torch.cuda.synchronize()
            names = [e.name() for e in prof.profiler.kineto_results.events()
                     if "emset" in e.name() or sort_designs.OURS.search(
                         e.name())]
            sorts = i % 2 == 0
            assert (SO.tally(cuda) - before).tolist() == ([1, 0] if sorts
                                                          else [0, 1])
            passes = [m for m in names if sort_designs.PASSES.search(m)]
            assert len(passes) == (5 if sorts else 0), names
            assert not [m for m in names if "emset" in m], names
            assert len([m for m in names
                        if sort_designs.CONDITION.search(m)]) == 1, names
            want = torch.sort(keys, stable=True).indices if sorts else \
                torch.full((n,), -7, dtype=torch.int64, device=cuda)
            assert torch.equal(order, want)
    finally:
        del g
        rec.release()


def test_key_sort_replays_in_a_captured_graph(cuda):
    """Captured in a CUDA graph (no cadence: no if node; the persistent
    scratch made outside, never zeroed by the launch) the sort orders new
    keys on every replay."""
    n = 1 << 18
    keys = torch.zeros(n, dtype=torch.int32, device=cuda)
    SO.stable_order(keys)   # the library and the tally made outside
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        order = SO.stable_order(keys)
    for seed, keyset in enumerate(("random31", "mostly_dead", "all_equal")):
        keys.copy_(torch.from_numpy(sort_designs.synthetic_keys(
            keyset, n, seed)).to(cuda))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(order, torch.sort(keys, stable=True).indices)


def _one_sample_cfg(n, k):
    return RenderConfig(width=256, height=256, num_samples=16,
                        max_bounces=5, num_working_paths=n,
                        direct_max_tris=0, one_sample_mis=True, sort_every=k)


@pytest.mark.parametrize("n", [3000, (1 << 17) + 5, 1 << 18])
@pytest.mark.parametrize("skip", [False, True], ids=["sorts", "skips"])
def test_one_sample_shade_designs_equal_plain_versions(cuda, n, skip):
    """The sorted engine's one-sample shade (``shade_1s``: a resident grid
    whose threads pipeline their tiles' loads) and its first design
    (``shade_1s_v1``: one thread a position) each bit for bit against the
    plain version on synthetic pools at sizes that are and are not
    multiples of the 128-lane tile, on a sorting iteration and on a
    ``sort_every`` skip iteration (the identity order), the frame's last
    camera rays among the lanes of a second pool; the framebuffer within
    the atomic adds' reordering; the two designs' outputs equal; each
    wrapper launched its own kernel."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    k = 2 if skip else 1
    cfg = _one_sample_cfg(n, k)
    assert S.step_mode(scene, cfg) == "default_1s"
    g = torch.Generator(device=cuda).manual_seed(n % 1000 + skip)
    before, before_v1 = dict(S.LAUNCHES), dict(S.MODE_V1_LAUNCHES)
    it = torch.tensor(1 if skip else 2, device=cuda)
    for first in (12345, cfg.total_camera_rays - n // 4):
        state = _synthetic_state(scene, cfg, g, cuda)
        if skip:
            # most lanes continue: the cadence skips this iteration
            state = dataclasses.replace(
                state, hit=torch.ones_like(state.hit),
                bounces=torch.where(state.bounces >= cfg.max_bounces, 0,
                                    state.bounces))
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        keys, bundle, counts = S.route_ref(scene, cfg, state, words)
        do_gen = S.cadence(counts, n, it, k)
        assert (do_gen is not None and not bool(do_gen)) == skip
        order = torch.sort(keys, stable=True).indices
        fb = torch.rand(cfg.num_pixels, 3, generator=g, device=cuda)
        cam_start = torch.tensor(first, device=cuda)
        fb0 = fb.clone()
        sh0 = S.shade_ref(scene, cam, cfg, state, fb0, words, order, bundle,
                          counts, it, cam_start, k)
        outs = {}
        for design, shade in (("record", S.shade), ("v1", S.shade_1s_v1)):
            fb1 = fb.clone()
            sh1 = shade(scene, cam, cfg, _copy_state(state), fb1, words,
                        order, bundle, counts.clone(), it, cam_start, k)
            for f in _UNSORTED_FIELDS:
                for j, (x, y) in enumerate(zip(_flat(getattr(sh1, f)),
                                               _flat(getattr(sh0, f)),
                                               strict=True)):
                    assert _bits_equal(x, y), (design, f, j)
            torch.testing.assert_close(fb1, fb0, rtol=1e-5, atol=1e-7)
            outs[design] = sh1
        for f in _UNSORTED_FIELDS:
            for x, y in zip(_flat(getattr(outs["record"], f)),
                            _flat(getattr(outs["v1"], f)), strict=True):
                assert _bits_equal(x, y), f
    assert S.LAUNCHES["shade_1s"] - before["shade_1s"] == 2
    assert {k_: v - before_v1[k_] for k_, v in S.MODE_V1_LAUNCHES.items()} \
        == {"shade_1s_v1": 2, "resolve_parity_stats_v1": 0}


@pytest.mark.parametrize("nb", [1, 11, 32, 33, 127])
@pytest.mark.parametrize("kind", ["stats", "1s_stats", "parity_stats"])
def test_stats_resolves_equal_plain_versions(cuda, kind, nb):
    """The stats resolves (``resolve_stats``, ``resolve_1s_stats``,
    ``resolve_parity_stats``: the histogram around the lane's work) and
    the parity one's first design
    (``resolve_parity_stats_v1``) against their plain versions at 1, 11,
    32, 33 and 127 bins, on synthetic pools of 3,000 and 2^18 - 3 lanes
    (neither a multiple of the 256-lane block): every bin exactly, every
    other output bit for bit."""
    from rtjax_torch.kernels import step as S
    scene = _step_scene(cuda)
    cam = Camera.make((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45, 1.0,
                      device=cuda)
    g = torch.Generator(device=cuda).manual_seed(nb)
    copy = lambda v: None if v is None else tuple(copy(c) for c in v) \
        if isinstance(v, tuple) else v.clone()
    for n in (3000, (1 << 18) - 3):
        parity = dict(reference_parity=True, rr_start=0) \
            if kind == "parity_stats" else {}
        cfg = RenderConfig(width=256, height=256, num_samples=16,
                           max_bounces=nb - 1, num_working_paths=n,
                           direct_max_tris=0, detailed_stats=True,
                           one_sample_mis=kind == "1s_stats", **parity)
        mode = S.step_mode(scene, cfg)
        state = _synthetic_state(scene, cfg, g, cuda)
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=cuda,
                              dtype=torch.int64)
        fb = torch.zeros(cfg.num_pixels, 3, device=cuda)
        cam_start = torch.tensor(77, device=cuda)
        if parity:
            keys, record, counts = S.route_full_ref(scene, cfg, state, words,
                                                    mode)
            order = torch.sort(keys, stable=True).indices
            sh = S.shade_full_ref(scene, cam, cfg, fb, words, order, record,
                                  counts, cam_start, mode)
        else:
            keys, bundle, counts = S.route_ref(scene, cfg, state, words)
            order = torch.sort(keys, stable=True).indices
            sh = S.shade_ref(scene, cam, cfg, state, fb, words, order, bundle,
                             counts, 0, cam_start, 1)
        occ = torch.rand(sh.shadow[4].shape[0], generator=g,
                         device=cuda) < 0.3
        inf = torch.full((n,), float("inf"), device=cuda)
        hit, t, prim, src, nrm = trace.trace_closest(
            scene, cfg, sh.ray_o, sh.ray_d, inf, sh.trace_mask)
        hits = (hit, t, nrm, prim, src)
        hist = torch.randint(0, 99, (nb,), generator=g, device=cuda)
        rays = torch.tensor(7.0, dtype=torch.float64, device=cuda)
        occ_sum = torch.tensor(0.5, dtype=torch.float64, device=cuda)
        acc = lambda: dataclasses.replace(sh, acc=copy(sh.acc))
        if parity:
            want = S.resolve_full_ref(cfg, acc(), occ, hits, cam_start, rays,
                                      occ_sum, mode, hist.clone())
            got = [S.resolve_full(cfg, acc(), occ, copy(hits), cam_start,
                                  rays, occ_sum, mode, hist.clone()),
                   S.resolve_full_v1(cfg, acc(), occ, copy(hits), cam_start,
                                     rays, occ_sum, mode, hist.clone())]
        else:
            want = S.resolve_ref(cfg, acc(), occ, 0, 1, cam_start, rays,
                                 occ_sum, hits, hist.clone())
            got = [S.resolve(cfg, acc(), occ, 0, 1, cam_start, rays, occ_sum,
                             copy(hits), hist.clone())]
        for out in got:
            for j, (x, y) in enumerate(zip(_flat(out), _flat(want),
                                           strict=True)):
                assert _bits_equal(x, y), (n, j)
            assert int(out[-1].sum() - hist.sum()) == int(
                sh.trace_mask.sum())


@pytest.mark.parametrize("design", ["record", "v1"])
@pytest.mark.parametrize("change", [
    dict(one_sample_mis=True), dict(one_sample_mis=True, detailed_stats=True,
                                    sort_every=2),
    dict(reference_parity=True, rr_start=0, detailed_stats=True)], ids=str)
def test_first_design_frame_captured_equals_the_eager_loop(
        cuda, monkeypatch, change, design):
    """A captured frame of the sorted engine under ``one_sample_mis`` (the
    one-sample shade's designs) and of ``reference_parity`` under
    ``detailed_stats`` (the stats resolve's designs) against the same loop
    run eagerly, under each design: the same iterations, rays, occupancy,
    bounce histogram, counts and launches (the design's kernels once an
    iteration, the other design's never), the framebuffers within the
    atomic adds' reordering."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import graph as G
    monkeypatch.setattr(S, "DESIGN", design)
    G.clear_graphs()
    scene, cam = _graph_scene("planes", cuda)
    cfg = RenderConfig(width=32, height=32, num_samples=8, max_bounces=4,
                       num_working_paths=4096, direct_max_tris=0, **change)
    mode = S.step_mode(scene, cfg)
    mine = [k for k in S.MODE_KERNELS[mode] if k in S.MODE_V1]
    launches, firsts = dict(S.LAUNCHES), dict(S.MODE_V1_LAUNCHES)
    (fb, st, ran, gs), (fb0, st0, ran0, gs0) = _graph_vs_eager(scene, cam,
                                                               cfg)
    G.clear_graphs()
    assert st["graphed"] and not st0["graphed"] and mine
    for k in st0:
        if k not in ("graphed", "host_reads", "bounce_histogram"):
            assert st[k] == st0[k], k
    if cfg.detailed_stats:
        assert torch.equal(st["bounce_histogram"], st0["bounce_histogram"])
    assert ran == ran0 and ran and torch.equal(gs, gs0)
    torch.testing.assert_close(fb, fb0, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(fb).all()) and float(fb.sum()) > 0
    for k in mine:
        ours = S.LAUNCHES[k] - launches[k]
        theirs = S.MODE_V1_LAUNCHES[S.MODE_V1[k]] - firsts[S.MODE_V1[k]]
        assert (ours > 0, theirs > 0) == (design == "record", design == "v1")


# ------------------------------------------------- the TPU probes (row 11)
def _probe_sets(name):
    """rtjax's kind of operands and mixed ones (the scalar walk also its
    deep chain), on the card."""
    if name == "clz":
        return [[]]
    sets = [list(PMK.ALL[name][0](1, 1, "cuda")[1]),
            [torch.from_numpy(a).cuda() for a in PMK.mixed_operands(
                name, np.random.default_rng(21))]]
    if name == "scalar_walk":
        sets.append([torch.from_numpy(PMK.deep_meta()).cuda()])
    return sets


@pytest.mark.parametrize("name", [k for k in PMK.ALL if k not in PR.MXU])
def test_probe_kernels_equal_plain_versions(cuda, name):
    """Each probe kernel's checksum equals its plain version's bit for bit
    at two iteration counts, at one tile and at the full card, every tile
    equal."""
    counts = {"scalar_walk": (7, 200), "clz": (5, 5_000)}.get(name, (3, 30))
    full = PR.full_card(name)
    assert full >= torch.cuda.get_device_properties(0).multi_processor_count
    for n in counts:
        for ops in _probe_sets(name):
            want = PMK.plain(name, n, ops)
            for tiles in (1, full):
                got = PMK.launch(name, n, ops, tiles)
                assert got.shape == (tiles,) and got.is_cuda
                assert PR.checksum(got) == int(want[0])


@pytest.mark.parametrize("name", ["slab_pair", "leaf_mt_vpu_row1"])
def test_probe_kernels_wrap_the_table(cuda, name):
    """Past the table's 1,024 rows a probe reads them again from row 0,
    on the card as in the plain version: a slab probe (rows read by every
    thread) and a leaf probe (rows spread by shuffles), at one tile and
    at the full card."""
    ops = _probe_sets(name)[1]
    want = PMK.plain(name, 1030, ops)
    for tiles in (1, PR.full_card(name)):
        assert PR.checksum(PMK.launch(name, 1030, ops, tiles)) == \
            int(want[0])


def test_probe_nop_launch_equals_plain_version(cuda):
    """The copy bit for bit its input, eagerly, as a programmatic
    dependent and replayed in a captured graph; the sum the plain
    version's on integer-valued tiles; at one tile and at the full
    card."""
    for tiles in (1, PR.full_card("nop_copy")):
        shape = (16, 128) if tiles == 1 else (tiles, 16, 128)
        x = torch.randint(-100, 100, shape, device="cuda").float()
        y = torch.empty_like(x)
        for pdl in (False, True):
            assert torch.equal(PR.nop_copy(x, pdl=pdl), x)
        assert torch.equal(PR.tile_sum(x), PR.tile_sum_ref(x))
        assert torch.equal(PR.nop_launch(x), x.reshape(tiles, -1).sum(1))
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            PR.nop_copy(x, y, pdl=True)
        y.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, x)


def test_probe_wrappers_raise_without_their_library(cuda, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor goes to the kernels or the wrapper raises: with no
    library and no compiler, every wrapper raises and none falls back to
    its plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(PR, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    x = torch.zeros(16, 128, device="cuda")
    table = torch.zeros(1024, 128, device="cuda")
    rays = torch.zeros(7, 16, 128, device="cuda")
    meta = torch.zeros(1024, dtype=torch.int32, device="cuda")
    for call in (lambda: PR.nop_copy(x), lambda: PR.tile_sum(x),
                 lambda: PR.scalar_walk(meta, 3),
                 lambda: PR.tile_probe("slab_pair", table, rays, 3),
                 lambda: PR.clz(3, 1, "cuda")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()


# ---------------------------------- the tensor-core probes (rows 11e-11h)
MXU_NAMES = list(PR.MXU)
# the kernels against their plain versions on rtjax's kind of operands
# (uniform [0, 1)): the tensor cores sum each mma's products in their own
# order, the plain version in k order; at most K <= 96 roundings of 2^-24
# in det and each numerator
MXU_RTOL = 1e-5


def _mxu_exact(name):
    return [PMK._mxu_tensor(a, name) for a in PMK.exact_operands(
        name, np.random.default_rng(26))]


@pytest.mark.parametrize("name", MXU_NAMES)
def test_mxu_kernels_equal_plain_versions_on_exact_operands(cuda, name):
    """Each tensor-core kernel's out and fields equal its plain version's
    bit for bit where every product is exact, at two counts (past the
    group tables' 128 blocks), at one tile and at the full card."""
    ops = _mxu_exact(name)
    full = PR.full_card(name)
    assert full >= torch.cuda.get_device_properties(0).multi_processor_count
    for n in (3, 133):
        want_out, want_fields = PR.mxu_probe_ref(name, *ops, n)
        assert (want_out[0] < PR.BIG).any() and (want_out[0] >= PR.BIG).any()
        for tiles in (1, full):
            out, fields = PR.mxu_probe(name, *ops, n, tiles, fields=True)
            assert out.shape == (tiles, PR.TILE_LANES) and out.is_cuda
            assert torch.equal(PR.same_tiles(out), want_out[0])
            assert torch.equal(PR.same_tiles(fields), want_fields[0])


@pytest.mark.parametrize("name", MXU_NAMES)
def test_mxu_kernels_match_plain_versions_on_rtjax_operands(cuda, name):
    """On rtjax's kind of operands each tensor-core kernel matches its
    plain version within MXU_RTOL (summation order), the same lanes hit,
    at one tile and at the full card."""
    ops = list(PMK.ALL[name][0](1, 1, "cuda")[1])
    for n in (3, 133):
        want = PR.mxu_probe_ref(name, *ops, n)[1][0]
        for tiles in (1, PR.full_card(name)):
            got = PR.same_tiles(PR.mxu_probe(name, *ops, n, tiles,
                                             fields=True)[1])
            assert torch.equal(got[0] >= PR.BIG, want[0] >= PR.BIG)
            torch.testing.assert_close(got, want, rtol=MXU_RTOL, atol=0)


def test_mxu_wrapper_raises_on_bad_inputs(cuda):
    """A bad shape, dtype or device raises before any launch."""
    table, feats = PMK.ALL["leaf_mt_mxu_bf16"][0](1, 1, "cuda")[1]
    before = dict(PR.LAUNCHES)
    for args, err in (((table[:-1], feats), ValueError),
                      ((table.float(), feats), TypeError),
                      ((table, feats.cpu()), ValueError),
                      ((table, feats[:8]), ValueError)):
        with pytest.raises(err):
            PR.mxu_probe("leaf_mt_mxu_bf16", *args, 2)
    with pytest.raises(ValueError, match="unknown"):
        PR.mxu_probe("leaf_mt_vpu", table, feats, 2)
    assert PR.LAUNCHES == before


def test_mxu_entry_point_prints_its_lines(cuda, capsys):
    """``python -m rtjax_torch.probes.micro_kernel leaf_mt_mxu_*``: the
    line of a tensor-core probe has its bound, its HMMA instructions and
    ns a leaf visit."""
    names = ["leaf_mt_mxu_bf16", "leaf_mt_mxu_g2_splitk"]
    out = PMK.main([*names, "--scale", "0.02"])
    lines = capsys.readouterr().out.splitlines()
    for name in names:
        line = next(x for x in lines if x.startswith(f"{name}: "))
        assert "HMMA" in line and "leaf visit" in line
        rec = out[name]
        assert rec["hmma"] > 0 and rec["one_tile"]["ns"] > 0
        assert rec["one_tile"]["bound_ns"] >= rec["one_tile"]["tensor_ns"]


# --------------------------------------------- the chained timer ([C 5])
def test_chain_ms_times_a_chain_of_prepared_calls(cuda):
    """``probes.chain_ms``: each chain's calls are made before its first
    event (a copy an output here), a warm-up chain and ``reps`` chains;
    a launch in a chain costs less than one alone between two events."""
    import rtjax_torch.probes as PROBES
    x = torch.zeros(16, 128, device="cuda")
    made = []

    def make():
        ys = [torch.empty_like(x) for _ in range(32)]
        made.append(ys)
        return [lambda y=y: PR.nop_copy(x, y) for y in ys]

    mean, least, most = PROBES.chain_ms(make, reps=3)
    assert len(made) == 4 and 0 < least <= mean <= most
    assert all(torch.equal(y, x) for ys in made for y in ys)
    alone = PROBES.launch_ms(lambda: PR.nop_copy(x, made[0][0]), 3)[0]
    assert mean < alone


def test_probe_entry_points_print_their_lines(cuda, capsys):
    """The probe entry points' ``main``: a ``name: X ns/iter`` line a probe
    (rtjax's format first), positive slopes, and the no-op launch's
    timings."""
    out = PMK.main(["clz", "slab_pair", "--scale", "0.05"])
    lines = capsys.readouterr().out.splitlines()
    for name in ("clz", "slab_pair"):
        line = next(x for x in lines if x.startswith(f"{name}: "))
        assert "ns/iter" in line and out[name]["one_tile"]["ns"] > 0
        assert out[name]["instructions"] > 0
    nop = PSB.main([])
    assert capsys.readouterr().out.count(" ms ") >= 2 * 10
    assert 0 < nop["one_tile"]["chain_ms"] < nop["one_tile"]["eager_ms"] < 1
    assert nop["full_card"]["tiles"] > nop["one_tile"]["tiles"]
