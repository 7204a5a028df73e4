"""rtjax_torch on a CUDA device: the hand-written kernels (persistent
walkers, two-level, packet and lane kernels, each in both designs, and the
binary-BVH walk) against their plain PyTorch versions, and the engine's
main path through the kernels, single-level and instanced, under every
walker and under ``traversal="xla"``.

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
from rtjax_torch.kernels import traversal as T
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.render import trace
from rtjax_torch.render.wavefront import render_frame
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder
from rtjax_torch.scene.transform import Transform, rotate, scale, translate
from rtjax_torch.scenes import cornell_planes

from test_torch_binary_launch import DEEP_T, deep_bvh, down_rays
from test_torch_persist_work import chain_rays, chain_tables

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
                       num_working_paths=4096)
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
    sc = types.SimpleNamespace(instances=None, tables=tables)
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
                       anyhit_walker=anyhit_walker)
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
                       num_working_paths=4096)
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
    """Both binary kernels and their stats instances against the plain
    versions, bit for bit; the counts equal."""
    work = T.new_work()
    ref = T.traverse_closest_ref(bvh, tris, o, d, tmax, active, work=work)
    got = T.traverse_closest(bvh, tris, o, d, tmax, active)
    sgot = T.traverse_closest(bvh, tris, o, d, tmax, active, with_stats=True)
    for a, b, c in zip(got[:5], ref[:5], sgot[:5]):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b, c in zip(got[5], ref[5], sgot[5]):
        assert torch.equal(a, b) and torch.equal(a, c)
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
    assert torch.equal(occ, occ_ref) and torch.equal(occ, occ_s)
    assert (int(st[0]), int(st[1])) == (work["steps"], work["leafs"])
    assert not bool(occ[dead].any())
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
                       num_working_paths=4096, **change)
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
