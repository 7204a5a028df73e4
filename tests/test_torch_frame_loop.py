"""The frame loop with its condition and sort cadence on the device
(render/wavefront.py, render/graph.py), on the CPU, where the chunked loop
runs op by op and no graph is captured.

(a) ``render_frame_linear`` at ``STEPS_PER_READ`` 1, 3 and 8 gives the
    same framebuffer, iterations, rays, occupancy and ``detailed_stats``
    bit for bit, and leaves the generator and the kernels' counters as
    each other, on ``cornell_planes`` (12 triangles: ``sort_every`` auto
    2) and on a 1,164-triangle box (auto 1), also under a
    ``max_iterations`` that ends a chunk early; the loop's blocking reads
    are one a chunk and one for the stats.
(b) Steps after the loop condition turned false leave the framebuffer,
    ``it``, ``cam_start``, rays, occupancy and the ``detailed_stats`` sums
    bitwise as they were.
(c) The device-side ``sort_every`` decision against the step that made it
    on the host (a copy of it is kept here), state for state on the same
    words, over iterations where it sorts and where it skips.
(d) ``wavefront_step`` takes ``it`` as a Python int and as a 0-d tensor,
    with the same results, and returns the type it was given.
(e) No mode's step reads the host: with the kernels stubbed, every
    mode's step, repass's included, runs with every tensor-to-host
    conversion and host-to-device copy trapped.
(f) The graph module's carry plumbing (``flatten``, ``store``), a device
    loop outside a capture, and a loop body's launches counted once a run
    (``StepGraph.account``).
(g) A frame against rtjax's ``render_frame_linear`` at the seed-to-seed
    noise floor.
"""

import math

import jax
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.render.wavefront import render_frame_linear as jax_frame
from rtjax.utils.compare import mse

from rtjax_torch import RenderConfig
from rtjax_torch.core import rng, vec
from rtjax_torch.kernels import counts
from rtjax_torch.render import graph, trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder, scene_from_arrays
from rtjax_torch.scene.transform import Transform, translate
from rtjax_torch.scenes import cornell_planes

from scenes import cornell, default_camera
from test_torch_scene import camera_arrays, scene_arrays

W = H = 16
POOL = 1024
DECISIONS = []   # the host-decision step's sort_every decisions


@pytest.fixture(scope="module")
def planes():
    return cornell_planes("cpu")


@pytest.fixture(scope="module")
def busy():
    """Cornell planes with a 24 x 24-quad slab (1,152 triangles) above the
    floor: 1,164 triangles, so ``sort_every`` auto resolves to 1."""
    cam = Camera.make((0.5, 0.5, 1.5), (0.5, 0.5, 0.0), (0.0, 1.0, 0.0),
                      37.8, 1.0, device="cpu")
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    red = b.make_matte((0.65, 0.05, 0.05))
    for (p0, p1, p2), mat in WALLS:
        b.add_triangles(p0, p1, p2, red if mat == "red" else white)
    g = np.linspace(0.2, 0.8, 25, dtype=np.float32)
    x0, z0 = np.meshgrid(g[:-1], -g[:-1])
    x1, z1 = np.meshgrid(g[1:], -g[1:])
    y = np.full(x0.size, 0.3, np.float32)
    a = np.stack([x0.ravel(), y, z0.ravel()], 1)
    bb = np.stack([x1.ravel(), y, z0.ravel()], 1)
    c = np.stack([x1.ravel(), y, z1.ravel()], 1)
    d = np.stack([x0.ravel(), y, z1.ravel()], 1)
    b.add_triangles(np.concatenate([a, a]), np.concatenate([bb, c]),
                    np.concatenate([c, d]), white)
    b.add_area_light((0.4, 0.999, -0.4), (0.6, 0.999, -0.4),
                     (0.6, 0.999, -0.6), (15.0, 15.0, 15.0), white)
    b.add_area_light((0.4, 0.999, -0.4), (0.4, 0.999, -0.6),
                     (0.6, 0.999, -0.6), (15.0, 15.0, 15.0), white)
    scene = b.build("cpu", max_leaf_size=8)
    assert scene.tris.num == 1164
    return scene, cam


WALLS = [
    (((0, 0, 0), (0, 0, -1), (0, 1, -1)), "red"),
    (((0, 0, 0), (0, 1, 0), (0, 1, -1)), "red"),
    (((1, 0, 0), (1, 0, -1), (1, 1, -1)), "white"),
    (((1, 0, 0), (1, 1, 0), (1, 1, -1)), "white"),
    (((0, 0, 0), (1, 0, 0), (1, 0, -1)), "white"),
    (((0, 0, 0), (0, 0, -1), (1, 0, -1)), "white"),
    (((0, 1, 0), (1, 1, 0), (1, 1, -1)), "white"),
    (((0, 1, 0), (0, 1, -1), (1, 1, -1)), "white"),
    (((0, 0, -1), (1, 0, -1), (1, 1, -1)), "white"),
    (((0, 0, -1), (0, 1, -1), (1, 1, -1)), "white"),
]


def _frame(scene, cam, cfg, s, monkeypatch, seed=1):
    monkeypatch.setattr(wf, "STEPS_PER_READ", s)
    gen = torch.Generator().manual_seed(seed)
    before = counts.snapshot()
    fb, stats = wf.render_frame_linear(scene, cam, cfg, gen)
    return fb, stats, gen.get_state(), counts.delta(before,
                                                    counts.snapshot())


def _same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("cap", [None, 5], ids=["to_the_end", "cap5"])
@pytest.mark.parametrize("which", ["planes", "busy"])
def test_chunked_loop_is_bitwise_the_same_at_any_chunk(which, cap, request,
                                                       monkeypatch):
    scene, cam = request.getfixturevalue(which)
    cfg = RenderConfig(width=W, height=H, num_samples=16, max_bounces=3,
                       num_working_paths=POOL, detailed_stats=True,
                       direct_max_tris=0, max_iterations=cap)
    assert wf.resolve_sort_every(scene, cfg) == (2 if which == "planes"
                                                 else 1)
    runs = {s: _frame(scene, cam, cfg, s, monkeypatch) for s in (1, 3, 8)}
    fb, stats, gstate, launched = runs[1]
    its = stats["iterations"]
    assert its == cap if cap else its > 8
    assert stats["graphed"] is False
    assert isinstance(its, int) and isinstance(stats["rays_traced"], float)
    assert isinstance(stats["avg_occupancy"], float)
    assert float(fb.sum()) > 0 and launched
    for s, (fb_s, stats_s, gstate_s, launched_s) in runs.items():
        assert torch.equal(fb_s, fb), s
        assert stats_s.keys() == stats.keys()
        for k in stats:
            if k != "host_reads":
                assert _same(stats_s[k], stats[k]), (s, k)
        # one read a chunk, one for the rays and occupancy, one for the
        # detailed_stats sums
        assert stats_s["host_reads"] == math.ceil(its / s) + 2, s
        assert torch.equal(gstate_s, gstate), s
        assert launched_s == launched, s


def test_a_chunk_needs_a_step(planes, monkeypatch):
    scene, cam = planes
    monkeypatch.setattr(wf, "STEPS_PER_READ", 0)
    with pytest.raises(ValueError, match="STEPS_PER_READ"):
        wf.render_frame_linear(scene, cam, RenderConfig(
            width=4, height=4, num_samples=1, num_working_paths=64),
            torch.Generator())


def _words(seed, n):
    r = np.random.default_rng(seed)
    return torch.tensor(r.integers(0, 1 << 32, (wf.NUM_RNG_WORDS, n),
                                   dtype=np.int64))


def _fresh(cfg):
    c = wf.initial_carry(cfg, "cpu")
    return c[:3] + (torch.zeros((), dtype=torch.int64),) + c[4:]


@pytest.mark.parametrize("change", [
    dict(detailed_stats=True), dict(reference_parity=True, rr_start=0),
    dict(sort_rays=False), dict(sort_every=3, num_samples=16)], ids=str)
def test_steps_after_the_end_change_nothing(planes, change):
    scene, cam = planes
    kw = dict(width=8, height=8, num_samples=2, max_bounces=2,
              num_working_paths=256)
    cfg = RenderConfig(**{**kw, **change})
    carry = _fresh(cfg)
    for i in range(200):
        if not bool(wf._more(carry, cfg)):
            break
        carry = wf.frame_step(scene, cam, cfg, _words(i, 256), carry)
    assert 0 < int(carry[3]) == i < 200
    # the framebuffer, cam_start, it, work_left, rays, occupancy and the
    # detailed_stats sums
    keep = [t.clone() for t in carry[1:]]
    for j in range(3):
        carry = wf.frame_step(scene, cam, cfg, _words(1000 + j, 256), carry)
        for k, (a, b) in enumerate(zip(keep, carry[1:], strict=True)):
            assert torch.equal(a, b), (j, k)


@pytest.mark.parametrize("change", [
    dict(num_samples=4), dict(num_samples=16, sort_every=3),
    dict(num_samples=4, detailed_stats=True, direct_max_tris=0)], ids=str)
def test_device_cadence_equals_the_host_decision(planes, change):
    """Eight iterations from a fresh pool, both steps fed the same words:
    every state field, the framebuffer and the counters bit for bit, over
    iterations that sort and that skip (by the cadence and by the
    occupancy guard)."""
    scene, cam = planes
    cfg = RenderConfig(width=W, height=H, max_bounces=3,
                       num_working_paths=512, **change)
    assert wf.resolve_sort_every(scene, cfg) > 1
    DECISIONS.clear()
    new, old = _fresh(cfg), wf.initial_carry(cfg, "cpu")
    for it in range(8):
        words = _words(it, 512)
        new = wf.wavefront_step(scene, cam, cfg, words, new)
        old = _host_decision_step(scene, cam, cfg, words, old)
        assert int(new[3]) == old[3] == it + 1
        a, b = graph.flatten(new), graph.flatten(old)
        for k, (x, y) in enumerate(zip(a, b, strict=True)):
            if torch.is_tensor(y):
                assert torch.equal(x, y), (it, k)
    assert True in DECISIONS and False in DECISIONS
    # the occupancy guard sorted on an iteration off the cadence
    k = wf.resolve_sort_every(scene, cfg)
    assert any(d and i % k for i, d in enumerate(DECISIONS))


def test_step_takes_it_as_int_or_tensor(planes):
    scene, cam = planes
    cfg = RenderConfig(width=W, height=H, num_samples=4, max_bounces=3,
                       num_working_paths=512)
    carry = wf.initial_carry(cfg, "cpu")
    for it in range(3):
        carry = wf.wavefront_step(scene, cam, cfg, _words(it, 512), carry)
    assert carry[3] == 3 and type(carry[3]) is int
    as_int = (carry[0], carry[1].clone()) + carry[2:]
    as_tensor = (carry[0], carry[1].clone(), carry[2], torch.tensor(3)) + \
        carry[4:]
    a = wf.wavefront_step(scene, cam, cfg, _words(9, 512), as_int)
    b = wf.wavefront_step(scene, cam, cfg, _words(9, 512), as_tensor)
    assert type(a[3]) is int and a[3] == 4
    assert torch.is_tensor(b[3]) and int(b[3]) == 4
    b = b[:3] + (4,) + b[4:]
    for x, y in zip(graph.flatten(a), graph.flatten(b), strict=True):
        assert x == y if isinstance(x, int) else torch.equal(x, y)


# ------------------------------------------ (e) which steps read the host

class _HostRead(Exception):
    pass


def _trap(monkeypatch):
    """Make every tensor -> host conversion and every host tensor made
    on the way to the device raise ``_HostRead``."""
    def boom(*a, **k):
        raise _HostRead
    for name in ("__bool__", "__int__", "__float__", "__index__", "item",
                 "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch, "tensor", boom)


def _stub_kernels(monkeypatch):
    """Replace every kernel name render/trace.py calls by a function that
    returns misses (no walk: the plain walks read the host)."""
    def closest(*args, with_stats=False, binary=False, inst=False):
        tmax = args[-2]
        z = torch.zeros_like(tmax)
        prim = torch.full_like(tmax, -1, dtype=torch.int32)
        out = (torch.zeros_like(tmax, dtype=torch.bool), tmax) + \
            ((z, z) if binary else ()) + (prim,) + \
            ((torch.zeros_like(prim),) if inst else ()) + ((z, z, z),)
        zero = torch.zeros((), dtype=torch.int64)
        return out + (((zero, zero),) if with_stats else ())

    def anyhit(*args, with_stats=False, **kw):
        occ = torch.zeros_like(args[-1])
        zero = torch.zeros((), dtype=torch.int64)
        return (occ, (zero, zero)) if with_stats else occ

    for name in ("persist_traverse_closest", "wide_traverse_closest",
                 "lane_traverse_closest", "direct_closest"):
        monkeypatch.setattr(trace, name, closest)
    monkeypatch.setattr(trace, "wide_traverse_closest_inst",
                        lambda *a, **k: closest(*a, inst=True, **k))
    monkeypatch.setattr(trace, "traverse_closest",
                        lambda *a, **k: closest(*a[2:6], binary=True,
                                                with_stats=a[7] if len(a) > 7
                                                else False))
    for name in ("persist_traverse_anyhit", "wide_traverse_anyhit",
                 "direct_anyhit", "wide_traverse_anyhit_inst",
                 "traverse_anyhit"):
        monkeypatch.setattr(trace, name, anyhit)


def _instanced():
    """Three instances of one tetrahedron over a floor, with a light."""
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    mid = b.register_mesh(np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                                    [0.1, 0.25, -0.07]]),
                          np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3],
                                    [0, 1, 2]]))
    for x in (0.2, 0.5, 0.7):
        b.add_instance(mid, white, Transform(translate(x, 0, -0.4)))
    return b.build("cpu")


@pytest.mark.parametrize("inst, change", [
    (False, {}),
    (False, dict(traversal="xla")),
    (False, dict(sort_rays=False)),
    (False, dict(reference_parity=True)),
    (False, dict(one_sample_mis=True)),
    (False, dict(detailed_stats=True, walker="packet")),
    (False, dict(sort_every=2, num_samples=16)),
    (True, dict(two_level="kernel")),
    (True, dict(traversal="xla")),
    (True, dict(two_level="kernel", detailed_stats=True)),
    (True, {}),
    (True, dict(two_level="kernel", two_level_anyhit="repass")),
], ids=str)
def test_no_mode_reads_the_host_in_a_step(planes, inst, change,
                                          monkeypatch):
    """Every mode's step, repass's passes included, runs with every
    tensor-to-host conversion and host-to-device copy trapped: each can be
    captured."""
    scene, cam = planes
    if inst:
        scene = _instanced()
        assert scene.inst_tables is not None
    cfg = RenderConfig(**{**dict(width=8, height=8, num_samples=4,
                                 max_bounces=2, num_working_paths=256,
                                 direct_max_tris=0), **change})
    carry = _fresh(cfg)
    words = _words(0, 256)
    wf.blocked_pixel_table(8, 8, torch.device("cpu"))
    _stub_kernels(monkeypatch)
    carry = wf.frame_step(scene, cam, cfg, words, carry)
    # repass's loop takes its card path, which reads nothing (on the CPU
    # it reads the condition, as rtjax's while_loop does)
    from rtjax_torch.render import device_loop
    monkeypatch.setattr(device_loop, "_on_card", lambda pend: True)
    _trap(monkeypatch)
    wf.frame_step(scene, cam, cfg, words, carry)


# ------------------------------------------------- (f) the graph's carry

def test_device_loop_runs_every_pass_outside_a_capture(monkeypatch):
    """Outside a captured graph on the card (its path patched in here) a
    device loop runs its body ``n`` times, whatever the condition; inside
    one it is a while node (the card tests).  On the CPU it runs while
    the condition holds, as rtjax's ``while_loop`` does."""
    from rtjax_torch.render import device_loop
    for pend, on_cpu in ((torch.zeros(5, dtype=torch.bool), 0),
                         (torch.ones(5, dtype=torch.bool), 7)):
        assert sum(1 for _ in device_loop.passes(pend, 7)) == on_cpu
    flags = torch.ones(5, dtype=torch.bool)
    runs = 0
    for _ in device_loop.passes(flags, 7):
        runs += 1
        flags[runs - 1] = False
    assert runs == 5
    monkeypatch.setattr(device_loop, "_on_card", lambda pend: True)
    for pend in (torch.zeros(5, dtype=torch.bool),
                 torch.ones(5, dtype=torch.bool)):
        assert sum(1 for _ in device_loop.passes(pend, 7)) == 7


def test_graph_counts_a_loop_body_once_a_run(planes):
    """A captured step's launches outside its device loops are added once
    a replay; a loop body's, once for every run its device counter read
    since the last read (``StepGraph.account``)."""
    from types import SimpleNamespace

    from rtjax_torch.kernels import persist
    scene, cam = planes
    cfg = RenderConfig(width=W, height=H, num_samples=4, max_bounces=3,
                       num_working_paths=512)
    body = {(("persist", "LAUNCHES"), "closest"): 1}
    step = {(("persist", "LAUNCHES"), "closest"): 3,
            (("direct", "LAUNCHES"), "anyhit"): 2}
    graph.counts_sub(step, body)
    assert step == {(("persist", "LAUNCHES"), "closest"): 2,
                    (("direct", "LAUNCHES"), "anyhit"): 2}
    g = graph.StepGraph(scene, cam, cfg, _fresh(cfg))
    assert g.totals().shape == (0,)
    runs = torch.tensor(0, dtype=torch.int64)
    g.loops = SimpleNamespace(loops=[(runs, body)])
    g._runs = [0]
    before = counts.snapshot()
    try:
        start = persist.LAUNCHES["closest"]
        for now in (4, 4, 9):
            runs.fill_(now)
            g.account(g.totals().tolist())
        assert persist.LAUNCHES["closest"] - start == 9
    finally:
        counts.restore(before)


def test_store_copies_a_step_into_the_carry(planes):
    scene, cam = planes
    cfg = RenderConfig(width=W, height=H, num_samples=4, max_bounces=3,
                       num_working_paths=512, detailed_stats=True)
    static = _fresh(cfg)
    want = wf.frame_step(scene, cam, cfg, _words(0, 512), _fresh(cfg))
    fb = static[1]
    out = wf.frame_step(scene, cam, cfg, _words(0, 512), static)
    graph.store(static, out)
    assert static[1] is fb
    for x, y in zip(graph.flatten(static), graph.flatten(want), strict=True):
        assert torch.equal(x, y)
    # an output that does not fit, or that aliases the carry, is refused
    bad = (out[0], out[1], out[2], out[3].to(torch.int32)) + out[4:]
    with pytest.raises(RuntimeError, match="does not fit"):
        graph.store(static, bad)
    alias = (out[0], out[1], static[3], static[2]) + out[4:]
    with pytest.raises(RuntimeError, match="shares memory"):
        graph.store(static, alias)
    assert graph.cached() is None


# ------------------------------------------------------ (g) against rtjax

def test_frame_matches_rtjax_at_the_noise_floor():
    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    scene = scene_from_arrays(scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    kw = dict(width=W, height=H, num_samples=32, max_bounces=4,
              num_working_paths=POOL)
    imgs = []
    for seed in (1, 2):
        fb, stats = wf.render_frame(scene, cam, RenderConfig(**kw),
                                    torch.Generator().manual_seed(seed))
        imgs.append(fb.numpy().reshape(H, W, 3))
        assert stats["host_reads"] == math.ceil(
            stats["iterations"] / wf.STEPS_PER_READ) + 1
    jfb, _ = jax_frame(jscene, jcam, JaxConfig(**kw), jax.random.key(1))
    img_j = np.sqrt(np.asarray(jfb) / 32).reshape(H, W, 3)
    assert np.isfinite(imgs[0]).all() and (imgs[0] >= 0).all()
    assert mse(imgs[0], img_j) <= 2.0 * mse(imgs[0], imgs[1])


def _host_decision_step(scene, camera, cfg, words, carry):
    """The engine step before the loop moved to the device, verbatim but
    for the ``wf.`` prefixes, the pixel table made once and the record of
    its decisions: ``it`` a Python int, and with ``sort_every > 1`` the
    cadence decided on the host from one device read (``DECISIONS``)."""
    state, fb, cam_start, it, _, rays_traced, occ_sum, *extra = carry
    n = state.pixel.shape[0]
    dev = state.pixel.device
    num_lights = scene.num_lights
    parity = cfg.reference_parity
    cam_end = cfg.total_camera_rays
    draw_pair = lambda w: rng.u01_pair(words[w])
    u_rr, u_pick = draw_pair(wf._W_RR_PICK)

    # ---- emission, Russian roulette, routing ------------------------------
    if 0 < num_lights <= 16:
        # the light id by comparing the hit prim with the emitter triangles
        light_idx = torch.full_like(state.prim, wf.INVALID_INDEX)
        for li in range(num_lights):
            ltri_l = scene.lights.tri[li]
            light_idx = torch.where((state.prim == ltri_l) & (ltri_l >= 0)
                                    & (state.src == 0), li, light_idx)
    else:
        light_idx = torch.where(
            state.src == 0, vec.take_rows(scene.prim_light, state.prim),
            wf.INVALID_INDEX)
    emit0 = state.hit & (light_idx >= 0) & (state.bounces == 0)
    emit_li = torch.clamp(light_idx, min=0)
    emit_val = tuple(vec.take_rows(scene.lights.emit[:, k], emit_li)
                     for k in range(3))
    acc = wf._accum(state.acc, emit_val, emit0)
    # the constant environment light on a miss (a BSDF-sampled channel
    # that NEE never samples, so it takes no MIS weight)
    env_mask = ~state.hit & (state.bounces <= cfg.max_bounces)
    env = scene.env_radiance
    acc = wf._accum(acc, vec.mul(state.beta, (env[0], env[1], env[2])),
                 env_mask)

    alive = state.bounces < cfg.max_bounces
    beta = state.beta
    beta_max = vec.vmax(beta)
    rr_cand = alive & state.hit & (state.bounces > cfg.rr_start) & \
        (beta_max < cfg.rr_threshold)
    p_term = torch.clamp(1.0 - beta_max, min=0.05)
    rr_kill = rr_cand & (u_rr < p_term)
    rr_boost = torch.where(rr_cand & ~rr_kill, 1.0 / (1.0 - p_term), 1.0)
    beta = vec.scale(rr_boost, beta)
    bounces = state.bounces + 1
    mat_mask = alive & state.hit & ~rr_kill

    # ---- the sort: the iteration's one compaction step -------------------
    hp_t = torch.where(mat_mask, state.t, 0.0)
    hp = vec.add(state.ray_o, vec.scale(hp_t, state.ray_d))
    state_sorted = cfg.sort_rays and wf.resolve_mode(scene, cfg) != "xla"
    # the reference's RR "limbo" (parity): a killed path keeps its payload
    # (and hit) for later re-rolls; it neither shades, traces nor
    # regenerates
    limbo = rr_kill if parity else None
    do_gen = True
    if not state_sorted:
        # the unsorted engine: every lane keeps its slot
        pixel, ray_o_p, ray_d_p, t_p, normal, prim, src = (
            state.pixel, state.ray_o, state.ray_d, state.t, state.normal,
            state.prim, state.src)
        p = hp
    elif parity:
        # every iteration sorts, with the full state
        bundle = (state.pixel, state.ray_o, state.ray_d, state.t,
                  state.normal, state.prim, state.src, bounces, beta, acc,
                  mat_mask, limbo)
        (pixel, ray_o_p, ray_d_p, t_p, normal, prim, src, bounces, beta, acc,
         mat_mask, limbo) = wf.sort_pytree_by_key(
             wf._sort_keys(scene, cfg, state, hp, bounces, mat_mask), bundle)
        p = vec.add(ray_o_p, vec.scale(torch.where(mat_mask, t_p, 0.0),
                                       ray_d_p))
    else:
        compact = wf._compact_bundle_ok(scene, cfg)
        k_req = wf.resolve_sort_every(scene, cfg) if compact else 1
        if k_req > 1:
            # sort, gen and flush only every k-th iteration, or when the
            # live part drops below 3/4 of the pool (one device read)
            num_mat_pre = int(mat_mask.sum())
            do_gen = (it % k_req) == 0 or num_mat_pre * 4 < n * 3
            DECISIONS.append(do_gen)
        if do_gen:
            dirty = ~mat_mask & ((acc[0] != 0.0) | (acc[1] != 0.0)
                                 | (acc[2] != 0.0))
            skeys = torch.where(dirty, wf._DIRTY_KEY, wf._sort_keys(
                scene, cfg, state, hp, bounces, mat_mask))
        sort = lambda bundle: wf.sort_pytree_by_key(skeys, bundle) \
            if do_gen else bundle
        if compact:
            # packed bundle: pixel | bounces (7 bits, 127 = dead) | mat
            # bit; prim + 1 | src; octahedral normal and direction;
            # RGB9E5 beta and acc
            b7 = torch.clamp(bounces, max=127)
            pbm = state.pixel | (b7 << 21) | (mat_mask.to(torch.int32) << 28)
            sp = (state.prim + 1) | (state.src << 23)
            p, b9, a9, pbm, sp, onrm, od = sort((
                hp, wf.rgb9e5_encode_v3(beta), wf.rgb9e5_encode_v3(acc), pbm, sp,
                wf.oct_encode_v3(state.normal), wf.oct_encode_v3(state.ray_d)))
            ray_d_p = wf.oct_decode_v3(od)
            beta = wf.rgb9e5_decode_v3(b9)
            acc = wf.rgb9e5_decode_v3(a9)
            pixel = pbm & 0x1FFFFF
            b_dec = (pbm >> 21) & 0x7F
            bounces = torch.where(b_dec >= 127, wf.DEAD_BOUNCES, b_dec)
            mat_mask = ((pbm >> 28) & 1) != 0
            prim = (sp & 0x7FFFFF) - 1
            src = (sp >> 23) & 0xFF
            normal = wf.oct_decode_v3(onrm)
        else:
            # the wide bundle (frames above 2^21 pixels, more than 255
            # instances, max_bounces >= 126): every field at full
            # precision, bounces (15 bits, 0x7FFF = dead) and the mat bit
            # in one word.  src rides in a column of its own: rtjax packs
            # it in 12 bits, which an instance id above 4,095 overflows
            # into the mat bit.
            meta = torch.clamp(bounces, max=0x7FFF) | \
                (mat_mask.to(torch.int32) << 15)
            pixel, p, ray_d_p, normal, prim, src, beta, acc, meta = sort((
                state.pixel, hp, state.ray_d, state.normal, state.prim,
                state.src, beta, acc, meta))
            mat_mask = ((meta >> 15) & 1) != 0
            b_dec = meta & 0x7FFF
            bounces = torch.where(b_dec >= 0x7FFF, wf.DEAD_BOUNCES, b_dec)
        ray_o_p = p  # a dead lane's ray is never read
    gen_mask = ~mat_mask & ~limbo if parity else ~mat_mask

    # ---- shading (full width; see the module docstring) -------------------
    b1u1, b1u2 = draw_pair(wf._W_BSDF1)
    b2u1, b2u2 = draw_pair(wf._W_BSDF2)
    sh = wf._shade(scene, cfg, src, prim, beta, p, ray_d_p, normal, mat_mask,
                (b1u1, b1u2, b1u1), u_pick, draw_pair(wf._W_LIGHT_UV),
                (b2u1, b2u2, b2u1))

    # ---- camera generation into the dead suffix ---------------------------
    gen_u, gen_v = draw_pair(wf._W_GEN)
    if do_gen:
        num_gen = gen_mask.sum()
        if parity or not state_sorted:
            # the dead lanes are not a suffix (unsorted, or limbo lanes
            # among them): rank by a prefix sum
            gen_rank = torch.cumsum(gen_mask, 0) - gen_mask.long()
            cam_id = cam_start + gen_rank
            got_ray = gen_mask & (cam_id < cam_end)
        else:
            # after the sort the continuing lanes are exactly the prefix
            num_mat = n - num_gen
            idx = torch.arange(n, dtype=torch.int32, device=dev)
            gen_rank = torch.clamp(idx - num_mat, min=0)
            cam_id = cam_start + gen_rank
            got_ray = (idx >= num_mat) & (cam_id < cam_end)
        pix_rank = torch.clamp(torch.div(cam_id, cfg.num_samples,
                                         rounding_mode="floor"),
                               max=cfg.num_pixels - 1)
        blocked = (cfg.camera_order == "blocked"
                   or (cfg.camera_order == "auto" and cfg.num_samples <= 8))
        if blocked:
            order = wf.blocked_pixel_table(cfg.width, cfg.height, dev)
            pix_new = order[pix_rank.long()]
        else:
            pix_new = pix_rank.to(torch.int32)
        ci = (pix_new % cfg.width).to(torch.float32)
        cj = torch.div(pix_new, cfg.width, rounding_mode="floor") \
            .to(torch.float32)
        cam_o, cam_d = camera.get_rays_v3((ci + gen_u) / cfg.width,
                                          (cj + gen_v) / cfg.height)
        # flush the radiance of slots leaving their pixel
        flush = torch.stack([torch.where(gen_mask, c, 0.0) for c in acc], 1)
        fb.index_add_(0, pixel.long(), flush)
        acc = tuple(torch.where(gen_mask, 0.0, c) for c in acc)
    else:
        num_gen = torch.zeros((), dtype=torch.int64, device=dev)
        got_ray = torch.zeros(n, dtype=torch.bool, device=dev)
        pix_new = torch.zeros(n, dtype=torch.int32, device=dev)
        zf = torch.zeros(n, dtype=torch.float32, device=dev)
        cam_o = cam_d = (zf, zf, zf)

    # ---- merge continued and regenerated rays ------------------------------
    ray_o = vec.where(mat_mask, sh["next_o"],
                      vec.where(got_ray, cam_o, ray_o_p))
    ray_d = vec.where(mat_mask, sh["next_d"],
                      vec.where(got_ray, cam_d, ray_d_p))
    pixel = torch.where(got_ray, pix_new, pixel)
    beta = tuple(torch.where(mat_mask, nb, torch.where(got_ray, 1.0, b))
                 for nb, b in zip(sh["next_beta"], beta))
    bounces = torch.where(got_ray, 0,
                          torch.where(gen_mask, wf.DEAD_BOUNCES, bounces))

    # ---- traversal ---------------------------------------------------------
    stats = cfg.detailed_stats
    trace_mask = mat_mask | got_ray
    ray_o = tuple(c.contiguous() for c in ray_o)
    ray_d = tuple(c.contiguous() for c in ray_d)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    hit, ht, hprim, hsrc, hnrm, *cst = wf.trace_closest(
        scene, cfg, ray_o, ray_d, inf, trace_mask, with_stats=stats)
    traced = trace_mask.sum(dtype=torch.float64)
    ast = None
    if num_lights > 0 and cfg.one_sample_mis:
        # the BSDF-MIS channel's "closest hit == the picked light's
        # triangle" is read off the path ray's hit: one N-ray any-hit
        # launch, and only its traversals are counted
        occluded = wf.trace_anyhit(scene, cfg, sh["ah_o"], sh["ah_d"],
                                sh["ah_tmax"], sh["ltri"], sh["ah_mask"],
                                with_stats=stats)
        if stats:
            occluded, ast = occluded
        chs_ok = hit & (hsrc == 0) & (hprim == sh["ltri"])
        acc = wf._accum(acc, sh["ah_L"], sh["ah_mask"] & ~occluded)
        acc = wf._accum(acc, sh["chs_L"], sh["chs_mask"] & chs_ok)
        traced = traced + sh["ah_mask"].sum(dtype=torch.float64)
    elif num_lights > 0:
        # both shadow channels ride one 2N any-hit launch
        cat = lambda a, b: torch.cat([a, b])
        cat3 = lambda a, b: tuple(cat(x, y) for x, y in zip(a, b))
        occ2 = wf.trace_anyhit(scene, cfg, cat3(sh["ah_o"], sh["chs_o"]),
                            cat3(sh["ah_d"], sh["chs_d"]),
                            cat(sh["ah_tmax"], sh["chs_t"]),
                            cat(sh["ltri"], sh["chs_tgt"]),
                            cat(sh["ah_mask"], sh["chs_mask"]),
                            with_stats=stats)
        if stats:
            occ2, ast = occ2
        occluded, chs_occ = occ2[:n], occ2[n:]
        acc = wf._accum(acc, sh["ah_L"], sh["ah_mask"] & ~occluded)
        acc = wf._accum(acc, sh["chs_L"], sh["chs_mask"] & ~chs_occ)
        traced = traced + sh["ah_mask"].sum(dtype=torch.float64) + \
            sh["chs_mask"].sum(dtype=torch.float64)

    work_left = trace_mask.any()
    if parity:
        # limbo slots did not trace: the payload the kernel cleared
        # survives for the next re-roll, and the frame waits for them
        hit = hit | limbo
        ht = torch.where(limbo, t_p, ht)
        hnrm = vec.where(limbo, normal, hnrm)
        hprim = torch.where(limbo, prim, hprim)
        hsrc = torch.where(limbo, src, hsrc)
        work_left = work_left | limbo.any()

    new_state = wf.PathState(pixel=pixel, ray_o=ray_o, ray_d=ray_d, hit=hit,
                          t=ht, normal=hnrm, prim=hprim, src=hsrc,
                          bounces=bounces, beta=beta, acc=acc)
    occupancy = trace_mask.sum(dtype=torch.float64) / n
    if stats:
        # bounce-depth histogram of traced path rays (depth 0 = camera
        # rays) and the traversal counts, summed on the device
        hist, steps, leafs, ah_steps, ah_leafs = extra
        depth = torch.clamp(bounces, 0, cfg.max_bounces).long()
        hist = hist.index_add(0, depth, trace_mask.to(hist.dtype))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ast = ast if ast is not None else (zero, zero)
        extra = (hist, steps + cst[0][0], leafs + cst[0][1],
                 ah_steps + ast[0], ah_leafs + ast[1])
    return (new_state, fb, cam_start + num_gen, it + 1, work_left,
            rays_traced + traced, occ_sum + occupancy) + tuple(extra)
