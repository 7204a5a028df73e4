"""rtjax_torch's estimator modes and detailed stats vs rtjax.

(a) State for state, as ``test_torch_wavefront.py``'s
    ``test_step_matches_rtjax_state_for_state`` does it (rtjax stepping op
    by op under ``jax.disable_jit()`` with its sorted engine, its own
    random words injected into the port): iterations under
    ``reference_parity`` (Russian roulette from bounce 1, so that limbo
    slots appear), ``one_sample_mis``, an environment light
    (``set_environment`` on both builders) and ``detailed_stats``.
    Integer and bool fields exactly (the prim of an equal-t tie masked),
    floats at rtol 1e-5 / atol 1e-6, the bounce histogram and
    ``rays_traced`` exactly.  The node and leaf counts are not compared
    with rtjax's, which count TPU walk rounds.
(b) Ports of rtjax's own tests of these features (tests/test_parity.py,
    tests/test_metrics_and_semantics.py, tests/test_features.py), on the
    port's CPU path.
(c) The counting plain walks and the trace glue's sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax import SceneBuilder as JaxSceneBuilder
from rtjax.core import rng as jax_rng
from rtjax.render import wavefront as jax_wf

from rtjax_torch import RenderConfig
from rtjax_torch.kernels import persist as P
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder, scene_from_arrays
from rtjax_torch.utils.compare import mse, psnr, ssim

from scenes import COLORS, WALLS, cornell, default_camera
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_wavefront import STATE_INT, STATE_VEC, _close, _port_carry

POOL = 4096
W = H = 32
ENV = (0.4, 0.5, 0.6)


def _cornell_env(b):
    """The Cornell box of tests/scenes.py (open at the front) with its
    ceiling light and a constant environment light, on either builder."""
    mats = {name: b.make_matte(c) for name, c in COLORS.items()}
    for (p0, p1, p2), mat in WALLS:
        b.add_triangles(p0, p1, p2, mats[mat])
    h = 0.25
    b.add_area_light((0.5 - h, 0.999, -0.5 + h), (0.5 + h, 0.999, -0.5 + h),
                     (0.5 + h, 0.999, -0.5 - h), (4.0, 4.0, 4.0),
                     mats["white"])
    b.add_area_light((0.5 - h, 0.999, -0.5 + h), (0.5 - h, 0.999, -0.5 - h),
                     (0.5 + h, 0.999, -0.5 - h), (4.0, 4.0, 4.0),
                     mats["white"])
    b.set_environment(ENV)


@pytest.fixture(scope="module")
def scenes():
    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    jb = JaxSceneBuilder()
    _cornell_env(jb)
    jenv = jb.build(max_leaf_size=4)
    b = SceneBuilder()
    _cornell_env(b)
    env = b.build("cpu", max_leaf_size=4)
    return {"plain": (jscene, scene_from_arrays(scene_arrays(jscene), "cpu")),
            "env": (jenv, env)}, jcam, cam


MODES = {
    "reference_parity": ("plain", dict(reference_parity=True, rr_start=0)),
    "one_sample_mis": ("plain", dict(one_sample_mis=True)),
    "environment": ("env", {}),
    "detailed_stats": ("plain", dict(detailed_stats=True)),
}


def _rr_kills(state, words, cfg):
    """Slots that the iteration's Russian roulette kills (rtjax's rule)."""
    beta_max = np.maximum(np.maximum(state.beta[0], state.beta[1]),
                          state.beta[2])
    alive = state.bounces < cfg.max_bounces
    cand = alive & state.hit & (state.bounces > cfg.rr_start) & \
        (beta_max < cfg.rr_threshold)
    u_rr = (words[0] >> 16).astype(np.float32) * np.float32(2.0 ** -16)
    return cand & (u_rr < np.maximum(np.float32(0.05), 1.0 - beta_max))


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_rtjax_state_for_state(scenes, mode):
    pair, jcam, cam = scenes
    which, change = MODES[mode]
    jscene, scene = pair[which]
    assert float(scene.env_radiance.sum()) == (sum(ENV) if which == "env"
                                               else 0.0)
    np.testing.assert_array_equal(scene.env_radiance.numpy(),
                                  np.asarray(jscene.env_radiance))
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL, **change)
    jcfg = JaxConfig(traversal="pallas", sort_every=0, **kw)
    cfg = RenderConfig(**kw)
    stats = cfg.detailed_stats
    key = jax.random.key(1)
    jc = (jax_wf.make_initial_state(POOL),
          jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
          jnp.int32(0), jnp.bool_(False), jnp.float32(0), jnp.float32(0))
    if stats:
        jc += (jnp.zeros(cfg.max_bounces + 1, jnp.int32),) + \
            (jnp.int32(0),) * 4
    tris = jscene.tris
    kills = misses = 0
    steps = None
    for it in range(4):
        c = _port_carry(jc)
        if stats:
            zero = torch.zeros((), dtype=torch.int64)
            c += (torch.tensor(np.asarray(jc[7]), dtype=torch.int64),) + \
                (steps or (zero,) * 4)
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                                  POOL)).astype(np.int64)
            kills += int(_rr_kills(jax.tree_util.tree_map(np.asarray, jc[0]),
                                   words, cfg).sum())
            jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
        js, s = jc[0], c[0]

        hit = np.asarray(js.hit)
        misses += int((~hit & (np.asarray(js.bounces) < 1 << 20)).sum())
        ro = np.stack([np.asarray(x, np.float64) for x in s.ray_o], 1)
        rd = np.stack([np.asarray(x, np.float64) for x in s.ray_d], 1)
        t_want = np.where(hit, np.asarray(js.t), 0.0)
        uniq = ~hit | _unique_t(tris, ro, rd, np.full(POOL, np.inf),
                                t_want.astype(np.float64))
        assert uniq.sum() >= POOL - 4
        for f in STATE_INT:
            got, want = getattr(s, f).numpy(), np.asarray(getattr(js, f))
            m = uniq if f == "prim" else np.ones(POOL, bool)
            np.testing.assert_array_equal(got[m], want[m], err_msg=f)
        for f in STATE_VEC:
            m = hit & uniq if f == "normal" else np.ones(POOL, bool)
            for k in range(3):
                _close(getattr(s, f)[k].numpy()[m],
                       np.asarray(getattr(js, f)[k])[m], f"{f}[{k}]")
        _close(s.t.numpy()[hit], np.asarray(js.t)[hit], "t")
        _close(c[1].numpy(), np.asarray(jc[1]), "framebuffer")
        assert int(c[2]) == int(jc[2]), "cam_start"
        assert float(c[5]) == float(jc[5]), "rays traced"
        assert c[3] == int(jc[3]) == it + 1
        assert bool(c[4]) == bool(jc[4])
        if stats:
            np.testing.assert_array_equal(c[7].numpy(), np.asarray(jc[7]))
            steps = c[8:]
    assert hit.sum() > POOL // 2
    if stats:
        assert all(int(v) > 0 for v in steps)
    if mode == "reference_parity":
        assert kills > 0   # limbo slots were made and carried
    if mode == "environment":
        assert misses > 0  # paths left the box and met the environment


def test_one_sample_mis_with_reference_parity_raises(scenes):
    pair, _, cam = scenes
    cfg = RenderConfig(width=8, height=8, num_samples=1, max_bounces=1,
                       num_working_paths=256, one_sample_mis=True,
                       reference_parity=True)
    with pytest.raises(ValueError, match="reference_parity"):
        wf.render_frame(pair["plain"][1], cam, cfg, torch.Generator())


def test_one_sample_mis_traces_n_shadow_rays(scenes):
    """One N-ray any-hit launch per iteration in place of the 2N one."""
    pair, _, cam = scenes
    scene = pair["plain"][1]
    sizes = []
    orig = trace.persist_traverse_anyhit

    def spy(tables, o, d, tmax, exclude, active, **kw):
        sizes.append(tmax.shape[0])
        return orig(tables, o, d, tmax, exclude, active, **kw)

    for osm in (False, True):
        sizes.clear()
        cfg = RenderConfig(width=16, height=16, num_samples=2, max_bounces=2,
                           num_working_paths=1024, one_sample_mis=osm)
        trace.persist_traverse_anyhit = spy
        try:
            wf.render_frame(scene, cam, cfg, torch.Generator().manual_seed(1))
        finally:
            trace.persist_traverse_anyhit = orig
        assert sizes and set(sizes) == {1024 if osm else 2048}


# ------------------------------------------------- ports of rtjax's tests

def _floor_builder():
    sb = SceneBuilder()
    m = sb.make_matte((0.7, 0.7, 0.7))
    sb.add_triangles([(-2, 0, -2), (2, 0, -2)], [(2, 0, -2), (2, 0, 2)],
                     [(-2, 0, 2), (-2, 0, 2)], m)
    return sb, m


def _cam():
    return Camera.make((0, 1.2, 3), (0, 0.2, 0), (0, 1, 0), 45.0, 1.0,
                       device="cpu")


def _frame(scene, cam, cfg, seed):
    fb, st = wf.render_frame(scene, cam, cfg,
                             torch.Generator().manual_seed(seed))
    return fb.numpy(), st


def test_parity_noop_without_quirk_paths():
    """rtjax's test_parity_noop_without_quirk_paths: a delta light and
    bounces below the RR start, so no quirk can fire.  rtjax holds the two
    estimators bitwise on its unsorted CPU path; the port's parity mode
    sorts the unpacked state without the dirty-slot key class (as rtjax's
    sorted engine does), which reorders dead slots and so the random words
    camera paths draw.  Held here: the images agree within the noise of
    two seeds of the fixed estimator, and a single-iteration frame (every
    slot dead before the sort, so both orders agree) bitwise."""
    sb, _ = _floor_builder()
    sb.add_point_light((0, 2, 0), (10.0, 10.0, 10.0))
    scene = sb.build("cpu")
    cfg = RenderConfig(width=24, height=24, num_samples=8, max_bounces=3,
                       num_working_paths=1 << 11, sort_every=1)
    par = dataclasses.replace(cfg, reference_parity=True)
    fixed, _ = _frame(scene, _cam(), cfg, 3)
    fixed2, _ = _frame(scene, _cam(), cfg, 4)
    parity, _ = _frame(scene, _cam(), par, 3)
    assert mse(fixed, parity) <= 2.0 * mse(fixed, fixed2)
    assert abs(fixed.mean() - parity.mean()) < 0.02 * fixed.mean()
    one = dict(max_iterations=1)
    a, _ = _frame(scene, _cam(), dataclasses.replace(cfg, **one), 3)
    b, _ = _frame(scene, _cam(), dataclasses.replace(par, **one), 3)
    np.testing.assert_array_equal(a, b)


def test_parity_matte_area_light_agrees_in_mean():
    """For matte surfaces the reference's two MIS quirks nearly cancel
    (plain NEE): the means agree to noise."""
    sb, m = _floor_builder()
    sb.add_area_light((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0, 1.5, 0.5),
                      (8.0, 8.0, 8.0), m)
    scene = sb.build("cpu")
    cfg = RenderConfig(width=24, height=24, num_samples=64, max_bounces=3,
                       num_working_paths=1 << 12)
    fixed, _ = _frame(scene, _cam(), cfg, 3)
    parity, _ = _frame(scene, _cam(),
                       dataclasses.replace(cfg, reference_parity=True), 3)
    assert abs(fixed.mean() - parity.mean()) / fixed.mean() < 0.03


def test_parity_mirror_loses_specular_light_reflection():
    """A mirror floor reflects the light only through the BSDF-sampling
    channel, which the reference's own-triangle target loses: the parity
    image is much darker."""
    sb = SceneBuilder()
    mi = sb.make_mirror((0.9, 0.9, 0.9))
    sb.add_triangles([(-2, 0, -2), (2, 0, -2)], [(2, 0, -2), (2, 0, 2)],
                     [(-2, 0, 2), (-2, 0, 2)], mi)
    sb.add_area_light((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0, 1.5, 0.5),
                      (8.0, 8.0, 8.0), mi)
    scene = sb.build("cpu")
    cfg = RenderConfig(width=32, height=32, num_samples=32, max_bounces=3,
                       num_working_paths=1 << 12)
    fixed, _ = _frame(scene, _cam(), cfg, 5)
    parity, _ = _frame(scene, _cam(),
                       dataclasses.replace(cfg, reference_parity=True), 5)
    assert parity.mean() < 0.6 * fixed.mean(), (fixed.mean(), parity.mean())


def test_parity_rr_limbo_terminates_and_is_biased_up():
    """Limbo paths re-roll until they survive or pass max_bounces: the
    render terminates and stays finite."""
    sb, m = _floor_builder()
    sb.add_area_light((-0.5, 1.5, -0.5), (0.5, 1.5, -0.5), (0, 1.5, 0.5),
                      (8.0, 8.0, 8.0), m)
    scene = sb.build("cpu")
    cfg = RenderConfig(width=16, height=16, num_samples=16, max_bounces=10,
                       num_working_paths=1 << 11, reference_parity=True)
    fb, stats = _frame(scene, _cam(), cfg, 7)
    assert np.isfinite(fb).all()
    assert fb.mean() > 0
    assert stats["iterations"] >= 1


def _plane_scene():
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([-2, 0, 2], [2, 0, 2], [2, 0, -2], white)
    b.add_triangles([-2, 0, 2], [-2, 0, -2], [2, 0, -2], white)
    b.add_area_light([-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5],
                     (8, 8, 8), white)
    return b.build("cpu"), Camera.make((0, 1.2, 2.5), (0, 0, 0), (0, 1, 0),
                                       40, 1.0, device="cpu")


def test_detailed_stats_counters():
    """detailed_stats adds the bounce histogram and the traversal counts
    without changing the image."""
    scene, cam = _plane_scene()
    cfg = RenderConfig(width=16, height=16, num_samples=8, max_bounces=4,
                       num_working_paths=1024, detailed_stats=True)
    fb, st = _frame(scene, cam, cfg, 1)
    hist = st["bounce_histogram"].numpy()
    assert hist.shape == (cfg.max_bounces + 1,)
    # every camera sample appears at depth 0; depths can only shrink
    assert hist[0] == cfg.num_pixels * cfg.num_samples
    assert (np.diff(hist) <= 0).all()
    assert st["node_steps"] > 0 and st["leaf_visits"] > 0
    assert 0 < st["anyhit_steps"] < st["node_steps"]
    assert 0 < st["anyhit_visits"] < st["leaf_visits"]
    fb0, st0 = _frame(scene, cam,
                      dataclasses.replace(cfg, detailed_stats=False), 1)
    np.testing.assert_array_equal(fb, fb0)
    assert "bounce_histogram" not in st0
    assert st0["rays_traced"] == st["rays_traced"]


def test_detailed_stats_histogram_sums_to_path_rays():
    """The histogram counts the path rays traced: with no light the
    traversals are path rays alone."""
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([-2, 0, 2], [2, 0, 2], [2, 0, -2], white)
    b.add_triangles([-2, 0, 2], [-2, 0, -2], [2, 0, -2], white)
    b.set_environment((1.0, 1.0, 1.0))
    scene = b.build("cpu")
    cam = Camera.make((0, 1.2, 2.5), (0, 0, 0), (0, 1, 0), 40, 1.0,
                      device="cpu")
    cfg = RenderConfig(width=16, height=16, num_samples=4, max_bounces=3,
                       num_working_paths=1024, detailed_stats=True)
    _, st = _frame(scene, cam, cfg, 2)
    assert int(st["bounce_histogram"].sum()) == st["rays_traced"]
    assert st["anyhit_steps"] == st["anyhit_visits"] == 0


def _env_probe():
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles([100, 100, 100], [101, 100, 100], [100, 101, 100], m)
    b.set_environment((0.49, 0.49, 0.49))
    return b.build("cpu"), Camera.make((0, 0, 3), (0, 0, 0), (0, 1, 0), 40,
                                       1.0, device="cpu")


def test_windowed_flush_loses_no_radiance():
    """Every camera ray carries exactly the environment's radiance, so a
    lost flush shows as a dark pixel (atol: RGB9E5 acc quantization)."""
    scene, cam = _env_probe()
    cfg = RenderConfig(width=32, height=32, num_samples=16, max_bounces=3,
                       num_working_paths=1 << 10)
    fb, _ = _frame(scene, cam, cfg, 2)
    np.testing.assert_allclose(fb, 0.7, atol=2e-3)


def test_sort_every_conserves_radiance():
    """sort_every=2 skips gen and flush on alternate iterations: the
    constant-environment probe catches a dropped or doubled flush, and the
    Cornell mean an estimator biased by the schedule."""
    scene, cam = _env_probe()
    cfg = RenderConfig(width=32, height=32, num_samples=16, max_bounces=3,
                       num_working_paths=1 << 10, sort_every=2)
    fb, st = _frame(scene, cam, cfg, 2)
    np.testing.assert_allclose(fb, 0.7, atol=2e-3)
    assert st["rays_traced"] == 32 * 32 * 16

    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    scene2 = scene_from_arrays(scene_arrays(jscene), "cpu")
    cfg2 = RenderConfig(width=24, height=24, num_samples=48, max_bounces=4,
                        num_working_paths=1 << 12)
    a, _ = _frame(scene2, cam, dataclasses.replace(cfg2, sort_every=1), 3)
    b2, _ = _frame(scene2, cam, dataclasses.replace(cfg2, sort_every=2), 3)
    assert np.isfinite(b2).all()
    assert abs(a.mean() - b2.mean()) < 0.01


def test_environment_light_analytic():
    """A matte floor under a constant environment: sky pixels read the
    environment exactly, floor pixels a value between one bounce and the
    geometric series."""
    b = SceneBuilder()
    alb = 0.6
    m = b.make_matte((alb, alb, alb))
    b.add_triangles([-50, 0, 50], [50, 0, 50], [50, 0, -50], m)
    b.add_triangles([-50, 0, 50], [-50, 0, -50], [50, 0, -50], m)
    b.set_environment((1.0, 1.0, 1.0))
    scene = b.build("cpu")
    cam = Camera.make((0, 2, 6), (0, 0, 0), (0, 1, 0), 50, 1.0, device="cpu")
    cfg = RenderConfig(width=24, height=24, num_samples=128, max_bounces=6,
                       num_working_paths=4096)
    fb, _ = _frame(scene, cam, cfg, 2)
    img = fb.reshape(24, 24, 3)
    assert abs(img[0:4].mean() - 1.0) < 0.02
    floor = img[16:22].mean() ** 2  # undo gamma
    assert alb - 0.05 < floor < alb / (1 - alb) + 0.05


def test_metrics_identities():
    rng = np.random.default_rng(0)
    a = rng.random((32, 32, 3))
    assert mse(a, a) == 0.0
    assert psnr(a, a) == float("inf")
    assert abs(ssim(a, a) - 1.0) < 1e-12
    b = a + 0.1
    assert mse(a, b) > 0
    assert ssim(a, b) < 1.0
    from rtjax.utils import compare as jax_compare
    for fn in ("mse", "psnr", "ssim"):
        assert getattr(jax_compare, fn)(a, b) == {"mse": mse, "psnr": psnr,
                                                  "ssim": ssim}[fn](a, b)


def test_profiler_prints_rtjax_text(caplog):
    from rtjax_torch.utils.profiler import Profiler
    prof = Profiler()
    with caplog.at_level("INFO", logger="rtjax_torch"):
        import logging
        logging.getLogger("rtjax_torch").addHandler(caplog.handler)
        try:
            with prof.phase("Rendering"):
                pass
        finally:
            logging.getLogger("rtjax_torch").removeHandler(caplog.handler)
    assert any(r.getMessage().startswith("Rendering... done. (")
               and r.getMessage().endswith(" ms)") for r in caplog.records)
    assert "Rendering" in prof.records
    with pytest.raises(RuntimeError):
        prof.stop()


# ------------------------------------------------- counting walks

def test_plain_walk_stats_equal_work_counts(scenes):
    pair, _, _ = scenes
    scene = pair["plain"][1]
    g = np.random.default_rng(3)
    n = 512
    o = tuple(torch.tensor(g.uniform(0.05, 0.95, n).astype(np.float32))
              for _ in range(3))
    o = (o[0], o[1], -o[2])
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d = tuple(torch.tensor(c) for c in d)
    tmax = torch.full((n,), float("inf"))
    active = torch.tensor(g.random(n) > 0.2)
    ex = torch.tensor(g.integers(-1, scene.tris.num, n).astype(np.int32))
    tab = scene.tables
    work = P.new_work()
    want = P.persist_traverse_closest_ref(tab, o, d, tmax, active, work=work)
    got = P.persist_traverse_closest(tab, o, d, tmax, active,
                                     with_stats=True)
    for a, b in zip(want, got[:4]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert got[4][0].dtype == torch.int64 and got[4][0].dim() == 0
    assert (int(got[4][0]), int(got[4][1])) == (work["node_visits"],
                                                work["leaf_rows"])
    dist = torch.full((n,), 0.7)
    work = P.new_work()
    occ = P.persist_traverse_anyhit_ref(tab, o, d, dist, ex, active,
                                        work=work)
    occ2, (steps, leafs) = P.persist_traverse_anyhit(tab, o, d, dist, ex,
                                                     active, with_stats=True)
    assert torch.equal(occ, occ2) and bool(occ.any())
    assert (int(steps), int(leafs)) == (work["node_visits"],
                                        work["leaf_rows"])


def test_repass_stats_sum_every_pass():
    """Under repass, the counts of trace_closest / trace_anyhit are the
    sum of the base launch's and every pass's."""
    from test_torch_wavefront import _instanced_scene
    scene = _instanced_scene()
    cfg = RenderConfig(detailed_stats=True)
    g = np.random.default_rng(5)
    n = 256
    o = (torch.tensor(g.uniform(0.1, 0.9, n).astype(np.float32)),
         torch.full((n,), 0.5), torch.tensor(
             -g.uniform(0.1, 0.9, n).astype(np.float32)))
    d = (torch.tensor(g.uniform(-0.3, 0.3, n).astype(np.float32)),
         torch.full((n,), -1.0), torch.tensor(
             g.uniform(-0.3, 0.3, n).astype(np.float32)))
    d = tuple(c / torch.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2) for c in d)
    active = torch.ones(n, dtype=torch.bool)
    inf = torch.full((n,), float("inf"))
    seen = []
    orig_c, orig_a = trace.persist_traverse_closest, \
        trace.persist_traverse_anyhit

    def spy(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            seen.append(out[-1] if kw.get("with_stats") else None)
            return out
        return call

    trace.persist_traverse_closest = spy(orig_c)
    trace.persist_traverse_anyhit = spy(orig_a)
    try:
        *res, st = trace.trace_closest(scene, cfg, o, d, inf, active,
                                       with_stats=True)
        closest_calls = list(seen)
        seen.clear()
        occ, ast = trace.trace_anyhit(scene, cfg, o, d, torch.full((n,), 0.6),
                                      torch.full((n,), -1, dtype=torch.int32),
                                      active, with_stats=True)
    finally:
        trace.persist_traverse_closest = orig_c
        trace.persist_traverse_anyhit = orig_a
    assert len(closest_calls) >= 2 and len(seen) >= 2  # base + passes
    assert int(st[0]) == sum(int(c[0]) for c in closest_calls)
    assert int(st[1]) == sum(int(c[1]) for c in closest_calls)
    assert int(ast[0]) == sum(int(c[0]) for c in seen)
    assert int(ast[1]) == sum(int(c[1]) for c in seen)
    plain = trace.trace_closest(scene, RenderConfig(), o, d, inf, active)
    for a, b in zip(plain, res):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert bool(res[0].any()) and bool((res[3] > 0).any())
