"""rtjax_torch wavefront engine vs rtjax.

(a) State for state: the port's ``wavefront_step`` and rtjax's, fed the
    same state and rtjax's own random words, on the Cornell test scene
    (12 triangles, so ``sort_every`` auto resolves to 2 and the skip
    iterations run too), once in blocked camera order (8 spp) and once in
    scanline order (64 spp).  rtjax steps op by op (``jax.disable_jit``),
    so neither side contracts multiply-adds; the remaining differences
    are libm vs XLA transcendentals (sin, cos): integer and bool fields
    exactly, except the prim of lanes whose hit is an equal-t tie; floats
    at rtol 1e-5 (atol 1e-6 for values near zero).  rtjax runs its sorted
    engine (``traversal="pallas"``; on the CPU ``"auto"`` takes the
    unsorted XLA path).
(b) The whole frame on the CPU against the NumPy oracle (test_render.py's
    tolerances) and against an rtjax render at the seed-to-seed noise
    floor.
(c) PPM bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.render import render_frame as jax_render_frame
from rtjax.render import wavefront as jax_wf
from rtjax.render.film import write_ppm as jax_write_ppm
from rtjax.utils.compare import mse

from rtjax_torch import RenderConfig
from rtjax_torch.render import wavefront as wf
from rtjax_torch.render.film import read_ppm, write_ppm
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from oracle import render_oracle_image
from scenes import cornell, default_camera
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays, scene_arrays

POOL = 4096
W = H = 32
STATE_INT = ("pixel", "hit", "prim", "src", "bounces")
STATE_VEC = ("ray_o", "ray_d", "normal", "beta", "acc")


@pytest.fixture(scope="module")
def pair():
    jscene, osc = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    return (jscene, jcam, osc, scene_from_arrays(scene_arrays(jscene), "cpu"),
            Camera.from_arrays(camera_arrays(jcam), "cpu"))


def _t(x):
    return torch.tensor(np.asarray(x))


def _port_carry(jc):
    """rtjax's carry as the port's (same state, framebuffer, counters)."""
    s = jc[0]
    state = wf.PathState(**{
        f: tuple(_t(c) for c in getattr(s, f)) if f in STATE_VEC
        else _t(getattr(s, f)) for f in STATE_INT + STATE_VEC + ("t",)})
    return (state, _t(jc[1]), torch.tensor(int(jc[2])), int(jc[3]),
            torch.tensor(bool(jc[4])), torch.tensor(float(jc[5]),
                                                    dtype=torch.float64),
            torch.tensor(float(jc[6]), dtype=torch.float64))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("spp", [8, 64], ids=["blocked", "scan"])
def test_step_matches_rtjax_state_for_state(pair, spp):
    jscene, jcam, _, scene, cam = pair
    kw = dict(width=W, height=H, num_samples=spp, max_bounces=4,
              num_working_paths=POOL)
    jcfg = JaxConfig(traversal="pallas", sort_every=0, **kw)
    cfg = RenderConfig(**kw)
    key = jax.random.key(1)
    jc = (jax_wf.make_initial_state(POOL),
          jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
          jnp.int32(0), jnp.bool_(False), jnp.float32(0), jnp.float32(0))
    tris = jscene.tris
    cams = []
    for it in range(3):
        c = _port_carry(jc)
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                                  POOL)).astype(np.int64)
            jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
        js, s = jc[0], c[0]
        cams.append(int(c[2]))

        hit = np.asarray(js.hit)
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
            # untraced lanes: rtjax's tiny-scene direct path leaves their
            # normal unmasked, the kernels zero it
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
    assert hit.sum() > POOL // 2
    # iteration 1 was a sort_every skip: nothing regenerated
    assert cams[0] == cams[1] == POOL < cams[2]


def test_frame_matches_oracle_and_rtjax(pair):
    jscene, jcam, osc, scene, cam = pair
    kw = dict(width=W, height=H, num_samples=64, max_bounces=4,
              num_working_paths=POOL)
    img_o = render_oracle_image(osc, jcam, W, H, 600, 4, seed=5)
    fb, stats = wf.render_frame(scene, cam, RenderConfig(**kw),
                                torch.Generator().manual_seed(1))
    fb2, _ = wf.render_frame(scene, cam, RenderConfig(**kw),
                             torch.Generator().manual_seed(2))
    img = fb.numpy().reshape(H, W, 3)
    img2 = fb2.numpy().reshape(H, W, 3)

    assert np.isfinite(img).all() and (img >= 0).all()
    assert abs(img_o.mean() - img.mean()) < 0.01
    assert mse(img_o, img) < 0.004
    assert stats["iterations"] > 0
    assert stats["rays_traced"] >= W * H * 64

    jfb, _ = jax_render_frame(jscene, jcam, JaxConfig(**kw),
                              jax.random.key(1))
    img_j = np.asarray(jfb).reshape(H, W, 3)
    # two independent renders differ by twice the per-image variance; a
    # port that agrees with rtjax in expectation stays within 2x of that
    assert mse(img, img_j) <= 2.0 * mse(img, img2)


def test_flush_counts_each_path_once_at_any_pool_size(pair):
    """A path that dies on a sort_every skip iteration is flushed once, on
    the next generating iteration, whatever the pool size.  (rtjax's
    unchunked flush, taken when the pool is not a multiple of 8, also
    flushes on skip iterations without clearing: +11% mean radiance at
    pool 1020 vs 1024 on this scene.)"""
    *_, scene, cam = pair
    means = []
    for pool in (1024, 1020):
        cfg = RenderConfig(width=16, height=16, num_samples=32, max_bounces=4,
                           num_working_paths=pool)
        fb, _ = wf.render_frame_linear(scene, cam, cfg,
                                       torch.Generator().manual_seed(1))
        means.append(float(fb.mean()) / cfg.num_samples)
    assert abs(means[1] / means[0] - 1.0) < 0.03


@pytest.mark.parametrize("binary", [False, True], ids=["P3", "P6"])
def test_write_ppm_bytes_match(tmp_path, binary):
    rng = np.random.default_rng(4)
    fb = (rng.random((7 * 5, 3)) * 1.2 - 0.1).astype(np.float32)
    ours, theirs = tmp_path / "ours.ppm", tmp_path / "theirs.ppm"
    write_ppm(ours, torch.tensor(fb).numpy(), 7, 5, binary=binary)
    jax_write_ppm(theirs, fb, 7, 5, binary=binary)
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_ppm(ours).shape == (5, 7, 3)


def test_config_matches_rtjax_sizes_and_validates():
    for kw in (dict(width=256, height=256, num_samples=64),
               dict(width=32, height=32, num_samples=8),
               dict(width=1920, height=1080, num_samples=16),
               dict(width=64, height=64, num_samples=4,
                    num_working_paths=1000, shade_chunks=4)):
        ours, theirs = RenderConfig(**kw), JaxConfig(**kw)
        for k in ("pool_size", "total_camera_rays", "shade_chunks_effective",
                  "num_pixels"):
            assert getattr(ours, k) == getattr(theirs, k), (kw, k)
    with pytest.raises(ValueError):
        RenderConfig(sort_every=-1)
    with pytest.raises(ValueError):
        RenderConfig(two_level="repas")
    with pytest.raises(ValueError):
        RenderConfig(width=65536, height=65536, num_samples=1)\
            .total_camera_rays


def _instanced_scene():
    """Two instances of one tetrahedron over a floor, with a light."""
    from rtjax_torch.scene.scene import SceneBuilder
    from rtjax_torch.scene.transform import Transform, translate
    b = SceneBuilder()
    white = b.make_matte((0.73, 0.73, 0.73))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    mid = b.register_mesh(np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                                    [0.1, 0.25, -0.07]]),
                          np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3],
                                    [0, 1, 2]]))
    for x in (0.2, 0.6):
        b.add_instance(mid, white, Transform(translate(x, 0, -0.4)))
    return b.build("cpu")


@pytest.mark.parametrize("change, item", [
    (dict(detailed_stats=True, walker="packet"), "Queue S 3"),
    (dict(detailed_stats=True, walker="lane"), "Queue S 3"),
    (dict(detailed_stats=True, two_level="kernel"), "Queue S 3"),
], ids=lambda v: str(v) if isinstance(v, dict) else v)
def test_out_of_slice_configs_raise(pair, change, item):
    """The configurations that raised NotImplementedError (naming ``item``)
    before the packet, lane and two-level kernels counted their work: each
    renders a finite, non-negative frame with its histogram and counts."""
    *_, scene, cam = pair
    if change.get("two_level") == "kernel":
        scene = _instanced_scene()
        assert scene.instances is not None
    cfg = RenderConfig(width=8, height=8, num_samples=1, max_bounces=1,
                       num_working_paths=256, **change)
    fb, stats = wf.render_frame(scene, cam, cfg, torch.Generator())
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert int(stats["bounce_histogram"].sum()) > 0
    assert stats["node_steps"] > 0 and stats["leaf_visits"] > 0


@pytest.mark.parametrize("change", [
    dict(sort_key="prim"), dict(traversal="xla"), dict(sort_key="adaptive"),
    dict(sort_rays=False)], ids=str)
def test_once_refused_configs_render(pair, change):
    """The configurations that raised NotImplementedError before the
    binary walk, the unsorted engine and the sort keys were ported."""
    *_, scene, cam = pair
    cfg = RenderConfig(width=8, height=8, num_samples=2, max_bounces=2,
                       num_working_paths=256, **change)
    fb, stats = wf.render_frame(scene, cam, cfg, torch.Generator())
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert float(fb.mean()) > 0 and stats["iterations"] > 0


@pytest.mark.parametrize("change", [
    dict(traversal="cuda"), dict(traversal="Pallas"),
    dict(sort_key="hilbert"), dict(sort_key="morton_pos9")], ids=str)
def test_config_rejects_unknown_modes(change):
    with pytest.raises(ValueError, match=next(iter(change))):
        RenderConfig(**change)
