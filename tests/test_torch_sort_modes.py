"""rtjax_torch's traversal and sort modes vs rtjax: the sort keys, the
unsorted engine (``sort_rays=False`` and ``traversal="xla"``), the wide
sort bundle and the per-instance loop.

- Every sort key function bit for bit against rtjax's on random hit
  points, directions, normals and prims (the extreme cells included);
  the adaptive key where rtjax's live keys reach the dead lanes' markers
  (``0x7FFFFFFE`` / ``0x7FFFFFFF``) and the port's stop at
  ``MAX_LIVE_KEY``.
- ``wavefront_step`` state for state against rtjax over 3 iterations with
  rtjax's random words, as test_torch_wavefront.py does, under
  ``sort_rays=False``, ``traversal="xla"``, each sort key and the wide
  bundle (``_compact_bundle_ok`` monkeypatched to False in both
  packages): integer and bool fields exactly, except the prim of lanes
  whose hit is an equal-t tie; floats at rtol 1e-5, atol 4e-6.  rtjax
  steps op by op (``jax.disable_jit``) except inside its binary walk's
  ``while_loop``, which compiles as one loop and contracts multiply-adds,
  so t differs from the port's in the last bits there; and XLA's sin and
  cos are within an ulp but not correctly rounded, which the tangent frame
  of a sampled direction turns into up to ~2e-6 on a component near zero
  (test_torch_wavefront.py's atol 1e-6 holds on its two frames, not on
  every lane of these).
- The wide bundle's src: rtjax packs it in 12 bits, and a hit on instance
  4,096 or above spills into the mat bit, so a lane that stopped keeps
  shading; the port carries src in a column of its own.
- Instanced scenes: one built with ``max_leaf_size=None`` (no wide tables
  anywhere) and one whose BLAS lack wide tables while the base keeps them
  (the kernels for the base, the binary walk for the BLAS, rtjax's
  ``mode_k``), against rtjax's per-instance loop.
- A ``traversal="xla"`` frame against the NumPy oracle, and a checkpointed
  ``"xla"`` render resumed bit for bit.
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
from rtjax.render import sorting as jax_sorting
from rtjax.render import trace as jax_trace
from rtjax.render import wavefront as jax_wf
from rtjax.scene import transform as jax_tf
from rtjax.utils.compare import mse

from rtjax_torch import RenderConfig
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import traversal as T
from rtjax_torch.render import sorting
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.render.checkpoint import render_checkpointed
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from oracle import render_oracle_image
from scenes import cornell, default_camera
from test_torch_instancing import (N_RAYS, RECIPES, _hits_match, _rays, _v3,
                                   _world_tris, inst_scene_arrays)
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_wavefront import STATE_INT, STATE_VEC, _port_carry

POOL = 4096
W = H = 32


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=4e-6,
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    jscene, osc = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    return (jscene, jcam, osc, scene_from_arrays(scene_arrays(jscene), "cpu"),
            Camera.from_arrays(camera_arrays(jcam), "cpu"))


# ------------------------------------------------------------- sort keys

def _key_inputs(n=4096, seed=3):
    """Hit points over (and beyond) a root box, with the box's corners;
    directions and normals with zero components; prims from -1 up past
    2^24; bounces 0-5; a tenth of the lanes inactive."""
    rng = np.random.default_rng(seed)
    lo = np.float32([-1.0, -0.5, -2.0])
    hi = np.float32([1.0, 1.5, 0.0])
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32) * (hi - lo) / 2 \
        + (hi + lo) / 2
    o[:8] = hi
    o[8:16] = lo
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[16:32, 0] = 0.0
    d[32:48, 1] = -0.0
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm[:8] = -1.0
    prim = rng.integers(-1, 1 << 25, n).astype(np.int32)
    bounces = rng.integers(0, 6, n).astype(np.int32)
    active = rng.random(n) > 0.1
    active[:16] = True
    return o, d, nrm, prim, bounces, active, lo, hi


def _key_args(name, inp, port):
    o, d, nrm, prim, bounces, active, lo, hi = inp
    if port:
        v3 = lambda a: tuple(torch.tensor(a[:, k]) for k in range(3))
        t = torch.tensor
    else:
        v3 = lambda a: tuple(jnp.asarray(a[:, k]) for k in range(3))
        t = jnp.asarray
    if name in ("ray_sort_keys_prim_v3", "ray_sort_keys_prim_pos_v3"):
        return (t(prim), v3(d), t(active))
    if name == "ray_sort_keys_normal_pos_v3":
        return (v3(o), v3(nrm), t(lo), t(hi), t(active))
    if name == "ray_sort_keys_adaptive_v3":
        return (v3(o), v3(nrm), t(bounces), t(lo), t(hi), t(active))
    return (v3(o), v3(d), t(lo), t(hi), t(active))


KEY_FUNCTIONS = ("ray_sort_keys_v3", "ray_sort_keys_pos_v3",
                 "ray_sort_keys_pos10_v3", "ray_sort_keys_prim_v3",
                 "ray_sort_keys_prim_pos_v3", "ray_sort_keys_normal_pos_v3",
                 "ray_sort_keys_adaptive_v3")


@pytest.mark.parametrize("name", KEY_FUNCTIONS)
def test_key_function_matches_rtjax(name):
    inp = _key_inputs()
    got = getattr(sorting, name)(*_key_args(name, inp, True)).numpy()
    want = np.asarray(getattr(jax_sorting, name)(*_key_args(name, inp,
                                                            False)))
    # rtjax's adaptive keys that reach the dead markers are the one
    # difference (test_adaptive_keys_stay_below_the_dead_markers)
    same = want <= sorting.MAX_LIVE_KEY
    same |= ~inp[5]
    np.testing.assert_array_equal(got[same], want[same])
    assert got.dtype == np.int32
    assert (got[inp[5]] <= sorting.MAX_LIVE_KEY).all()
    assert (got[~inp[5]] == sorting.INACTIVE_KEY).all()
    if name != "ray_sort_keys_adaptive_v3":
        assert same.all()


def test_octant_matches_rtjax():
    d = _key_inputs()[1]
    np.testing.assert_array_equal(
        sorting._octant3_v3(tuple(torch.tensor(d[:, k])
                                  for k in range(3))).numpy(),
        np.asarray(jax_sorting._octant3_v3(tuple(jnp.asarray(d[:, k])
                                                 for k in range(3)))))


def test_adaptive_keys_stay_below_the_dead_markers():
    """A deep lane at the root box's far corner with a normal pointing
    into octant 7: rtjax's key is 0x7FFFFFFF, the clean dead lanes' marker
    (one cell short of the corner, 0x7FFFFFFE, the dirty dead lanes' key),
    so the engine's sort would seat the live lane among the dead; the
    port's is MAX_LIVE_KEY."""
    lo, hi = np.float32([0, 0, 0]), np.float32([1, 1, 1])
    o = np.float32([[1, 1, 1], [1 - 0.5 / 511, 1, 1], [0.5, 0.5, 0.5]])
    nrm = np.float32([[-1, -1, -1]] * 3)
    b = np.int32([3, 3, 3])
    act = np.ones(3, bool)
    want = np.asarray(jax_sorting.ray_sort_keys_adaptive_v3(
        tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(nrm[:, k]) for k in range(3)), jnp.asarray(b),
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(act)))
    got = sorting.ray_sort_keys_adaptive_v3(
        tuple(torch.tensor(o[:, k]) for k in range(3)),
        tuple(torch.tensor(nrm[:, k]) for k in range(3)), torch.tensor(b),
        torch.tensor(lo), torch.tensor(hi), torch.tensor(act)).numpy()
    assert want[0] == 0x7FFFFFFF and want[1] == 0x7FFFFFFE
    assert (got[:2] == sorting.MAX_LIVE_KEY).all()
    assert got[2] == want[2] < sorting.MAX_LIVE_KEY


# ------------------------------------------------- engine, state for state

def _compare_steps(jscene, jcam, scene, cam, jcfg, cfg, world, pool=POOL,
                   seed=1, iterations=3, jc=None):
    """Run ``iterations`` steps of both engines from rtjax's state (the
    port re-seeded from it each iteration) and compare every field; the
    cam_start after each step."""
    key = jax.random.key(seed)
    if jc is None:
        jc = (jax_wf.make_initial_state(pool),
              jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
              jnp.int32(0), jnp.bool_(False), jnp.float32(0),
              jnp.float32(0))
    cams = []
    for it in range(iterations):
        c = _port_carry(jc)
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                                  pool)).astype(np.int64)
            jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
        js, s = jc[0], c[0]
        cams.append(int(c[2]))
        hit = np.asarray(js.hit)
        ro = np.stack([np.asarray(x, np.float64) for x in s.ray_o], 1)
        rd = np.stack([np.asarray(x, np.float64) for x in s.ray_d], 1)
        t_want = np.where(hit, np.asarray(js.t), 0.0)
        uniq = ~hit | _unique_t(world, ro, rd, np.full(pool, np.inf),
                                t_want.astype(np.float64))
        assert uniq.sum() >= pool - 8
        for f in STATE_INT:
            got, want = getattr(s, f).numpy(), np.asarray(getattr(js, f))
            m = uniq if f in ("prim", "src") else np.ones(pool, bool)
            np.testing.assert_array_equal(got[m], want[m], err_msg=f)
        for f in STATE_VEC:
            # untraced lanes: rtjax's tiny-scene direct path leaves their
            # normal unmasked, the kernels zero it
            m = hit & uniq if f == "normal" else np.ones(pool, bool)
            for k in range(3):
                _close(getattr(s, f)[k].numpy()[m],
                       np.asarray(getattr(js, f)[k])[m], f"{f}[{k}]")
        _close(s.t.numpy()[hit], np.asarray(js.t)[hit], "t")
        _close(c[1].numpy(), np.asarray(jc[1]), "framebuffer")
        assert int(c[2]) == int(jc[2]), "cam_start"
        assert float(c[5]) == float(jc[5]), "rays traced"
        assert bool(c[4]) == bool(jc[4])
    assert hit.sum() > pool // 2
    return cams, jc


MODES = {
    "no_sort": dict(sort_rays=False),
    "xla": dict(traversal="xla"),
    "xla_parity": dict(traversal="xla", reference_parity=True, rr_start=0),
    **{k: dict(sort_key=k) for k in ("morton", "morton_pos10", "prim",
                                     "prim_pos", "normal_pos", "adaptive")},
    "wide": dict(),
    "wide_prim": dict(sort_key="prim"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_rtjax_state_for_state(pair, monkeypatch, mode):
    jscene, jcam, _, scene, cam = pair
    change = MODES[mode]
    if mode.startswith("wide"):
        monkeypatch.setattr(jax_wf, "_compact_bundle_ok", lambda s, c: False)
        monkeypatch.setattr(wf, "_compact_bundle_ok", lambda s, c: False)
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL, **change)
    jkw = dict(kw, traversal=change.get("traversal", "pallas"))
    refs = dict(T.REF_CALLS), dict(P.REF_CALLS)
    # the port walks the tables (its direct path off), rtjax takes its
    # direct loop: the persist walk is held to rtjax's hits
    cams, _ = _compare_steps(jscene, jcam, scene, cam,
                             JaxConfig(sort_every=0, **jkw),
                             RenderConfig(direct_max_tris=0, **kw),
                             jscene.tris)
    binary = T.REF_CALLS["closest"] - refs[0]["closest"]
    persist = P.REF_CALLS["closest"] - refs[1]["closest"]
    assert (binary, persist) == ((3, 0) if "xla" in mode else (0, 3))
    if mode in ("no_sort", "xla", "xla_parity") or mode.startswith("wide"):
        # cadence 1 (the unsorted engine, the wide bundle): every
        # iteration generates camera rays
        assert cams[0] < cams[1] < cams[2]
    else:
        # the 12-triangle scene's auto cadence 2: iteration 1 skips
        assert cams[0] == cams[1] < cams[2]


def test_wide_bundle_keeps_src_above_4095(pair, monkeypatch):
    """Lanes that stopped (hit at the last bounce) with src 4,096: rtjax's
    wide bundle reads the src bit 12 back as the mat bit, so those lanes
    shade on and generate no camera ray; the port generates as rtjax does
    for src 0."""
    jscene, jcam, _, scene, cam = pair
    monkeypatch.setattr(jax_wf, "_compact_bundle_ok", lambda s, c: False)
    monkeypatch.setattr(wf, "_compact_bundle_ok", lambda s, c: False)
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL)
    jcfg = JaxConfig(traversal="pallas", **kw)
    _, jc = _compare_steps(jscene, jcam, scene, cam, jcfg, RenderConfig(**kw),
                           jscene.tris, iterations=2)
    s = jc[0]
    stop = np.asarray(s.hit) & (np.arange(POOL) % 7 == 0)
    assert stop.sum() > 100
    bounces = np.where(stop, 4, np.asarray(s.bounces)).astype(np.int32)
    cam_after = {}
    for src_v in (0, 4096):
        src = np.where(stop, src_v, np.asarray(s.src)).astype(np.int32)
        state = dataclasses.replace(s, src=jnp.asarray(src),
                                    bounces=jnp.asarray(bounces))
        jc2 = (state,) + tuple(jc[1:])
        key = jax.random.key(1)
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(2), 5,
                                                  POOL)).astype(np.int64)
            out = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc2)
        cam_after["rtjax", src_v] = int(out[2])
        c = wf.wavefront_step(scene, cam, RenderConfig(**kw),
                              torch.tensor(words), _port_carry(jc2))
        cam_after["port", src_v] = int(c[2])
    assert cam_after["port", 0] == cam_after["rtjax", 0] \
        == cam_after["port", 4096]
    assert cam_after["rtjax", 4096] == cam_after["rtjax", 0] - stop.sum()


# ------------------------------------------------------- instanced scenes

def _carried(name, **build):
    """rtjax's build of a recipe and the port's scene from its arrays."""
    b = JaxSceneBuilder()
    RECIPES[name](b, jax_tf)
    jscene = b.build(**build)
    return jscene, inst_scene_arrays(jscene)


def _loop_reference(jscene, scene, name):
    """rtjax's per-instance loop ("xla") on random rays."""
    o, d, active = _rays(name)
    want = tuple(np.asarray(a) for a in jax_trace.trace_closest(
        jscene, JaxConfig(), "xla", True, jnp.asarray(o), jnp.asarray(d),
        jnp.full(N_RAYS, jnp.inf), jnp.asarray(active)))
    rng = np.random.default_rng(1)
    exclude = np.where(rng.random(N_RAYS) > 0.5,
                       rng.integers(0, jscene.tris.num, N_RAYS),
                       -1).astype(np.int32)
    want_occ = np.asarray(jax_trace.trace_anyhit(
        jscene, JaxConfig(), "xla", True, jnp.asarray(o), jnp.asarray(d),
        jnp.full(N_RAYS, 2.0), jnp.asarray(exclude), jnp.asarray(active)))
    return dict(o=o, d=d, active=active, exclude=exclude, want=want,
                want_occ=want_occ, world=_world_tris(scene))


def _trace_both(tr, scene, cfg):
    hit, t, prim, src, nrm = trace.trace_closest(
        scene, cfg, _v3(tr["o"]), _v3(tr["d"]),
        torch.full((N_RAYS,), float("inf")), torch.tensor(tr["active"]))
    nrm = np.stack([c.numpy() for c in nrm], 1)
    assert _hits_match(tr, hit.numpy(), t.numpy(), prim.numpy(),
                       src.numpy(), nrm) > 5
    occ = trace.trace_anyhit(
        scene, cfg, _v3(tr["o"]), _v3(tr["d"]), torch.full((N_RAYS,), 2.0),
        torch.tensor(tr["exclude"]), torch.tensor(tr["active"])).numpy()
    np.testing.assert_array_equal(occ, tr["want_occ"])
    assert occ.sum() > 50


def test_instanced_scene_without_wide_tables_matches_rtjax_loop():
    """Built with max_leaf_size=None: "auto" takes the binary walk for the
    base and every instance, rtjax's per-instance loop."""
    jscene, arrays = _carried("pyramid3", max_leaf_size=None)
    scene = scene_from_arrays(arrays, "cpu")
    assert scene.tables is None and scene.inst_tables is None
    tr = _loop_reference(jscene, scene, "pyramid3")
    calls = dict(T.REF_CALLS)
    _trace_both(tr, scene, RenderConfig())
    assert T.REF_CALLS["closest"] - calls["closest"] == 1 + 3
    with pytest.raises(ValueError, match="max_leaf_size"):
        trace.trace_closest(scene, RenderConfig(traversal="pallas"),
                            _v3(tr["o"]), _v3(tr["d"]),
                            torch.full((N_RAYS,), float("inf")),
                            torch.tensor(tr["active"]))


def test_blas_without_wide_tables_takes_the_binary_walk():
    """The base keeps its wide tables, the BLAS have none (rtjax's VMEM
    guard drops them; here the arrays are left out): the kernels walk the
    base and the binary walk every instance (rtjax's ``mode_k``)."""
    jscene, arrays = _carried("grid64")
    arrays = {k: v for k, v in arrays.items()
              if not (k.startswith("blas.") and ".tables." in k)
              and not k.startswith("inst_tables.")}
    scene = scene_from_arrays(arrays, "cpu")
    assert scene.tables is not None and scene.inst_tables is None
    assert all(b.tables is None for b in scene.blas)
    tr = _loop_reference(jscene, scene, "grid64")
    calls = dict(T.REF_CALLS), dict(P.REF_CALLS)
    _trace_both(tr, scene, RenderConfig(direct_max_tris=0))
    assert T.REF_CALLS["closest"] - calls[0]["closest"] == 64
    assert P.REF_CALLS["closest"] - calls[1]["closest"] == 1


def test_instanced_stats_sum_every_launch():
    """detailed_stats under "xla": the per-instance loop's counts are the
    sum of its launches' counts."""
    jscene, arrays = _carried("pyramid3")
    scene = scene_from_arrays(arrays, "cpu")
    o, d, active = _rays("pyramid3")
    cfg = RenderConfig(traversal="xla", detailed_stats=True)
    args = (_v3(o), _v3(d), torch.full((N_RAYS,), float("inf")),
            torch.tensor(active))
    *_, st = trace.trace_closest(scene, cfg, *args, with_stats=True)
    base = T.traverse_closest(scene.bvh, scene.tris, *args,
                              with_stats=True)
    steps, leafs = int(base[6][0]), int(base[6][1])
    tcur = torch.where(base[0], base[1], args[2])
    inst = scene.instances
    for k in range(inst.num):
        m = args[3] & trace._instance_mask(inst, k, args[0], args[1])
        h2, t2, *_, st2 = T.traverse_closest(
            scene.blas[inst.mesh_id[k]].bvh, scene.blas[inst.mesh_id[k]].tris,
            *trace._local_rays(inst, k, args[0], args[1]), tcur, m,
            with_stats=True)
        steps, leafs = steps + int(st2[0]), leafs + int(st2[1])
        tcur = torch.where(h2 & (t2 < tcur), t2, tcur)
    assert (int(st[0]), int(st[1])) == (steps, leafs) and steps > 0


# ----------------------------------------------------------- whole frames

def test_xla_frame_matches_oracle(pair):
    jscene, jcam, osc, scene, cam = pair
    kw = dict(width=W, height=H, num_samples=64, max_bounces=4,
              num_working_paths=POOL)
    img_o = render_oracle_image(osc, jcam, W, H, 600, 4, seed=5)
    fb, stats = wf.render_frame(scene, cam, RenderConfig(traversal="xla",
                                                         **kw),
                                torch.Generator().manual_seed(1))
    img = fb.numpy().reshape(H, W, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert abs(img_o.mean() - img.mean()) < 0.01
    assert mse(img_o, img) < 0.004
    assert stats["rays_traced"] >= W * H * 64


def test_xla_checkpoint_resume_is_bitwise(tmp_path):
    from test_torch_checkpoint import _cam, _scene
    scene = _scene()
    cfg = RenderConfig(width=16, height=16, num_samples=12, max_bounces=2,
                       num_working_paths=1024, traversal="xla")
    path = str(tmp_path / "ck.npz")
    full = render_checkpointed(scene, _cam(), cfg, path=None, batch_spp=4,
                               verbose=False)
    render_checkpointed(scene, _cam(), dataclasses.replace(cfg,
                                                           num_samples=4),
                        path=path, batch_spp=4, verbose=False)
    resumed = render_checkpointed(scene, _cam(), cfg, path=path, batch_spp=4,
                                  verbose=False)
    assert torch.equal(resumed, full) and float(full.mean()) > 0
