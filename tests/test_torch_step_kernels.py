"""The fused wavefront step (rtjax_torch/kernels/step.py): route, shade
and resolve, whose CUDA kernels (csrc/step_kernels.cu) run only on the
card (tests/test_torch_cuda.py); here their plain versions.

(a) The plain versions against rtjax's public pieces on seeded numpy
    inputs: route's keys against rtjax's sort keys, its bundle against
    rtjax's codecs; shade's path rays against ``sample_f``, its NEE rays
    against ``sample_li`` and ``get_f``, its BSDF-MIS mask against
    ``pdf_li``, its camera rays against ``Camera.get_rays``; rtjax steps
    op by op (``jax.disable_jit``).  Integers exact; floats that pass
    through sqrt, sin or cos (libm against XLA's, not correctly rounded)
    at rtol 1e-5 / atol 1e-6, as tests/test_torch_wavefront.py.
(b) The composed plain step (route, sort, shade, the traversals,
    resolve) against rtjax's ``wavefront_step`` state for state with
    rtjax's own words: cadence 1, cadence 2, glass and mirror with point
    and area lights and the environment light, and an instanced scene.
(c) The composed plain step bit for bit against the op-by-op step
    (``step_kernels=False``) over every sort key and cadence, without
    lights, with point lights only, and instanced.
(d) The mode predicate (``step_kernels_cover``), the routing to the
    kernels or the plain versions (spies), a failing library load
    raising instead of falling back, the wrappers' input checks, and the
    kernels' argument block field for field csrc/step_math.cuh's.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import Camera as JaxCamera
from rtjax import RenderConfig as JaxConfig
from rtjax import SceneBuilder as JaxSceneBuilder
from rtjax.core import rng as jax_rng
from rtjax.render import sorting as jax_sorting
from rtjax.render import trace as jax_trace
from rtjax.render import wavefront as jax_wf
from rtjax.scene import light as jax_light
from rtjax.scene import material as jax_material

from rtjax_torch import RenderConfig
from rtjax_torch.constants import DEAD_BOUNCES
from rtjax_torch.kernels import _build
from rtjax_torch.kernels import step as S
from rtjax_torch.render import graph
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from scenes import cornell, default_camera
from test_torch_instancing import _jax_scene, inst_scene_arrays
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_wavefront import STATE_INT, STATE_VEC, _close

W = H = 16
POOL = 512


def _jax_mixed(env=(0.2, 0.3, 0.4), point_lights=2, area=True):
    """rtjax scene: matte, mirror and glass triangles (12 each), point
    lights, an area light, an environment light."""
    b = JaxSceneBuilder()
    mats = (b.make_matte((0.7, 0.6, 0.5)), b.make_mirror((0.9, 0.8, 0.9)),
            b.make_glass(1.5))
    rng = np.random.default_rng(3)
    for m in mats + mats:
        p0 = rng.uniform(-1, 1, (6, 3))
        b.add_triangles(p0, p0 + rng.uniform(-0.6, 0.6, (6, 3)),
                        p0 + rng.uniform(-0.6, 0.6, (6, 3)), m)
    for q in range(point_lights):
        b.add_point_light((0.3 * q, 1.5, 0.3), (5.0, 4.0, 3.0))
    if area:
        b.add_area_light([-0.3, 1.2, -0.3], [0.3, 1.2, -0.3],
                         [0.0, 1.2, 0.3], (8, 8, 8), mats[0])
    if env is not None:
        b.set_environment(env)
    return b.build()


_JCAM = ((0, 0.5, 3), (0, 0, 0), (0, 1, 0), 45.0, 1.0)


@pytest.fixture(scope="module")
def mixed():
    jscene = _jax_mixed()
    jcam = JaxCamera.make(*_JCAM)
    return (jscene, jcam, scene_from_arrays(scene_arrays(jscene), "cpu"),
            Camera.from_arrays(camera_arrays(jcam), "cpu"))


def _cfg(**kw):
    return RenderConfig(**{**dict(width=W, height=H, num_samples=4,
                                  max_bounces=5, num_working_paths=POOL,
                                  direct_max_tris=0), **kw})


def _synthetic_state(scene, cfg, seed, p_hit=0.7):
    """A pool of random lanes of every kind (hits, misses, dead and dirty
    dead lanes, lanes past max_bounces, inf and NaN throughput), from
    numpy; ``p_hit`` of the live lanes hit."""
    rng = np.random.default_rng(seed)
    n = cfg.pool_size
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    i = lambda a: torch.tensor(np.asarray(a, np.int32))
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    beta = rng.uniform(0, 1.5, (3, n))
    beta[0, rng.uniform(size=n) < 0.02] = np.inf
    beta[1, rng.uniform(size=n) < 0.02] = np.nan
    acc = np.where(rng.uniform(size=(3, n)) < 0.5, 0.0,
                   rng.uniform(size=(3, n)))
    bounces = np.where(rng.uniform(size=n) < (1 - p_hit) / 2, DEAD_BOUNCES,
                       rng.integers(0, cfg.max_bounces + (p_hit < 0.9) + 1,
                                    n))
    num_src = 1 + (scene.instances.num if scene.instances is not None
                   else 0)
    return wf.PathState(
        pixel=i(rng.integers(0, cfg.num_pixels, n)),
        ray_o=tuple(f(c) for c in rng.uniform(-1, 1, (3, n))),
        ray_d=tuple(f(c) for c in d),
        hit=torch.tensor(rng.uniform(size=n) < p_hit),
        t=f(rng.uniform(0, 3, n)),
        normal=tuple(f(c) for c in rng.normal(size=(3, n))),
        prim=i(rng.integers(-1, scene.tris.num, n)),
        src=i(rng.integers(0, num_src, n)), bounces=i(bounces),
        beta=tuple(f(c) for c in beta), acc=tuple(f(c) for c in acc))


def _words(seed, n=POOL):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(0, 1 << 32, (5, n), dtype=np.int64))


def _j(t):
    return jnp.asarray(t.numpy())


def _j3(v):
    return tuple(_j(c) for c in v)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ------------------------------------------- (a) against rtjax's pieces

@pytest.mark.parametrize("sort_key", ["morton", "morton_pos",
                                      "morton_pos10", "prim", "prim_pos",
                                      "normal_pos", "adaptive"])
def test_route_matches_rtjax_keys_and_codecs(mixed, sort_key):
    """Route's keys are rtjax's sort keys of the continuing paths' hit
    points (``DIRTY_KEY`` for dead slots holding radiance), its bundle
    rtjax's codecs of the state after emission and roulette."""
    jscene, _, scene, _ = mixed
    cfg = _cfg(sort_key=sort_key)
    state = _synthetic_state(scene, cfg, 1)
    words = _words(2)
    keys, bundle, counts = S.route_ref(scene, cfg, state, words)
    mat = ((bundle[5] >> 28) & 1).numpy() != 0
    assert 0 < mat.sum() < POOL and int(counts[0]) == mat.sum()
    assert counts[1:].eq(0).all()
    t = np.where(mat, state.t.numpy(), 0.0).astype(np.float32)
    hp = [(o.numpy() + t * d.numpy()).astype(np.float32)
          for o, d in zip(state.ray_o, state.ray_d)]
    for k in range(3):
        _eq(bundle[k].view(torch.float32).numpy(), hp[k], f"hp[{k}]")
    u_rr = S.rng.u01_pair(words[S.W_RR_PICK])[0]
    acc, beta, _, mat_p, _, _ = S.emit_and_roulette(scene, cfg, state, u_rr)
    _eq(mat_p.numpy(), mat, "material mask")
    with jax.disable_jit():
        lo, hi = jscene.bvh.bmin[0], jscene.bvh.bmax[0]
        hpj, dj, nj = tuple(jnp.asarray(c) for c in hp), _j3(
            state.ray_d), _j3(state.normal)
        prim = jnp.where(jnp.asarray(mat), _j(state.prim), -1)
        want = {
            "morton": lambda: jax_sorting.ray_sort_keys_v3(hpj, dj, lo, hi,
                                                           mat),
            "morton_pos": lambda: jax_sorting.ray_sort_keys_pos_v3(
                hpj, dj, lo, hi, mat),
            "morton_pos10": lambda: jax_sorting.ray_sort_keys_pos10_v3(
                hpj, dj, lo, hi, mat),
            "prim": lambda: jax_sorting.ray_sort_keys_prim_v3(prim, dj,
                                                              mat),
            "prim_pos": lambda: jax_sorting.ray_sort_keys_prim_pos_v3(
                prim, dj, mat),
            "normal_pos": lambda: jax_sorting.ray_sort_keys_normal_pos_v3(
                hpj, nj, lo, hi, mat),
            "adaptive": lambda: jax_sorting.ray_sort_keys_adaptive_v3(
                hpj, nj, _j(state.bounces + 1), lo, hi, mat)}[sort_key]()
        want = np.minimum(np.asarray(want), 0x7FFFFFFD) if \
            sort_key == "adaptive" else np.asarray(want)
        a = np.stack([c.numpy() for c in acc])
        dirty = ~mat & (a != 0).any(0)
        _eq(keys.numpy(), np.where(dirty, S.DIRTY_KEY,
                                   np.where(mat, want, 0x7FFFFFFF)), "keys")
        _eq(bundle[3].numpy(), jax_sorting.rgb9e5_encode_v3(_j3(beta)),
            "beta")
        _eq(bundle[4].numpy(), jax_sorting.rgb9e5_encode_v3(_j3(acc)), "acc")
        _eq(bundle[7].numpy(), jax_sorting.oct_encode_v3(nj), "normal")
        _eq(bundle[8].numpy(), jax_sorting.oct_encode_v3(dj), "direction")
    b7 = np.minimum(state.bounces.numpy() + 1, 127)
    _eq(bundle[5].numpy(), state.pixel.numpy() | (b7 << 21)
        | (mat.astype(np.int32) << 28), "pixel | bounces | mat")
    _eq(bundle[6].numpy(), (state.prim.numpy() + 1)
        | (state.src.numpy() << 23), "prim | src")


def test_shade_matches_rtjax_sampling(mixed):
    """Shade's next path rays are rtjax's ``sample_f`` of the decoded
    bundle, its NEE rays ``sample_li`` with ``get_f``'s mask, its BSDF-MIS
    mask ``pdf_li > 0`` (or a specular bounce) and its camera rays
    ``Camera.get_rays`` of the jittered pixels."""
    jscene, jcam, scene, cam = mixed
    cfg = _cfg()
    state = _synthetic_state(scene, cfg, 4)
    words = _words(5)
    keys, bundle, counts = S.route_ref(scene, cfg, state, words)
    order = torch.sort(keys, stable=True).indices
    fb = torch.zeros(cfg.num_pixels, 3)
    it, cam_start = 2, torch.tensor(40, dtype=torch.int64)
    sh = S.shade_ref(scene, cam, cfg, state, fb, words, order, bundle,
                     counts, it, cam_start, 1)
    b = bundle[:, order]
    mat = ((b[5] >> 28) & 1).numpy() != 0
    nm = int(counts[0])
    assert mat[:nm].all() and not mat[nm:].any()
    p = tuple(jnp.asarray(b[k].view(torch.float32).numpy()) for k in range(3))
    u = [S.rng.u01_pair(words[w]) for w in range(5)]
    with jax.disable_jit():
        wo = jax_sorting.oct_decode_v3(_j(b[8]))
        nrm = jax_sorting.oct_decode_v3(_j(b[7]))
        prim, src = _j((b[6] & 0x7FFFFF) - 1), _j((b[6] >> 23) & 0xFF)
        mi = jax_trace._hit_material_index(jscene, src, prim)
        mtype, albedo, ior = jscene.materials.gather_v3(mi)
        inv = 1.0 / jnp.sqrt(nrm[0] ** 2 + nrm[1] ** 2 + nrm[2] ** 2)
        n_g = tuple(-(inv * c) for c in nrm)
        f1, wi1, pdf1, n1 = jax_material.sample_f_v3(
            mtype, albedo, ior, wo, n_g, _j(u[1][0]), _j(u[1][1]),
            _j(u[1][0]))
        pick = jnp.minimum((_j(u[0][1]) * scene.num_lights).astype(
            jnp.int32), scene.num_lights - 1)
        wi_l, _, t_l, _, ltri = jax_light.sample_li_v3(
            jscene.lights, pick, p, _j(u[2][0]), _j(u[2][1]))
        dl = wi_l[0] * n_g[0] + wi_l[1] * n_g[1] + wi_l[2] * n_g[2]
        n_l = tuple(jnp.where(dl > 0, c, -c) for c in n_g)
        got_f, _, _ = jax_material.get_f_v3(mtype, albedo, wo, wi_l, n_l)
        f2, wi2, pdf2, n2 = jax_material.sample_f_v3(
            mtype, albedo, ior, wo, n_g, _j(u[3][0]), _j(u[3][1]),
            _j(u[3][0]))
        lpdf2 = jax_light.pdf_li_v3(jscene.lights, pick, p, wi2)
        ltype = jscene.lights.ltype[pick]
        idx = np.arange(POOL)
        cam_id = 40 + np.maximum(idx - nm, 0)
        got_ray = (idx >= nm) & (cam_id < cfg.total_camera_rays)
        blocked = S.blocked_pixel_table(W, H, torch.device("cpu")).numpy()
        pix = blocked[np.minimum(cam_id // cfg.num_samples,
                                 cfg.num_pixels - 1)]
        x = (pix % W + u[4][0].numpy()) / W
        y = (pix // W + u[4][1].numpy()) / H
        _, cam_d = jcam.get_rays_v3(jnp.asarray(x, jnp.float32),
                                    jnp.asarray(y, jnp.float32))
    n2_ = POOL
    for k in range(3):
        _close(sh.ray_d[k].numpy()[mat], np.asarray(wi1[k])[mat],
               f"path direction[{k}]")
        _close(sh.shadow[1][k].numpy()[:n2_], np.asarray(wi_l[k]),
               f"NEE direction[{k}]")
        _close(sh.shadow[1][k].numpy()[n2_:], np.asarray(wi2[k]),
               f"BSDF-MIS direction[{k}]")
        _close(sh.ray_d[k].numpy()[got_ray], np.asarray(cam_d[k])[got_ray],
               f"camera direction[{k}]")
    _close(sh.shadow[2].numpy()[:n2_], np.asarray(t_l), "NEE tmax")
    _eq(sh.shadow[3].numpy()[:n2_], ltri, "NEE exclude")
    _eq(sh.shadow[4].numpy()[:n2_], mat & np.asarray(got_f), "NEE mask")
    spec = np.isin(np.asarray(mtype), (1, 2))
    may = mat & (np.asarray(ltype) != 0) & (spec | (np.asarray(lpdf2) > 0))
    assert not (sh.shadow[4].numpy()[n2_:] & ~may).any()
    _eq(sh.trace_mask.numpy(), mat | got_ray, "traced")
    _eq(sh.pixel.numpy()[got_ray], pix[got_ray], "camera pixels")
    _eq(sh.bounces.numpy(), np.where(got_ray, 0, np.where(
        mat, sh.bounces.numpy(), DEAD_BOUNCES)), "bounces")
    assert got_ray.sum() > 0 and mat.sum() > 0


# -------------------------------------------- (b) the step against rtjax

def _jax_carry(c):
    """The port's carry as rtjax's (same state, framebuffer, counters)."""
    st = jax_wf.PathState(**{
        f: tuple(_j(x) for x in v) if isinstance(v, tuple) else _j(v)
        for f, v in vars(c[0]).items()})
    return (st, _j(c[1]), jnp.int32(int(c[2])), jnp.int32(int(c[3])),
            jnp.bool_(False), jnp.float32(0), jnp.float32(0))


@pytest.mark.parametrize("case", ["mixed", "cadence2", "instanced"])
def test_step_matches_rtjax_state_for_state(mixed, case):
    """One iteration of the composed plain step against rtjax's
    ``wavefront_step`` (its sorted engine, op by op) on rtjax's words,
    from a synthetic pool of every lane kind: glass, mirror, point and
    area lights and the environment light at cadence 1 (the headline's),
    the Cornell box at cadence 2 on iteration 1 with nine in ten paths
    continuing (a ``sort_every`` skip), and an instanced scene.  Integers
    exact but the prim and src of equal-t ties, floats at rtol 1e-5 /
    atol 1e-6."""
    if case == "mixed":
        jscene, jcam, scene, cam = mixed
    elif case == "instanced":
        jscene = _jax_scene("pyramid3")
        jcam = JaxCamera.make((0.5, 0.6, 0.8), (0.5, 0.15, -0.5),
                              (0, 1, 0), 45.0, 1.0)
        scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
        cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    else:
        jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
        jcam = default_camera()
        scene = scene_from_arrays(scene_arrays(jscene), "cpu")
        cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    kw = dict(width=W, height=H, num_samples=4, max_bounces=4,
              num_working_paths=POOL,
              sort_every=1 if case == "mixed" else 0)
    jcfg = JaxConfig(traversal="pallas", **kw)
    cfg = RenderConfig(**kw)
    assert wf.step_kernels_cover(scene, cfg)
    it = 1 if case == "cadence2" else 2
    state = _synthetic_state(scene, cfg, 6, p_hit=0.97 if it == 1 else 0.7)
    c = (state, torch.zeros(cfg.num_pixels, 3), torch.tensor(300), it,
         torch.tensor(False), torch.tensor(0.0, dtype=torch.float64),
         torch.tensor(0.0, dtype=torch.float64))
    key = jax.random.key(5)
    refs = dict(S.REF_CALLS)
    with jax.disable_jit():
        words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                              POOL)).astype(np.int64)
        jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, _jax_carry(c))
    c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
    assert all(S.REF_CALLS[k] - refs[k] == 1 for k in refs)
    js, s = jc[0], c[0]
    hit = np.asarray(js.hit)
    uniq = np.ones(POOL, bool)
    if scene.instances is None:
        ro = np.stack([np.asarray(x, np.float64) for x in s.ray_o], 1)
        rd = np.stack([np.asarray(x, np.float64) for x in s.ray_d], 1)
        t_want = np.where(hit, np.asarray(js.t), 0.0)
        uniq = ~hit | _unique_t(jscene.tris, ro, rd, np.full(POOL, np.inf),
                                t_want.astype(np.float64))
    for f in STATE_INT:
        got, want = getattr(s, f).numpy(), np.asarray(getattr(js, f))
        m = uniq if f in ("prim", "src") else np.ones(POOL, bool)
        _eq(got[m], want[m], f)
    for f in STATE_VEC:
        m = hit & uniq if f == "normal" else np.ones(POOL, bool)
        for k in range(3):
            _close(getattr(s, f)[k].numpy()[m],
                   np.asarray(getattr(js, f)[k])[m], f"{f}[{k}]")
    _close(c[1].numpy(), np.asarray(jc[1]), "framebuffer")
    assert int(c[2]) == int(jc[2]) and float(c[5]) == float(jc[5])
    assert bool(c[4]) == bool(jc[4]) and hit.sum() > 0
    # cadence 2 at iteration 1 with most paths continuing: no camera ray
    assert (int(c[2]) == 300) == (case == "cadence2")


# ---------------------------------- (c) the step against the op-by-op step

@pytest.mark.parametrize("change, lights", [
    ({}, "mixed"), (dict(sort_key="adaptive"), "mixed"),
    (dict(sort_key="prim_pos"), "mixed"), (dict(sort_key="morton"), "mixed"),
    (dict(sort_key="morton_pos10"), "mixed"),
    (dict(sort_key="normal_pos", sort_every=3), "mixed"),
    (dict(sort_key="prim", num_samples=16), "mixed"),
    ({}, "none"), ({}, "points"), (dict(two_level="kernel"), "instanced"),
    ({}, "instanced")], ids=str)
def test_step_equals_the_op_by_op_step(mixed, change, lights):
    """Three iterations from a fresh pool, both steps on the same words:
    every state field, the framebuffer and the counters bit for bit."""
    if lights == "instanced":
        scene = scene_from_arrays(inst_scene_arrays(_jax_scene("pyramid3")),
                                  "cpu")
    elif lights == "mixed":
        scene = mixed[2]
    else:
        scene = scene_from_arrays(scene_arrays(_jax_mixed(
            env=None, area=lights == "none", point_lights=2 * (
                lights == "points"))), "cpu")
        if lights == "none":
            scene = dataclasses.replace(scene, num_lights=0)
    cam = mixed[3]
    cfg = _cfg(direct_max_tris=64, **change)
    assert wf.step_kernels_cover(scene, cfg)
    new, old = wf.initial_carry(cfg, "cpu"), wf.initial_carry(cfg, "cpu")
    for it in range(3):
        words = _words(10 + it)
        new = wf.wavefront_step(scene, cam, cfg, words, new)
        old = wf.wavefront_step(scene, cam, cfg, words, old,
                                step_kernels=False)
        for k, (x, y) in enumerate(zip(graph.flatten(new), graph.flatten(old),
                                       strict=True)):
            if torch.is_tensor(y):
                assert x.dtype == y.dtype and torch.equal(x, y), (it, k)
            else:
                assert x == y
    assert float(new[5]) > 0


# --------------------------------------------------- (d) routing, checks

@pytest.mark.parametrize("change, covered", [
    ({}, True), (dict(sort_key="prim", sort_every=3), True),
    (dict(reference_parity=True), False), (dict(one_sample_mis=True), False),
    (dict(sort_rays=False), False), (dict(traversal="xla"), False),
    (dict(detailed_stats=True), False), (dict(max_bounces=126), False),
    (dict(width=2048, height=1025), False)], ids=str)
def test_mode_predicate(mixed, change, covered):
    """``step_kernels_cover`` names the modes the kernels run: the default
    estimator of the sorted engine with the compact bundle."""
    assert wf.step_kernels_cover(mixed[2], _cfg(**change)) == covered


def test_predicate_takes_the_compact_bundle_ranges():
    """Past 255 instances (src's 8 bits) the wide bundle runs, op by op."""
    from types import SimpleNamespace as NS
    for n_inst, covered in ((255, True), (256, False)):
        fake = NS(tables=object(), tris=NS(num=3), blas=(NS(tris=NS(num=4)),),
                  instances=NS(num=n_inst))
        assert wf.step_kernels_cover(fake, _cfg()) == covered


class _Spy:
    """Stands in for ``launch``: records the kernels launched."""

    def __init__(self):
        self.names = []

    def __call__(self, name, a, dev):
        self.names.append(name)


@pytest.mark.parametrize("step_kernels, change, want", [
    (True, {}, ["route", "shade", "resolve"]),
    (False, {}, []), (True, dict(reference_parity=True), []),
    (True, dict(sort_rays=False), [])], ids=str)
def test_step_routes_by_mode_and_device(mixed, monkeypatch, step_kernels,
                                        change, want):
    """On a CUDA tensor the wrappers launch their kernels (spied), on a
    CPU one they run the plain versions; the modes outside the predicate
    and ``step_kernels=False`` call neither."""
    _, _, scene, cam = mixed
    cfg = _cfg(**change)
    refs, launches = dict(S.REF_CALLS), dict(S.LAUNCHES)
    wf.wavefront_step(scene, cam, cfg, _words(1), wf.initial_carry(cfg, "cpu"),
                      step_kernels=step_kernels)
    assert [k for k in refs if S.REF_CALLS[k] > refs[k]] == want
    assert S.LAUNCHES == launches
    # the same wrappers on a "card" tensor: the kernels, never the plain
    spy = _Spy()
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(S, "launch", spy)
    state = _synthetic_state(scene, cfg, 3)
    keys, bundle, counts = S.route(scene, cfg, state, _words(1))
    sh = S.shade(scene, cam, cfg, state, torch.zeros(cfg.num_pixels, 3),
                 _words(1), torch.arange(POOL), bundle, counts, 0,
                 torch.tensor(0), 1)
    occ = torch.zeros(2 * POOL, dtype=torch.bool)
    S.resolve(cfg, sh, occ, 0, 1, torch.tensor(0),
              torch.tensor(0.0, dtype=torch.float64),
              torch.tensor(0.0, dtype=torch.float64))
    assert spy.names == ["route", "shade", "resolve"]
    assert sh.pixel is state.pixel and sh.acc is state.acc
    assert [c.shape for c in sh.shadow[0]] == [(2 * POOL,)] * 3
    assert S.REF_CALLS == {k: v + (k in want) for k, v in refs.items()}


def test_failing_library_load_raises(mixed, monkeypatch):
    """A library that does not build makes the launch raise; nothing
    falls back to the plain version."""
    _, _, scene, _ = mixed
    cfg = _cfg()

    def broken():
        raise RuntimeError("build of libstep_kernels.so failed")
    monkeypatch.setattr(_build, "step_library", broken)
    monkeypatch.setattr(S, "_lib", None)
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    refs = dict(S.REF_CALLS)
    with pytest.raises(RuntimeError, match="libstep_kernels"):
        S.route(scene, cfg, _synthetic_state(scene, cfg, 1), _words(1))
    assert S.REF_CALLS == refs


@pytest.mark.parametrize("bad", ["pixel dtype", "ray_o stride", "words",
                                 "fb shape", "it dtype"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(mixed, monkeypatch,
                                                         bad):
    _, _, scene, cam = mixed
    cfg = _cfg()
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(S, "launch", _Spy())
    state = _synthetic_state(scene, cfg, 2)
    words, fb, it = _words(1), torch.zeros(cfg.num_pixels, 3), \
        torch.tensor(0)
    if bad == "pixel dtype":
        state.pixel = state.pixel.long()
    elif bad == "ray_o stride":
        state.ray_o = tuple(torch.stack(state.ray_o, 1).unbind(1))
    elif bad == "words":
        words = words[:4]
    elif bad == "fb shape":
        fb = fb[:-1]
    else:
        it = it.int()
    _, bundle, counts = S.route_ref(scene, cfg, state, words[:5] if
                                    bad != "words" else _words(1))
    with pytest.raises((TypeError, ValueError)):
        S.route(scene, cfg, state, words)
        S.shade(scene, cam, cfg, state, fb, words, torch.arange(POOL),
                bundle, counts, it, torch.tensor(0), 2)


def test_argument_block_matches_the_kernel_header():
    """kernels/step.py's ``ARG_FIELDS`` name csrc/step_math.cuh's
    ``StepArgs`` fields in order, with the same kinds (pointer, 64-bit,
    32-bit integer, float, arrays of three pointers)."""
    src = (Path(_build.CSRC_DIR) / "step_math.cuh").read_text()
    body = re.search(r"struct StepArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*(\w+)(\[3\])?;", line)
        ctype, name, arr = m.groups()
        kind = "ptr" if "*" in ctype else {"long long": "i64", "int": "i32",
                                           "float": "f32"}[ctype]
        fields.append((name, kind + ("x3" if arr else "")))
    kinds = {S._P: "ptr", S._I64: "i64", S._I32: "i32", S._F32: "f32",
             S._P * 3: "ptrx3"}
    assert fields == [(n, kinds[t]) for n, t in S.ARG_FIELDS]
