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
(e) The record design: the record against the first design's columns,
    its material word against rtjax's hit-material rule, the dirty-window
    flush, and the device code compiled as host C++ through the wrappers.
(f) The library's entry points and kernel ids against its source, and
    the step graph's cache keyed on the design.
(g) The full-record modes (the unsorted engine, ``reference_parity`` and
    both): their plain versions through (b) and (c), Russian-roulette
    limbo lanes included; their device code compiled as host C++ against
    the plain versions; the camera rank's scan against ``torch.cumsum``;
    their wrappers launching their own kernels.
(h) The sorted engine's wide bundle (the compact bundle's range test
    patched False), one-sample MIS and ``detailed_stats``, alone and
    combined: through (b), (c) and (g) as the full-record modes, the
    bounce histogram and ``rays_traced`` exact.
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


def _jax_mixed(env=(0.2, 0.3, 0.4), point_lights=2, area=True,
               max_leaf_size=8):
    """rtjax scene: matte, mirror and glass triangles (12 each), point
    lights, an area light, an environment light; above 8 triangles a leaf
    it has no wide tables (the binary walk)."""
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
    return b.build(max_leaf_size=max_leaf_size)


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
    assert bundle.shape == (POOL, S.BUNDLE_ROWS)
    bundle = bundle.T    # the records' words as rows
    mat = ((bundle[5] >> 28) & 1).numpy() != 0
    assert 0 < mat.sum() < POOL and int(counts[0]) == mat.sum()
    assert counts[1:4].eq(0).all()
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
        assert int(counts[4]) == dirty.sum() > 0
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
    b = bundle[order].T
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


@pytest.mark.parametrize("case", ["mixed", "cadence2", "instanced", "parity",
                                  "unsorted", "wide", "one_sample", "stats"])
def test_step_matches_rtjax_state_for_state(mixed, monkeypatch, case):
    """One iteration of the composed plain step against rtjax's
    ``wavefront_step`` (op by op) on rtjax's words, from a synthetic pool
    of every lane kind: glass, mirror, point and area lights and the
    environment light at cadence 1 (the headline's), the Cornell box at
    cadence 2 on iteration 1 with nine in ten paths continuing (a
    ``sort_every`` skip), an instanced scene, and the mixed scene under
    ``reference_parity`` (roulette from bounce 0: limbo lanes), on the
    unsorted engine (``sort_rays=False``), with the sorted engine's wide
    bundle (``_compact_bundle_ok`` patched False in both packages), under
    ``one_sample_mis`` and under ``detailed_stats`` (the bounce histogram
    exact).  Integers exact but the prim and src of equal-t ties, floats
    at rtol 1e-5 / atol 1e-6."""
    if case == "wide":
        for mod in (wf, jax_wf):
            monkeypatch.setattr(mod, "_compact_bundle_ok", lambda s, c: False)
    if case in ("mixed", "parity", "unsorted", "wide", "one_sample",
                "stats"):
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
              sort_every=1 if case == "mixed" else 0,
              **{"parity": dict(reference_parity=True, rr_start=0),
                 "unsorted": dict(sort_rays=False),
                 "one_sample": dict(one_sample_mis=True),
                 "stats": dict(detailed_stats=True)}.get(case, {}))
    jcfg = JaxConfig(traversal="pallas", **kw)
    cfg = RenderConfig(**kw)
    assert wf.step_kernels_cover(scene, cfg)
    assert (S.engine_of(wf._step_mode(scene, cfg)) == "wide") == \
        (case == "wide")
    it = 1 if case == "cadence2" else 2
    state = _synthetic_state(scene, cfg, 6, p_hit=0.97 if it == 1 else 0.7)
    c = (state, torch.zeros(cfg.num_pixels, 3), torch.tensor(300), it,
         torch.tensor(False), torch.tensor(0.0, dtype=torch.float64),
         torch.tensor(0.0, dtype=torch.float64))
    jcarry = _jax_carry(c)
    if cfg.detailed_stats:
        hist = np.random.default_rng(7).integers(0, 50, cfg.max_bounces + 1)
        c += (torch.tensor(hist),) + (torch.zeros((), dtype=torch.int64),) * 4
        jcarry += (jnp.asarray(hist, jnp.int32),) + (jnp.int32(0),) * 4
    key = jax.random.key(5)
    refs = dict(S.REF_CALLS)
    with jax.disable_jit():
        words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                              POOL)).astype(np.int64)
        jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jcarry)
    if case == "parity":
        limbo = S.route_full_ref(scene, cfg, state, torch.tensor(words),
                                 "parity")[2][4]
        assert int(limbo) > 0
        refs = dict(S.REF_CALLS)
    c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
    mine = S.MODE_KERNELS[wf._step_mode(scene, cfg)]
    assert all(S.REF_CALLS[k] - refs[k] == (k in mine) for k in refs)
    if cfg.detailed_stats:
        _eq(c[7].numpy(), np.asarray(jc[7]), "bounce histogram")
        assert int(c[7].sum()) > hist.sum()
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

_PARITY = dict(reference_parity=True, rr_start=0)
_ONE = dict(one_sample_mis=True)
_STATS = dict(detailed_stats=True)
# not a RenderConfig field: the sorted engine's wide bundle, forced by
# patching the compact bundle's range test (:func:`_narrow`)
_WIDE = dict(wide=True)


def _narrow(monkeypatch, change):
    """``change`` without ``_WIDE``'s key; under it the compact bundle's
    range test patched False (both steps read it through kernels/step.py
    ``compact_bundle_ok``)."""
    change = dict(change)
    if change.pop("wide", False):
        monkeypatch.setattr(S, "compact_bundle_ok", lambda scene, cfg: False)
    return change


@pytest.mark.parametrize("change, lights", [
    ({}, "mixed"), (dict(sort_key="adaptive"), "mixed"),
    (dict(sort_key="prim_pos"), "mixed"), (dict(sort_key="morton"), "mixed"),
    (dict(sort_key="morton_pos10"), "mixed"),
    (dict(sort_key="normal_pos", sort_every=3), "mixed"),
    (dict(sort_key="prim", num_samples=16), "mixed"),
    ({}, "none"), ({}, "points"), (dict(two_level="kernel"), "instanced"),
    ({}, "instanced"),
    (dict(sort_rays=False), "mixed"), (dict(traversal="xla"), "mixed"),
    (dict(traversal="xla"), "no_wide"),
    (_PARITY, "mixed"), (dict(_PARITY, sort_key="prim_pos"), "mixed"),
    (_PARITY, "none"), (_PARITY, "instanced"),
    (dict(_PARITY, sort_rays=False), "mixed"),
    (_WIDE, "mixed"), (dict(_WIDE, sort_key="adaptive"), "instanced"),
    (_WIDE, "none"), (_ONE, "mixed"), (dict(_ONE, sort_every=2), "points"),
    (dict(_ONE, sort_rays=False), "mixed"), (dict(_WIDE, **_ONE), "mixed"),
    (_ONE, "none"), (_STATS, "mixed"), (dict(_PARITY, **_STATS), "mixed"),
    (dict(_STATS, traversal="xla"), "mixed"),
    (dict(_WIDE, **_STATS), "instanced"),
    (dict(_ONE, **_STATS), "mixed")], ids=str)
def test_step_equals_the_op_by_op_step(mixed, monkeypatch, change, lights):
    """Three iterations from a fresh pool, both steps on the same words:
    every state field, the framebuffer and the counters bit for bit.
    Beside the sorted engine's default estimator: the unsorted engine
    (``sort_rays=False``, the traversal "xla", also on a scene without wide
    tables), ``reference_parity`` with roulette from bounce 0, so that
    lanes fall into limbo within the three iterations, the sorted engine's
    wide bundle, ``one_sample_mis`` and ``detailed_stats`` (its histogram
    and traversal sums)."""
    change = _narrow(monkeypatch, change)
    limbo = 0
    if lights == "instanced":
        scene = scene_from_arrays(inst_scene_arrays(_jax_scene("pyramid3")),
                                  "cpu")
    elif lights == "mixed":
        scene = mixed[2]
    elif lights == "no_wide":
        scene = scene_from_arrays(scene_arrays(_jax_mixed(max_leaf_size=12)),
                                  "cpu")
        assert scene.tables is None
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
    mode = S.step_mode(scene, cfg)
    refs = dict(S.REF_CALLS)
    for it in range(3):
        words = _words(10 + it)
        if mode.startswith("parity"):
            limbo += int(S._route_full(scene, cfg, new[0], words,
                                       mode)[2][4])
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
    assert (limbo > 0) == mode.startswith("parity")
    assert {k: v - refs[k] for k, v in S.REF_CALLS.items() if v != refs[k]} \
        == {k: 3 for k in S.MODE_KERNELS[mode]}
    if cfg.detailed_stats:
        assert int(new[7].sum()) > 0 and int(new[9]) > 0


# --------------------------------------------------- (d) routing, checks

@pytest.mark.parametrize("change, covered, mode", [
    ({}, True, "default"), (dict(sort_key="prim", sort_every=3), True,
                            "default"),
    (dict(reference_parity=True), True, "parity"),
    (dict(one_sample_mis=True), True, "default_1s"),
    (dict(sort_rays=False), True, "unsorted"),
    (dict(traversal="xla"), True, "unsorted"),
    (dict(detailed_stats=True), True, "default_stats"),
    (dict(max_bounces=126), True, "wide"),
    (dict(width=2048, height=1025), True, "wide"),
    (dict(reference_parity=True, max_bounces=126), True, "parity"),
    (dict(sort_rays=False, width=2048, height=1025), True, "unsorted"),
    (dict(reference_parity=True, sort_rays=False), True, "parity_unsorted"),
    (dict(reference_parity=True, detailed_stats=True), True, "parity_stats"),
    (dict(traversal="xla", detailed_stats=True), True, "unsorted_stats"),
    (dict(sort_rays=False, one_sample_mis=True), True, "unsorted_1s"),
    (dict(max_bounces=126, one_sample_mis=True, detailed_stats=True), True,
     "wide_1s_stats"),
    (dict(reference_parity=True, one_sample_mis=True), False, "parity_1s")],
    ids=str)
def test_mode_predicate(mixed, change, covered, mode):
    """``step_kernels_cover`` names the modes the kernels run: every mode
    ``check_slice`` accepts, the sorted engine with the compact bundle and
    beyond its ranges (the wide bundle), the unsorted engine and
    ``reference_parity``, with ``one_sample_mis`` (but under parity, which
    ``check_slice`` refuses) and ``detailed_stats``; ``step_mode`` names
    each."""
    cfg = _cfg(**change)
    assert wf.step_kernels_cover(mixed[2], cfg) == covered
    assert S.step_mode(mixed[2], cfg) == wf._step_mode(mixed[2], cfg) == mode
    if not covered:
        with pytest.raises(ValueError):
            wf.check_slice(mixed[2], cfg)


def test_predicate_takes_the_compact_bundle_ranges():
    """Past 255 instances (src's 8 bits) the wide bundle's kernels run."""
    from types import SimpleNamespace as NS
    for n_inst, mode in ((255, "default"), (256, "wide")):
        fake = NS(tables=object(), tris=NS(num=3), blas=(NS(tris=NS(num=4)),),
                  instances=NS(num=n_inst))
        assert wf.step_kernels_cover(fake, _cfg())
        assert S.step_mode(fake, _cfg()) == mode


class _Spy:
    """Stands in for ``launch``: records the kernels launched."""

    def __init__(self):
        self.names = []

    def __call__(self, name, a, dev):
        self.names.append(name)


@pytest.mark.parametrize("step_kernels, change, want", [
    (True, {}, ["route", "shade", "resolve"]),
    (False, {}, []),
    (True, dict(reference_parity=True),
     ["route_parity", "shade_parity", "resolve_parity"]),
    (True, dict(sort_rays=False), ["resolve", "route_shade_unsorted"]),
    (False, dict(reference_parity=True), []),
    (True, dict(one_sample_mis=True), ["route", "shade_1s", "resolve_1s"]),
    (True, dict(detailed_stats=True), ["route", "shade", "resolve_stats"]),
    (False, dict(one_sample_mis=True, detailed_stats=True), [])], ids=str)
def test_step_routes_by_mode_and_device(mixed, monkeypatch, step_kernels,
                                        change, want):
    """On a CUDA tensor the wrappers launch their kernels (spied), on a
    CPU one they run the plain versions, each mode its own;
    ``step_kernels=False`` calls neither."""
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
    rays = POOL if cfg.one_sample_mis else 2 * POOL
    occ = torch.zeros(rays, dtype=torch.bool)
    S.resolve(cfg, sh, occ, 0, 1, torch.tensor(0),
              torch.tensor(0.0, dtype=torch.float64),
              torch.tensor(0.0, dtype=torch.float64), _hits(),
              _hist(cfg))
    assert spy.names == list(S.kernels_of(cfg, "default"))
    assert sh.pixel is state.pixel and sh.acc is state.acc
    assert [c.shape for c in sh.shadow[0]] == [(rays,)] * 3
    assert (sh.chs_mask is None) != cfg.one_sample_mis
    assert S.REF_CALLS == {k: v + (k in want) for k, v in refs.items()}


def _hits(n=POOL):
    """Closest hits ``(hit, t, normal, prim, src)`` of ``n`` misses."""
    return (torch.zeros(n, dtype=torch.bool), torch.zeros(n),
            (torch.zeros(n),) * 3, torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32))


def _hist(cfg):
    """A zero bounce histogram under ``detailed_stats``, else None."""
    return torch.zeros(cfg.max_bounces + 1, dtype=torch.int64) \
        if cfg.detailed_stats else None


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


# ---------------------------------- (e) the record design and the flush

def test_record_round_trip_matches_the_column_layout(mixed):
    """The ``[N, 10]`` record decodes to the values the first design's
    ``[9, N]`` columns decode to, bit for bit: its first nine words are the
    columns, word 9 the material index."""
    _, _, scene, _ = mixed
    cfg = _cfg()
    state = _synthetic_state(scene, cfg, 12)
    words = _words(13)
    keys, rec, counts = S.route_ref(scene, cfg, state, words)
    keys1, cols, counts1 = S.route_v1_ref(scene, cfg, state, words)
    assert rec.shape == (POOL, S.BUNDLE_ROWS) and rec.dtype == torch.int32
    assert cols.shape == (S.V1_BUNDLE_ROWS, POOL) and cols.is_contiguous()
    assert torch.equal(keys, keys1) and torch.equal(counts, counts1)
    assert torch.equal(rec[:, :S.V1_BUNDLE_ROWS], cols.T)
    for a, b in zip(_flat(S.unpack_bundle(rec)),
                    _flat(S.unpack_bundle(cols.T)), strict=True):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    # pack_bundle of route's state packs the same words again
    acc, beta, bounces, mat, _, hp = S.emit_and_roulette(
        scene, cfg, state, S.rng.u01_pair(words[S.W_RR_PICK])[0])
    again = S.pack_bundle(hp, beta, acc, state.pixel, bounces, mat,
                          state.prim, state.src, state.normal, state.ray_d,
                          rec[:, S.W_MATERIAL])
    assert torch.equal(again, rec)


@pytest.mark.parametrize("kind", ["single", "instanced"])
def test_bundle_material_is_rtjax_hit_material(mixed, kind):
    """The record's material word against rtjax's hit-material rule
    (``_hit_material_index``, clamped to the table as its gather clamps
    it), with misses (prim -1) and, instanced, hits in instances (src >
    0); shade's materials are the ones rtjax's ``gather_v3`` gives."""
    if kind == "single":
        jscene, _, scene, _ = mixed
    else:
        jscene = _jax_scene("pyramid3")
        scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    cfg = _cfg()
    state = _synthetic_state(scene, cfg, 14)
    src, prim = state.src.numpy(), state.prim.numpy()
    assert (prim == -1).any()
    assert (src > 0).any() == (kind == "instanced")
    _, rec, _ = S.route_ref(scene, cfg, state, _words(15))
    with jax.disable_jit():
        mi = jax_trace._hit_material_index(jscene, _j(state.src),
                                           _j(state.prim))
        want = np.clip(np.asarray(mi), 0,
                       jscene.materials.mtype.shape[0] - 1)
        mt, alb, ior = jscene.materials.gather_v3(jnp.asarray(want))
    _eq(rec[:, S.W_MATERIAL].numpy(), want, "material index")
    mtype, albedo, ior_p = scene.materials.gather_v3(rec[:, S.W_MATERIAL])
    _eq(mtype.numpy(), mt, "mtype")
    for k in range(3):
        _eq(albedo[k].numpy(), alb[k], f"albedo[{k}]")
    _eq(ior_p.numpy(), ior, "ior")


@pytest.mark.parametrize("sort_every, it", [(1, 2), (2, 1), (3, 3)])
def test_dirty_window_flush_equals_the_full_flush(mixed, sort_every, it):
    """Only the dirty window (sorted positions ``[counts[0], counts[0] +
    counts[4])``) holds radiance to flush: the plain version's
    ``index_add_`` of every dead lane gives the framebuffer bit for bit
    that adding the window's lanes with radiance alone gives (the
    kernels' rule), and every lane past the window holds none."""
    _, _, scene, cam = mixed
    cfg = _cfg(sort_every=sort_every, num_samples=16)
    state = _synthetic_state(scene, cfg, 16 + it)
    words = _words(17 + it)
    keys, rec, counts = S.route_ref(scene, cfg, state, words)
    order = torch.sort(keys, stable=True).indices
    fb = torch.tensor(np.random.default_rng(3).uniform(
        0, 2, (cfg.num_pixels, 3)).astype(np.float32))
    got = fb.clone()
    S.shade_ref(scene, cam, cfg, state, got, words, order, rec, counts, it,
                torch.tensor(50), sort_every)
    do_gen = S.cadence(counts, POOL, it, sort_every)
    want = fb.clone()
    lo, hi = int(counts[0]), int(counts[0]) + int(counts[4])
    assert 0 < lo < hi < POOL
    if do_gen is None or bool(do_gen):
        _, _, acc, pixel, _, mat, *_ = S.unpack_bundle(rec[order])
        a = torch.stack(acc, 1)
        assert not bool(mat[lo:].any()) and bool(mat[:lo].all())
        assert not bool(a[hi:].any())
        some = (a[lo:hi] != 0).any(1)
        assert bool(some.any())
        want.index_add_(0, pixel[lo:hi][some].long(), a[lo:hi][some])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_first_design_step_equals_the_record_step(mixed, monkeypatch):
    """The composed plain step under ``DESIGN = "v1"`` (the first design's
    plain versions: the column bundle, the material from prim and src)
    equals the record design's bit for bit, three iterations from a fresh
    pool."""
    _, _, scene, cam = mixed
    cfg = _cfg(sort_every=2)
    new, old = wf.initial_carry(cfg, "cpu"), wf.initial_carry(cfg, "cpu")
    for it in range(3):
        words = _words(30 + it)
        new = wf.wavefront_step(scene, cam, cfg, words, new)
        monkeypatch.setattr(S, "DESIGN", "v1")
        old = wf.wavefront_step(scene, cam, cfg, words, old)
        monkeypatch.setattr(S, "DESIGN", "record")
        for x, y in zip(graph.flatten(new), graph.flatten(old), strict=True):
            assert not torch.is_tensor(y) or torch.equal(x, y)
    assert float(new[1].sum()) > 0


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [c for v in x for c in _flat(v)]
    return [] if x is None else [x]


def _host_kernels():
    """The step kernels' device code and launch logic compiled as host C++
    (tests/step_kernels_host.cpp over csrc/step_math.cuh), bound as the
    kernels' library."""
    import ctypes
    src = Path(__file__).with_name("step_kernels_host.cpp")
    out = _build._build(
        _build.BUILD_DIR / "libstep_kernels_host.so", [src],
        ["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", f"-I{_build.CSRC_DIR}"],
        (Path(_build.CSRC_DIR) / "step_math.cuh",))
    return S.bind(ctypes.CDLL(str(out)))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("spp, sort_every, it", [
    (4, 1, 2), (16, 2, 1), (16, 3, 3), (64, 1, 5), (8, 2, 4)], ids=str)
def test_host_compiled_kernels_match_plain_and_first_design(
        mixed, monkeypatch, spp, sort_every, it):
    """csrc/step_math.cuh compiled as host C++ and run through the real
    wrappers on CPU tensors: route bit for bit against its plain version;
    shade of the record design bit for bit against the first design's
    (the same math, another bundle layout and material source) and
    against the plain version (floats at rtol 1e-4: the host's sqrt and
    the card's division by a host scalar differ from torch's CPU ones);
    the framebuffer, its dirty-window flush added lane by lane in order,
    bit for bit against the plain version's ``index_add_``."""
    _, _, scene, cam = mixed
    monkeypatch.setattr(S, "_lib", _host_kernels())
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    cfg = _cfg(num_samples=spp, sort_every=sort_every)
    state = _synthetic_state(scene, cfg, 40 + it)
    words = _words(41 + it)
    want = S.route_ref(scene, cfg, state, words)
    got = S.route(scene, cfg, state, words)
    for x, y in zip(got, want, strict=True):
        assert torch.equal(x, y)
    got_v1 = S.route_v1(scene, cfg, state, words)
    assert torch.equal(got_v1[1], want[1][:, :9].T)
    order = torch.sort(want[0], stable=True).indices
    fb = torch.tensor(np.random.default_rng(it).uniform(
        0, 2, (cfg.num_pixels, 3)).astype(np.float32))
    fb0, fb1, fb2 = fb.clone(), fb.clone(), fb.clone()
    t_it, t_cam = torch.tensor(it), torch.tensor(97 * it)
    sh0 = S.shade_ref(scene, cam, cfg, state, fb0, words, order, want[1],
                      want[2], t_it, t_cam, sort_every)
    copy = lambda st: dataclasses.replace(st, **{
        f: tuple(c.clone() for c in v) if isinstance(v, tuple) else v.clone()
        for f, v in vars(st).items()})
    sh1 = S.shade(scene, cam, cfg, copy(state), fb1, words, order, want[1],
                  want[2].clone(), t_it, t_cam, sort_every)
    sh2 = S.shade_v1(scene, cam, cfg, copy(state), fb2, words, order,
                     got_v1[1], want[2].clone(), t_it, t_cam, sort_every)
    flat = lambda sh: _flat(tuple(getattr(sh, f) for f in (
        "pixel", "ray_o", "ray_d", "beta", "bounces", "acc", "trace_mask",
        "counts", "shadow", "ah_L", "chs_L")))
    for x, y, z in zip(flat(sh1), flat(sh2), flat(sh0), strict=True):
        assert torch.equal(_bits(x), _bits(y))
        if x.dtype == torch.float32:
            torch.testing.assert_close(x, z, rtol=1e-4, atol=1e-5,
                                       equal_nan=True)
        else:
            assert torch.equal(x, z)
    assert torch.equal(_bits(fb1), _bits(fb2))
    assert torch.equal(_bits(fb1), _bits(fb0))
    assert int(want[2][4]) > 0 and not torch.equal(fb1, fb)


# ------------------------------- (f) the library's surface and the graph key

_KERNEL_SOURCE = Path(_build.CSRC_DIR) / "step_kernels.cu"


@pytest.mark.parametrize("name", sorted(S.KERNEL_IDS))
def test_kernel_ids_match_the_kernel_source(name):
    """``KERNEL_IDS`` names the kernel that ``rtjax_step_kernel_info``
    reports under its id, at the block its entry point launches."""
    src = _KERNEL_SOURCE.read_text()
    body = src[src.index('"C" int rtjax_step_kernel_info'):]
    m = re.search(rf"case {S.KERNEL_IDS[name]}: return info\((\w+), (\w+),",
                  body)
    assert m is not None and m.group(1) == f"{name}_kernel"
    launch = re.search(rf'"C" int rtjax_step_{name}\(.*?\n\}}', src,
                       re.S).group(0)
    assert f"launch({name}_kernel, {m.group(2)}, a, stream)" in launch


@pytest.mark.parametrize("source", [_KERNEL_SOURCE,
                                    Path(__file__).with_name(
                                        "step_kernels_host.cpp")],
                         ids=["card", "host"])
def test_library_exports_the_entry_points_bind_binds(source):
    """The card's library and the host stand-in export one entry point a
    counted kernel (``_COUNTERS``) and ``kernel_info``, and no other."""
    names = re.findall(r'extern "C" int rtjax_step_(\w+)\(',
                       source.read_text())
    assert sorted(names) == sorted([*S._COUNTERS, "kernel_info"])


def _graph_carry(cfg):
    """A fresh frame's carry as the graph path holds it (``it`` a 0-d
    tensor)."""
    c = wf.initial_carry(cfg, "cpu")
    return c[:3] + (torch.zeros((), dtype=torch.int64),) + c[4:]


@pytest.mark.parametrize("captured, asked", [
    ("record", "record"), ("record", "v1"), ("v1", "v1"), ("v1", "record")])
def test_graph_cache_follows_the_step_design(mixed, monkeypatch, captured,
                                             asked):
    """A cached step graph serves a frame only under the step kernels'
    design it was made under; under the other the cache takes a new one."""
    _, _, scene, cam = mixed
    cfg = _cfg()
    monkeypatch.setattr(graph, "_cache", [])
    monkeypatch.setattr(S, "DESIGN", captured)
    g = graph.frame_steps(scene, cam, cfg, _graph_carry(cfg))
    monkeypatch.setattr(S, "DESIGN", asked)
    assert g.matches(scene, cam, cfg) == (captured == asked)
    again = graph.frame_steps(scene, cam, cfg, _graph_carry(cfg))
    assert (again is g) == (captured == asked)
    assert graph.cached() is again and again.key[4] == asked


def test_graph_refuses_to_capture_under_another_design(mixed, monkeypatch):
    """A step graph made under one design and captured after the design
    changed raises before it touches the card."""
    _, _, scene, cam = mixed
    cfg = _cfg()
    monkeypatch.setattr(S, "DESIGN", "record")
    g = graph.StepGraph(scene, cam, cfg, _graph_carry(cfg))
    monkeypatch.setattr(S, "DESIGN", "v1")
    with pytest.raises(RuntimeError, match="captured under the 'record'"):
        g.step(torch.Generator())


# ------------------------------------------------- (g) the full-record modes

_FULL_MODES = {"unsorted": dict(sort_rays=False), "parity": _PARITY,
               "parity_unsorted": dict(_PARITY, sort_rays=False)}
# the modes of the wide bundle, one-sample MIS and detailed_stats (their
# step_mode names), which the host-compiled and wrapper tests take beside
# _FULL_MODES
_FLAG_MODES = {"wide": _WIDE, "default_1s": _ONE,
               "unsorted_1s": dict(_ONE, sort_rays=False),
               "wide_1s": dict(_WIDE, **_ONE), "default_stats": _STATS,
               "parity_stats": dict(_PARITY, **_STATS),
               "default_1s_stats": dict(_ONE, **_STATS)}
_MODES = {**_FULL_MODES, **_FLAG_MODES}


def _on_host(monkeypatch):
    """Bind the host-compiled kernels as the library and take the card's
    path on CPU tensors."""
    monkeypatch.setattr(S, "_lib", _host_kernels())
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))


def _copy_state(st):
    return dataclasses.replace(st, **{
        f: tuple(c.clone() for c in v) if isinstance(v, tuple) else v.clone()
        for f, v in vars(st).items()})


def _shade_both(scene, cam, cfg, mode, state, words, fb0, fb1, cam_start,
                monkeypatch):
    """``mode``'s route (held bit for bit to its plain version) and
    shade, plain (into ``fb0``) and on the host-compiled kernels (into
    ``fb1``): ``(plain Shaded, kernels' Shaded, route's counts)``."""
    engine = S.engine_of(mode)
    if engine == "unsorted":
        sh0 = S.route_shade_unsorted_ref(scene, cam, cfg, state, fb0, words,
                                         cam_start)
        _on_host(monkeypatch)
        return sh0, S.route_shade_unsorted(
            scene, cam, cfg, _copy_state(state), fb1, words, cam_start), None
    if engine == "default":
        want = S.route_ref(scene, cfg, state, words)
        _on_host(monkeypatch)
        got = S.route(scene, cfg, state, words)
    else:
        want = S.route_full_ref(scene, cfg, state, words, mode)
        _on_host(monkeypatch)
        got = S.route_full(scene, cfg, state, words, mode)
    for x, y in zip(got, want, strict=True):
        assert (x is None and y is None) or torch.equal(x, y)
    keys, record, counts = want
    order = None if keys is None else torch.sort(keys, stable=True).indices
    if engine == "default":
        sh0 = S.shade_ref(scene, cam, cfg, state, fb0, words, order, record,
                          counts, 2, cam_start, 1)
        sh1 = S.shade(scene, cam, cfg, _copy_state(state), fb1, words, order,
                      record, counts.clone(), 2, cam_start, 1)
    else:
        sh0 = S.shade_full_ref(scene, cam, cfg, fb0, words, order, record,
                               counts, cam_start, mode)
        sh1 = S.shade_full(scene, cam, cfg, _copy_state(state), fb1, words,
                           order, record, counts.clone(), cam_start, mode)
    return sh0, sh1, counts


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("lights", ["mixed", "none"])
def test_host_compiled_full_modes_match_plain_versions(mixed, monkeypatch,
                                                       mode, lights):
    """csrc/step_math.cuh's full-record modes (the unsorted engine,
    ``reference_parity``, the wide bundle) and the one-sample and
    ``detailed_stats`` instances compiled as host C++ and run through the
    real wrappers on CPU tensors, on a synthetic pool with limbo (parity)
    or dirty (sorted engine) lanes: route (keys, record, counts) and
    resolve (radiance, the limbo lanes' restored hits, the one-sample
    channel on hits that reach the picked light, the bounce histogram,
    counters) bit for bit against their plain versions; shade's (on the
    unsorted engine route and shade's one kernel's) integers, masks and
    framebuffer (every flushing lane added in order) bit for bit and its
    floats at rtol 1e-4, as the default instances' host test (the host's
    sin, cos and the card's division by a host scalar differ from torch's
    CPU ones)."""
    _, _, scene, cam = mixed
    if lights == "none":
        scene = dataclasses.replace(scene, num_lights=0)
    cfg = _cfg(**_narrow(monkeypatch, _MODES[mode]))
    assert S.step_mode(scene, cfg) == mode
    state = _synthetic_state(scene, cfg, 50)
    words = _words(51)
    fb = torch.tensor(np.random.default_rng(5).uniform(
        0, 2, (cfg.num_pixels, 3)).astype(np.float32))
    fb0, fb1 = fb.clone(), fb.clone()
    cam_start = torch.tensor(301)
    scan = S.scan_buffer("cpu", 0, POOL)
    sh0, sh1, counts = _shade_both(scene, cam, cfg, mode, state, words, fb0,
                                   fb1, cam_start, monkeypatch)
    if counts is not None:
        # limbo lanes (parity) or dirty ones (the sorted engine)
        assert int(counts[4]) > 0
    # the scan buffer is left zero for the next launch
    assert scan.shape == (S.scan_words(POOL),) and not scan.any()
    fields = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
              "trace_mask", "counts", "shadow", "ah_L", "chs_L", "chs_mask")
    fields += ("limbo",) * mode.startswith("parity")
    for f in fields:
        for x, y in zip(_flat(getattr(sh1, f)), _flat(getattr(sh0, f)),
                        strict=True):
            if x.dtype == torch.float32:
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5,
                                           equal_nan=True)
            else:
                assert torch.equal(x, y), f
    assert (sh0.chs_mask is not None) == (cfg.one_sample_mis and
                                          lights == "mixed")
    assert torch.equal(_bits(fb1), _bits(fb0)) and not torch.equal(fb1, fb)
    # resolve on the plain version's shading, with drawn hits (under
    # one-sample MIS half of them on each lane's picked light)
    rng = np.random.default_rng(52)
    occ = None if sh0.shadow is None else torch.tensor(
        rng.uniform(size=sh0.shadow[4].shape[0]) < 0.3)
    prim = torch.tensor(rng.integers(-1, 20, POOL).astype(np.int32))
    if sh0.chs_mask is not None:
        prim = torch.where(torch.tensor(rng.uniform(size=POOL) < 0.5),
                           sh0.shadow[3], prim)
    hits = (torch.tensor(rng.uniform(size=POOL) < 0.5),
            torch.tensor(rng.uniform(0, 3, POOL).astype(np.float32)),
            tuple(torch.tensor(rng.normal(size=POOL).astype(np.float32))
                  for _ in range(3)), prim,
            torch.zeros(POOL, dtype=torch.int32))
    hist = None if not cfg.detailed_stats else torch.tensor(
        rng.integers(0, 99, cfg.max_bounces + 1))
    rays, occ_sum = (torch.tensor(v, dtype=torch.float64) for v in (7, .5))
    copy = lambda v: None if v is None else tuple(c.clone() for c in v) \
        if isinstance(v, tuple) else v.clone()
    monkeypatch.setattr(S, "_on_card", lambda t: False)
    r0 = S.resolve_full(cfg, dataclasses.replace(sh0, acc=copy(sh0.acc)),
                        occ, hits, cam_start, rays, occ_sum, mode, copy(hist))
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    r1 = S.resolve_full(cfg, dataclasses.replace(sh0, acc=copy(sh0.acc)),
                        occ, tuple(copy(v) for v in hits), cam_start, rays,
                        occ_sum, mode, copy(hist))
    for x, y in zip(_flat(r1), _flat(r0), strict=True):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    if mode.startswith("parity"):
        assert bool(r1[1][0][sh0.limbo].all())
    if hist is not None:
        assert int(r1[-1].sum() - hist.sum()) == int(sh0.trace_mask.sum())
    if sh0.chs_mask is not None:
        # the one-sample channel landed on some lane
        assert bool((sh0.chs_mask & hits[0] & (prim == sh0.shadow[3])).any())


_RANK_MASKS = {
    "all": lambda i: i >= 0, "none": lambda i: i < 0,
    "alternating": lambda i: i % 2 == 0,
    "one a block": lambda i: i % S.SCAN_BLOCK == 37,
    "block edges": lambda i: (i % S.SCAN_BLOCK == 0)
    | (i % S.SCAN_BLOCK == S.SCAN_BLOCK - 1)}


@pytest.mark.parametrize("mask", list(_RANK_MASKS))
def test_scan_rank_equals_cumsum(mixed, monkeypatch, mask):
    """The camera rank of the unsorted engine is the exclusive prefix sum
    of the lanes that take a camera ray, in slot order, across shade
    blocks (7 of SCAN_BLOCK lanes and a ragged tail): with one sample a
    pixel in scanline order, such a lane takes pixel ``cam_start`` + its
    rank.  The plain version (``torch.cumsum``) and the host-compiled
    kernels (step_math.cuh's look-back scan, each block walking back over
    its predecessors' aggregates) both give ``torch.cumsum``'s ranks."""
    _, _, scene, cam = mixed
    n = 7 * S.SCAN_BLOCK + 5
    cfg = RenderConfig(width=64, height=64, num_samples=1, max_bounces=5,
                       num_working_paths=n, sort_rays=False,
                       camera_order="scanline", rr_start=1 << 20,
                       direct_max_tris=0)
    gen = _RANK_MASKS[mask](torch.arange(n))
    f = lambda v: torch.full((n,), v)
    z = torch.zeros(n, dtype=torch.int32)
    state = wf.PathState(
        pixel=z.clone(), ray_o=(f(0.0), f(0.0), f(0.0)),
        ray_d=(f(0.0), f(0.0), f(1.0)), hit=~gen, t=f(1.0),
        normal=(f(0.0), f(1.0), f(0.0)), prim=z.clone(), src=z.clone(),
        bounces=torch.where(gen, DEAD_BOUNCES, 0).to(torch.int32),
        beta=(f(1.0), f(1.0), f(1.0)), acc=(f(0.0), f(0.0), f(0.0)))
    want = torch.where(gen, 11 + torch.cumsum(gen, 0) - gen.long(), 0)
    words = _words(60, n)

    def pixels():
        sh = S.route_shade_unsorted(scene, cam, cfg, _copy_state(state),
                                    torch.zeros(cfg.num_pixels, 3), words,
                                    torch.tensor(11))
        assert bool(sh.trace_mask.all())
        return torch.where(gen, sh.pixel.long(), 0)

    assert torch.equal(pixels(), want)
    _on_host(monkeypatch)
    assert torch.equal(pixels(), want)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_full_wrappers_launch_their_kernels(mixed, monkeypatch, mode):
    """On a CUDA tensor (spied) a full-record mode's wrappers launch its
    own kernels (the unsorted engine's route and shade one, its and the
    wide bundle's resolve the default one), as do the one-sample and
    ``detailed_stats`` instances, and no plain version runs;
    ``shade_full`` leaves the record, the order and the limbo flags to
    ``resolve_full``."""
    _, _, scene, cam = mixed
    cfg = _cfg(**_narrow(monkeypatch, _MODES[mode]))
    engine = S.engine_of(mode)
    spy = _Spy()
    monkeypatch.setattr(S, "_on_card", lambda t: True)
    monkeypatch.setattr(S, "launch", spy)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    refs = dict(S.REF_CALLS)
    state = _synthetic_state(scene, cfg, 3)
    fb = torch.zeros(cfg.num_pixels, 3)
    if engine == "unsorted":
        sh = S.route_shade_unsorted(scene, cam, cfg, state, fb, _words(1),
                                    torch.tensor(0))
        assert sh.record is None and sh.order is None and sh.limbo is None
    elif engine == "default":
        _, bundle, counts = S.route(scene, cfg, state, _words(1))
        sh = S.shade(scene, cam, cfg, state, fb, _words(1),
                     torch.arange(POOL), bundle, counts, 0, torch.tensor(0),
                     1)
    else:
        keys, rec, counts = S.route_full(scene, cfg, state, _words(1), mode)
        assert (keys is None) == (engine == "parity_unsorted")
        order = None if keys is None else torch.arange(POOL)
        sh = S.shade_full(scene, cam, cfg, state, fb, _words(1), order, rec,
                          counts, torch.tensor(0), mode)
        assert sh.record is rec and sh.order is order
        assert (sh.limbo is not None) == engine.startswith("parity")
    rays = POOL if cfg.one_sample_mis else 2 * POOL
    out = S.resolve_full(cfg, sh, torch.zeros(rays, dtype=torch.bool),
                         _hits(), torch.tensor(0),
                         torch.tensor(0.0, dtype=torch.float64),
                         torch.tensor(0.0, dtype=torch.float64), mode,
                         _hist(cfg))
    assert spy.names == list(S.MODE_KERNELS[mode])
    assert len(out) == 6 + cfg.detailed_stats
    assert S.REF_CALLS == refs


def _tool(name):
    """A module of ``tools/`` (its functions import ``chip_smoke``)."""
    import importlib
    import sys
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(f"tools.{name}")


@pytest.mark.parametrize("change", [{}, *_MODES.values(),
                                    dict(traversal="xla")],
                         ids=["default", *_MODES, "xla"])
def test_step_designs_checks_every_mode(mixed, monkeypatch, change):
    """tools/step_designs.py's check, which chip_smoke.py's phase 14 and
    tools/mode_steps.py run on the card, takes every mode on the CPU
    (the wrappers' plain versions): it checks each of the mode's kernels
    (under the default mode the first design's too, on every sorted engine
    the key sort) on three op-by-op states, limbo lanes among them under
    parity, and finds no mismatching lane and no framebuffer gap."""
    SD = _tool("step_designs")
    _, _, scene, cam = mixed
    cfg = _cfg(**_narrow(monkeypatch, change))
    mode = S.step_mode(scene, cfg)
    lines = []
    worst, gap, timed = SD.check_and_time(scene, cam, cfg, (0, 1, 2), None,
                                          log=lines.append)
    want = set(S.MODE_KERNELS[mode]) | (
        {"route_v1", "shade_v1"} if mode == "default" else set()) | (
        {"key_sort"} if S.engine_of(mode) in ("default", "wide", "parity")
        else set())
    assert set(worst) == want and not any(worst.values())
    assert gap == 0.0 and timed is None and len(lines) == 3
    if mode.startswith("parity"):
        assert re.search(r"[1-9]\d* in limbo", lines[-1]), lines


def test_split_patch_applies_to_the_kernel_source():
    """tools/mode_steps.py --split-ab patches csrc/step_kernels.cu: the
    unsorted engine's merged branch and its count each occur once, and the
    patched source keeps the merged kernel and adds a route of its own."""
    M = _tool("mode_steps")
    src = _build.STEP_SOURCE.read_text()
    out = M.split_source(src)
    assert M.SPLIT_MERGED not in out and M.SPLIT_COUNT not in out
    assert "route_shade_unsorted_kernel" in out
    assert 'extern "C" int rtjax_step_route_unsorted(' in out
    with pytest.raises(RuntimeError, match="no single"):
        M.split_source(src.replace(M.SPLIT_COUNT, ""))
