"""Repass as a device loop (render/trace.py ``_repass_passes``), on the
CPU, against rtjax's repass (``jax.lax.while_loop`` over passes):

- outside a captured graph on the card (render/device_loop.py; its card
  path patched in) every mesh group of G instances runs exactly G
  passes, on the CPU as many as rtjax's ``while_loop``; with nothing
  blocking, a ray is pending in as many passes as it has candidate
  instances, so after G passes none is left, on a scene whose world boxes
  overlap (two meshes, groups of 6 and 3);
- a pass with no pending ray changes nothing: repass with every group's
  passes doubled (the added ones all idle) gives the same hits, normals,
  sources, occlusion and ``with_stats`` sums bit for bit, under the
  persist, packet and direct walkers, and each walker's launch over an
  empty mask returns inactive-lane results and counts nothing;
- ``trace_closest`` / ``trace_anyhit`` and one ``wavefront_step`` under
  repass, with rtjax's random words, against rtjax stepped op by op
  (``jax.disable_jit()``), counts included.  Every BLAS has at most 64
  triangles, so rtjax takes its direct loop and stays out of its
  interpret-mode kernels, and so does the port (its direct pair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import Camera as JaxCamera
from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.render import trace as jax_trace
from rtjax.render import wavefront as jax_wf
from rtjax.scene import transform as jax_tf
from rtjax.scene.scene import SceneBuilder as JaxSceneBuilder

from rtjax_torch import RenderConfig
from rtjax_torch.accel.instancing import RepassGroup
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene import transform as tf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from test_torch_instancing import PYRAMID_F, PYRAMID_V, _blob, \
    inst_scene_arrays
from test_torch_scene import camera_arrays
from test_torch_walker_stats import _stats_carry, _zero_jc

N = 768
WALKERS = {"persist": dict(direct_max_tris=0),
           "packet": dict(direct_max_tris=0, walker="packet",
                          anyhit_walker="packet"),
           "direct": {}}


def _overlap(b, t):
    """Six blobs (64 triangles) stacked a few hundredths apart and three
    pyramids on one spot, over a floor with a light: world boxes that
    overlap, so rays from above have several candidates."""
    white = b.make_matte((0.7, 0.7, 0.7))
    red = b.make_matte((0.6, 0.1, 0.1))
    b.add_triangles([-2, 0, 2], [2, 0, 2], [2, 0, -2], white)
    b.add_triangles([-2, 0, 2], [-2, 0, -2], [2, 0, -2], white)
    b.add_area_light((-0.3, 2.0, -0.3), (0.3, 2.0, -0.3), (0.3, 2.0, 0.3),
                     (20, 20, 20), white)
    blob = b.register_mesh(*_blob())
    pyr = b.register_mesh(PYRAMID_V, PYRAMID_F)
    for i in range(6):
        b.add_instance(blob, red, t.Transform(t.rotate([0, 1, 0], 0.5 * i))
                       .composite(t.translate(0.04 * i, 0.02 * i, 0.0)))
    for i in range(3):
        b.add_instance(pyr, white, t.Transform(t.translate(
            0.05 * i - 0.1, 0.1, 0.05 * i)))


@pytest.fixture(scope="module")
def scenes():
    """The overlap scene built by rtjax, and the port's from its arrays."""
    jb = JaxSceneBuilder()
    _overlap(jb, jax_tf)
    jscene = jb.build()
    return jscene, scene_from_arrays(inst_scene_arrays(jscene), "cpu")


def _rays(seed=3, n=N):
    """Rays from above the instances, pointing down and a little aside."""
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-0.4, 0.5, n), np.full(n, 1.5),
                  g.uniform(-0.4, 0.4, n)], 1).astype(np.float32)
    d = np.stack([g.uniform(-0.2, 0.2, n), np.full(n, -1.0),
                  g.uniform(-0.2, 0.2, n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = g.uniform(size=n) < 0.9
    return o, d, active


def _t(a):
    return tuple(torch.tensor(np.ascontiguousarray(c)) for c in a.T)


def _candidates(scene, o, d, active):
    """Each ray's candidate instances of each group (its world box met),
    from rtjax-order slab tests (``trace._instance_mask``)."""
    inst = scene.instances
    out = {}
    for grp in inst.groups:
        ks = (grp.src_of - 1).tolist()
        out[grp.mesh_id] = sum(
            (trace._instance_mask(inst, k, o, d) & active).long()
            for k in ks)
    return out


def test_groups_are_the_meshes_in_instance_order(scenes):
    _, scene = scenes
    groups = scene.instances.groups
    assert [(g.mesh_id, g.size) for g in groups] == [(0, 6), (1, 3)]
    assert groups[0].src_of.tolist() == [1, 2, 3, 4, 5, 6]
    assert groups[1].src_of.tolist() == [7, 8, 9]
    for g in groups:
        ks = (g.src_of - 1).long()
        assert torch.equal(g.inv, scene.instances.inv[ks])
        assert torch.equal(g.boxes[:, 0, :3], scene.instances.aabb_lo[ks])
        assert torch.equal(g.boxes[:, 0, 3:], scene.instances.aabb_hi[ks])
        assert g.src_of.dtype == torch.int32


@pytest.mark.parametrize("seed", [3, 4])
def test_each_group_runs_exactly_g_passes(scenes, seed, monkeypatch):
    """Nothing blocking: on the card's path (patched here) G passes a
    group, a ray pending in as many passes as it has candidates (so none
    is left after G), and the passes that have a pending ray as many as
    rtjax's ``while_loop`` runs: the most candidates of any ray.  On the
    CPU's path the loop runs just those, as rtjax's does."""
    from rtjax_torch.render import device_loop
    _, scene = scenes
    o, d, active = _rays(seed)
    o, d, active = _t(o), _t(d), torch.tensor(active)
    none = lambda ent: torch.zeros_like(ent, dtype=torch.bool)
    cand = _candidates(scene, o, d, active)
    for card in (True, False):
        passes = {}

        def body(blas, pend, src, *_):
            mesh = next(k for k, b in enumerate(scene.blas) if b is blas)
            passes.setdefault(mesh, []).append((pend.clone(), src))

        monkeypatch.setattr(device_loop, "_on_card", lambda pend: card)
        trace._repass_passes(scene, o, d, active, none, body)
        for grp in scene.instances.groups:
            got = passes[grp.mesh_id]
            busy = sum(bool(p.any()) for p, _ in got)
            assert busy == int(cand[grp.mesh_id].max()) >= 2
            assert len(got) == (grp.size if card else busy)
            pending = sum(p.long() for p, _ in got)
            assert torch.equal(pending, cand[grp.mesh_id])
            # each pending ray walks each of its candidates once
            for k in (grp.src_of).tolist():
                walked = sum(((s == k) & p).long() for p, s in got)
                assert int(walked.max()) <= 1


def _both(scene, cfg, o, d, active, with_stats=True):
    tmax = torch.full((o[0].shape[0],), float("inf"))
    closest = trace.trace_closest(scene, cfg, o, d, tmax, active,
                                  with_stats=with_stats)
    occ = trace.trace_anyhit(scene, cfg, o, d, torch.full_like(tmax, 1.2),
                             torch.full(tmax.shape, -1, dtype=torch.int32),
                             active, with_stats=with_stats)
    return closest, occ


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("walker", list(WALKERS))
def test_idle_passes_change_nothing(scenes, walker, monkeypatch):
    """Every group's passes doubled on the card's path (patched here, so
    that every pass runs): the added G passes find no candidate and leave
    every output and the counts bit for bit."""
    from rtjax_torch.render import device_loop
    monkeypatch.setattr(device_loop, "_on_card", lambda pend: True)
    _, scene = scenes
    cfg = RenderConfig(two_level="repass", **WALKERS[walker])
    o, d, active = _rays(5)
    o, d, active = _t(o), _t(d), torch.tensor(active)
    want = _both(scene, cfg, o, d, active)
    monkeypatch.setattr(RepassGroup, "size",
                        property(lambda g: 2 * g.inv.shape[0]))
    got = _both(scene, cfg, o, d, active)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool(want[0][0].any()) and bool(want[1][0].any())
    assert int(want[0][-1][1]) > 0


@pytest.mark.parametrize("walker", list(WALKERS))
def test_a_launch_over_an_empty_mask_counts_nothing(scenes, walker):
    """What an idle pass launches: each walker over no active ray returns
    inactive-lane results (no hit, prim -1, normal zero, not occluded)
    and zero counts."""
    _, scene = scenes
    cfg = RenderConfig(**WALKERS[walker])
    o, d, _ = _rays(6)
    o, d = _t(o), _t(d)
    off = torch.zeros(N, dtype=torch.bool)
    closest, anyhit = trace._backend(scene.blas[0], cfg, with_stats=True)
    hit, t, prim, nrm, st = closest(o, d, torch.full((N,), 9.0), off)
    assert not bool(hit.any()) and bool((prim == -1).all())
    assert bool((t >= 3.4e38).all())
    assert all(not bool(c.any()) for c in nrm)
    occ, ast = anyhit(o, d, torch.full((N,), 9.0),
                      torch.full((N,), -1, dtype=torch.int32), off)
    assert not bool(occ.any())
    assert [int(v) for v in (*st, *ast)] == [0, 0, 0, 0]


def test_trace_matches_rtjax_repass(scenes):
    """``trace_closest`` / ``trace_anyhit`` under repass against rtjax's
    (its direct loop on every mesh, op by op): hits, t, prims, sources,
    the hits' normals and occlusion bit for bit, and the counts equal."""
    jscene, scene = scenes
    o, d, active = _rays(7)
    n = o.shape[0]
    jcfg = JaxConfig(traversal="pallas")
    cfg = RenderConfig()
    tmax = np.full(n, np.inf, np.float32)
    jo, jd = tuple(jnp.asarray(c) for c in o.T), tuple(jnp.asarray(c)
                                                         for c in d.T)
    with jax.disable_jit():
        want = jax_trace.trace_closest(jscene, jcfg, "pallas", True, jo, jd,
                                       jnp.asarray(tmax),
                                       jnp.asarray(active), True)
        want_occ = jax_trace.trace_anyhit(
            jscene, jcfg, "pallas", True, jo, jd,
            jnp.full(n, 1.2, jnp.float32), jnp.full(n, -1, jnp.int32),
            jnp.asarray(active), True)
    got = trace.trace_closest(scene, cfg, _t(o), _t(d), torch.tensor(tmax),
                              torch.tensor(active), with_stats=True)
    got_occ = trace.trace_anyhit(
        scene, cfg, _t(o), _t(d), torch.full((n,), 1.2),
        torch.full((n,), -1, dtype=torch.int32), torch.tensor(active),
        with_stats=True)
    for k in range(4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    hit = got[0].numpy()
    for g, w in zip(got[4], want[4]):   # rtjax leaves misses' normals
        np.testing.assert_array_equal(g.numpy()[hit], np.asarray(w)[hit])
    assert [int(v) for v in got[5]] == [int(v) for v in want[5]]
    np.testing.assert_array_equal(got_occ[0].numpy(),
                                  np.asarray(want_occ[0]))
    assert [int(v) for v in got_occ[1]] == [int(v) for v in want_occ[1]]
    assert int((got[3] > 0).sum()) > N // 8 and bool(got_occ[0].any())


def test_step_matches_rtjax_state_for_state(scenes):
    """Two iterations of ``wavefront_step`` under repass with
    ``detailed_stats``, the port re-seeded from rtjax's carry with rtjax's
    words each iteration: histogram, rays, hit, bounces, src, prim and the
    node and leaf counts equal rtjax's (its repass runs only the passes it
    needs; the port's idle passes add nothing)."""
    jscene, scene = scenes
    jcam = JaxCamera.make((0.1, 1.2, 1.4), (0.05, 0.1, 0), (0, 1, 0), 40,
                          1.0)
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    pool = 1024
    kw = dict(width=16, height=16, num_samples=8, max_bounces=4,
              num_working_paths=pool)
    jcfg = JaxConfig(traversal="pallas", sort_every=0, detailed_stats=True,
                     **kw)
    cfg = RenderConfig(detailed_stats=True, **kw)
    key = jax.random.key(11)
    jc = _zero_jc(pool, jcfg)
    for it in range(2):
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(
                key, jnp.int32(it), 5, pool)).astype(np.int64)
            want = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        counts = tuple(torch.tensor(int(v), dtype=torch.int64)
                       for v in jc[8:])
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words),
                              _stats_carry(jc, counts))
        np.testing.assert_array_equal(c[7].numpy(), np.asarray(want[7]))
        assert float(c[5]) == float(want[5])
        for f in ("hit", "bounces", "src", "prim"):
            np.testing.assert_array_equal(getattr(c[0], f).numpy(),
                                          np.asarray(getattr(want[0], f)),
                                          err_msg=f)
        assert [int(v) for v in c[8:]] == [int(v) for v in want[8:]]
        jc = want
    assert int((c[0].src > 0).sum()) > 0 and int(c[8]) + int(c[9]) > 0
