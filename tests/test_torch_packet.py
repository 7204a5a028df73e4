"""rtjax_torch packet and lane traversal (the group walk) vs rtjax.

The plain group walk (the CPU path of kernels/wide.py and kernels/lane.py,
and the oracle the CUDA group-walk kernels are held against on the card)
is compared, on the same numpy-seeded tables and rays:

- with rtjax's packet kernels (``wide_traverse_*``) at ``group`` = PACKET
  and its lane kernels (``lane_traverse_*``) at LANE, in interpret mode:
  ``hit`` and occlusion equal; ``t`` at rtol 1e-5 / atol 1e-6 (rtjax's
  jitted code contracts multiply-adds on the CPU, the port rounds every
  product); ``prim`` and ``normal`` equal where the closest t is unique.
  One difference is allowed against rtjax only: rtjax's leaf drain tests
  every ray of its tile against a queued leaf, the port only the rays
  whose own slab accepted the leaf's box, so a ray may find a triangle in
  rtjax that its slab test skips here.  Such rays are counted
  (``drain_only``), must agree with the persist plain version, and stay
  within ``DRAIN_ONLY_MAX``;
- with the persist plain version (kernels/persist.py), which walks one ray
  at a time: ``hit``, ``t`` and occlusion bit for bit; ``prim`` and
  ``normal`` equal except at equal-t ties, which are counted and must be
  real ties (two triangles at the closest t);
- the engine's routing by ``walker`` / ``anyhit_walker``, repass under
  the packet walker, and ``wavefront_step`` state for state against rtjax
  with ``walker="packet"``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.kernels.pallas_lane import (
    lane_traverse_anyhit as jax_lane_anyhit,
    lane_traverse_closest as jax_lane_closest)
from rtjax.kernels.pallas_wide import (
    wide_traverse_anyhit as jax_wide_anyhit,
    wide_traverse_closest as jax_wide_closest)
from rtjax.render import wavefront as jax_wf

from rtjax_torch import RenderConfig
from rtjax_torch.accel.wide import WideTables
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide as WD
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

from scenes import cornell, default_camera
from test_pallas_lane import _pack
from test_torch_instancing import _port_scene, _rays as _inst_rays, _v3
from test_torch_persist import N_RAYS, _inputs, _tt, _unique_t
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_wavefront import STATE_INT, STATE_VEC, _close, _port_carry

DRAIN_ONLY_MAX = 4
# (name, group, port closest, port any-hit, rtjax closest, rtjax any-hit)
WALKS = {
    "packet": (WD.PACKET, WD.wide_traverse_closest, WD.wide_traverse_anyhit,
               jax_wide_closest, jax_wide_anyhit),
    "lane": (L.LANE, L.lane_traverse_closest, L.lane_traverse_anyhit,
             jax_lane_closest, jax_lane_anyhit),
}


@pytest.fixture(scope="module", params=[
    8, pytest.param(16, marks=pytest.mark.slow)], ids=["w8", "w16"])
def scene(request):
    res, ptris, tables = _pack(width=request.param)
    ours = WideTables.from_arrays(
        {k: np.asarray(getattr(tables, k)) for k in
         ("node_bounds", "child_meta", "node_info", "leaf_tris")},
        width=tables.width, depth=res.max_depth, device="cpu")
    return res, ptris, tables, ours


def _closest(fn, ours, o, d, tmax, active):
    return tuple(a.numpy() for a in fn(ours, _tt(o), _tt(d), _tt(tmax),
                                       _tt(active)))


@pytest.mark.parametrize("walk", ["packet", "lane"])
@pytest.mark.parametrize("tmax_v", [np.inf, 0.7], ids=["inf", "0.7"])
def test_group_walk_matches_rtjax(scene, walk, tmax_v):
    _, ptris, tables, ours = scene
    _, closest, anyhit, jax_closest, jax_anyhit = WALKS[walk]
    o, d, active, exclude = _inputs(3)
    tmax = np.full(N_RAYS, tmax_v, np.float32)
    h, t, p, nrm = _closest(closest, ours, o, d, tmax, active)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    jh, jt, jp, jn = (np.asarray(a) for a in jax_closest(
        tables, *args, jnp.asarray(active), interpret=True))

    ph, pt, _, _ = _closest(P.persist_traverse_closest, ours, o, d, tmax,
                            active)
    same = (h == jh) & (~jh | np.isclose(t, jt, rtol=1e-5, atol=1e-6))
    drain_only = ~same
    # the rtjax-only difference: the port agrees with persist's walk there
    assert drain_only.sum() <= DRAIN_ONLY_MAX
    np.testing.assert_array_equal(h[drain_only], ph[drain_only])
    np.testing.assert_array_equal(t[drain_only], pt[drain_only])
    m = jh & same
    uniq = m & _unique_t(ptris, o.astype(np.float64), d.astype(np.float64),
                         tmax, t.astype(np.float64))
    assert uniq.sum() > 0.95 * m.sum() and m.sum() > 300
    np.testing.assert_array_equal(p[uniq], jp[uniq])
    np.testing.assert_array_equal(nrm[uniq], jn[uniq])

    occ = anyhit(ours, _tt(o), _tt(d), _tt(tmax), _tt(exclude),
                 _tt(active)).numpy()
    jocc = np.asarray(jax_anyhit(tables, *args, jnp.asarray(exclude),
                                 jnp.asarray(active), interpret=True))
    pocc = P.persist_traverse_anyhit(ours, _tt(o), _tt(d), _tt(tmax),
                                     _tt(exclude), _tt(active)).numpy()
    drain_only = occ != jocc
    assert drain_only.sum() <= DRAIN_ONLY_MAX
    np.testing.assert_array_equal(occ[drain_only], pocc[drain_only])
    assert occ.sum() > 100 and not occ[~active].any()


@pytest.mark.parametrize("walk", ["packet", "lane"])
@pytest.mark.parametrize("tmax_v", [np.inf, 0.7], ids=["inf", "0.7"])
def test_group_walk_equals_persist_walk(scene, walk, tmax_v):
    """Bit for bit against the one-ray-at-a-time walk, but for the prim of
    equal-t ties (a different visit order may keep the other triangle)."""
    _, ptris, _, ours = scene
    _, closest, anyhit, _, _ = WALKS[walk]
    o, d, active, exclude = _inputs(5)
    tmax = np.full(N_RAYS, tmax_v, np.float32)
    h, t, p, nrm = _closest(closest, ours, o, d, tmax, active)
    ph, pt, pp, pn = _closest(P.persist_traverse_closest_ref, ours, o, d,
                              tmax, active)
    np.testing.assert_array_equal(h, ph)
    np.testing.assert_array_equal(t, pt)
    ties = (p != pp) | (nrm != pn).any(1)
    uniq = _unique_t(ptris, o.astype(np.float64), d.astype(np.float64),
                     tmax, t.astype(np.float64))
    assert not (ties & h & uniq).any()   # every difference is a real tie
    assert ties.sum() <= 0.01 * h.sum() and h.sum() > 300
    occ = anyhit(ours, _tt(o), _tt(d), _tt(tmax), _tt(exclude),
                 _tt(active)).numpy()
    np.testing.assert_array_equal(occ, P.persist_traverse_anyhit_ref(
        ours, _tt(o), _tt(d), _tt(tmax), _tt(exclude), _tt(active)).numpy())


@pytest.mark.parametrize("walk", ["packet", "lane"])
@pytest.mark.parametrize("n", [1, 31, 33, 255, 257, 700])
def test_ragged_batches_and_dead_lanes(scene, walk, n):
    """Partial last groups, dead lanes (a whole dead group at 700 rays) and
    the inactive-lane contract values."""
    _, _, _, ours = scene
    _, closest, anyhit, _, _ = WALKS[walk]
    o, d, active, exclude = (a[:n] for a in _inputs(7))
    active = active.copy()
    active[256:512] = False
    tmax = np.full(n, np.inf, np.float32)
    h, t, p, nrm = _closest(closest, ours, o, d, tmax, active)
    ph, pt, _, _ = _closest(P.persist_traverse_closest_ref, ours, o, d, tmax,
                            active)
    np.testing.assert_array_equal(h, ph)
    np.testing.assert_array_equal(t, pt)
    dead = ~active
    assert not h[dead].any() and (t[dead] == np.float32(P.BIG)).all()
    assert (p[dead] == -1).all() and not nrm[dead].any()
    assert (p[~h] == -1).all() and not nrm[~h].any()
    occ = anyhit(ours, _tt(o), _tt(d), _tt(tmax), _tt(exclude),
                 _tt(active)).numpy()
    np.testing.assert_array_equal(occ, P.persist_traverse_anyhit_ref(
        ours, _tt(o), _tt(d), _tt(tmax), _tt(exclude), _tt(active)).numpy())
    assert not occ[dead].any()


@pytest.mark.parametrize("walk", ["packet", "lane"])
def test_triple_and_array_layouts_agree(scene, walk):
    _, _, _, ours = scene
    _, closest, _, _, _ = WALKS[walk]
    o, d, active, _ = _inputs(9)
    tmax = _tt(np.full(N_RAYS, np.inf, np.float32))
    arr = closest(ours, _tt(o), _tt(d), tmax, _tt(active))
    tri = closest(ours, tuple(_tt(o[:, k]) for k in range(3)),
                  tuple(_tt(d[:, k]) for k in range(3)), tmax, _tt(active))
    for a, b in zip(arr[:3], tri[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert isinstance(tri[3], tuple) and arr[3].shape == (N_RAYS, 3)
    np.testing.assert_array_equal(torch.stack(tri[3], -1).numpy(),
                                  arr[3].numpy())


def test_wrappers_take_any_depth_and_count(scene):
    """The group walks size their stack from the tree's depth, so a depth
    the persist walkers refuse still runs; CPU tensors reach the plain
    version, never a kernel."""
    _, _, _, ours = scene
    deep = dataclasses.replace(ours, depth=P.STACK + 8)
    n = 300
    o, d, active, exclude = (_tt(a[:n]) for a in _inputs(11))
    tmax = torch.full((n,), float("inf"))
    with pytest.raises(ValueError, match="stack"):
        P.persist_traverse_closest(deep, o, d, tmax, active)
    launches = dict(WD.LAUNCHES), dict(L.LAUNCHES)
    refs = dict(WD.REF_CALLS)
    want = P.persist_traverse_closest_ref(ours, o, d, tmax, active)
    for closest, anyhit in ((WD.wide_traverse_closest,
                             WD.wide_traverse_anyhit),
                            (L.lane_traverse_closest,
                             L.lane_traverse_anyhit)):
        got = closest(deep, o, d, tmax, active)
        assert torch.equal(got[1], want[1])
        anyhit(deep, o, d, tmax, exclude, active)
    assert WD.REF_CALLS == {k: v + 2 for k, v in refs.items()}
    assert (WD.LAUNCHES, L.LAUNCHES) == launches


def test_wrappers_reject_bad_inputs(scene):
    _, _, _, ours = scene
    n = 64
    o = tuple(torch.zeros(n) for _ in range(3))
    d = tuple(torch.ones(n) for _ in range(3))
    tmax, act = torch.ones(n), torch.ones(n, dtype=torch.bool)
    for closest, anyhit in ((WD.wide_traverse_closest,
                             WD.wide_traverse_anyhit),
                            (L.lane_traverse_closest,
                             L.lane_traverse_anyhit)):
        with pytest.raises(TypeError):
            closest(ours, o, d, tmax.double(), act)
        with pytest.raises(ValueError):
            closest(ours, o, d, tmax[:10], act)
        with pytest.raises(TypeError):
            anyhit(ours, o, d, tmax, torch.zeros(n, dtype=torch.int64), act)
        with pytest.raises(ValueError, match="width"):
            closest(dataclasses.replace(ours, width=4), o, d, tmax, act)


# ---------------------------------------------------------------- routing

class _Spy:
    """Records which traversal wrappers the engine calls."""

    NAMES = ("persist_traverse_closest", "persist_traverse_anyhit",
             "wide_traverse_closest", "wide_traverse_anyhit",
             "lane_traverse_closest")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            fn = getattr(trace, name)
            monkeypatch.setattr(trace, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kw):
            self.calls.append(name)
            return fn(*args, **kw)
        return call

    def used(self):
        return set(self.calls)


def _single_level(ours):
    """A single-level scene of the tables: the soup's 300 triangles, above
    ``direct_max_tris``."""
    return types.SimpleNamespace(instances=None, tables=ours,
                                 tris=types.SimpleNamespace(num=300))


def _trace_both(sc, cfg, n=300, seed=13):
    o, d, active, exclude = (_tt(a[:n]) for a in _inputs(seed))
    o3 = tuple(o[:, k].contiguous() for k in range(3))
    d3 = tuple(d[:, k].contiguous() for k in range(3))
    closest = trace.trace_closest(sc, cfg, o3, d3,
                                  torch.full((n,), float("inf")), active)
    occ = trace.trace_anyhit(sc, cfg, o3, d3, torch.full((n,), 2.0),
                             exclude, active)
    return closest, occ


@pytest.mark.parametrize("walker, anyhit_walker, want", [
    ("auto", "auto", {"persist_traverse_closest", "persist_traverse_anyhit"}),
    ("persist", "persist",
     {"persist_traverse_closest", "persist_traverse_anyhit"}),
    ("packet", "auto", {"wide_traverse_closest", "persist_traverse_anyhit"}),
    ("packet", "packet", {"wide_traverse_closest", "wide_traverse_anyhit"}),
    ("lane", "auto", {"lane_traverse_closest", "persist_traverse_anyhit"}),
    ("lane", "packet", {"lane_traverse_closest", "wide_traverse_anyhit"}),
    ("auto", "packet", {"persist_traverse_closest", "wide_traverse_anyhit"}),
])
def test_walker_picks_its_kernels(scene, monkeypatch, walker, anyhit_walker,
                                  want):
    _, _, _, ours = scene
    spy = _Spy(monkeypatch)
    cfg = RenderConfig(walker=walker, anyhit_walker=anyhit_walker)
    (hit, t, *_), occ = _trace_both(_single_level(ours), cfg)
    assert spy.used() == want
    o, d, active, exclude = (_tt(a[:300]) for a in _inputs(13))
    wh, wt, *_ = P.persist_traverse_closest_ref(
        ours, o, d, torch.full((300,), float("inf")), active)
    assert torch.equal(hit, wh) and torch.equal(t[hit], wt[hit])
    assert torch.equal(occ, P.persist_traverse_anyhit_ref(
        ours, o, d, torch.full((300,), 2.0), exclude, active))


def test_deep_tree_takes_the_packet_kernels(scene, monkeypatch):
    """A tree deeper than the persist walkers' stack: "auto" and
    ``anyhit_walker`` "auto" / "persist" take the packet kernels, "persist"
    warns and takes them too, "lane" keeps the lane kernel."""
    _, _, _, ours = scene
    monkeypatch.setattr(P, "STACK", ours.depth)
    assert ours.depth + 1 > P.STACK
    sc = _single_level(ours)
    spy = _Spy(monkeypatch)
    _trace_both(sc, RenderConfig())
    assert spy.used() == {"wide_traverse_closest", "wide_traverse_anyhit"}
    spy.calls.clear()
    with pytest.warns(UserWarning, match="packet walker"):
        _trace_both(sc, RenderConfig(walker="persist",
                                     anyhit_walker="persist"))
    assert spy.used() == {"wide_traverse_closest", "wide_traverse_anyhit"}
    spy.calls.clear()
    _trace_both(sc, RenderConfig(walker="lane"))
    assert spy.used() == {"lane_traverse_closest", "wide_traverse_anyhit"}


@pytest.mark.parametrize("change", [dict(walker="bvh"),
                                    dict(anyhit_walker="lane"),
                                    dict(walker="Packet")])
def test_bad_walker_values_raise(change):
    jscene, _ = cornell()
    scene = scene_from_arrays(scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(default_camera()), "cpu")
    cfg = RenderConfig(width=8, height=8, num_samples=1, max_bounces=1,
                       num_working_paths=256, **change)
    with pytest.raises(ValueError, match="walker"):
        wf.render_frame(scene, cam, cfg, torch.Generator())


def test_repass_follows_the_walker(monkeypatch):
    """Under ``walker="packet"`` (and the packet any-hit walker) repass's
    base launch and every BLAS pass run the packet kernels, and find the
    hits of repass over the persist walkers."""
    scene = _port_scene("grid64")
    o, d, active = _inst_rays("grid64")
    n = o.shape[0]
    rng = np.random.default_rng(2)
    exclude = torch.tensor(np.where(rng.random(n) > 0.5, rng.integers(
        0, scene.tris.num, n), -1).astype(np.int32))
    out = {}
    for walker in ("packet", "auto"):
        spy = _Spy(monkeypatch)
        cfg = RenderConfig(two_level="repass", walker=walker,
                           anyhit_walker=walker, direct_max_tris=0)
        hit, t, prim, src, _ = trace.trace_closest(
            scene, cfg, _v3(o), _v3(d), torch.full((n,), float("inf")),
            torch.tensor(active))
        occ = trace.trace_anyhit(scene, cfg, _v3(o), _v3(d),
                                 torch.full((n,), 2.0), exclude,
                                 torch.tensor(active))
        out[walker] = hit, t, src, occ
        kinds = {c.split("_")[0] for c in spy.calls}
        assert kinds == ({"wide"} if walker == "packet" else {"persist"})
        # the base launch and at least one BLAS pass per channel
        assert spy.calls.count(f"{'wide' if walker == 'packet' else 'persist'}"
                               "_traverse_closest") > 1
        monkeypatch.undo()
    (h1, t1, s1, o1), (h2, t2, s2, o2) = out["packet"], out["auto"]
    assert torch.equal(h1, h2) and torch.equal(t1[h1], t2[h2])
    assert torch.equal(o1, o2) and int((s1 > 0).sum()) > 20


# ----------------------------------------------------------------- engine

def test_step_matches_rtjax_state_for_state_packet():
    """test_torch_wavefront.py's state-for-state harness with
    ``walker="packet"`` and ``anyhit_walker="packet"`` on both sides: rtjax
    steps op by op through its interpret-mode packet kernels (its direct
    all-triangles path disabled), the port through the plain group walk;
    two iterations (the second a ``sort_every`` skip iteration)."""
    pool, w = 2048, 16
    jscene, _ = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    scene = scene_from_arrays(scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    kw = dict(width=w, height=w, num_samples=8, max_bounces=4,
              num_working_paths=pool, walker="packet",
              anyhit_walker="packet")
    jcfg = JaxConfig(traversal="pallas", sort_every=0, direct_max_tris=0,
                     **kw)
    cfg = RenderConfig(direct_max_tris=0, **kw)
    key = jax.random.key(2)
    jc = (jax_wf.make_initial_state(pool),
          jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
          jnp.int32(0), jnp.bool_(False), jnp.float32(0), jnp.float32(0))
    refs = dict(WD.REF_CALLS), dict(P.REF_CALLS)
    for it in range(2):
        c = _port_carry(jc)
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                                  pool)).astype(np.int64)
            jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), c)
        js, s = jc[0], c[0]
        hit = np.asarray(js.hit)
        ro = np.stack([np.asarray(x, np.float64) for x in s.ray_o], 1)
        rd = np.stack([np.asarray(x, np.float64) for x in s.ray_d], 1)
        t_want = np.where(hit, np.asarray(js.t), 0.0)
        uniq = ~hit | _unique_t(jscene.tris, ro, rd, np.full(pool, np.inf),
                                t_want.astype(np.float64))
        assert uniq.sum() >= pool - 4
        for f in STATE_INT:
            got, want = getattr(s, f).numpy(), np.asarray(getattr(js, f))
            m = uniq if f == "prim" else np.ones(pool, bool)
            np.testing.assert_array_equal(got[m], want[m], err_msg=f)
        for f in STATE_VEC:
            m = hit & uniq if f == "normal" else np.ones(pool, bool)
            for k in range(3):
                _close(getattr(s, f)[k].numpy()[m],
                       np.asarray(getattr(js, f)[k])[m], f"{f}[{k}]")
        _close(s.t.numpy()[hit], np.asarray(js.t)[hit], "t")
        _close(c[1].numpy(), np.asarray(jc[1]), "framebuffer")
        assert int(c[2]) == int(jc[2]), "cam_start"
        assert float(c[5]) == float(jc[5]), "rays traced"
    assert hit.sum() > pool // 2
    # the port traced through the group walk alone
    assert WD.REF_CALLS["closest"] > refs[0]["closest"]
    assert WD.REF_CALLS["anyhit"] > refs[0]["anyhit"]
    assert P.REF_CALLS == refs[1]
