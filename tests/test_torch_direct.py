"""rtjax_torch's tiny-scene direct path (kernels/direct.py) against rtjax's
``_direct_closest`` / ``_direct_anyhit`` (render/trace.py), and the gate
that sends a launch to it.

(a) The plain versions on the same triangles and rays as rtjax's loop,
    which steps op by op (``jax.disable_jit()``), so that neither side
    contracts multiply-adds: on a soup of 60 triangles with coincident
    copies and edges shared by two triangles, hit, t, prim, normal,
    occlusion and the counts are equal bit for bit on every active lane,
    ties included (both keep the first triangle of least t).  The
    all-triangles oracle (kernels/brute.py) keeps the same triangle.
(b) The gate, launch by launch: the kernels each package calls for one
    closest-hit and one any-hit trace are recorded (render/trace.py's
    names replaced by recorders that return misses, in both packages, so
    that both take the same passes), for the default config,
    ``direct_max_tris`` 0 and below a mesh's size, ``"xla"``, repass's
    base and BLAS launches, the per-instance loop and
    ``two_level="kernel"``.
(c) ``wavefront_step`` state for state against rtjax (``traversal=
    "pallas"``, so that rtjax takes its direct loop) on eval config 2's
    Cornell planes with ``detailed_stats``: the histogram, ``rays_traced``
    and the node and leaf counts exactly, the state as
    tests/test_torch_wavefront.py holds it.
(d) The kernels' device code (csrc/direct_math.cuh) and launch logic
    compiled as host C++ (tests/direct_kernels_host.cpp) and run through
    the real wrappers on CPU tensors: closest hit, any hit and any hit's
    first design bit for bit against the plain versions on
    tests/direct_cases.py's soups and activity masks; the wrappers'
    refusals; the library's entry points and the stand-in's layout.
"""

import dataclasses
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax.core import rng as jax_rng
from rtjax.core.geometry import Triangles as JaxTriangles
from rtjax.render import trace as jax_trace
from rtjax.render import wavefront as jax_wf
from rtjax.scenes import cornell_planes as jax_cornell_planes

from rtjax_torch import RenderConfig
from rtjax_torch.core.geometry import Triangles
from rtjax_torch.kernels import _build, brute, direct
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import scene_from_arrays

import direct_cases
from test_torch_instancing import _jax_scene, inst_scene_arrays
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays, scene_arrays
from test_torch_walker_stats import _stats_carry, _zero_jc
from test_torch_wavefront import STATE_INT, STATE_VEC, _close

N_RAYS = 512
N_TRIS = 60
BIG = 3.4e38


def _soup():
    """60 triangles: 44 random ones, two quads split along a diagonal
    (shared edges), the first quad again with its vertices rotated
    (coincident triangles), and two more coincident copies."""
    rng = np.random.default_rng(23)
    p0 = rng.uniform(-1, 1, (44, 3))
    p1 = p0 + rng.uniform(-0.5, 0.5, (44, 3))
    p2 = p0 + rng.uniform(-0.5, 0.5, (44, 3))
    tris = list(zip(p0, p1, p2))
    for z in (0.3, -0.4):
        a, b, c, d = (np.array(v) for v in (
            (-0.6, -0.6, z), (0.6, -0.7, z), (0.7, 0.6, z), (-0.5, 0.6, z)))
        tris += [(a, b, c), (a, c, d)]
    a, b, c, d = tris[44][0], tris[44][1], tris[44][2], tris[45][2]
    tris += [(b, c, a), (c, a, d), tris[3], tris[10]]
    tris += [tuple(p + 0.01 for p in tris[k]) for k in range(8)]
    p0, p1, p2 = (np.array(v, np.float32) for v in zip(*tris))
    assert p0.shape[0] == N_TRIS
    e1 = p0 - p1
    e2 = p2 - p0
    return dict(p0=p0, e1=e1, e2=e2, n=np.cross(e1, e2))


def _rays(arr, seed=5):
    """Rays from the front toward random points, the quads' diagonals and
    edges, and the coincident triangles' centroids."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 2] = rng.uniform(1.5, 2.5, n)
    p0, p1 = arr["p0"], arr["p0"] - arr["e1"]
    p2 = arr["p0"] + arr["e2"]
    s = rng.uniform(0.05, 0.95, n)[:, None]
    target = rng.uniform(-1, 1, (n, 3))
    q = n // 4
    target[:q] = p0[44] + s[:q] * (p2[44] - p0[44])             # diagonal
    target[q:2 * q] = p1[44] + s[q:2 * q] * (p2[44] - p1[44])   # edge
    cen = (p0 + p1 + p2) / 3
    pick = rng.choice([44, 45, 3, 10], n - 3 * q)               # coincident
    target[3 * q:] = cen[pick]
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, 1.8, np.inf).astype(np.float32)
    active = rng.random(n) > 0.1
    exclude = np.where(rng.random(n) < 0.5, rng.integers(0, N_TRIS, n),
                       -1).astype(np.int32)
    return o, d.astype(np.float32), tmax, active, exclude


@pytest.fixture(scope="module")
def soup():
    arr = _soup()
    ours = Triangles(**{k: torch.tensor(v) for k, v in arr.items()})
    theirs = JaxTriangles(**{k: jnp.asarray(v) for k, v in arr.items()})
    return arr, ours, theirs


def _v3t(a):
    return tuple(torch.tensor(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


def _v3j(a):
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


def test_direct_closest_matches_rtjax_bitwise(soup):
    arr, ours, theirs = soup
    o, d, tmax, active, _ = _rays(arr)
    hit, t, prim, nrm, (steps, leafs) = direct.direct_closest_ref(
        ours, _v3t(o), _v3t(d), torch.tensor(tmax), torch.tensor(active),
        with_stats=True)
    with jax.disable_jit():
        whit, wt, wprim, wn, (wsteps, wleafs) = jax_trace._direct_closest(
            theirs, _v3j(o), _v3j(d), jnp.asarray(tmax),
            jnp.asarray(active), True)
    a = active
    np.testing.assert_array_equal(hit.numpy(), np.asarray(whit))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(wprim))
    np.testing.assert_array_equal(t.numpy()[a], np.asarray(wt)[a])
    for k in range(3):
        np.testing.assert_array_equal(nrm[k].numpy()[a], np.asarray(wn[k])[a])
    assert (int(steps), int(leafs)) == (int(wsteps), int(wleafs)) == \
        (0, int(active.sum()) * N_TRIS)
    # the shared contract on inactive lanes; enough hits and ties to matter
    assert (t.numpy()[~a] == np.float32(BIG)).all()
    assert all((c.numpy()[~a] == 0).all() for c in nrm)
    hit = hit.numpy()
    assert hit.sum() > N_RAYS // 2
    ties = hit & ~_unique_t(types.SimpleNamespace(**arr),
                            o.astype(np.float64), d.astype(np.float64),
                            tmax.astype(np.float64), t.numpy())
    assert ties.sum() > 30
    # the oracle keeps the same triangle, ties included
    bh, bt, _, _, bp, _ = brute.closest_brute(
        ours, torch.tensor(o), torch.tensor(d), torch.tensor(tmax),
        torch.tensor(active))
    np.testing.assert_array_equal(bh.numpy(), hit)
    np.testing.assert_array_equal(bp.numpy()[hit], prim.numpy()[hit])
    np.testing.assert_array_equal(bt.numpy()[hit], t.numpy()[hit])


def test_direct_anyhit_matches_rtjax_bitwise(soup):
    arr, ours, theirs = soup
    o, d, tmax, active, exclude = _rays(arr, seed=6)
    occ, (steps, leafs) = direct.direct_anyhit_ref(
        ours, _v3t(o), _v3t(d), torch.tensor(tmax), torch.tensor(exclude),
        torch.tensor(active), with_stats=True)
    with jax.disable_jit():
        wocc, (wsteps, wleafs) = jax_trace._direct_anyhit(
            theirs, _v3j(o), _v3j(d), jnp.asarray(tmax),
            jnp.asarray(exclude), jnp.asarray(active), True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(wocc))
    assert (int(steps), int(leafs)) == (int(wsteps), int(wleafs))
    np.testing.assert_array_equal(occ.numpy(), brute.anyhit_brute(
        ours, torch.tensor(o), torch.tensor(d), torch.tensor(tmax),
        torch.tensor(exclude), torch.tensor(active)).numpy())
    assert 50 < int(occ.sum()) < int(active.sum())


def test_wrappers_take_the_plain_version_on_the_cpu(soup):
    """The wrappers equal the plain versions on CPU tensors, in either ray
    layout, count no launch, and refuse inputs the kernels do not take."""
    arr, ours, _ = soup
    o, d, tmax, active, exclude = _rays(arr, seed=7)
    launches = dict(direct.LAUNCHES)
    args = (torch.tensor(tmax), torch.tensor(active))
    want = direct.direct_closest_ref(ours, _v3t(o), _v3t(d), *args)
    for got in (direct.direct_closest(ours, _v3t(o), _v3t(d), *args),
                direct.direct_closest(ours, torch.tensor(o),
                                      torch.tensor(d), *args)):
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x, y)
        nrm = got[3] if isinstance(got[3], tuple) else got[3].unbind(-1)
        assert all(torch.equal(x, y) for x, y in zip(nrm, want[3]))
    occ = direct.direct_anyhit(ours, torch.tensor(o), torch.tensor(d),
                               args[0], torch.tensor(exclude), args[1])
    assert torch.equal(occ, direct.direct_anyhit_ref(
        ours, _v3t(o), _v3t(d), args[0], torch.tensor(exclude), args[1]))
    assert direct.LAUNCHES == launches
    with pytest.raises(TypeError):
        direct.direct_closest(ours, _v3t(o), _v3t(d), args[0].double(),
                              args[1])
    with pytest.raises(ValueError):
        direct.direct_anyhit(ours, _v3t(o), _v3t(d), args[0],
                             torch.tensor(exclude)[:-1], args[1])


# ------------------------------------------------------------ the gate

def _miss_closest(n):
    return (torch.zeros(n, dtype=torch.bool), torch.full((n,), BIG),
            torch.full((n,), -1, dtype=torch.int32),
            tuple(torch.zeros(n) for _ in range(3)))


def _jmiss_closest(n):
    return (jnp.zeros(n, bool), jnp.full(n, BIG, jnp.float32),
            jnp.full(n, -1, jnp.int32),
            tuple(jnp.zeros(n, jnp.float32) for _ in range(3)))


class _Gate:
    """Replaces each package's kernel names in its render/trace.py with
    recorders that return misses (and no occlusion), and records the
    launches in order: ``("direct", triangles)``, ``"walk"`` (a wide-table
    walker), ``"binary"`` or ``"two-level"``."""

    def __init__(self, monkeypatch):
        self.port, self.rtjax = [], []
        rec = self.port

        def port_direct(kind):
            def call(tris, o, d, tmax, *rest, **kw):
                rec.append((f"direct {kind}", tris.num))
                return _miss_closest(tmax.shape[0]) if kind == "closest" \
                    else torch.zeros(tmax.shape[0], dtype=torch.bool)
            return call

        def port_walk(label, kind):
            def call(tables, o, d, tmax, *rest, **kw):
                rec.append(f"{label} {kind}")
                n = tmax.shape[0]
                if kind == "anyhit":
                    return torch.zeros(n, dtype=torch.bool)
                out = _miss_closest(n)
                if label == "two-level":
                    return out[:3] + (torch.zeros(n, dtype=torch.int32),
                                      out[3])
                return out
            return call

        def port_binary(kind):
            def call(bvh, tris, o, d, tmax, *rest, **kw):
                rec.append(f"binary {kind}")
                n = tmax.shape[0]
                if kind == "anyhit":
                    return torch.zeros(n, dtype=torch.bool)
                hit, t, prim, nrm = _miss_closest(n)
                return hit, t, torch.zeros(n), torch.zeros(n), prim, nrm
            return call

        for kind in ("closest", "anyhit"):
            monkeypatch.setattr(trace, f"direct_{kind}", port_direct(kind))
            monkeypatch.setattr(trace, f"persist_traverse_{kind}",
                                port_walk("walk", kind))
            monkeypatch.setattr(trace, f"wide_traverse_{kind}",
                                port_walk("walk", kind))
            monkeypatch.setattr(trace, f"wide_traverse_{kind}_inst",
                                port_walk("two-level", kind))
            monkeypatch.setattr(trace, f"traverse_{kind}", port_binary(kind))
        monkeypatch.setattr(trace, "lane_traverse_closest",
                            port_walk("walk", "closest"))

        jrec = self.rtjax

        def jax_direct(kind):
            def call(tris, o, d, tmax, *rest, **kw):
                jrec.append((f"direct {kind}", tris.num))
                return _jmiss_closest(tmax.shape[0]) if kind == "closest" \
                    else jnp.zeros(tmax.shape[0], bool)
            return call

        def jax_walk(label, kind):
            def call(tables, o, d, tmax, *rest, **kw):
                jrec.append(f"{label} {kind}")
                n = tmax.shape[0]
                if kind == "anyhit":
                    return jnp.zeros(n, bool)
                out = _jmiss_closest(n)
                if label == "two-level":
                    return out[:3] + (jnp.zeros(n, jnp.int32), out[3])
                return out
            return call

        def jax_binary(kind):
            def call(bvh, tris, o, d, tmax, *rest, **kw):
                jrec.append(f"binary {kind}")
                n = tmax.shape[0]
                if kind == "anyhit":
                    return jnp.zeros(n, bool)
                hit, t, prim, _ = _jmiss_closest(n)
                z = jnp.zeros(n, jnp.float32)
                return hit, t, z, z, prim, jnp.zeros((n, 3), jnp.float32)
            return call

        for kind in ("closest", "anyhit"):
            monkeypatch.setattr(jax_trace, f"_direct_{kind}",
                                jax_direct(kind))
            monkeypatch.setattr(jax_trace, f"persist_traverse_{kind}",
                                jax_walk("walk", kind))
            monkeypatch.setattr(jax_trace, f"wide_traverse_{kind}",
                                jax_walk("walk", kind))
            monkeypatch.setattr(jax_trace, f"wide_traverse_{kind}_inst",
                                jax_walk("two-level", kind))
            monkeypatch.setattr(jax_trace, f"traverse_{kind}",
                                jax_binary(kind))
        monkeypatch.setattr(jax_trace, "lane_traverse_closest",
                            jax_walk("walk", "closest"))


def _gate_rays(n=256, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 1.2, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def gate_scenes():
    """pyramid3 (3 instances of a 4-triangle mesh over a 3-triangle base)
    and config 2's Cornell planes (12 triangles) in both packages."""
    jinst = _jax_scene("pyramid3")
    jplanes, _ = jax_cornell_planes()
    return {"pyramid3": (jinst, scene_from_arrays(inst_scene_arrays(jinst),
                                                  "cpu")),
            "planes": (jplanes, scene_from_arrays(scene_arrays(jplanes),
                                                  "cpu"))}


# (scene, no inst_tables, port config, rtjax config, rtjax mode, expected
# closest-hit launches)
GATE_CASES = {
    "planes-default": ("planes", False, {}, {}, "pallas",
                       [("direct closest", 12)]),
    "planes-11": ("planes", False, dict(direct_max_tris=11),
                  dict(direct_max_tris=11), "pallas", ["walk closest"]),
    "planes-off": ("planes", False, dict(direct_max_tris=0),
                   dict(direct_max_tris=0), "pallas", ["walk closest"]),
    "planes-xla": ("planes", False, dict(traversal="xla"), {}, "xla",
                   ["binary closest"]),
    "repass": ("pyramid3", False, {}, {}, "pallas",
               [("direct closest", 3), ("direct closest", 4)]),
    "repass-blas-walked": ("pyramid3", False, dict(direct_max_tris=3),
                           dict(direct_max_tris=3), "pallas",
                           [("direct closest", 3), "walk closest"]),
    "repass-off": ("pyramid3", False, dict(direct_max_tris=0),
                   dict(direct_max_tris=0), "pallas",
                   ["walk closest", "walk closest"]),
    "loop": ("pyramid3", True, {}, dict(two_level="kernel"), "pallas",
             [("direct closest", 3)] + [("direct closest", 4)] * 3),
    "loop-xla": ("pyramid3", False, dict(traversal="xla"), {}, "xla",
                 ["binary closest"] * 4),
    "two-level-kernel": ("pyramid3", False, dict(two_level="kernel"),
                         dict(two_level="kernel"), "pallas",
                         ["two-level closest"]),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_follows_rtjax(gate_scenes, monkeypatch, case):
    name, no_inst, kw, jkw, jmode, first = GATE_CASES[case]
    jscene, scene = gate_scenes[name]
    if no_inst:
        jscene = dataclasses.replace(jscene, inst_tables=None)
        scene = dataclasses.replace(scene, inst_tables=None)
    gate = _Gate(monkeypatch)
    o, d = _gate_rays()
    n = o.shape[0]
    active = np.ones(n, bool)
    active[::7] = False
    exclude = np.full(n, -1, np.int32)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**jkw)
    trace.trace_closest(scene, cfg, _v3t(o), _v3t(d),
                        torch.full((n,), float("inf")), torch.tensor(active))
    trace.trace_anyhit(scene, cfg, _v3t(o), _v3t(d), torch.full((n,), 2.0),
                       torch.tensor(exclude), torch.tensor(active))
    with jax.disable_jit():
        jax_trace.trace_closest(jscene, jcfg, jmode, True, _v3j(o), _v3j(d),
                                jnp.full(n, jnp.inf), jnp.asarray(active))
        jax_trace.trace_anyhit(jscene, jcfg, jmode, True, _v3j(o), _v3j(d),
                               jnp.full(n, 2.0), jnp.asarray(exclude),
                               jnp.asarray(active))
    # on the CPU repass's passes stop where rtjax's while_loop stops
    assert gate.port == gate.rtjax
    if case.startswith("repass"):
        for kind in ("closest", "anyhit"):
            ref = [x for x in gate.rtjax if kind in str(x)]
            assert 1 < len(ref) <= 1 + scene.instances.num
    closest = [x for x in gate.port if "closest" in str(x)]
    # the base launch, then each pass or instance in turn
    assert closest[:len(first)] == first
    assert len({str(x) for x in closest}) == len({str(x) for x in first})
    anyhit = [x for x in gate.port if "anyhit" in str(x)]
    assert len(anyhit) > 0


@pytest.mark.parametrize("case", [c for c in GATE_CASES
                                  if c.startswith("repass")])
def test_gate_on_the_card_runs_g_masked_passes(gate_scenes, monkeypatch,
                                               case):
    """With render/device_loop.py taking its card path (patched here), the
    eager repass loop runs all G = 3 passes a mesh group with no host
    read: rtjax's launches, then masked passes up to G."""
    from rtjax_torch.render import device_loop
    name, no_inst, kw, jkw, jmode, first = GATE_CASES[case]
    jscene, scene = gate_scenes[name]
    gate = _Gate(monkeypatch)
    monkeypatch.setattr(device_loop, "_on_card", lambda pend: True)
    o, d = _gate_rays()
    n = o.shape[0]
    active = np.ones(n, bool)
    active[::7] = False
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**jkw)
    trace.trace_closest(scene, cfg, _v3t(o), _v3t(d),
                        torch.full((n,), float("inf")), torch.tensor(active))
    trace.trace_anyhit(scene, cfg, _v3t(o), _v3t(d), torch.full((n,), 2.0),
                       torch.full((n,), -1, dtype=torch.int32),
                       torch.tensor(active))
    with jax.disable_jit():
        jax_trace.trace_closest(jscene, jcfg, jmode, True, _v3j(o), _v3j(d),
                                jnp.full(n, jnp.inf), jnp.asarray(active))
        jax_trace.trace_anyhit(jscene, jcfg, jmode, True, _v3j(o), _v3j(d),
                               jnp.full(n, 2.0), jnp.full(n, -1, jnp.int32),
                               jnp.asarray(active))
    for kind in ("closest", "anyhit"):
        port = [x for x in gate.port if kind in str(x)]
        ref = [x for x in gate.rtjax if kind in str(x)]
        assert len(port) == 1 + scene.instances.num
        assert port[:len(ref)] == ref and len(ref) > 1
        assert all(x == port[-1] for x in port[len(ref):])


# ------------------------------------------------ the engine, config 2

POOL = 1024
W = H = 16
ITERS = 3


def test_step_matches_rtjax_on_cornell_planes_with_stats():
    """Eval config 2's scene: rtjax's direct loop and the port's direct
    pair (its plain versions here), state for state with detailed_stats;
    the counts are rtjax's exactly, leaf visits = active rays x 12 a
    launch."""
    jscene, jcam = jax_cornell_planes()
    scene = scene_from_arrays(scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    assert scene.tris.num == 12
    kw = dict(width=W, height=H, num_samples=8, max_bounces=4,
              num_working_paths=POOL)
    jcfg = JaxConfig(traversal="pallas", sort_every=0, detailed_stats=True,
                     **kw)
    cfg = RenderConfig(detailed_stats=True, **kw)
    key = jax.random.key(4)
    jc = _zero_jc(POOL, jcfg)
    launches = dict(direct.LAUNCHES)
    for it in range(ITERS):
        carry = _stats_carry(jc, tuple(torch.tensor(int(v), dtype=torch.int64)
                                       for v in jc[8:]))
        with jax.disable_jit():
            words = np.asarray(jax_rng.bits_block(key, jnp.int32(it), 5,
                                                  POOL)).astype(np.int64)
            jc = jax_wf.wavefront_step(jscene, jcam, jcfg, key, jc)
        c = wf.wavefront_step(scene, cam, cfg, torch.tensor(words), carry)
        js, s = jc[0], c[0]
        np.testing.assert_array_equal(c[7].numpy(), np.asarray(jc[7]))
        assert float(c[5]) == float(jc[5]), "rays traced"
        assert [int(v) for v in c[8:]] == [int(v) for v in jc[8:]]
        hit = np.asarray(js.hit)
        ro = np.stack([np.asarray(x, np.float64) for x in s.ray_o], 1)
        rd = np.stack([np.asarray(x, np.float64) for x in s.ray_d], 1)
        t_want = np.where(hit, np.asarray(js.t), 0.0)
        uniq = ~hit | _unique_t(jscene.tris, ro, rd, np.full(POOL, np.inf),
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
    assert hit.sum() > POOL // 2
    steps_c, leafs_c, steps_a, leafs_a = (int(v) for v in c[8:])
    assert steps_c == steps_a == 0 and leafs_c > 0 and leafs_a > 0
    assert leafs_c % 12 == 0 and leafs_a % 12 == 0
    assert direct.LAUNCHES == launches      # the CPU runs no kernel


# ------------------------------- (d) the kernels' device code on the host

def _host_kernels():
    """The direct pair's device code and launch logic compiled as host C++
    (tests/direct_kernels_host.cpp over csrc/direct_math.cuh), bound as
    the kernels' library."""
    import ctypes
    src = Path(__file__).with_name("direct_kernels_host.cpp")
    out = _build._build(
        _build.BUILD_DIR / "libdirect_kernels_host.so", [src],
        ["g++", "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", f"-I{_build.CSRC_DIR}"],
        (_build.DIRECT_HEADER,))
    return direct.bind(ctypes.CDLL(str(out)))


@pytest.fixture(scope="module")
def host_lib():
    return _host_kernels()


@pytest.fixture
def host(host_lib, monkeypatch):
    """The wrappers' CUDA path on CPU tensors, through the host build."""
    monkeypatch.setattr(direct, "_lib", host_lib)
    monkeypatch.setattr(direct, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("kind", direct_cases.MASKS)
@pytest.mark.parametrize("n_tris", direct_cases.TRI_COUNTS)
def test_host_compiled_kernels_match_plain_versions(host, n_tris, kind):
    """csrc/direct_math.cuh compiled as host C++ and run through the real
    wrappers -- closest hit, any hit and any hit's first design -- bit for
    bit against the plain versions on every lane (hit, t, prim, normal and
    occlusion) on soups with ties of equal t and a shared edge, rays
    grazing edges, ``tmax`` at a hit's t and just below it, ``exclude``
    the lane's own occluder, at 0 to 300 triangles (one shared-memory tile
    up to 64, several above) and under each activity mask; one launch
    counted a call."""
    tris, o, d, tmax, active, exclude = direct_cases.case(n_tris, kind,
                                                          "cpu")
    want = direct.direct_closest_ref(tris, o, d, tmax, active)
    want_occ = direct.direct_anyhit_ref(tris, o, d, tmax, exclude, active)
    before = dict(direct.LAUNCHES), dict(direct.V1_LAUNCHES)
    got = direct.direct_closest(tris, o, d, tmax, active)
    for x, y in zip(got[:3] + got[3], want[:3] + want[3], strict=True):
        assert torch.equal(_bits(x), _bits(y))
    for anyhit in (direct.direct_anyhit, direct.direct_anyhit_v1):
        assert torch.equal(anyhit(tris, o, d, tmax, exclude, active),
                           want_occ)
    assert direct.LAUNCHES == {k: v + 1 for k, v in before[0].items()}
    assert direct.V1_LAUNCHES == {k: v + 1 for k, v in before[1].items()}
    hit, t = want[0], want[1]
    if n_tris and kind != "none":
        assert bool(hit.any()) and bool(want_occ.any())
    if n_tris and kind == "all":
        assert bool((hit & (t == tmax)).any())          # tmax at the hit
        # excluding its own occluder leaves a lane unoccluded
        assert bool((hit & (exclude == want[2]) & ~want_occ).any())


def test_wrappers_refuse_before_a_launch(host):
    """On the CUDA path the wrappers refuse inputs the kernels do not take
    (dtype, shape, device) before any launch; any hit's first design takes
    no CPU tensors off that path."""
    tris, o, d, tmax, active, exclude = direct_cases.case(12, "all", "cpu")
    before = dict(direct.LAUNCHES), dict(direct.V1_LAUNCHES)
    with pytest.raises(TypeError):
        direct.direct_closest(tris, o, d, tmax.double(), active)
    with pytest.raises(ValueError):
        direct.direct_anyhit(tris, o, d, tmax, exclude[:-1], active)
    with pytest.raises(TypeError):
        direct.direct_anyhit_v1(tris, o, d, tmax, exclude.long(), active)
    with pytest.raises(ValueError, match="contiguous"):
        direct.direct_closest(tris, o, d, tmax, torch.stack(
            [active, active], 1)[:, 0])
    assert (dict(direct.LAUNCHES), dict(direct.V1_LAUNCHES)) == before


def test_first_design_takes_only_cuda_tensors():
    tris, o, d, tmax, active, exclude = direct_cases.case(12, "all", "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        direct.direct_anyhit_v1(tris, o, d, tmax, exclude, active)


_KERNEL_SOURCE = Path(_build.CSRC_DIR) / "direct_traverse.cu"


@pytest.mark.parametrize("source", [
    _KERNEL_SOURCE, Path(__file__).with_name("direct_kernels_host.cpp")],
    ids=["card", "host"])
def test_library_exports_the_entry_points_bind_binds(source):
    """The card's library and the host stand-in export closest hit, any
    hit and any hit's first design, and no other entry point."""
    names = re.findall(r'extern "C" int rtjax_direct_(\w+)\(',
                       source.read_text())
    assert sorted(names) == ["anyhit", "anyhit_v1", "closest"]


def test_host_stand_in_follows_the_kernels_layout():
    """The stand-in's window is the any-hit kernel's (kPerThread x
    kBlock lanes), and the kernel stages each triangle's fields in the
    record's order (p0, e1, e2, n: direct_math.cuh ``Tri``), as the
    stand-in does."""
    card = _KERNEL_SOURCE.read_text()
    per, block = (int(re.search(rf"constexpr int {k} = (\d+);", card)
                      .group(1)) for k in ("kPerThread", "kBlock"))
    host = Path(__file__).with_name("direct_kernels_host.cpp").read_text()
    assert f"constexpr int kWindow = {per} * {block};" in host
    header = (Path(_build.CSRC_DIR) / "direct_math.cuh").read_text()
    assert "float p0[3], e1[3], e2[3], n[3];" in header
    order = re.search(r"field == 0 \? tr\.(\w+) : field == 1 \? tr\.(\w+)"
                      r"\s*: field == 2 \? tr\.(\w+) : tr\.(\w+);", card)
    assert order is not None and order.groups() == ("p0", "e1", "e2", "n")
