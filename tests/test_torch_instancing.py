"""rtjax_torch instanced scenes (two-level BVH) vs rtjax.

- Host build: on rtjax's small instanced scenes (three pyramids with mixed
  transforms, a 64-instance grid, a non-uniformly scaled quad), the port's
  InstanceTable, BLAS triangles / BVH / wide tables and InstancedTables are
  array-equal to rtjax's, at width 16 and, with the 16-wide node cap
  shrunk so that the concatenated tables reach it, at width 8 (the 8-wide
  rebuild of base + BLAS).  Triangle normals as in test_torch_scene.py.
- Tracing: the port's two strategies (``two_level="kernel"``, whose
  wrapper runs the plain two-level versions on the CPU, and "repass", over
  the plain persist versions) against rtjax's per-instance XLA loop, and
  (slow) the plain two-level versions against rtjax's interpret-mode
  Pallas two-level kernels, on random rays: ``hit`` and occlusion equal;
  t at rtol 1e-5 / atol 1e-6 (jitted XLA contracts multiply-adds on the
  CPU, the port rounds every product); ``(src, prim)`` equal except where
  two triangles meet the closest t (rtjax's loop takes the first
  instance in index order, the port's the nearest box first); world
  normals at rtol 1e-4 (rtjax's cofactor matvec is also contracted).
- The three places where the port diverged from rtjax once a scene has
  instances: the ``sort_every`` auto rule, the compact sort bundle's
  ranges and the per-instance material.
- ``wavefront_step`` state for state on an instanced scene with rtjax's
  random words (as test_torch_wavefront.py), and whole renders: kernel vs
  repass, and instanced vs baked geometry at the noise floor.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax import RenderConfig as JaxConfig
from rtjax import SceneBuilder as JaxSceneBuilder
from rtjax.core import rng as jax_rng
from rtjax.kernels.pallas_wide import (
    wide_traverse_anyhit_inst as jax_inst_anyhit,
    wide_traverse_closest_inst as jax_inst_closest)
from rtjax.render import trace as jax_trace
from rtjax.render import wavefront as jax_wf
from rtjax.scene import transform as jax_tf
from rtjax.utils.compare import mse

from rtjax_torch import RenderConfig
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.render import trace
from rtjax_torch.render import wavefront as wf
from rtjax_torch.scene import transform as tf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder, scene_from_arrays

from test_torch_persist import _unique_t
from test_torch_scene import (TABLE_FIELDS, _normals_match, camera_arrays,
                              scene_arrays)
from test_torch_wavefront import STATE_INT, STATE_VEC, _close, _port_carry
from test_trace import _mixed3_scene

PYRAMID_V = np.array([[0, 0, 0], [0.2, 0, 0], [0.1, 0, -0.2],
                      [0.1, 0.25, -0.07]])
PYRAMID_F = np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3], [0, 1, 2]])
N_RAYS = 2048


# ------------------------------------------------------------------ scenes
# Each recipe fills a SceneBuilder of either package (``t`` is that
# package's transform module), so one recipe gives both packages the same
# scene.

def _pyramid3(b, t):
    """tests/test_trace.py::_mixed3_scene: 3 pyramids, mixed transforms."""
    white = b.make_matte((0.7, 0.7, 0.7))
    red = b.make_matte((0.6, 0.1, 0.1))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
    b.add_triangles([0, 0, 0], [0, 0, -1], [1, 0, -1], white)
    b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3], [0.7, 0.9, -0.7],
                     (10, 10, 10), white)
    mid = b.register_mesh(PYRAMID_V, PYRAMID_F)
    for m in [t.Transform(t.translate(0.2, 0, -0.3)),
              t.Transform(t.scale(1.5, 1.5, 1.5)).composite(
                  t.translate(0.55, 0, -0.55)),
              t.Transform(t.rotate((0, 1, 0), 0.7)).composite(
                  t.translate(0.1, 0.2, -0.7))]:
        b.add_instance(mid, red, m)


def _grid64(b, t):
    """tests/test_trace.py::test_64_instances_single_launch_path."""
    white = b.make_matte((0.7, 0.7, 0.7))
    red = b.make_matte((0.6, 0.1, 0.1))
    b.add_triangles([-4, 0, 4], [4, 0, 4], [4, 0, -4], white)
    b.add_triangles([-4, 0, 4], [4, 0, -4], [-4, 0, -4], white)
    b.add_area_light([-0.5, 3, -0.5], [0.5, 3, -0.5], [0.5, 3, 0.5],
                     (10, 10, 10), white)
    mid = b.register_mesh(PYRAMID_V, PYRAMID_F)
    for i in range(64):
        b.add_instance(mid, red, t.Transform(t.translate(
            (i % 8) * 0.9 - 3.5, 0.0, (i // 8) * 0.9 - 3.5)))


def _quad(b, t):
    """tests/test_trace.py::test_instance_normal_nonuniform_scale."""
    red = b.make_matte((0.6, 0.1, 0.1))
    white = b.make_matte((0.7, 0.7, 0.7))
    b.add_area_light([-1, 4, -1], [1, 4, -1], [1, 4, 1], (5, 5, 5), white)
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    mid = b.register_mesh(v, f)
    b.add_instance(mid, red, t.Transform(t.rotate([1, 0, 0], np.pi / 4))
                   .composite(t.scale(1.0, 3.0, 1.0)))


def _blob(n_tris=64, seed=2):
    """A 64-triangle mesh (the largest a BLAS may have and still take
    rtjax's direct traversal on the CPU)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.15, 0.15, (3 * n_tris, 3)) + [0.0, 0.2, 0.0]
    return v, np.arange(3 * n_tris).reshape(n_tris, 3)


def _field17(b, t):
    """17 instances of a 64-triangle mesh over a 3-triangle base: 1,091
    effective triangles, 3 base ones."""
    white = b.make_matte((0.7, 0.7, 0.7))
    mats = [b.make_matte((0.6, 0.1, 0.1)), b.make_matte((0.1, 0.5, 0.2))]
    b.add_triangles([-3, 0, 3], [3, 0, 3], [3, 0, -3], white)
    b.add_triangles([-3, 0, 3], [-3, 0, -3], [3, 0, -3], white)
    b.add_area_light((-0.5, 2.0, -0.5), (0.5, 2.0, -0.5), (0.5, 2.0, 0.5),
                     (20, 20, 20), white)
    mid = b.register_mesh(*_blob())
    for i in range(17):
        m = t.Transform(t.rotate([0, 1, 0], 0.37 * i)).composite(
            t.translate((i % 5) * 0.8 - 1.6, 0.0, (i // 5) * 0.8 - 1.2))
        b.add_instance(mid, mats[i % 2], m)


RECIPES = {"pyramid3": _pyramid3, "grid64": _grid64, "quad": _quad,
           "field17": _field17}


def _jax_scene(name):
    b = JaxSceneBuilder()
    RECIPES[name](b, jax_tf)
    return b.build()


def _port_scene(name, device="cpu"):
    b = SceneBuilder()
    RECIPES[name](b, tf)
    return b.build(device)


def inst_scene_arrays(scene) -> dict:
    """An instanced rtjax Scene as scene_from_arrays's dict (the port's
    Scene reads the same way)."""
    out = scene_arrays(scene)
    inst = scene.instances
    if inst is None:
        return out
    for f in ("fwd", "inv", "nrm", "aabb_lo", "aabb_hi", "material"):
        out[f"instances.{f}"] = np.asarray(getattr(inst, f))
    out["instances.mesh_id"] = tuple(inst.mesh_id)
    for k, blas in enumerate(scene.blas):
        for f in ("p0", "e1", "e2", "n"):
            out[f"blas.{k}.tris.{f}"] = np.asarray(getattr(blas.tris, f))
        for f in ("bmin", "bmax", "left_first", "num_prims"):
            out[f"blas.{k}.bvh.{f}"] = np.asarray(getattr(blas.bvh, f))
        out[f"blas.{k}.bvh.max_depth"] = blas.bvh.max_depth
        if blas.tables is not None:
            for f in TABLE_FIELDS:
                out[f"blas.{k}.tables.{f}"] = np.asarray(
                    getattr(blas.tables, f))
            out[f"blas.{k}.tables.width"] = blas.tables.width
    if scene.inst_tables is not None:
        it = scene.inst_tables
        for f in TABLE_FIELDS:
            out[f"inst_tables.wide.{f}"] = np.asarray(getattr(it.wide, f))
        out["inst_tables.wide.width"] = it.wide.width
        out["inst_tables.root"] = np.asarray(it.root)
        out["inst_tables.affine"] = np.asarray(it.affine)
    return out


def _arrays_equal(got, want, built=True):
    """Every array and static field; the normals of a port build (``built``)
    are NumPy's cross products, within one product's rounding of rtjax's."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        if built and key.endswith("tris.n"):
            pre = key[:-1]
            _normals_match(got[key], got[pre + "e1"], got[pre + "e2"], w)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


def _shrink_node_cap(monkeypatch, cap):
    """A 16-wide node cap of ``cap`` in both packages."""
    monkeypatch.setattr("rtjax.kernels.pallas_wide.MAX_NODES16", cap)
    monkeypatch.setattr("rtjax_torch.accel.wide.MAX_NODES16", cap)
    monkeypatch.setattr("rtjax_torch.scene.scene.MAX_NODES16", cap)


# -------------------------------------------------------------- host build

@pytest.mark.parametrize("width", [16, 8], ids=["w16", "w8"])
@pytest.mark.parametrize("name", ["pyramid3", "grid64", "quad"])
def test_instanced_build_matches(monkeypatch, name, width):
    if width == 8:
        # base and BLAS are one wide node each: a cap of 2 leaves the base
        # 16-wide but sends the concatenation to the 8-wide rebuild
        _shrink_node_cap(monkeypatch, 2)
    theirs, ours = _jax_scene(name), _port_scene(name)
    assert theirs.inst_tables is not None and ours.inst_tables is not None
    assert ours.tables.width == ours.inst_tables.wide.width == width
    assert all(b.tables.width == width for b in ours.blas)
    _arrays_equal(inst_scene_arrays(ours), inst_scene_arrays(theirs))
    # and the array hand-over gives the same scene
    _arrays_equal(inst_scene_arrays(scene_from_arrays(
        inst_scene_arrays(theirs), "cpu")), inst_scene_arrays(theirs),
        built=False)
    # the concatenation: instance 0 is the base scene at root 0, every
    # instance of the one mesh starts at the BLAS root after the base nodes
    root = ours.inst_tables.root.numpy()
    assert root[0] == 0 and (root[1:] == ours.tables.num_wide_nodes).all()
    assert ours.inst_tables.wide.depth == max(
        [ours.tables.depth] + [b.tables.depth for b in ours.blas])


def test_recipe_is_rtjax_scene():
    """The pyramid recipe builds tests/test_trace.py's own scene."""
    _arrays_equal(inst_scene_arrays(_jax_scene("pyramid3")),
                  inst_scene_arrays(_mixed3_scene()), built=False)


def test_affine_helpers_match_rtjax():
    from rtjax.accel import instancing as jax_inst

    from rtjax_torch.accel import instancing as inst
    rng = np.random.default_rng(6)
    m = tf.Transform(tf.rotate((0.3, 1.0, 0.2), 0.9)).composite(
        tf.scale(1.5, 0.5, 2.0)).composite(tf.translate(0.3, -1.0, 2.0)).matrix
    rows = inst.affine_rows(m)
    np.testing.assert_array_equal(rows, jax_inst.affine_rows(m))
    p = rng.normal(size=(64, 3)).astype(np.float32)
    for name in ("apply_affine_point", "apply_affine_vector"):
        ours, theirs = getattr(inst, name), getattr(jax_inst, name)
        got = torch.stack(ours(torch.tensor(rows), _v3(p)), -1)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(theirs(jnp.asarray(rows), jnp.asarray(p))),
            rtol=1e-5, atol=1e-6)
    lo, hi = np.float32([-0.1, 0.0, -0.2]), np.float32([0.1, 0.3, 0.05])
    for a, b in zip(inst.instance_world_aabb(lo, hi, m),
                    jax_inst.instance_world_aabb(lo, hi, m)):
        np.testing.assert_array_equal(a, b)


def test_add_instance_copies_the_matrix():
    b = SceneBuilder()
    m = b.make_matte((0.5, 0.5, 0.5))
    b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], m)
    mid = b.register_mesh(PYRAMID_V, PYRAMID_F)
    t = tf.Transform(tf.translate(1.0, 0.0, 0.0))
    b.add_instance(mid, m, t)
    t.composite(tf.translate(5.0, 0.0, 0.0))
    scene = b.build("cpu")
    np.testing.assert_array_equal(scene.instances.fwd[0, :, 3].numpy(),
                                  [1.0, 0.0, 0.0])


# ----------------------------------------------------------------- tracing

def _world_tris(scene):
    """Every triangle of the port's scene in world space (float64), as
    ``_unique_t``'s triangle namespace."""
    parts = [tuple(getattr(scene.tris, f).numpy().astype(np.float64)
                   for f in ("p0", "e1", "e2"))]
    inst = scene.instances
    for k in range(inst.num):
        tri = scene.blas[inst.mesh_id[k]].tris
        m = inst.fwd[k].numpy().astype(np.float64)
        parts.append((tri.p0.numpy() @ m[:, :3].T + m[:, 3],
                      tri.e1.numpy() @ m[:, :3].T,
                      tri.e2.numpy() @ m[:, :3].T))
    p0, e1, e2 = (np.concatenate(c) for c in zip(*parts))
    return types.SimpleNamespace(p0=p0, e1=e1, e2=e2, n=np.cross(e1, e2))


def _rays(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "grid64":
        o = rng.uniform(-3.5, 3.5, (N_RAYS, 3)).astype(np.float32)
        o[:, 1] = np.abs(rng.normal(0.5, 0.3, N_RAYS)) + 0.05
    elif name == "quad":
        o = rng.uniform(-0.5, 1.5, (N_RAYS, 3)).astype(np.float32)
        o[:, 2] += 3.0
    else:
        o = rng.uniform(-0.3, 1.2, (N_RAYS, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1]) + 0.3
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    if name == "quad":
        d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(N_RAYS) > 0.1
    return o, d.astype(np.float32), active


def _v3(a):
    return tuple(torch.tensor(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


@pytest.fixture(scope="module", params=["pyramid3", "grid64", "quad"])
def traced(request):
    """A scene of both packages and rtjax's per-instance XLA loop on random
    rays: closest hits and occlusion (tmax 2, 5 for the quad far ahead of
    its rays; random base exclusions)."""
    name = request.param
    occ_tmax = 5.0 if name == "quad" else 2.0
    jscene = _jax_scene(name)
    scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    o, d, active = _rays(name)
    rng = np.random.default_rng(1)
    exclude = np.where(rng.random(N_RAYS) > 0.5,
                       rng.integers(0, jscene.tris.num, N_RAYS),
                       -1).astype(np.int32)
    jcfg = JaxConfig()
    args = (jnp.asarray(o), jnp.asarray(d))
    want = tuple(np.asarray(a) for a in jax_trace.trace_closest(
        jscene, jcfg, "xla", True, *args, jnp.full(N_RAYS, jnp.inf),
        jnp.asarray(active)))
    want_occ = np.asarray(jax_trace.trace_anyhit(
        jscene, jcfg, "xla", True, *args, jnp.full(N_RAYS, occ_tmax),
        jnp.asarray(exclude), jnp.asarray(active)))
    return dict(name=name, jscene=jscene, scene=scene, o=o, d=d,
                occ_tmax=occ_tmax,
                active=active, exclude=exclude, want=want, want_occ=want_occ,
                world=_world_tris(scene))


def _hits_match(tr, hit, t, prim, src, nrm):
    """Port hits vs rtjax's XLA loop at the stated tolerances; returns the
    number of instanced hits compared."""
    whit, wt, wprim, wsrc, wnrm = tr["want"]
    np.testing.assert_array_equal(hit, whit)
    m = whit
    np.testing.assert_allclose(t[m], wt[m], rtol=1e-5, atol=1e-6)
    uniq = m & _unique_t(tr["world"], tr["o"].astype(np.float64),
                         tr["d"].astype(np.float64),
                         np.full(N_RAYS, np.inf), t.astype(np.float64))
    assert uniq.sum() > 0.9 * m.sum() and m.sum() > 20
    np.testing.assert_array_equal(prim[uniq], wprim[uniq])
    np.testing.assert_array_equal(src[uniq], wsrc[uniq])
    np.testing.assert_allclose(nrm[uniq], wnrm[uniq], rtol=1e-4, atol=1e-6)
    return int((src[uniq] > 0).sum())


@pytest.mark.parametrize("strategy", ["kernel", "repass", "xla"])
def test_trace_matches_rtjax_loop(traced, strategy):
    """"xla": rtjax's per-instance loop over the binary walk, as rtjax
    runs it here."""
    from rtjax_torch.kernels import traversal as T
    tr = traced
    cfg = RenderConfig(traversal="xla") if strategy == "xla" \
        else RenderConfig(two_level=strategy)
    refs = dict(WI.REF_CALLS), dict(P.REF_CALLS), dict(T.REF_CALLS)
    hit, t, prim, src, nrm = (
        a if isinstance(a, tuple) else a.numpy()
        for a in trace.trace_closest(
            tr["scene"], cfg, _v3(tr["o"]), _v3(tr["d"]),
            torch.full((N_RAYS,), float("inf")), torch.tensor(tr["active"])))
    nrm = np.stack([c.numpy() for c in nrm], 1)
    assert _hits_match(tr, hit, t, prim, src, nrm) > 5
    occ = trace.trace_anyhit(
        tr["scene"], cfg, _v3(tr["o"]), _v3(tr["d"]),
        torch.full((N_RAYS,), tr["occ_tmax"]), torch.tensor(tr["exclude"]),
        torch.tensor(tr["active"])).numpy()
    np.testing.assert_array_equal(occ, tr["want_occ"])
    assert occ.sum() > 50 and not occ[~tr["active"]].any()
    # the strategy ran the plain versions it names, and only those
    two_level = WI.REF_CALLS["closest"] - refs[0]["closest"]
    persist = P.REF_CALLS["closest"] - refs[1]["closest"]
    binary = T.REF_CALLS["closest"] - refs[2]["closest"]
    assert (two_level, persist > 0, binary) == {
        "kernel": (1, False, 0), "repass": (0, True, 0),
        "xla": (0, False, 1 + tr["scene"].instances.num)}[strategy]


def test_plain_two_level_contract(traced):
    """Dead lanes, misses and the local normal of the plain two-level
    closest hit."""
    tr = traced
    scene = tr["scene"]
    active = torch.tensor(tr["active"])
    hit, t, prim, inst, nl = WI.wide_traverse_closest_inst(
        scene.inst_tables, torch.tensor(tr["o"]), torch.tensor(tr["d"]),
        torch.full((N_RAYS,), float("inf")), active)
    dead = ~hit
    assert not bool(hit[~active].any())
    assert bool((t[dead] == np.float32(P.BIG)).all())
    assert bool((prim[dead] == -1).all()) and bool((inst[dead] == 0).all())
    assert not bool(nl[dead].any()) and nl.shape == (N_RAYS, 3)
    np.testing.assert_array_equal(hit.numpy(), tr["want"][0])


def test_repass_closest_respects_tmax(traced):
    """A short tmax: hits only closer than it, as rtjax's loop finds."""
    tr = traced
    tmax = np.full(N_RAYS, 0.4, np.float32)
    want = np.asarray(jax_trace.trace_closest(
        tr["jscene"], JaxConfig(), "xla", True, jnp.asarray(tr["o"]),
        jnp.asarray(tr["d"]), jnp.asarray(tmax),
        jnp.asarray(tr["active"]))[0])
    for strategy in ("repass", "kernel"):
        hit, t, *_ = trace.trace_closest(
            tr["scene"], RenderConfig(two_level=strategy), _v3(tr["o"]),
            _v3(tr["d"]), torch.tensor(tmax), torch.tensor(tr["active"]))
        np.testing.assert_array_equal(hit.numpy(), want)
        assert bool((t <= 0.4).all())


@pytest.mark.slow
def test_plain_versions_match_rtjax_pallas_kernels(traced):
    """The plain two-level versions against rtjax's interpret-mode
    two-level Pallas kernels on the same InstancedTables."""
    tr = traced
    it = tr["jscene"].inst_tables
    o, d, active = tr["o"], tr["d"], tr["active"]
    tmax = np.full(N_RAYS, np.inf, np.float32)
    jh, jt, jp, ji, jn = (np.asarray(a) for a in jax_inst_closest(
        it, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(active), interpret=True))
    h, t, p, i, n = (a.numpy() for a in WI.wide_traverse_closest_inst(
        tr["scene"].inst_tables, torch.tensor(o), torch.tensor(d),
        torch.tensor(tmax), torch.tensor(active)))
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_allclose(t[h], jt[h], rtol=1e-5, atol=1e-6)
    uniq = h & _unique_t(tr["world"], o.astype(np.float64),
                         d.astype(np.float64), tmax, t.astype(np.float64))
    assert uniq.sum() > 0.9 * h.sum()
    for a, b in ((p, jp), (i, ji), (n, jn)):
        np.testing.assert_array_equal(a[uniq], b[uniq])
    ex = jnp.asarray(tr["exclude"])
    joc = np.asarray(jax_inst_anyhit(
        it, jnp.asarray(o), jnp.asarray(d), jnp.full(N_RAYS, tr["occ_tmax"]),
        ex, jnp.asarray(active), interpret=True))
    oc = WI.wide_traverse_anyhit_inst(
        tr["scene"].inst_tables, torch.tensor(o), torch.tensor(d),
        torch.full((N_RAYS,), tr["occ_tmax"]), torch.tensor(tr["exclude"]),
        torch.tensor(active)).numpy()
    np.testing.assert_array_equal(oc, joc)


def test_two_level_wrappers_reject_bad_inputs():
    scene = _port_scene("pyramid3")
    it = scene.inst_tables
    n = 16
    o = tuple(torch.zeros(n) for _ in range(3))
    d = tuple(torch.ones(n) for _ in range(3))
    tmax, act = torch.ones(n), torch.ones(n, dtype=torch.bool)
    with pytest.raises(TypeError):
        WI.wide_traverse_closest_inst(it, o, d, tmax.double(), act)
    with pytest.raises(ValueError, match="affine"):
        WI.wide_traverse_closest_inst(
            dataclasses.replace(it, affine=it.affine[:-1]), o, d, tmax, act)
    with pytest.raises(TypeError):
        WI.wide_traverse_anyhit_inst(it, o, d, tmax,
                                     torch.zeros(n, dtype=torch.int64), act)
    launches = dict(WI.LAUNCHES)
    WI.wide_traverse_anyhit_inst(it, o, d, tmax,
                                 torch.full((n,), -1, dtype=torch.int32), act)
    assert WI.LAUNCHES == launches  # CPU tensors never reach the kernels


# ------------------------------------------- the repaired divergences

def test_sort_every_counts_effective_triangles():
    """3 base triangles but 1,091 effective ones: rtjax resolves the auto
    cadence to 1 (traversal-bound), as on config 4."""
    scene = _port_scene("field17")
    assert scene.tris.num == 3 and scene.blas[0].tris.num == 64
    assert wf.resolve_sort_every(scene, RenderConfig()) == 1
    assert wf.resolve_sort_every(scene, RenderConfig(sort_every=3)) == 3
    assert wf.resolve_sort_every(_port_scene("pyramid3"), RenderConfig()) == 2


@pytest.mark.parametrize("base, blas, n_inst, ok", [
    (4, [64], 3, True),
    (4, [(1 << 23) - 1], 3, False),     # a BLAS beyond the 23-bit prim field
    (4, [64, 1 << 23], 3, False),
    (4, [64], 255, True),               # 256 sources fill the 8-bit field
    (4, [64], 256, False),
], ids=["small", "blas-prims", "second-blas", "255-inst", "256-inst"])
def test_compact_bundle_ranges_match_rtjax(base, blas, n_inst, ok):
    fake = types.SimpleNamespace(
        tris=types.SimpleNamespace(num=base),
        blas=tuple(types.SimpleNamespace(tris=types.SimpleNamespace(num=p))
                   for p in blas),
        instances=types.SimpleNamespace(num=n_inst))
    cfg = dict(width=256, height=256, num_samples=8, max_bounces=5)
    assert jax_wf._compact_bundle_ok(fake, JaxConfig(**cfg)) == ok
    assert wf._compact_bundle_ok(fake, RenderConfig(**cfg)) == ok


def test_instance_material_overrides_the_prim_map():
    jscene = _jax_scene("field17")
    scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    rng = np.random.default_rng(4)
    src = rng.integers(0, 18, 500).astype(np.int32)
    prim = np.where(src == 0, rng.integers(-1, 3, 500),
                    rng.integers(0, 64, 500)).astype(np.int32)
    want = np.asarray(jax_trace._hit_material_index(
        jscene, jnp.asarray(src), jnp.asarray(prim)))
    got = trace._hit_material_index(scene, torch.tensor(src),
                                    torch.tensor(prim)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(want[src > 0].tolist())) == 2


# ------------------------------------------------------------------ engine

def test_step_matches_rtjax_state_for_state():
    """Three iterations on 17 instances (auto cadence 1, repass), blocked
    camera order (8 spp).  As test_torch_wavefront.py: rtjax steps op by op
    on its sorted engine, the port is re-seeded from rtjax's state each
    iteration, prim and src are compared where the closest t is unique."""
    from rtjax import Camera as JaxCamera
    pool, w = 4096, 32
    jscene = _jax_scene("field17")
    jcam = JaxCamera.make((0, 2.5, 3.5), (0, 0.1, 0), (0, 1, 0), 45, 1.0)
    scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    world = _world_tris(scene)
    kw = dict(width=w, height=w, num_samples=8, max_bounces=4,
              num_working_paths=pool)
    jcfg = JaxConfig(traversal="pallas", sort_every=0, **kw)
    cfg = RenderConfig(**kw)
    key = jax.random.key(3)
    jc = (jax_wf.make_initial_state(pool),
          jnp.zeros((cfg.num_pixels, 3), jnp.float32), jnp.int32(0),
          jnp.int32(0), jnp.bool_(False), jnp.float32(0), jnp.float32(0))
    cams, srcs = [], 0
    for it in range(3):
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
            m = hit & uniq if f == "normal" else np.ones(pool, bool)
            for k in range(3):
                _close(getattr(s, f)[k].numpy()[m],
                       np.asarray(getattr(js, f)[k])[m], f"{f}[{k}]")
        _close(s.t.numpy()[hit], np.asarray(js.t)[hit], "t")
        _close(c[1].numpy(), np.asarray(jc[1]), "framebuffer")
        assert int(c[2]) == int(jc[2]), "cam_start"
        assert float(c[5]) == float(jc[5]), "rays traced"
        srcs += int((s.src.numpy() > 0).sum())
    assert hit.sum() > pool // 2 and srcs > 500
    # cadence 1: every iteration generates camera rays
    assert cams[0] < cams[1] < cams[2]


_RENDER_CAM = ((0.5, 0.6, 0.8), (0.5, 0.15, -0.5), (0, 1, 0), 45.0, 1.0)


def test_render_kernel_matches_repass():
    """rtjax's test_repass_render_matches_kernel_two_level: the same
    estimator sees the same hits, so the frames agree to rounding."""
    scene = _port_scene("pyramid3")
    cam = Camera.make(*_RENDER_CAM, device="cpu")
    base = RenderConfig(width=32, height=32, num_samples=4, max_bounces=4,
                        num_working_paths=4096)
    fb = {}
    for strategy in ("kernel", "repass"):
        fb[strategy], _ = wf.render_frame(
            scene, cam, dataclasses.replace(base, two_level=strategy),
            torch.Generator().manual_seed(7))
    assert bool(torch.isfinite(fb["repass"]).all())
    np.testing.assert_allclose(fb["repass"].numpy(), fb["kernel"].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_instanced_render_matches_baked():
    """tests/test_features.py::test_instanced_matches_baked on the port:
    two pyramids instanced vs baked into the base scene, at the noise
    floor of that test."""
    frames = []
    for instanced in (False, True):
        b = SceneBuilder()
        white = b.make_matte((0.73, 0.73, 0.73))
        red = b.make_matte((0.65, 0.05, 0.05))
        b.add_triangles([0, 0, 0], [1, 0, 0], [1, 0, -1], white)
        b.add_triangles([0, 0, 0], [0, 0, -1], [1, 0, -1], white)
        b.add_area_light([0.3, 0.9, -0.3], [0.7, 0.9, -0.3],
                         [0.7, 0.9, -0.7], (10, 10, 10), white)
        places = [tf.Transform(tf.translate(0.2, 0, -0.3)),
                  tf.Transform(tf.scale(1.5, 1.5, 1.5)).composite(
                      tf.translate(0.55, 0, -0.55))]
        mid = b.register_mesh(PYRAMID_V, PYRAMID_F) if instanced else None
        for t in places:
            if instanced:
                b.add_instance(mid, red, t)
            else:
                b.add_mesh(PYRAMID_V, PYRAMID_F, red, transform=t)
        cam = Camera.make((0.5, 0.6, 1.2), (0.5, 0.2, -0.4), (0, 1, 0), 45,
                          1.0, device="cpu")
        cfg = RenderConfig(width=32, height=32, num_samples=48, max_bounces=3,
                           num_working_paths=4096)
        fb, _ = wf.render_frame(b.build("cpu"), cam, cfg,
                                torch.Generator().manual_seed(1))
        frames.append(fb.numpy().reshape(32, 32, 3))
    a, b_ = frames
    assert np.isfinite(b_).all() and (b_ >= 0).all()
    assert abs(a.mean() - b_.mean()) < 0.01
    assert mse(a, b_) < 0.004


def test_instanced_scene_without_wide_tables_renders():
    """A scene built with max_leaf_size > 8 has no wide tables: "auto"
    takes the binary walk and rtjax's per-instance loop."""
    from rtjax_torch.kernels import traversal as T
    b = SceneBuilder()
    RECIPES["pyramid3"](b, tf)
    scene = b.build("cpu", max_leaf_size=None)
    assert scene.inst_tables is None
    cfg = RenderConfig(width=8, height=8, num_samples=2, max_bounces=2,
                       num_working_paths=256)
    cam = Camera.make(*_RENDER_CAM, device="cpu")
    calls = T.REF_CALLS["closest"]
    fb, _ = wf.render_frame(scene, cam, cfg, torch.Generator())
    assert bool(torch.isfinite(fb).all()) and bool((fb >= 0).all())
    assert float(fb.mean()) > 0 and T.REF_CALLS["closest"] > calls
