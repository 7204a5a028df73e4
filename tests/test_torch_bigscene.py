"""Scenes past the wide tables' caps ([C 1]), pinned on small scenes with
the caps patched down (no multi-million-triangle build here).

- META_CAP (2^20 wide nodes or leaf rows): the f32 mirror of the metas in
  the node rows is no longer exact.  The tables are built all the same,
  the mirror lanes NaN, every other array equal to the unpatched build's
  (single-level at widths 16 and 8, and the two-level concatenation); no
  walk reads the mirror, so the persist, packet, lane and two-level plain
  walks return the same hits bit for bit as on the unpatched tables, and
  the hits of rtjax's all-triangles oracle (``rtjax.kernels.brute``, op by
  op): hit equal, t at rtol 1e-5, prim where the closest t is unique.
- PRIM_CAP (2^24 triangles, the leaf rows' f32 prim ids): a mesh past it
  gets no wide tables, as in rtjax.  A single-level scene resolves to
  "xla" (the binary walk); an instanced scene keeps its base tables and
  walks the oversized BLAS with the binary walk (rtjax's per-instance
  loop).  Each renders a frame at the NumPy oracle's noise floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.core.geometry import Triangles as JaxTriangles
from rtjax.kernels import brute as jax_brute
from rtjax.utils.compare import mse

from rtjax_torch import RenderConfig
from rtjax_torch.accel import wide
from rtjax_torch.kernels import lane as L
from rtjax_torch.kernels import persist as P
from rtjax_torch.kernels import traversal as T
from rtjax_torch.kernels import wide as WD
from rtjax_torch.kernels import wide_inst as WI
from rtjax_torch.render import render, trace
from rtjax_torch.scene import transform as tf
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder

from oracle import render_oracle_image
from scenes import COLORS, WALLS, cornell, default_camera
from test_torch_instancing import RECIPES
from test_torch_persist import _unique_t
from test_torch_scene import camera_arrays

N_RAYS = 2048


def _soup_scene(width):
    b = SceneBuilder()
    mat = b.make_matte((0.6, 0.6, 0.6))
    rng = np.random.default_rng(23)
    p0 = rng.uniform(-1, 1, (900, 3))
    b.add_triangles(p0, p0 + rng.uniform(-0.25, 0.25, (900, 3)),
                    p0 + rng.uniform(-0.25, 0.25, (900, 3)), mat)
    return b


def _build(monkeypatch, kind, width, meta_cap=None):
    with monkeypatch.context() as m:
        if meta_cap is not None:
            m.setattr(wide, "META_CAP", meta_cap)
        if width == 8:
            m.setattr("rtjax_torch.scene.scene.MAX_NODES16", 1)
        if kind == "single":
            return _soup_scene(width).build("cpu")
        b = SceneBuilder()
        RECIPES["field17"](b, tf)
        return b.build("cpu")


def _mirror(tables):
    w = tables.width
    return tables.node_bounds[:, 6 * w:7 * w + 1]


def _rest(tables):
    """Every table array with the mirror lanes cut out."""
    w = tables.width
    nb = tables.node_bounds
    return (nb[:, :6 * w], nb[:, 7 * w + 1:], tables.child_meta,
            tables.node_info, tables.leaf_tris)


def _same(a, b):
    return all(torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0))
               for x, y in zip(a, b))


CASES = [("single", 16), ("single", 8), ("instanced", 8)]


@pytest.mark.parametrize("kind,width", CASES,
                         ids=["single_w16", "single_w8", "two_level"])
def test_tables_past_the_meta_cap_keep_all_but_the_mirror(monkeypatch, kind,
                                                          width):
    full = _build(monkeypatch, kind, width)
    cut = _build(monkeypatch, kind, width, meta_cap=2)
    pick = (lambda s: s.tables) if kind == "single" \
        else (lambda s: s.inst_tables.wide)
    a, b = pick(full), pick(cut)
    assert a.width == b.width == width
    assert b.num_wide_nodes > 2 and b.num_leaf_rows > 2
    w = a.width
    # unpatched: the mirror is the exact metas and info words
    assert torch.equal(_mirror(a)[:, :w],
                       a.child_meta.view(-1, w).to(torch.float32))
    assert torch.equal(_mirror(a)[:, w], a.node_info.to(torch.float32))
    assert torch.isnan(_mirror(b)).all()
    assert _same(_rest(a), _rest(b))
    if kind == "instanced":
        # the base's own tables (one node, one leaf) are below the cap
        assert cut.tables.num_wide_nodes == 1
        assert torch.equal(cut.tables.node_bounds.nan_to_num(-7.0),
                           full.tables.node_bounds.nan_to_num(-7.0))
        assert torch.equal(cut.inst_tables.root, full.inst_tables.root)
        assert torch.equal(cut.inst_tables.affine, full.inst_tables.affine)


def _rays(seed, lo=-1.3, hi=1.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d = rng.uniform(-0.9, 0.9, (N_RAYS, 3)).astype(np.float32) - o * 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N_RAYS) < 0.3, 0.8,
                    np.inf).astype(np.float32)
    active = rng.random(N_RAYS) > 0.1
    return (torch.tensor(o), torch.tensor(d.astype(np.float32)),
            torch.tensor(tmax), torch.tensor(active))


def _jax_tris(tris):
    return JaxTriangles(*(jnp.asarray(getattr(tris, k).numpy())
                          for k in ("p0", "e1", "e2", "n")))


def _brute_closest(tris, o, d, tmax, active):
    with jax.disable_jit():
        return [np.asarray(a) for a in jax_brute.closest_brute(
            _jax_tris(tris), *(jnp.asarray(x.numpy())
                               for x in (o, d, tmax, active)))]


def _brute_anyhit(tris, o, d, tmax, exclude, active):
    with jax.disable_jit():
        return np.asarray(jax_brute.anyhit_brute(
            _jax_tris(tris), *(jnp.asarray(x.numpy())
                               for x in (o, d, tmax, exclude, active))))


WALKS = {"persist": (P.persist_traverse_closest, P.persist_traverse_anyhit),
         "packet": (WD.wide_traverse_closest, WD.wide_traverse_anyhit),
         "lane": (L.lane_traverse_closest, L.lane_traverse_anyhit)}


@pytest.mark.parametrize("walk", list(WALKS))
def test_walks_past_the_meta_cap_match_the_oracle(monkeypatch, walk):
    full = _build(monkeypatch, "single", 16)
    cut = _build(monkeypatch, "single", 16, meta_cap=2)
    assert torch.isnan(_mirror(cut.tables)).all()
    closest, anyhit = WALKS[walk]
    o, d, tmax, active = _rays(3)
    got = closest(cut.tables, o, d, tmax, active)
    want = closest(full.tables, o, d, tmax, active)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    hit, t, prim, _ = (a.numpy() for a in got)
    bh, bt, _, _, bp, _ = _brute_closest(cut.tris, o, d, tmax, active)
    np.testing.assert_array_equal(hit, bh)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-5)
    uniq = hit & _unique_t(cut.tris, o.numpy().astype(np.float64),
                           d.numpy().astype(np.float64), tmax.numpy(),
                           t.astype(np.float64))
    assert uniq.sum() > 0.95 * hit.sum() and hit.sum() > 300
    np.testing.assert_array_equal(prim[uniq], bp[uniq])

    rng = np.random.default_rng(4)
    exclude = torch.tensor(np.where(rng.random(N_RAYS) < 0.5, prim,
                                    -1).astype(np.int32))
    occ = anyhit(cut.tables, o, d, tmax, exclude, active)
    assert torch.equal(occ, anyhit(full.tables, o, d, tmax, exclude, active))
    np.testing.assert_array_equal(
        occ.numpy(), _brute_anyhit(cut.tris, o, d, tmax, exclude, active))
    assert 100 < int(occ.sum()) < int(active.sum())


def _two_level_brute(scene, o, d, tmax, active):
    """rtjax's oracle over the base scene and over every instance's BLAS
    in its local frame (the rays of rtjax's per-instance loop); the
    closest of them, the earlier source at equal t.  Returns ``(hit, t,
    src)``."""
    bh, bt, *_ = _brute_closest(scene.tris, o, d, tmax, active)
    best_t = np.where(bh, bt, np.inf)
    src = np.where(bh, 0, -1)
    o3, d3 = tuple(o.T), tuple(d.T)
    for k in range(scene.instances.num):
        lo, ld = trace._local_rays(scene.instances, k, o3, d3)
        h, t, *_ = _brute_closest(
            scene.blas[scene.instances.mesh_id[k]].tris,
            torch.stack(lo, 1), torch.stack(ld, 1), tmax, active)
        closer = h & (t < best_t)
        best_t = np.where(closer, t, best_t)
        src = np.where(closer, k + 1, src)
    return src >= 0, best_t, src


def test_two_level_walk_past_the_meta_cap_matches_the_oracle(monkeypatch):
    full = _build(monkeypatch, "instanced", 8)
    cut = _build(monkeypatch, "instanced", 8, meta_cap=2)
    o, d, tmax, active = _rays(9, lo=-2.0, hi=2.0)
    o[:, 1] = o[:, 1].abs() * 0.3 + 0.05
    args = (tuple(o.T.contiguous()), tuple(d.T.contiguous()), tmax, active)
    got = WI.wide_traverse_closest_inst(cut.inst_tables, *args)
    want = WI.wide_traverse_closest_inst(full.inst_tables, *args)
    for x, y in zip(got, want):
        for a, b in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(a, b)
    hit, t, _, inst = (a.numpy() for a in got[:4])
    bh, bt, bsrc = _two_level_brute(cut, o, d, tmax, active)
    np.testing.assert_array_equal(hit, bh)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-5)
    assert (inst[hit] == bsrc[hit]).mean() > 0.99 and (bsrc > 0).sum() > 100
    exclude = torch.full((N_RAYS,), -1, dtype=torch.int32)
    occ = WI.wide_traverse_anyhit_inst(cut.inst_tables, *args[:3], exclude,
                                       active)
    assert torch.equal(occ, WI.wide_traverse_anyhit_inst(
        full.inst_tables, *args[:3], exclude, active))
    np.testing.assert_array_equal(occ.numpy(), bh)


# ------------------------------------------------ past the prim-id cap

MESH_V = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                   for z in (-1, 1)], float)
# a closed box, each face split into four triangles about its centre
_FACES = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
          (0, 2, 6, 4), (1, 5, 7, 3)]
PLACEMENTS = [((0.3, 0.18, -0.6), 0.18, 0.0), ((0.68, 0.12, -0.35), 0.12, 0.6)]


def _box_mesh():
    v = list(MESH_V)
    f = []
    for a, b, c, e in _FACES:
        v.append(MESH_V[[a, b, c, e]].mean(0))
        m = len(v) - 1
        f += [(a, b, m), (b, c, m), (c, e, m), (e, a, m)]
    return np.array(v), np.array(f)


def _matrix(at, size, turn):
    return (tf.Transform(tf.scale(size, size, size))
            .composite(tf.rotate((0, 1, 0), turn))
            .composite(tf.translate(*at)))


def _port_cornell(instanced):
    """tests/scenes.py's cornell(light_size=0.5, light_l=(4, 4, 4)) built by
    the port's SceneBuilder, with two instances of a 24-triangle box when
    ``instanced``; and the oracle scene of the same world triangles."""
    b = SceneBuilder()
    mats = {name: b.make_matte(c) for name, c in COLORS.items()}
    for (p0, p1, p2), mat in WALLS:
        b.add_triangles(p0, p1, p2, mats[mat])
    extra = []
    if instanced:
        v, f = _box_mesh()
        mid = b.register_mesh(v, f)
        for at, size, turn in PLACEMENTS:
            m = _matrix(at, size, turn)
            b.add_instance(mid, mats["white"], m)
            w = m.apply(v)
            extra += [((w[i], w[j], w[k]), "white") for i, j, k in f]
    h = 0.25
    for lt in (((0.5 - h, 0.999, -0.5 + h), (0.5 + h, 0.999, -0.5 + h),
                (0.5 + h, 0.999, -0.5 - h)),
               ((0.5 - h, 0.999, -0.5 + h), (0.5 - h, 0.999, -0.5 - h),
                (0.5 + h, 0.999, -0.5 - h))):
        b.add_area_light(*lt, (4.0, 4.0, 4.0), mats["white"])
    _, osc = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0), extra=extra)
    return b, osc


def _frame_at_oracle_floor(scene, osc, **change):
    jcam = default_camera()
    cam = Camera.from_arrays(camera_arrays(jcam), "cpu")
    w = h = 16
    img_o = render_oracle_image(osc, jcam, w, h, 600, 4, seed=5)
    img = render(w, h, 64, 4, cam, scene, seed=1, num_working_paths=4096,
                 **change).numpy().reshape(h, w, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert abs(img_o.mean() - img.mean()) < 0.01
    assert mse(img_o, img) < 0.004


def test_scene_past_the_prim_cap_renders_on_the_binary_walk(monkeypatch):
    b, osc = _port_cornell(instanced=False)
    assert b.build("cpu").tables is not None
    monkeypatch.setattr(wide, "PRIM_CAP", 12)   # the box has 12 triangles
    scene = b.build("cpu")
    assert scene.tables is None
    assert trace.resolve_mode(scene, RenderConfig()) == "xla"
    with pytest.raises(ValueError, match="max_leaf_size"):
        trace.resolve_mode(scene, RenderConfig(traversal="pallas"))
    calls = dict(T.REF_CALLS), dict(P.REF_CALLS)
    _frame_at_oracle_floor(scene, osc)
    assert T.REF_CALLS["closest"] > calls[0]["closest"]
    assert P.REF_CALLS == calls[1]


def test_blas_past_the_prim_cap_takes_the_binary_walk(monkeypatch):
    b, osc = _port_cornell(instanced=True)
    full = b.build("cpu")
    assert full.inst_tables is not None
    monkeypatch.setattr(wide, "PRIM_CAP", 20)   # base 12, BLAS 24
    scene = b.build("cpu")
    assert scene.tables is not None and scene.inst_tables is None
    assert scene.blas[0].tables is None
    assert trace.resolve_mode(scene, RenderConfig()) == "pallas"
    assert torch.equal(scene.tables.child_meta, full.tables.child_meta)
    calls = dict(T.REF_CALLS), dict(P.REF_CALLS), dict(WI.REF_CALLS)
    # the 12-triangle base walks its tables (the direct path off)
    _frame_at_oracle_floor(scene, osc, direct_max_tris=0)
    assert T.REF_CALLS["closest"] > calls[0]["closest"]
    assert P.REF_CALLS["closest"] > calls[1]["closest"]
    assert WI.REF_CALLS == calls[2]
