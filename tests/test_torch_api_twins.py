"""rtjax's ``[..., 3]`` API twins in the port: each against rtjax's
function on the same numpy inputs, and against the port's own component-
triple (``_v3``) form, which it is built on.

- Port twin vs the port's ``_v3`` form: bitwise (the twin only regroups
  the same tensors).
- Port twin vs rtjax, which steps op by op (``jax.disable_jit()``), so
  that neither side contracts multiply-adds: bitwise where the function
  rounds only products, sums, quotients and selects; at rtol 1e-5, atol
  1e-6 where it takes a square root, sine or cosine (XLA's CPU versions
  are within an ulp but not correctly rounded: the ROADMAP's ground rule).
- ``random_in_unit_sphere`` draws from a ``torch.Generator`` where rtjax
  draws from a JAX key: its parity is statistical (every point inside
  the ball, the radius CDF r^3, no mean direction).

Then rtjax's own cases of these functions (tests/test_core.py,
test_geometry.py, test_materials.py, test_lights.py, test_features.py and
test_trace.py), run on the port's twins.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.core import geometry as jgeo
from rtjax.core import sampling as jsamp
from rtjax.core import vec as jvec
from rtjax.render import sorting as jsort
from rtjax.render import trace as jtrace
from rtjax.scene import light as jlight
from rtjax.scene import material as jmat
from rtjax.scene.camera import Camera as JaxCamera

from rtjax_torch.constants import INVALID_INDEX
from rtjax_torch.core import geometry as geo
from rtjax_torch.core import sampling as samp
from rtjax_torch.core import vec
from rtjax_torch.render import sorting as sort
from rtjax_torch.render import trace
from rtjax_torch.scene import light, material
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.light import AREA_LIGHT, POINT_LIGHT
from rtjax_torch.scene.material import GLASS, MATTE, MIRROR
from rtjax_torch.scene.scene import scene_from_arrays

from test_torch_instancing import _jax_scene, inst_scene_arrays

N = 257
EXACT = 0.0
ULP = 1e-5       # rtol for square roots, sines and cosines (atol 1e-6)


def _g(seed=0):
    return np.random.default_rng(seed)


def _unit(g, n=N):
    a = g.standard_normal((n, 3))
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _u(g, n=N):
    return g.uniform(size=n).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    """Outputs as a flat list of numpy arrays (tuples flattened)."""
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in _np(y)]
    if isinstance(x, types.SimpleNamespace):
        return _np(tuple(vars(x).values()))
    return [np.asarray(x.numpy() if torch.is_tensor(x) else x)]


def _tris_arrays(g, n=24):
    p0 = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = g.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return dict(p0=p0, e1=e1, e2=e2, n=np.cross(e1, e2))


def _tris_pair(g):
    arr = _tris_arrays(g)
    return (geo.Triangles(**{k: _t(v) for k, v in arr.items()}),
            jgeo.Triangles(**{k: _j(v) for k, v in arr.items()}))


def _lights_pair(g):
    """Point and area lights over a 24-triangle soup, both packages."""
    ours_t, theirs_t = _tris_pair(g)
    ltype = [POINT_LIGHT, AREA_LIGHT, AREA_LIGHT, POINT_LIGHT, AREA_LIGHT]
    tri = [INVALID_INDEX, 3, 17, INVALID_INDEX, 0]
    pos = g.uniform(-2, 2, (5, 3))
    emit = g.uniform(0, 10, (5, 3))
    return (light.make_light_table(ltype, pos, emit, tri, ours_t,
                                   device="cpu"),
            jlight.make_light_table(ltype, pos, emit, tri, theirs_t))


def _mat_pair():
    args = dict(mtype=np.array([MATTE, MIRROR, GLASS, MATTE], np.int32),
                albedo=np.array([[0.7, 0.5, 0.3], [0.8, 0.9, 1.0], [0, 0, 0],
                                 [0.1, 0.6, 0.2]], np.float32),
                ior=np.array([1.0, 1.0, 1.5, 1.0], np.float32))
    return (material.MaterialTable(**{k: _t(v) for k, v in args.items()}),
            jmat.MaterialTable(**{k: _j(v) for k, v in args.items()}))


# Each case: (port twin's outputs, the port _v3 form's outputs, rtjax's
# outputs, tolerance), from one numpy draw.

def case_vec3():
    g = _g(1)
    x, y = _u(g), _u(g)
    return (vec.vec3(_t(x), _t(y), 2.0), vec.to_array((_t(x), _t(y),
                                                       torch.full((N,), 2.0))),
            jvec.vec3(_j(x), _j(y), 2.0), EXACT)


def case_intersect_triangle():
    g = _g(2)
    arr = _tris_arrays(g, N)
    o = g.uniform(-1, 1, (N, 3)).astype(np.float32)
    d = _unit(g)
    tmax = np.where(g.random(N) < 0.5, 1.5, np.inf).astype(np.float32)
    ours = geo.intersect_triangle(_t(o), _t(d), _t(tmax),
                                  *(_t(arr[k]) for k in ("p0", "e1", "e2",
                                                          "n")))
    c = lambda a: vec.from_array(_t(a))
    v3 = geo.intersect_triangle_v3(c(o), c(d), _t(tmax),
                                   *(c(arr[k]) for k in ("p0", "e1", "e2",
                                                         "n")))
    theirs = jgeo.intersect_triangle(_j(o), _j(d), _j(tmax),
                                     *(_j(arr[k]) for k in ("p0", "e1", "e2",
                                                            "n")))
    return ours, v3, theirs, EXACT


def case_spawn_offset_ray():
    g = _g(3)
    p = g.uniform(-5, 5, (N, 3)).astype(np.float32)
    n, d = _unit(g), _unit(g)
    ours = geo.spawn_offset_ray(_t(p), _t(n), _t(d), 7.0)
    c = lambda a: vec.from_array(_t(a))
    o3, d3, t3 = geo.spawn_offset_ray_v3(c(p), c(n), c(d), 7.0)
    theirs = jgeo.spawn_offset_ray(_j(p), _j(n), _j(d), 7.0)
    return ours, (vec.to_array(o3), vec.to_array(d3), t3), theirs, EXACT


@pytest.mark.parametrize("name", ["p1", "p2", "center", "point", "area",
                                  "bounds", "gather"])
def test_triangles_helpers_match_rtjax(name):
    g = _g(4)
    ours, theirs = _tris_pair(g)
    if name == "point":
        u, v = _u(g, 24), _u(g, 24)
        got, want = ours.point(_t(u), _t(v)), theirs.point(_j(u), _j(v))
    elif name == "gather":
        idx = g.integers(0, 24, 40)
        got, want = ours.gather(_t(idx)), theirs.gather(_j(idx))
        got = tuple(getattr(got, f) for f in ("p0", "e1", "e2", "n"))
        want = tuple(getattr(want, f) for f in ("p0", "e1", "e2", "n"))
    else:
        got, want = getattr(ours, name)(), getattr(theirs, name)()
    tol = ULP if name == "area" else EXACT
    _match(_np(got), _np(want), tol)
    if name == "area":
        np.testing.assert_array_equal(
            got.numpy(), (0.5 * vec.length(vec.from_array(ours.n))).numpy())


def case_offset_ray_origin():
    g = _g(5)
    p = g.uniform(-10, 10, (N, 3)).astype(np.float32)
    p[:20] *= 1e-3          # the fixed-step branch near zero
    n = _unit(g)
    return (samp.offset_ray_origin(_t(p), _t(n)),
            vec.to_array(samp.offset_ray_origin_v3(vec.from_array(_t(p)),
                                                   vec.from_array(_t(n)))),
            jsamp.offset_ray_origin(_j(p), _j(n)), EXACT)


def case_same_hemisphere():
    g = _g(6)
    wo, wi, n = _unit(g), _unit(g), _unit(g)
    c = lambda a: vec.from_array(_t(a))
    return (samp.same_hemisphere(_t(wo), _t(wi), _t(n)),
            samp.same_hemisphere_v3(c(wo), c(wi), c(n)),
            jsamp.same_hemisphere(_j(wo), _j(wi), _j(n)), EXACT)


def case_uniform_sample_sphere():
    g = _g(7)
    u1, u2 = _u(g), _u(g)
    return (samp.uniform_sample_sphere(_t(u1), _t(u2)),
            vec.to_array(samp.uniform_sample_sphere_v3(_t(u1), _t(u2))),
            jsamp.uniform_sample_sphere(_j(u1), _j(u2)), ULP)


def case_uniform_sample_disk():
    g = _g(8)
    u1, u2 = _u(g), _u(g)
    ours = samp.uniform_sample_disk(_t(u1), _t(u2))
    return (ours, ours, jsamp.uniform_sample_disk(_j(u1), _j(u2)), ULP)


def case_get_rays():
    g = _g(9)
    x, y = _u(g), _u(g)
    args = ((0.5, 0.5, 1.5), (0.5, 0.5, 0.0), (0, 1, 0), 37.8, 1.3)
    cam = Camera.make(*args, device="cpu")
    o3, d3 = cam.get_rays_v3(_t(x), _t(y))
    return (cam.get_rays(_t(x), _t(y)), (vec.to_array(o3), vec.to_array(d3)),
            JaxCamera.make(*args).get_rays(_j(x), _j(y)), ULP)


def case_material_gather():
    ours, theirs = _mat_pair()
    idx = _g(10).integers(-1, 6, N).astype(np.int32)   # clamped both ends
    mt, alb, ior = ours.gather_v3(_t(idx))
    return (ours.gather(_t(idx)), (mt, vec.to_array(alb), ior),
            theirs.gather(_j(idx)), EXACT)


def _shading_inputs(seed):
    g = _g(seed)
    mtype = g.integers(0, 3, N).astype(np.int32)
    albedo = g.uniform(0, 1, (N, 3)).astype(np.float32)
    ior = g.uniform(1.2, 1.8, N).astype(np.float32)
    return g, mtype, albedo, ior, _unit(g), _unit(g), _unit(g)


def case_get_f():
    _, mtype, albedo, _, wo, wi, n = _shading_inputs(11)
    c = lambda a: vec.from_array(_t(a))
    valid, f, pdf = material.get_f_v3(_t(mtype), c(albedo), c(wo), c(wi),
                                      c(n))
    return (material.get_f(_t(mtype), _t(albedo), _t(wo), _t(wi), _t(n)),
            (valid, vec.to_array(f), pdf),
            jmat.get_f(_j(mtype), _j(albedo), _j(wo), _j(wi), _j(n)), EXACT)


def case_sample_f():
    g, mtype, albedo, ior, wo, _, n = _shading_inputs(12)
    u = [_u(g) for _ in range(3)]
    c = lambda a: vec.from_array(_t(a))
    f, wi, pdf, n_out = material.sample_f_v3(
        _t(mtype), c(albedo), _t(ior), c(wo), c(n), *map(_t, u))
    return (material.sample_f(_t(mtype), _t(albedo), _t(ior), _t(wo), _t(n),
                              *map(_t, u)),
            (vec.to_array(f), vec.to_array(wi), pdf, vec.to_array(n_out)),
            jmat.sample_f(_j(mtype), _j(albedo), _j(ior), _j(wo), _j(n),
                          *map(_j, u)), ULP)


def case_make_light_table():
    ours, theirs = _lights_pair(_g(13))
    fields = light.LIGHT_FIELDS
    v3 = light.LightTable.from_arrays(
        {k: getattr(ours, k).numpy() for k in fields}, "cpu")
    return (tuple(getattr(ours, k) for k in fields),
            tuple(getattr(v3, k) for k in fields),
            tuple(getattr(theirs, k) for k in fields), EXACT)


def case_gather_light():
    g = _g(14)
    ours, theirs = _lights_pair(g)
    pick = g.integers(0, 5, N).astype(np.int32)
    rec = light.gather_light_v3(ours, _t(pick))
    return (light.gather_light(ours, _t(pick)),
            tuple(vec.to_array(f) if isinstance(f, tuple) else f
                  for f in rec),
            jlight.gather_light(theirs, _j(pick)), EXACT)


def case_sample_li():
    g = _g(15)
    ours, theirs = _lights_pair(g)
    pick = g.integers(0, 5, N).astype(np.int32)
    p = g.uniform(-1, 1, (N, 3)).astype(np.float32)
    u1, u2 = _u(g), _u(g)
    wi, li, t, pdf, ltri = light.sample_li_v3(ours, _t(pick),
                                              vec.from_array(_t(p)),
                                              _t(u1), _t(u2))
    return (light.sample_li(ours, _t(pick), _t(p), _t(u1), _t(u2)),
            (vec.to_array(wi), vec.to_array(li), t, pdf, ltri),
            jlight.sample_li(theirs, _j(pick), _j(p), _j(u1), _j(u2)), ULP)


def case_pdf_li():
    g = _g(16)
    ours, theirs = _lights_pair(g)
    pick = g.integers(0, 5, N).astype(np.int32)
    p = g.uniform(-1, 1, (N, 3)).astype(np.float32)
    wi = _unit(g)
    return (light.pdf_li(ours, _t(pick), _t(p), _t(wi)),
            light.pdf_li_v3(ours, _t(pick), vec.from_array(_t(p)),
                            vec.from_array(_t(wi))),
            jlight.pdf_li(theirs, _j(pick), _j(p), _j(wi)), ULP)


def case_ray_sort_keys():
    g = _g(17)
    o = g.uniform(-1, 2, (N, 3)).astype(np.float32)
    d = g.standard_normal((N, 3)).astype(np.float32)
    lo, hi = np.zeros(3, np.float32), np.array([1, 1.5, 2], np.float32)
    active = g.random(N) > 0.3
    return (sort.ray_sort_keys(_t(o), _t(d), _t(lo), _t(hi), _t(active)),
            sort.ray_sort_keys_v3(vec.from_array(_t(o)),
                                  vec.from_array(_t(d)), _t(lo), _t(hi),
                                  _t(active)),
            jsort.ray_sort_keys(_j(o), _j(d), _j(lo), _j(hi), _j(active)),
            EXACT)


def case_ray_sort_keys_prim():
    g = _g(18)
    prim = g.integers(-1, 1 << 25, N).astype(np.int32)
    d = g.standard_normal((N, 3)).astype(np.float32)
    active = g.random(N) > 0.3
    return (sort.ray_sort_keys_prim(_t(prim), _t(d), _t(active)),
            sort.ray_sort_keys_prim_v3(_t(prim), vec.from_array(_t(d)),
                                       _t(active)),
            jsort.ray_sort_keys_prim(_j(prim), _j(d), _j(active)), EXACT)


def case_sort_permutation():
    keys = _g(19).integers(0, 40, N).astype(np.int32)    # many equal keys
    ours = sort.sort_permutation(_t(keys))
    return ours, ours, jsort.sort_permutation(_j(keys)), EXACT


def case_gather_hit_materials():
    jscene = _jax_scene("pyramid3")
    scene = scene_from_arrays(inst_scene_arrays(jscene), "cpu")
    g = _g(20)
    src = g.integers(0, 4, N).astype(np.int32)
    prim = g.integers(-1, scene.tris.num, N).astype(np.int32)
    mt, alb, ior = trace.gather_hit_materials_v3(scene, _t(src), _t(prim))
    return (trace.gather_hit_materials(scene, _t(src), _t(prim)),
            (mt, vec.to_array(alb), ior),
            jtrace.gather_hit_materials(jscene, _j(src), _j(prim)), EXACT)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _match(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if tol == EXACT or a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_rtjax_and_its_v3_form(name):
    with jax.disable_jit():
        ours, v3, theirs, tol = CASES[name]()
        theirs = _np(theirs)
    ours, v3 = _np(ours), _np(v3)
    _match(ours, v3, EXACT)
    _match(ours, theirs, tol)


def test_random_in_unit_sphere_statistics():
    n = 50000
    gen = torch.Generator().manual_seed(3)
    p = samp.random_in_unit_sphere(gen, (n,), "cpu")
    assert p.shape == (n, 3) and p.dtype == torch.float32
    r = torch.linalg.vector_norm(p, dim=-1).numpy()
    assert r.max() <= 1.0 + 1e-6
    for q in (0.25, 0.5, 0.75, 0.9):
        assert abs((r <= q).mean() - q ** 3) < 0.01
    assert np.abs(p.numpy().mean(0)).max() < 0.02
    # the same seed draws the same points; rtjax's draws the same law
    again = samp.random_in_unit_sphere(torch.Generator().manual_seed(3),
                                       (n,), "cpu")
    assert torch.equal(p, again)
    theirs = np.asarray(jsamp.random_in_unit_sphere(jax.random.key(3), (n,)))
    rt = np.linalg.norm(theirs, axis=-1)
    assert abs(np.median(rt) - np.median(r)) < 0.01


# ------------------------------------------------- rtjax's own cases

def test_same_hemisphere_convention():
    n = torch.tensor([0.0, 1.0, 0.0])
    wo = torch.tensor([0.6, -0.8, 0.0])
    assert bool(samp.same_hemisphere(wo, torch.tensor([0.0, 1.0, 0.0]), n))
    assert not bool(samp.same_hemisphere(wo, torch.tensor([0.0, -1.0, 0.0]),
                                         n))


def test_offset_ray_origin_moves_along_normal():
    g = _g(21)
    p = g.uniform(-10, 10, (256, 3)).astype(np.float32)
    n = _unit(g, 256)
    moved = samp.offset_ray_origin(_t(p), _t(n)).numpy() - p
    assert (np.abs(moved) > 0).any(axis=-1).all()
    assert np.abs(moved).max() < 1e-2
    assert ((moved * n >= 0) | (np.abs(n) < 1e-3)).all()


def test_offset_ray_origin_near_zero_uses_fixed_step():
    p = torch.tensor([[1e-4, -1e-4, 0.0]])
    n = torch.tensor([[1.0, 1.0, 1.0]]) / np.sqrt(3.0)
    q = samp.offset_ray_origin(p, n).numpy()[0]
    np.testing.assert_allclose(q, p.numpy()[0] + n.numpy()[0] / 65536.0,
                               rtol=1e-6)


def test_uniform_sample_sphere_and_disk_statistics():
    g = _g(22)
    u1, u2 = _t(_u(g, 20000)), _t(_u(g, 20000))
    d = samp.uniform_sample_sphere(u1, u2).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert np.abs(d.mean(0)).max() < 0.02
    np.testing.assert_allclose(d.var(0), 1.0 / 3.0, atol=0.02)
    x, y = samp.uniform_sample_disk(u1, u2)
    r2 = x.numpy() ** 2 + y.numpy() ** 2
    assert r2.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(r2.mean(), 0.5, atol=0.01)


def _tri(p0, p1, p2):
    return geo.Triangles.from_vertices([p0], [p1], [p2], "cpu")


def test_triangle_storage_and_moeller_trumbore():
    t = _tri([0, 0, 0], [1, 0, 0], [0, 1, 0])
    np.testing.assert_allclose(t.p1().numpy()[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(t.p2().numpy()[0], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(float(t.area()[0]), 0.5, rtol=1e-6)
    np.testing.assert_allclose(t.center().numpy()[0], [1 / 3, 1 / 3, 0],
                               atol=1e-6)
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    args = (t.p0, t.e1, t.e2, t.n)
    hit, tt, u, v = geo.intersect_triangle(o, d, float("inf"), *args)
    assert bool(hit[0]) and abs(float(tt[0]) - 1.0) < 1e-6
    np.testing.assert_allclose(t.point(u, v).numpy()[0], [0.2, 0.2, 0.0],
                               atol=1e-6)
    miss = geo.intersect_triangle(torch.tensor([[0.9, 0.9, 1.0]]), d,
                                  float("inf"), *args)[0]
    behind = geo.intersect_triangle(o, -d, float("inf"), *args)[0]
    clipped = geo.intersect_triangle(o, d, torch.tensor(0.5), *args)[0]
    assert not (bool(miss[0]) or bool(behind[0]) or bool(clipped[0]))
    t2 = _tri([1, 2, 3], [2, 2, 3], [1, 5, 3])
    np.testing.assert_allclose(
        t2.point(torch.tensor([1.0]), torch.tensor([0.0])).numpy()[0],
        [2, 2, 3], atol=1e-6)
    np.testing.assert_allclose(
        t2.point(torch.tensor([0.0]), torch.tensor([1.0])).numpy()[0],
        [1, 5, 3], atol=1e-6)


def test_camera_matches_reference_geometry():
    cam = Camera.make((0.5, 0.5, 1.5), (0.5, 0.5, 0.0), (0, 1, 0), 37.8, 1.0,
                      device="cpu")
    o, d = cam.get_rays(torch.tensor([0.5]), torch.tensor([0.5]))
    np.testing.assert_allclose(o.numpy()[0], [0.5, 0.5, 1.5], atol=1e-6)
    np.testing.assert_allclose(d.numpy()[0], [0, 0, -1], atol=1e-6)
    _, d_top = cam.get_rays(torch.tensor([0.5]), torch.tensor([0.0]))
    _, d_bot = cam.get_rays(torch.tensor([0.5]), torch.tensor([1.0]))
    assert float(d_top[0, 1]) > 0 > float(d_bot[0, 1])
    expect = np.array([0.0, np.tan(np.radians(37.8) / 2), -1.0])
    np.testing.assert_allclose(d_top.numpy()[0],
                               expect / np.linalg.norm(expect), atol=1e-5)


def _consts(n, mtype, albedo=(0.7, 0.5, 0.3), ior=1.5):
    return (torch.full((n,), mtype, dtype=torch.int32),
            torch.tensor([albedo], dtype=torch.float32).repeat(n, 1),
            torch.full((n,), ior))


def _rows(v, n=1):
    return torch.tensor([v], dtype=torch.float32).repeat(n, 1)


def _normalize(a):
    return vec.to_array(vec.normalize(vec.from_array(a)))


def test_matte_cosine_sampling():
    n = 50000
    g = _g(23)
    u = [_t(_u(g, n)) for _ in range(3)]
    nrm = _rows([0.0, 1.0, 0.0], n)
    f, wi, pdf, n_out = material.sample_f(*_consts(n, MATTE),
                                          _rows([0.0, -1.0, 0.0], n), nrm,
                                          *u)
    cos = wi.numpy()[:, 1]
    assert (cos > -1e-6).all()
    np.testing.assert_allclose(cos.mean(), 2 / 3, atol=0.01)
    w = f.numpy() * cos[:, None] / pdf.numpy()[:, None]
    np.testing.assert_allclose(w.mean(0), [0.7, 0.5, 0.3], atol=0.01)
    np.testing.assert_allclose(n_out.numpy(), nrm.numpy(), atol=1e-6)


def test_matte_flip_and_mirror_reflection():
    up = _rows([0.0, 1.0, 0.0])
    half = (torch.tensor([0.3]), torch.tensor([0.6]), torch.tensor([0.1]))
    _, wi, _, n_out = material.sample_f(*_consts(1, MATTE), up, up, *half)
    assert float(n_out[0, 1]) == -1.0 and float(wi[0, 1]) < 0
    wo = _normalize(_rows([1.0, -1.0, 0.0]))
    f, wi, pdf, n_out = material.sample_f(
        *_consts(1, MIRROR, albedo=(0.8, 0.9, 1.0)), wo, up,
        *(torch.tensor([0.5]),) * 3)
    np.testing.assert_allclose(wi.numpy()[0],
                               _normalize(_rows([1.0, 1.0, 0.0])).numpy()[0],
                               atol=1e-6)
    assert float(pdf[0]) == 1.0
    cos = float((wi * n_out).sum(-1)[0])
    np.testing.assert_allclose(f.numpy()[0] * cos, [0.8, 0.9, 1.0],
                               rtol=1e-5)


def test_glass_schlick_energy_tir_and_flip():
    g = _g(24)
    n = 100000
    u = [_t(_u(g, n)) for _ in range(3)]
    down, up = _rows([0.0, -1.0, 0.0], n), _rows([0.0, 1.0, 0.0], n)
    _, wi, _, _ = material.sample_f(*_consts(n, GLASS), down, up, *u)
    np.testing.assert_allclose(float((wi.numpy()[:, 1] > 0).mean()),
                               ((1 - 1.5) / (1 + 1.5)) ** 2, atol=0.005)
    wo = _normalize(_rows([0.5, -1.0, 0.1], n))
    f, wi, pdf, n_out = material.sample_f(*_consts(n, GLASS), wo, up, *u)
    w = f.numpy()[:, 0] * (wi * n_out).sum(-1).numpy() / pdf.numpy()
    refl = wi.numpy()[:, 1] > 0
    np.testing.assert_allclose(w[refl], 1.0, rtol=1e-4)
    np.testing.assert_allclose(w[~refl], (1 / 1.5) ** 2, rtol=1e-4)
    one = (torch.tensor([0.5]), torch.tensor([0.5]))
    _, wi, pdf, _ = material.sample_f(
        *_consts(1, GLASS), _normalize(_rows([1.0, 0.2, 0.0])),
        _rows([0.0, 1.0, 0.0]), *one, torch.tensor([0.99]))
    assert float(pdf[0]) == 1.0 and float(wi[0, 1]) < 0
    _, wi, _, n_out = material.sample_f(
        *_consts(1, GLASS), _rows([0.0, -1.0, 0.0]), _rows([0.0, 1.0, 0.0]),
        *one, torch.tensor([0.9]))
    assert float(wi[0, 1]) < 0 and float(n_out[0, 1]) < 0


def test_get_f_matte_only_and_hemisphere():
    wo, nrm = _rows([0.0, -1.0, 0.0]), _rows([0.0, 1.0, 0.0])
    wi = _normalize(_rows([0.3, 1.0, 0.0]))
    for mtype, expect in ((MATTE, True), (MIRROR, False), (GLASS, False)):
        mt, alb, _ = _consts(1, mtype)
        assert bool(material.get_f(mt, alb, wo, wi, nrm)[0][0]) == expect
    mt, alb, _ = _consts(1, MATTE)
    wi_dn = _normalize(_rows([0.3, -1.0, 0.0]))
    assert not bool(material.get_f(mt, alb, wo, wi_dn, nrm)[0][0])


def _light_tris():
    return geo.Triangles.from_vertices([[0, 0, 2.0]], [[1, 0, 2.0]],
                                       [[0, 1, 2.0]], "cpu")


def test_point_light_inverse_square():
    lights = light.make_light_table([POINT_LIGHT], [(0, 0, 3)], [(9, 9, 9)],
                                    [INVALID_INDEX], _light_tris(),
                                    device="cpu")
    p = torch.zeros(1, 3)
    pick = torch.zeros(1, dtype=torch.int32)
    wi, li, t, pdf, ltri = light.sample_li(lights, pick, p,
                                           torch.tensor([0.5]),
                                           torch.tensor([0.5]))
    np.testing.assert_allclose(wi.numpy()[0], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-6)
    np.testing.assert_allclose(li.numpy()[0], [1, 1, 1], rtol=1e-6)
    assert float(pdf[0]) == 1.0 and int(ltri[0]) == INVALID_INDEX
    assert bool(light.is_delta(lights.ltype)[0])
    assert float(light.pdf_li(lights, pick, p, wi)[0]) == 0.0


def test_area_light_sample_pdf_and_solid_angle():
    lights = light.make_light_table([AREA_LIGHT], [(0, 0, 0)], [(5, 5, 5)],
                                    [0], _light_tris(), device="cpu")
    g = _g(25)
    n = 200000
    p = torch.tensor([[1 / 3, 1 / 3, 0.0]]).repeat(n, 1)
    pick = torch.zeros(n, dtype=torch.int32)
    wi, li, _, pdf, ltri = light.sample_li(lights, pick, p, _t(_u(g, n)),
                                           _t(_u(g, n)))
    np.testing.assert_allclose(li.numpy(), 5.0, rtol=1e-6)
    assert int(ltri[0]) == 0
    np.testing.assert_allclose(pdf.numpy(),
                               light.pdf_li(lights, pick, p, wi).numpy(),
                               rtol=2e-3)
    # the subtended solid angle, E[1 / pdf], against a grid integral
    k = 400
    gu, gv = np.meshgrid((np.arange(k) + 0.5) / k, (np.arange(k) + 0.5) / k)
    m = gu + gv <= 1.0
    pts = (np.array([0, 0, 2.0]) - gu[m][:, None] * np.array([-1, 0, 0.0])
           + gv[m][:, None] * np.array([0, 1, 0.0]))
    rel = pts - np.array([1 / 3, 1 / 3, 0.0])
    d2 = np.sum(rel ** 2, -1)
    omega = float(np.sum(np.abs(rel[:, 2]) / np.sqrt(d2) / d2)
                  * 0.5 / m.sum())
    np.testing.assert_allclose(float((1.0 / pdf.numpy()).mean()), omega,
                               rtol=0.01)


def test_mixed_light_table_batched_pick_and_gather():
    lights = light.make_light_table([POINT_LIGHT, AREA_LIGHT],
                                    [(0, 0, 3), (0, 0, 0)],
                                    [(9, 9, 9), (5, 5, 5)],
                                    [INVALID_INDEX, 0], _light_tris(),
                                    device="cpu")
    pick = torch.tensor([0, 1], dtype=torch.int32)
    _, _, _, pdf, ltri = light.sample_li(lights, pick, torch.zeros(2, 3),
                                         torch.tensor([0.3, 0.3]),
                                         torch.tensor([0.4, 0.4]))
    assert int(ltri[0]) == INVALID_INDEX and int(ltri[1]) == 0
    assert float(pdf[0]) == 1.0 and float(pdf[1]) > 0
    d = light.is_delta(lights.ltype[pick]).numpy()
    assert d[0] and not d[1]
    rec = light.gather_light(lights, pick)
    np.testing.assert_array_equal(rec[2].numpy(), [[9, 9, 9], [5, 5, 5]])
    np.testing.assert_array_equal(rec[4].numpy()[1], [0, 0, 2.0])
    # no triangles: the emitter fields stay zero, as in rtjax
    bare = light.make_light_table([AREA_LIGHT], [(0, 0, 0)], [(1, 1, 1)],
                                  [0], device="cpu")
    assert not bare.tri_n.any() and int(bare.tri[0]) == 0


def test_ray_sort_groups_octants():
    g = _g(26)
    n = 512
    o = _t(g.uniform(0, 1, (n, 3)).astype(np.float32))
    d = _t(g.standard_normal((n, 3)).astype(np.float32))
    active = _t(g.random(n) > 0.3)
    keys = sort.ray_sort_keys(o, d, torch.zeros(3), torch.ones(3), active)
    perm, inv = sort.sort_permutation(keys)
    assert (np.diff(keys[perm].numpy()) >= 0).all()
    act_sorted = active[perm].numpy()
    first = np.argmin(act_sorted) if not act_sorted.all() else n
    assert not act_sorted[first:].any()
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(n))


def test_hit_materials_take_the_instance_override():
    """tests/test_trace.py: an instance's hit takes its instance's
    material, a base hit the base scene's."""
    scene = scene_from_arrays(inst_scene_arrays(_jax_scene("pyramid3")),
                              "cpu")
    _, albedo, _ = trace.gather_hit_materials(
        scene, torch.tensor([1, 0], dtype=torch.int32),
        torch.tensor([0, 0], dtype=torch.int32))
    np.testing.assert_allclose(albedo.numpy(), [[0.6, 0.1, 0.1],
                                                [0.7, 0.7, 0.7]], atol=1e-6)
