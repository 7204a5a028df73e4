"""rtjax_torch host layer vs rtjax: PLY loading, transforms, triangles, the
BVH build, the wide tables, the scene tables and camera rays.

Host-side builds run the same NumPy / C++ code paths in both packages, so
everything here must match exactly, with two stated exceptions:

- triangle normals: the port computes ``cross(e1, e2)`` in NumPy, the
  convention of rtjax's own wide tables, and must equal that exactly;
  rtjax's ``Scene.tris.n`` comes from a jitted ``jnp.cross``, which XLA on
  the CPU contracts into fused multiply-adds, so it may differ by the
  rounding of one product: at most 2^-23 * (|a1 b2| + |a2 b1|) per
  component;
- camera rays: elementwise float32 on both sides, rtol 1e-6.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtjax.accel.bvh import BuildResult as JaxBuildResult
from rtjax.accel.builder_cpp import build_bvh as jax_build_bvh
from rtjax.core.geometry import Triangles as JaxTriangles
from rtjax.kernels.pallas_wide import build_wide_tables as jax_wide
from rtjax.scene import mesh as jax_mesh
from rtjax.scene.transform import Transform as JaxTransform
from rtjax.scene.transform import rotate as jax_rotate
from rtjax.scene.transform import scale as jax_scale
from rtjax.scene.transform import translate as jax_translate
from rtjax.scenes import cornell_bunny as jax_cornell_bunny

from rtjax_torch.accel.builder_cpp import build_bvh
from rtjax_torch.accel.bvh import BuildResult
from rtjax_torch.accel.wide import build_wide_tables
from rtjax_torch.core.geometry import Triangles
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.mesh import load_ply
from rtjax_torch.scene.scene import SceneBuilder, scene_from_arrays
from rtjax_torch.scene.transform import Transform, rotate, scale, translate
from rtjax_torch.scenes import cornell_bunny

from conftest import BUNNY_PLY, random_triangles
from scenes import COLORS, WALLS, cornell, default_camera

TABLE_FIELDS = ("node_bounds", "child_meta", "node_info", "leaf_tris")


def scene_arrays(scene) -> dict:
    """An rtjax Scene as the dict that rtjax_torch's scene_from_arrays
    takes: every array field as numpy, plus the static fields."""
    out = {}
    for group in ("tris", "bvh", "materials", "lights"):
        obj = getattr(scene, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name != "max_depth":
                out[f"{group}.{f.name}"] = np.asarray(v)
    out["bvh.max_depth"] = scene.bvh.max_depth
    out["prim_material"] = np.asarray(scene.prim_material)
    out["prim_light"] = np.asarray(scene.prim_light)
    if scene.tables is not None:
        for k in TABLE_FIELDS:
            out[f"tables.{k}"] = np.asarray(getattr(scene.tables, k))
        out["tables.width"] = scene.tables.width
    out["num_lights"] = scene.num_lights
    out["mat_runs"] = scene.mat_runs
    out["env_radiance"] = np.asarray(scene.env_radiance)
    return out


def camera_arrays(cam) -> dict:
    return {k: np.asarray(getattr(cam, k))
            for k in ("lookfrom", "upper_left", "horizontal", "vertical")}


def _tables_equal(ours, theirs):
    np.testing.assert_array_equal(ours.node_bounds.numpy(),
                                  np.asarray(theirs.node_bounds))  # NaN-aware
    for k in TABLE_FIELDS[1:]:
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(theirs, k)))
    assert ours.width == theirs.width


def _normals_match(n, e1, e2, n_fused):
    """``n`` is NumPy's cross(e1, e2); ``n_fused`` (an XLA-jitted cross)
    is within the rounding of one product of it."""
    np.testing.assert_array_equal(n, np.cross(e1, e2))
    prods = np.abs(np.stack([e1[:, 1] * e2[:, 2], e1[:, 2] * e2[:, 0],
                             e1[:, 0] * e2[:, 1]], 1)) + \
        np.abs(np.stack([e1[:, 2] * e2[:, 1], e1[:, 0] * e2[:, 2],
                         e1[:, 1] * e2[:, 0]], 1))
    assert (np.abs(n_fused - n) <= 2.0 ** -23 * prods).all()


def _write_ply(path, mesh, fmt):
    data = jax_mesh.PlyData(comments=[])
    data.add_element("vertex", {c: mesh.vertices[:, i]
                                for i, c in enumerate("xyz")})
    data.add_element("face", {"vertex_indices": list(mesh.faces)})
    jax_mesh.save_ply_data(path, data, fmt=fmt)


@pytest.mark.parametrize("fmt", ["bunny", "ascii", "binary_big_endian"])
def test_load_ply_matches(tmp_path, fmt):
    path = BUNNY_PLY
    if fmt != "bunny":
        rng = np.random.default_rng(3)
        mesh = jax_mesh.Mesh(vertices=rng.normal(size=(40, 3)),
                             faces=rng.integers(0, 40, (60, 3)))
        path = str(tmp_path / "m.ply")
        _write_ply(path, mesh, fmt)
    ours, theirs = load_ply(path), jax_mesh.load_ply(path)
    np.testing.assert_array_equal(ours.vertices, theirs.vertices)
    np.testing.assert_array_equal(ours.faces, theirs.faces)


def test_transform_and_triangles_match():
    mesh = load_ply(BUNNY_PLY)
    chain = [(translate, jax_translate, (0.09, -0.03, -0.05)),
             (scale, jax_scale, (2.0, 2.0, 2.0)),
             (rotate, jax_rotate, ((0.3, 1.0, 0.2), 0.7))]
    t, tj = Transform(), JaxTransform()
    for ours, theirs, args in chain:
        t.composite(ours(*args))
        tj.composite(theirs(*args))
    v, vj = t.apply(mesh.vertices), tj.apply(mesh.vertices)
    np.testing.assert_array_equal(v, vj)
    f = mesh.faces
    tri = Triangles.from_vertices(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], "cpu")
    trj = JaxTriangles.from_vertices(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    for k in ("p0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(tri, k).numpy(),
                                      np.asarray(getattr(trj, k)))
    _normals_match(tri.n.numpy(), tri.e1.numpy(), tri.e2.numpy(),
                   np.asarray(trj.n))


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(11)
    p0, p1, p2 = (np.asarray(a, np.float32)
                  for a in random_triangles(rng, 300))
    bmin = np.minimum(np.minimum(p0, p1), p2)
    bmax = np.maximum(np.maximum(p0, p1), p2)
    return p0, p1, p2, bmin, bmax, (p0 + p1 + p2) / 3.0


def test_build_result_matches(soup):
    *_, bmin, bmax, centers = soup
    ours = build_bvh(bmin, bmax, centers, max_leaf_size=8, min_leaf_size=8)
    theirs = jax_build_bvh(bmin, bmax, centers, max_leaf_size=8,
                           min_leaf_size=8)
    m = theirs.num_nodes
    assert (ours.num_nodes, ours.max_depth) == (m, theirs.max_depth)
    for k in ("bmin", "bmax", "left_first", "num_prims"):
        np.testing.assert_array_equal(getattr(ours, k)[:m],
                                      getattr(theirs, k)[:m])
    np.testing.assert_array_equal(ours.perm, theirs.perm)


@pytest.mark.parametrize("width", [8, 16])
def test_wide_tables_match(soup, width):
    p0, p1, p2, bmin, bmax, centers = soup
    res = jax_build_bvh(bmin, bmax, centers, max_leaf_size=8,
                        min_leaf_size=8)
    perm = res.perm
    pp0, e1, e2 = p0[perm], p0[perm] - p1[perm], p2[perm] - p0[perm]
    nv = np.cross(e1, e2)
    ours = build_wide_tables(BuildResult(**dataclasses.asdict(res)), pp0, e1,
                             e2, nv, "cpu", width=width)
    theirs = jax_wide(JaxBuildResult(**dataclasses.asdict(res)), pp0, e1, e2,
                      nv, as_numpy=True, width=width)
    _tables_equal(ours, theirs)
    assert ours.depth == res.max_depth
    # the trailing all-zero row that rejects every ray
    assert not ours.leaf_tris[-1].any()


def _scene_tables_equal(ours, theirs):
    """Every array and static field of the two scenes (scene_arrays reads
    the port's dataclasses the same way as rtjax's)."""
    got, want = scene_arrays(ours), scene_arrays(theirs)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key == "tris.n":
            _normals_match(got[key], got["tris.e1"], got["tris.e2"], w)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


def test_scene_build_matches():
    """Cornell box + mirror/glass extras + area lights: triangles, BVH,
    prim tables, material runs, light table and wide tables."""
    extra = [
        (((0.1, 0, -0.2), (0.45, 0, -0.2), (0.3, 0.5, -0.45)), "mirror"),
        (((0.55, 0, -0.2), (0.9, 0, -0.2), (0.7, 0.5, -0.45)),
         ("glass", 1.5)),
    ]
    theirs, _ = cornell(extra=extra, max_leaf_size=4)
    # rebuild the same scene through the port's SceneBuilder
    b = SceneBuilder()
    mats = {name: b.make_matte(c) for name, c in COLORS.items()}
    mats["mirror"] = b.make_mirror((0.9, 0.9, 0.9))
    for (p0, p1, p2), mat in WALLS:
        b.add_triangles(p0, p1, p2, mats[mat])
    b.add_triangles(*extra[0][0], mats["mirror"])
    b.add_triangles(*extra[1][0], b.make_glass(1.5))
    h = 0.15
    lt1 = ((0.5 - h, 0.999, -0.5 + h), (0.5 + h, 0.999, -0.5 + h),
           (0.5 + h, 0.999, -0.5 - h))
    lt2 = ((0.5 - h, 0.999, -0.5 + h), (0.5 - h, 0.999, -0.5 - h),
           (0.5 + h, 0.999, -0.5 - h))
    for lt in (lt1, lt2):
        b.add_area_light(*lt, (8.0, 8.0, 8.0), mats["white"])
    ours = b.build("cpu", max_leaf_size=4)
    _scene_tables_equal(ours, theirs)
    # and the array hand-over gives the same scene
    _scene_tables_equal(scene_from_arrays(scene_arrays(theirs), "cpu"),
                        theirs)


def test_cornell_bunny_matches():
    """The headline scene: 69,463 triangles, 16-wide tables."""
    theirs, cam_j = jax_cornell_bunny()
    ours, cam = cornell_bunny("cpu")
    assert ours.tables.width == 16 and ours.tris.num == 69463
    _scene_tables_equal(ours, theirs)
    for k, v in camera_arrays(cam_j).items():
        np.testing.assert_array_equal(getattr(cam, k).numpy(), v)


def test_camera_rays_match():
    cam_j = default_camera()
    cam = Camera.from_arrays(camera_arrays(cam_j), "cpu")
    rng = np.random.default_rng(0)
    x, y = (rng.random(4096).astype(np.float32) for _ in range(2))
    o, d = cam.get_rays_v3(torch.from_numpy(x), torch.from_numpy(y))
    oj, dj = cam_j.get_rays_v3(jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(o + d, oj + dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    made = Camera.make((0.5, 0.5, 1.5), (0.5, 0.5, 0.0), (0, 1, 0), 37.8,
                       1.0, device="cpu")
    for k, v in camera_arrays(cam_j).items():
        np.testing.assert_array_equal(getattr(made, k).numpy(), v)


def test_build_writes_only_into_build_dir():
    from rtjax_torch.kernels import _build
    lib = _build.bvh_library()
    assert lib.parent == _build.BUILD_DIR
    assert os.path.relpath(lib, _build.REPO_ROOT).startswith("build")
