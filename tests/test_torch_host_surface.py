"""rtjax's host and user surface in rtjax_torch, against rtjax on the CPU:
the NumPy builder, ``validate``, ``build_bvh_best``, ``Scene.build(builder=,
verbose=)``, the PLY writers, ``render()`` and the package exports.

- The NumPy builder's arrays equal rtjax's ``build_bvh_np``'s and the
  port's native build's, bit for bit.
- ``validate`` accepts a good build and raises on a corrupted child index
  and on a shrunken box, as rtjax's does.
- ``save_ply`` / ``save_ply_data`` files are byte-equal to rtjax's in all
  three formats and read back through the port's reader.
- ``render()`` is ``render_frame`` under a generator seeded ``seed`` bit for
  bit, and its image lies at the NumPy oracle's noise floor.
"""

import importlib
import logging
import types

import numpy as np
import pytest
import torch

import rtjax
from rtjax.accel import build_bvh_np as jax_build_np
from rtjax.accel import validate as jax_validate
from rtjax.scene import mesh as jax_mesh
from rtjax.utils.compare import mse

import rtjax_torch
from rtjax_torch import RenderConfig
from rtjax_torch.accel import build_bvh_best, build_bvh_np, validate
from rtjax_torch.accel import builder_cpp
from rtjax_torch.render import render, render_frame
from rtjax_torch.scene import mesh
from rtjax_torch.scene.camera import Camera
from rtjax_torch.scene.scene import SceneBuilder, scene_from_arrays

from oracle import render_oracle_image
from scenes import cornell, default_camera
from test_torch_scene import camera_arrays, scene_arrays


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p1 = (p0 + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    p2 = (p0 + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
    return (np.minimum(np.minimum(p0, p1), p2),
            np.maximum(np.maximum(p0, p1), p2), (p0 + p1 + p2) / 3.0)


def _same_build(a, b):
    assert (a.num_nodes, a.max_depth) == (b.num_nodes, b.max_depth)
    m = a.num_nodes
    for k in ("bmin", "bmax", "left_first", "num_prims"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k))[:m],
                                      np.asarray(getattr(b, k))[:m], k)
    np.testing.assert_array_equal(np.asarray(a.perm), np.asarray(b.perm))


# ------------------------------------------------------------- builders

@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_numpy_builder_matches_rtjax_and_the_native_build(leaf):
    bmin, bmax, cen = _soup(2000 if leaf > 1 else 1000, seed=leaf)
    ours = build_bvh_np(bmin, bmax, cen, max_leaf_size=leaf,
                        min_leaf_size=leaf)
    _same_build(ours, jax_build_np(bmin, bmax, cen, max_leaf_size=leaf,
                                   min_leaf_size=leaf))
    _same_build(ours, builder_cpp.build_bvh(bmin, bmax, cen,
                                            max_leaf_size=leaf,
                                            min_leaf_size=leaf))
    validate(ours, bmin, bmax)
    assert ours.num_nodes > 100


def _corrupt(res, how):
    res = types.SimpleNamespace(**vars(res))
    res.left_first = res.left_first.copy()
    res.bmax = res.bmax.copy()
    if how == "left_first":
        inner = np.flatnonzero(res.num_prims[:res.num_nodes] == 0)
        res.left_first[inner[len(inner) // 2]] = 0
    elif how == "box":
        res.bmax[0] = res.bmax[0] - 0.5
    return res


@pytest.mark.parametrize("how", ["good", "left_first", "box"])
def test_validate_agrees_with_rtjax(how):
    bmin, bmax, cen = _soup(300, seed=9)
    res = _corrupt(builder_cpp.build_bvh(bmin, bmax, cen, max_leaf_size=4),
                   how)
    if how == "good":
        validate(res, bmin, bmax)
        jax_validate(res, bmin, bmax)
        return
    with pytest.raises(AssertionError):
        validate(res, bmin, bmax)
    with pytest.raises(AssertionError):
        jax_validate(res, bmin, bmax)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append((record.levelname, record.getMessage()))


@pytest.fixture
def port_log():
    h = _Records()
    logger = logging.getLogger("rtjax_torch")
    logger.addHandler(h)
    yield h.lines
    logger.removeHandler(h)


@pytest.mark.parametrize("which", ["numpy", "auto_fails", "cpp_fails"])
def test_build_bvh_best_falls_back_to_numpy(which, port_log, monkeypatch):
    bmin, bmax, cen = _soup(200, seed=4)
    want = build_bvh_np(bmin, bmax, cen, max_leaf_size=8)
    if which != "numpy":
        def fail(*a, **k):
            raise RuntimeError("no compiler")
        monkeypatch.setattr(builder_cpp, "build_bvh", fail)
    if which == "cpp_fails":
        with pytest.raises(RuntimeError, match="no compiler"):
            build_bvh_best(bmin, bmax, cen, max_leaf_size=8, which="cpp")
        assert port_log == []
        return
    got = build_bvh_best(bmin, bmax, cen, max_leaf_size=8,
                         which="numpy" if which == "numpy" else "auto")
    _same_build(got, want)
    if which == "numpy":
        assert port_log == []
    else:
        assert len(port_log) == 1 and port_log[0][0] == "WARNING"
        assert "no compiler" in port_log[0][1] \
            and "falling back to the NumPy builder" in port_log[0][1]


def _pyramid(builder_cls):
    b = builder_cls()
    mat = b.make_matte((0.5, 0.6, 0.7))
    bmin, bmax, cen = _soup(120, seed=2)
    b.add_triangles(bmin, bmax, cen, mat)
    b.add_area_light((-1, 2, -1), (1, 2, -1), (0, 2, 1), (5.0, 5.0, 5.0),
                     mat)
    return b


def test_scene_build_logs_rtjax_lines_and_takes_either_builder(port_log):
    h = _Records()
    jlog = logging.getLogger("rtjax")
    jlog.addHandler(h)
    try:
        _pyramid(rtjax.SceneBuilder).build(verbose=True)
    finally:
        jlog.removeHandler(h)
    cpp = _pyramid(SceneBuilder).build("cpu", builder="cpp", verbose=True)
    assert len(h.lines) == 2 and port_log == h.lines
    assert port_log[0][1].startswith("Global bounding box: (")
    assert " nodes and 121 primitives, with max_depth = " in port_log[1][1]
    npy = _pyramid(SceneBuilder).build("cpu", builder="numpy")
    assert len(port_log) == 2    # verbose=False logs nothing
    for k in ("node_bounds", "child_meta", "node_info", "leaf_tris"):
        assert torch.equal(getattr(cpp.tables, k).nan_to_num(-7.0),
                           getattr(npy.tables, k).nan_to_num(-7.0)), k


# ------------------------------------------------------------------ PLY

FORMATS = ["ascii", "binary_little_endian", "binary_big_endian"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_save_ply_is_byte_equal_to_rtjax(tmp_path, fmt):
    rng = np.random.default_rng(3)
    v = rng.uniform(-1, 1, (12, 3))
    f = rng.integers(0, 12, (9, 3))
    kw = dict(binary=fmt != "ascii", big_endian=fmt == "binary_big_endian")
    mesh.save_ply(tmp_path / "ours.ply", mesh.Mesh(vertices=v, faces=f),
                  **kw)
    jax_mesh.save_ply(tmp_path / "theirs.ply",
                      jax_mesh.Mesh(vertices=v, faces=f), **kw)
    data = (tmp_path / "ours.ply").read_bytes()
    assert data == (tmp_path / "theirs.ply").read_bytes()
    assert f"format {fmt} 1.0".encode() in data
    back = mesh.load_ply(tmp_path / "ours.ply")
    want = v if fmt == "ascii" else v.astype(np.float32)
    np.testing.assert_array_equal(back.vertices, want)
    np.testing.assert_array_equal(back.faces, f)


def _ply_data(cls):
    """Every kind of property: float, uchar and double scalars, a list
    element of ragged rows, and an element mixing a list and a scalar."""
    rng = np.random.default_rng(8)
    d = cls(comments=["made by a test", "obj_info two comments"])
    d.add_element("vertex", {
        "x": rng.uniform(-1, 1, 5), "y": rng.uniform(-1, 1, 5),
        "z": rng.uniform(-1, 1, 5),
        "red": np.array([0, 64, 128, 200, 255], np.float64),
        "w": rng.uniform(0, 1e6, 5)},
        dtypes={"red": "u1", "w": "f8"})
    d.add_element("face", {"vertex_indices": [
        np.array([0, 1, 2]), np.array([1, 2, 3, 4]), np.array([4, 0, 3])]})
    d.add_element("edge", {
        "ends": [np.array([0, 1]), np.array([2, 3, 4])],
        "weight": np.array([-3.0, 7.0])},
        dtypes={"ends": ("u1", "u2"), "weight": "i2"})
    return d


@pytest.mark.parametrize("fmt", FORMATS)
def test_save_ply_data_is_byte_equal_to_rtjax(tmp_path, fmt):
    mesh.save_ply_data(tmp_path / "ours.ply", _ply_data(mesh.PlyData), fmt)
    jax_mesh.save_ply_data(tmp_path / "theirs.ply",
                           _ply_data(jax_mesh.PlyData), fmt)
    data = (tmp_path / "ours.ply").read_bytes()
    assert data == (tmp_path / "theirs.ply").read_bytes()
    back = mesh.load_ply_data(tmp_path / "ours.ply")
    want = jax_mesh.load_ply_data(tmp_path / "theirs.ply")
    assert back.comments == want.comments == [
        "comment made by a test", "obj_info two comments"]
    assert back.dtypes == want.dtypes == _ply_data(mesh.PlyData).dtypes
    for el, props in want.elements.items():
        for name, val in props.items():
            got = back.elements[el][name]
            if isinstance(val, list):
                assert len(got) == len(val)
                for a, b in zip(got, val):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(got, val)
    # a second write of what was read is the same file
    mesh.save_ply_data(tmp_path / "again.ply", back, fmt)
    assert (tmp_path / "again.ply").read_bytes() == data


def test_save_ply_data_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unsupported PLY format"):
        mesh.save_ply_data(tmp_path / "x.ply", _ply_data(mesh.PlyData),
                           "binary")


# --------------------------------------------------------------- render

@pytest.fixture(scope="module")
def box():
    jscene, osc = cornell(light_size=0.5, light_l=(4.0, 4.0, 4.0))
    jcam = default_camera()
    return (osc, jcam, scene_from_arrays(scene_arrays(jscene), "cpu"),
            Camera.from_arrays(camera_arrays(jcam), "cpu"))


def test_render_is_render_frame_under_a_seeded_generator(box):
    _, _, scene, cam = box
    fb = render(16, 16, 2, 3, cam, scene, seed=5, num_working_paths=512)
    cfg = RenderConfig(width=16, height=16, num_samples=2, max_bounces=3,
                       seed=5, num_working_paths=512)
    want, _ = render_frame(scene, cam, cfg, torch.Generator().manual_seed(5))
    assert fb.shape == (256, 3) and fb.dtype == torch.float32
    assert torch.equal(fb, want)
    other = render(16, 16, 2, 3, cam, scene, seed=6, num_working_paths=512)
    assert not torch.equal(fb, other)


def test_render_lies_at_the_oracle_noise_floor(box):
    osc, jcam, scene, cam = box
    w = h = 16
    img_o = render_oracle_image(osc, jcam, w, h, 600, 4, seed=5)
    img = render(w, h, 64, 4, cam, scene, seed=1,
                 num_working_paths=4096).numpy().reshape(h, w, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert abs(img_o.mean() - img.mean()) < 0.01
    assert mse(img_o, img) < 0.004


# -------------------------------------------------------------- exports

def _public(module):
    names = getattr(module, "__all__", None) or [
        n for n in dir(module) if not n.startswith("_")]
    return {n for n in names
            if not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("name", ["", ".scene", ".render", ".accel"],
                         ids=["package", "scene", "render", "accel"])
def test_port_exports_what_rtjax_exports(name):
    """Modules by import path: in both packages the package's ``render``
    is the function, which hides the ``render`` module's attribute."""
    theirs = importlib.import_module("rtjax" + name)
    ours = importlib.import_module("rtjax_torch" + name)
    want = _public(theirs)
    missing = want - _public(ours) - {"annotations"}
    assert len(want) > 4 and not missing, sorted(missing)
