"""Built-in demo scenes (port of rtjax.scenes).

``cornell_bunny`` is the reference demo: the Stanford bunny (translate ->
scale 2x -> translate chain) inside a Cornell box of 10 wall triangles with
a 2-triangle area light of radiance (15, 15, 15), seen by the reference
camera.  ``cornell_planes`` is the box and light without the bunny.
``instanced_bunnies`` is BASELINE.md's eval config 4 (16 instances of the
bunny on a floor under an area light, a two-level BVH), and
``instanced_bunnies_baked`` the same placements baked into one
single-level mesh.
"""

from __future__ import annotations

import os

import numpy as np

from .scene import mesh as mesh_mod
from .scene.camera import Camera
from .scene.scene import Scene, SceneBuilder
from .scene.transform import Transform, rotate, scale, translate

ASSET_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "assets")
BUNNY_PLY = os.path.abspath(os.path.join(ASSET_DIR, "bun_zipper.ply"))

# Cornell walls: left red, right green, rest white
_WALLS = [
    (((0, 0, 0), (0, 0, -1), (0, 1, -1)), "red"),
    (((0, 0, 0), (0, 1, 0), (0, 1, -1)), "red"),
    (((1, 0, 0), (1, 0, -1), (1, 1, -1)), "green"),
    (((1, 0, 0), (1, 1, 0), (1, 1, -1)), "green"),
    (((0, 0, 0), (1, 0, 0), (1, 0, -1)), "white"),
    (((0, 0, 0), (0, 0, -1), (1, 0, -1)), "white"),
    (((0, 1, 0), (1, 1, 0), (1, 1, -1)), "white"),
    (((0, 1, 0), (0, 1, -1), (1, 1, -1)), "white"),
    (((0, 0, -1), (1, 0, -1), (1, 1, -1)), "white"),
    (((0, 0, -1), (0, 1, -1), (1, 1, -1)), "white"),
]

_COLORS = {
    "red": (0.65, 0.05, 0.05),
    "green": (0.12, 0.45, 0.15),
    "white": (0.73, 0.73, 0.73),
    "brown": (0.62, 0.57, 0.54),
}


def _add_light(b: SceneBuilder, white: int) -> None:
    b.add_area_light((0.4, 0.999, -0.4), (0.6, 0.999, -0.4),
                     (0.6, 0.999, -0.6), (15.0, 15.0, 15.0), white)
    b.add_area_light((0.4, 0.999, -0.4), (0.4, 0.999, -0.6),
                     (0.6, 0.999, -0.6), (15.0, 15.0, 15.0), white)


def _camera(device) -> Camera:
    return Camera.make((0.5, 0.5, 1.5), (0.5, 0.5, 0.0), (0.0, 1.0, 0.0),
                       37.8, 1.0, device=device)


def cornell_bunny(device, bunny_path: str | None = None,
                  max_leaf_size: int | None = 8,
                  bunny_material: str = "matte",
                  floor: str = "matte") -> tuple[Scene, Camera]:
    """The reference demo scene + camera.  ``bunny_material``: "matte",
    "mirror" or "glass"; ``floor``: "matte" or "mirror"."""
    b = SceneBuilder()
    mats = {name: b.make_matte(c) for name, c in _COLORS.items()}
    if floor == "mirror":
        mirror_floor = b.make_mirror((0.9, 0.9, 0.9))

    mesh = mesh_mod.load_ply(bunny_path or BUNNY_PLY)
    t = Transform(translate(0.0946899, -0.0329874, -0.0587997))
    t.composite(scale(2.0, 2.0, 2.0))
    t.composite(translate(0.3, 0.0, -0.5))
    if bunny_material == "mirror":
        bunny_mat = b.make_mirror(_COLORS["brown"])
    elif bunny_material == "glass":
        bunny_mat = b.make_glass(1.5)
    else:
        bunny_mat = mats["brown"]
    b.add_mesh(mesh.vertices, mesh.faces, bunny_mat, transform=t)

    # walls 4 and 5 are the floor
    for i, ((p0, p1, p2), mat) in enumerate(_WALLS):
        if floor == "mirror" and i in (4, 5):
            b.add_triangles(p0, p1, p2, mirror_floor)
        else:
            b.add_triangles(p0, p1, p2, mats[mat])
    _add_light(b, mats["white"])

    scene = b.build(device, max_leaf_size=max_leaf_size)
    return scene, _camera(device)


def cornell_planes(device) -> tuple[Scene, Camera]:
    """Cornell planes + area light, no bunny."""
    b = SceneBuilder()
    mats = {name: b.make_matte(c) for name, c in _COLORS.items()}
    for (p0, p1, p2), mat in _WALLS:
        b.add_triangles(p0, p1, p2, mats[mat])
    _add_light(b, mats["white"])
    return b.build(device, max_leaf_size=8), _camera(device)


def _bunny_field(b: SceneBuilder, place, n_inst: int) -> None:
    """Config 4's floor, light and bunny placements: ``place(transform,
    material)`` adds one bunny."""
    white = b.make_matte((0.73, 0.73, 0.73))
    brown = b.make_matte((0.62, 0.57, 0.54))
    red = b.make_matte((0.65, 0.05, 0.05))
    b.add_triangles([-4, 0, 4], [4, 0, 4], [4, 0, -4], white)
    b.add_triangles([-4, 0, 4], [-4, 0, -4], [4, 0, -4], white)
    b.add_area_light((-1, 3.0, -1), (1, 3.0, -1), (1, 3.0, 1),
                     (40, 40, 40), white)
    rng = np.random.default_rng(3)
    for i in range(n_inst):
        t = Transform(translate(0.0946899, -0.0329874, -0.0587997))
        t.composite(scale(4.0, 4.0, 4.0))
        t.composite(rotate([0, 1, 0], rng.uniform(0, 6.28)))
        t.composite(translate((i % 4) * 1.6 - 2.4, 0.0,
                              (i // 4) * 1.6 - 2.4))
        place(t, brown if i % 2 else red)


def _field_camera(device) -> Camera:
    return Camera.make((0, 4.5, 7.5), (0, 0.6, 0), (0, 1, 0), 40, 1.0,
                       device=device)


def instanced_bunnies(device, n_inst: int = 16) -> tuple[Scene, Camera]:
    """Eval config 4 and its camera: ``n_inst`` instances of one bunny BLAS
    (16 x 69,451 = 1.11M effective triangles) over a 3-triangle base (floor
    quad + a one-triangle area light).  Counterpart of
    benchmarks/run_configs.py's config 4 (lines 198-226); render it at
    256x256 @ 8 spp, 5 bounces."""
    mesh = mesh_mod.load_ply(BUNNY_PLY)
    b = SceneBuilder()
    mid = b.register_mesh(mesh.vertices, mesh.faces)
    _bunny_field(b, lambda t, mat: b.add_instance(mid, mat, t), n_inst)
    return b.build(device), _field_camera(device)


def instanced_bunnies_baked(device) -> tuple[Scene, Camera]:
    """The scene of :func:`instanced_bunnies` with every placement baked
    into world-space triangles (``add_mesh(..., transform=t)``): one
    single-level BVH over 1.11M triangles, the control for the two-level
    path."""
    mesh = mesh_mod.load_ply(BUNNY_PLY)
    b = SceneBuilder()
    _bunny_field(b, lambda t, mat: b.add_mesh(mesh.vertices, mesh.faces, mat,
                                              transform=t), 16)
    return b.build(device), _field_camera(device)
