"""Scene aggregate and host-side scene builder (port of rtjax.scene.scene,
single-level scenes).

Triangles, prim tables and area-light triangle indices are all in BVH leaf
(permuted) order, so "same triangle" tests are plain int32 compares.
rtjax's TPU residency tiers (HBM leaf tables, meta in VMEM, packed node
rows) have no counterpart here: the tables sit in device memory as they
are.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..accel.builder_cpp import build_bvh
from ..accel.bvh import BvhArrays
from ..accel.wide import MAX_NODES16, WideTables, build_wide_tables
from ..constants import BVH_MAX_DEPTH, INVALID_INDEX
from ..core.geometry import Triangles
from .light import AREA_LIGHT, POINT_LIGHT, LightTable, make_light_arrays
from .material import MaterialBuilder, MaterialTable
from .transform import Transform

# prim -> material run chains longer than this fall back to a gather
MAT_RUN_LIMIT = 32


@dataclasses.dataclass(frozen=True)
class Scene:
    tris: Triangles
    bvh: BvhArrays
    materials: MaterialTable
    lights: LightTable
    prim_material: torch.Tensor  # [P] int32
    prim_light: torch.Tensor     # [P] int32 (INVALID_INDEX if not emissive)
    tables: WideTables | None    # None when max_leaf_size > 8 (no wide rows)
    num_lights: int
    # leaf-order prim -> material map as ((start, mat), ...) runs, or None
    mat_runs: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.tris.p0.device


def _material_runs(pm: np.ndarray) -> tuple | None:
    """Compress a leaf-order prim -> material map into ``((start, mat),
    ...)`` runs, or None when it has more than MAT_RUN_LIMIT runs."""
    if len(pm) == 0:
        return None
    starts = np.flatnonzero(np.diff(pm)) + 1
    if len(starts) + 1 > MAT_RUN_LIMIT:
        return None
    return tuple((int(s), int(pm[s])) for s in (0, *starts.tolist()))


class SceneBuilder:
    """Register materials, add triangles/meshes and lights, then
    :meth:`build` (BVH build + leaf-order permutation + wide tables)."""

    def __init__(self):
        self.materials = MaterialBuilder()
        self._p0: list[np.ndarray] = []
        self._p1: list[np.ndarray] = []
        self._p2: list[np.ndarray] = []
        self._mat: list[np.ndarray] = []
        self._num_tris = 0
        self._ltype: list[int] = []
        self._lpos: list[tuple] = []
        self._lemit: list[tuple] = []
        self._ltri: list[int] = []

    def make_matte(self, albedo) -> int:
        return self.materials.make_matte(albedo)

    def make_mirror(self, albedo) -> int:
        return self.materials.make_mirror(albedo)

    def make_glass(self, index_of_refraction: float) -> int:
        return self.materials.make_glass(index_of_refraction)

    def add_triangles(self, p0, p1, p2, material: int) -> np.ndarray:
        """Add a batch of triangles; returns their global indices."""
        p0 = np.atleast_2d(np.asarray(p0, np.float32))
        p1 = np.atleast_2d(np.asarray(p1, np.float32))
        p2 = np.atleast_2d(np.asarray(p2, np.float32))
        n = len(p0)
        self._p0.append(p0)
        self._p1.append(p1)
        self._p2.append(p2)
        self._mat.append(np.full(n, material, np.int32))
        idx = np.arange(self._num_tris, self._num_tris + n)
        self._num_tris += n
        return idx

    def add_mesh(self, vertices, faces, material: int,
                 transform: Transform | None = None) -> np.ndarray:
        """Add a triangle mesh; the transform is applied on the host."""
        v = np.asarray(vertices, np.float64)
        if transform is not None:
            v = transform.apply(v)
        f = np.asarray(faces, np.int64)
        return self.add_triangles(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], material)

    def add_point_light(self, pos, intensity) -> int:
        self._ltype.append(POINT_LIGHT)
        self._lpos.append(tuple(pos))
        self._lemit.append(tuple(intensity))
        self._ltri.append(INVALID_INDEX)
        return len(self._ltype) - 1

    def add_area_light(self, p0, p1, p2, radiance, material: int) -> int:
        """Add an emissive triangle (geometry + light)."""
        tri_idx = int(self.add_triangles(p0, p1, p2, material)[0])
        self._ltype.append(AREA_LIGHT)
        self._lpos.append((0.0, 0.0, 0.0))
        self._lemit.append(tuple(radiance))
        self._ltri.append(tri_idx)
        return len(self._ltype) - 1

    def register_mesh(self, vertices, faces) -> int:
        raise NotImplementedError(
            "instanced scenes are not ported yet (ROADMAP Queue A 12)")

    def add_instance(self, mesh_id: int, material: int, transform=None):
        raise NotImplementedError(
            "instanced scenes are not ported yet (ROADMAP Queue A 12)")

    def set_environment(self, radiance) -> None:
        raise NotImplementedError(
            "the environment light is not ported yet (ROADMAP Queue A 13)")

    def build(self, device, max_depth: int = BVH_MAX_DEPTH,
              max_leaf_size: int | None = 8,
              min_leaf_size: int | None = None) -> Scene:
        """Assemble the scene on ``device``; ``min_leaf_size`` defaults to
        ``max_leaf_size`` (filled leaf rows)."""
        if min_leaf_size is None:
            min_leaf_size = max_leaf_size if max_leaf_size else 1
        if self._num_tris == 0:
            raise ValueError("scene has no geometry")
        p0 = np.concatenate(self._p0)
        p1 = np.concatenate(self._p1)
        p2 = np.concatenate(self._p2)
        mat_idx = np.concatenate(self._mat)

        bmin = np.minimum(np.minimum(p0, p1), p2)
        bmax = np.maximum(np.maximum(p0, p1), p2)
        centers = (p0 + p1 + p2) / 3.0
        res = build_bvh(bmin, bmax, centers, max_depth=max_depth,
                        max_leaf_size=max_leaf_size,
                        min_leaf_size=min_leaf_size)

        perm = res.perm
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(len(perm))
        prim_light = np.full(self._num_tris, INVALID_INDEX, np.int32)
        ltri = list(self._ltri)
        for li, ti in enumerate(self._ltri):
            if ti != INVALID_INDEX:
                prim_light[ti] = li
                ltri[li] = int(inv_perm[ti])

        pp0, pp1, pp2 = p0[perm], p1[perm], p2[perm]
        tris = Triangles.from_vertices(pp0, pp1, pp2, device)
        te1 = (pp0 - pp1).astype(np.float32)
        te2 = (pp2 - pp0).astype(np.float32)
        tris_host = types.SimpleNamespace(p0=pp0.astype(np.float32), e1=te1,
                                          e2=te2, n=np.cross(te1, te2))

        tables = None
        if max_leaf_size is not None and max_leaf_size <= 8:
            # 16-wide whenever the collapsed tree fits the 16-wide node cap
            # (rtjax's rule, so both packages trace the same tables)
            width = 16 if res.num_nodes < 14 * MAX_NODES16 else 8
            tables = build_wide_tables(res, pp0, te1, te2,
                                       np.cross(te1, te2), device,
                                       width=width)

        return Scene(
            tris=tris,
            bvh=res.to_device(device),
            tables=tables,
            materials=_material_table(self.materials.arrays(), device),
            lights=LightTable.from_arrays(
                make_light_arrays(self._ltype, self._lpos, self._lemit, ltri,
                                  tris_host), device),
            prim_material=torch.tensor(mat_idx[perm], device=device),
            prim_light=torch.tensor(prim_light[perm], device=device),
            num_lights=len(self._ltype),
            mat_runs=_material_runs(mat_idx[perm]),
        )


def _material_table(arrays: dict, device) -> MaterialTable:
    return MaterialTable(**{k: torch.tensor(np.asarray(v), device=device)
                            for k, v in arrays.items()})


def scene_from_arrays(arrays: dict, device) -> Scene:
    """The port's Scene from another build's arrays: keys ``"tris.p0"``,
    ``"bvh.bmin"``, ``"materials.mtype"``, ``"lights.ltype"``,
    ``"tables.node_bounds"``, ``"prim_material"``, ... as NumPy arrays, plus
    the static fields ``"tables.width"``, ``"bvh.max_depth"``,
    ``"num_lights"`` and ``"mat_runs"`` as Python values (``tables.*`` may
    be absent for a scene without wide tables)."""
    t = lambda k: torch.tensor(np.asarray(arrays[k]), device=device)
    sub = lambda prefix: {k.split(".", 1)[1]: v for k, v in arrays.items()
                          if k.startswith(prefix + ".")}
    depth = int(arrays["bvh.max_depth"])
    tables = None
    if "tables.node_bounds" in arrays:
        tables = WideTables.from_arrays(sub("tables"),
                                        width=arrays["tables.width"],
                                        depth=depth, device=device)
    runs = arrays.get("mat_runs")
    return Scene(
        tris=Triangles(p0=t("tris.p0"), e1=t("tris.e1"), e2=t("tris.e2"),
                       n=t("tris.n")),
        bvh=BvhArrays(bmin=t("bvh.bmin"), bmax=t("bvh.bmax"),
                      left_first=t("bvh.left_first"),
                      num_prims=t("bvh.num_prims"), max_depth=depth),
        materials=_material_table(sub("materials"), device),
        lights=LightTable.from_arrays(sub("lights"), device),
        prim_material=t("prim_material"),
        prim_light=t("prim_light"),
        tables=tables,
        num_lights=int(arrays["num_lights"]),
        mat_runs=None if runs is None else tuple(tuple(r) for r in runs),
    )
