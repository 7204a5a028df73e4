"""Scene aggregate and host-side scene builder (port of rtjax.scene.scene).

Triangles, prim tables and area-light triangle indices are all in BVH leaf
(permuted) order, so "same triangle" tests are plain int32 compares.
Instanced meshes (``register_mesh`` / ``add_instance``) each build one
bottom-level BVH (BLAS) in their local frame, shared by all their
instances; a hit is identified by ``(src, prim)``, src 0 being the base
scene and src k instance k - 1.  rtjax's TPU residency tiers (HBM leaf
tables, meta in VMEM, packed node rows, VMEM guards) have no counterpart
here: the tables sit in device memory as they are.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..accel import build_bvh_best
from ..accel.bvh import BvhArrays
from ..accel.instancing import (InstanceTable, MeshBlas, affine_rows,
                                instance_world_aabb)
from ..accel.wide import (MAX_NODES16, InstancedTables, WideTables,
                          build_instanced_tables, build_wide_tables,
                          prims_fit)
from ..constants import BVH_MAX_DEPTH, INVALID_INDEX
from ..core.geometry import Triangles
from ..utils.log import logger
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
    instances: InstanceTable | None = None  # None for a single-level scene
    blas: tuple = ()                        # MeshBlas per registered mesh
    # base + BLAS tables for the two-level kernels, or None
    inst_tables: InstancedTables | None = None
    # [3] float32 constant environment radiance added on a miss (zero:
    # no environment light); None is taken as zero on the scene's device
    env_radiance: torch.Tensor | None = None

    def __post_init__(self):
        if self.env_radiance is None:
            object.__setattr__(self, "env_radiance", torch.zeros(
                3, dtype=torch.float32, device=self.tris.p0.device))

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
        self._blas_meshes: list[tuple] = []   # (vertices, faces)
        self._instances: list[tuple] = []     # (mesh id, matrix, material)
        self._env = (0.0, 0.0, 0.0)

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
        """Register a unique mesh for instancing; returns its mesh id."""
        self._blas_meshes.append((np.asarray(vertices, np.float64),
                                  np.asarray(faces, np.int64)))
        return len(self._blas_meshes) - 1

    def add_instance(self, mesh_id: int, material: int,
                     transform: Transform | np.ndarray | None = None) -> int:
        """Place an instance of a registered mesh.  Unlike :meth:`add_mesh`
        the transform is not baked into triangles: all instances of a mesh
        share its BLAS.  The matrix is copied, so changing the Transform
        afterwards does not move the instance."""
        m = np.eye(4)
        if transform is not None:
            m = transform.matrix if isinstance(transform, Transform) \
                else np.asarray(transform, np.float64)
        self._instances.append((mesh_id, np.array(m, np.float64), material))
        return len(self._instances) - 1

    def set_environment(self, radiance) -> None:
        """Constant environment radiance added where a path misses."""
        self._env = tuple(float(c) for c in radiance)

    def build(self, device, max_depth: int = BVH_MAX_DEPTH,
              max_leaf_size: int | None = 8,
              min_leaf_size: int | None = None,
              builder: str = "auto", verbose: bool = False) -> Scene:
        """Assemble the scene on ``device``; ``min_leaf_size`` defaults to
        ``max_leaf_size`` (filled leaf rows).  ``builder`` picks the BVH
        builder of the scene and of every BLAS (``accel.build_bvh_best``:
        "auto", "cpp" or "numpy"); ``verbose`` logs the global box and the
        node count with the tree's depth, the reference's two lines.

        Wide tables are built where ``max_leaf_size <= 8`` and the mesh's
        prim ids fit the leaf rows (``accel.wide.prims_fit``, below 2^24
        triangles); a scene or BLAS without them renders on the binary
        walk, as in rtjax."""
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
        res = build_bvh_best(bmin, bmax, centers, max_depth=max_depth,
                             max_leaf_size=max_leaf_size,
                             min_leaf_size=min_leaf_size, which=builder)
        if verbose:
            lo, hi = bmin.min(0), bmax.max(0)
            logger.info(f"Global bounding box: ({lo[0]:.6g}, {lo[1]:.6g}, "
                        f"{lo[2]:.6g}) ({hi[0]:.6g}, {hi[1]:.6g}, "
                        f"{hi[2]:.6g})")
            logger.info(f"BVH has {res.num_nodes} nodes and "
                        f"{self._num_tris} primitives, with max_depth = "
                        f"{res.max_depth}")

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

        wide = max_leaf_size is not None and max_leaf_size <= 8
        base_wide = lambda w: build_wide_tables(res, pp0, te1, te2,
                                                np.cross(te1, te2), device,
                                                width=w)
        tables = None
        if wide and prims_fit(self._num_tris):
            # 16-wide whenever the collapsed tree fits the 16-wide node cap
            # (rtjax's rule, so both packages trace the same tables)
            tables = base_wide(16 if res.num_nodes < 14 * MAX_NODES16 else 8)

        instances, blas, inst_tables = None, (), None
        if self._instances:
            meshes = self._build_blas(max_depth, max_leaf_size,
                                      min_leaf_size, builder, device)
            instances = self._instance_table(meshes, device)
            width = tables.width if tables is not None else 8
            blas = self._blas_tables(meshes, width if wide else None, device)
            if tables is not None:
                if width != 8 and all(b.tables is not None for b in blas) \
                        and tables.num_wide_nodes + sum(
                            b.tables.num_wide_nodes for b in blas) \
                        >= MAX_NODES16:
                    # the concatenated 16-wide node table would reach the
                    # 16-wide node cap: base and BLAS go 8-wide together
                    tables = base_wide(8)
                    blas = self._blas_tables(meshes, 8, device)
                inst_tables = build_instanced_tables(
                    tables, bmin.min(0), bmax.max(0),
                    [b.tables for b in blas], instances, device)

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
            instances=instances,
            blas=blas,
            inst_tables=inst_tables,
            env_radiance=torch.tensor(self._env, dtype=torch.float32,
                                      device=device),
        )

    def _build_blas(self, max_depth, max_leaf_size, min_leaf_size, builder,
                    device):
        """Binary BVH of every registered mesh in its local frame: per mesh
        ``(build, leaf-order p0, e1, e2, Triangles, (lo, hi))``."""
        out = []
        for verts, faces in self._blas_meshes:
            p0 = verts[faces[:, 0]].astype(np.float32)
            p1 = verts[faces[:, 1]].astype(np.float32)
            p2 = verts[faces[:, 2]].astype(np.float32)
            bmin = np.minimum(np.minimum(p0, p1), p2)
            bmax = np.maximum(np.maximum(p0, p1), p2)
            res = build_bvh_best(bmin, bmax, (p0 + p1 + p2) / 3.0,
                                 max_depth=max_depth,
                                 max_leaf_size=max_leaf_size,
                                 min_leaf_size=min_leaf_size or 1,
                                 which=builder)
            perm = res.perm
            pp0, pp1, pp2 = p0[perm], p1[perm], p2[perm]
            out.append((res, pp0, pp0 - pp1, pp2 - pp0,
                        Triangles.from_vertices(pp0, pp1, pp2, device),
                        (bmin.min(0), bmax.max(0))))
        return out

    @staticmethod
    def _blas_tables(meshes, width, device) -> tuple:
        """MeshBlas per mesh, with ``width``-wide tables (None: none, and
        none for a mesh whose prim ids do not fit the leaf rows)."""
        return tuple(
            MeshBlas(tris=tris, bvh=res.to_device(device),
                     tables=build_wide_tables(
                         res, pp0, te1, te2, np.cross(te1, te2), device,
                         width=width)
                     if width is not None and prims_fit(len(pp0)) else None)
            for res, pp0, te1, te2, tris, _ in meshes)

    def _instance_table(self, meshes, device) -> InstanceTable:
        """Affine rows, cofactors (float64, then float32), world bounds and
        materials of every instance."""
        n_inst = len(self._instances)
        fwd = np.zeros((n_inst, 3, 4), np.float32)
        inv = np.zeros((n_inst, 3, 4), np.float32)
        nrm = np.zeros((n_inst, 3, 3), np.float32)
        lo = np.zeros((n_inst, 3), np.float32)
        hi = np.zeros((n_inst, 3), np.float32)
        mats = np.zeros(n_inst, np.int32)
        for i, (mid, m, mat) in enumerate(self._instances):
            m64 = np.asarray(m, np.float64)
            fwd[i] = affine_rows(m64)
            inv[i] = affine_rows(np.linalg.inv(m64))
            m3 = m64[:3, :3]
            nrm[i] = np.linalg.det(m3) * np.linalg.inv(m3).T
            lo[i], hi[i] = instance_world_aabb(*meshes[mid][5], m)
            mats[i] = mat
        t = lambda a: torch.tensor(a, device=device)
        return InstanceTable(fwd=t(fwd), inv=t(inv), nrm=t(nrm),
                             aabb_lo=t(lo), aabb_hi=t(hi), material=t(mats),
                             mesh_id=tuple(int(m[0]) for m in self._instances))


def _material_table(arrays: dict, device) -> MaterialTable:
    return MaterialTable(**{k: torch.tensor(np.asarray(v), device=device)
                            for k, v in arrays.items()})


def _sub(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + ".")}


def _geometry_from_arrays(arrays: dict, device) -> tuple:
    """``(Triangles, BvhArrays, WideTables | None)`` from ``tris.*``,
    ``bvh.*`` and ``tables.*`` keys."""
    t = lambda k: torch.tensor(np.asarray(arrays[k]), device=device)
    depth = int(arrays["bvh.max_depth"])
    tables = None
    if "tables.node_bounds" in arrays:
        tables = WideTables.from_arrays(_sub(arrays, "tables"),
                                        width=arrays["tables.width"],
                                        depth=depth, device=device)
    return (Triangles(p0=t("tris.p0"), e1=t("tris.e1"), e2=t("tris.e2"),
                      n=t("tris.n")),
            BvhArrays(bmin=t("bvh.bmin"), bmax=t("bvh.bmax"),
                      left_first=t("bvh.left_first"),
                      num_prims=t("bvh.num_prims"), max_depth=depth),
            tables)


def scene_from_arrays(arrays: dict, device) -> Scene:
    """The port's Scene from another build's arrays: keys ``"tris.p0"``,
    ``"bvh.bmin"``, ``"materials.mtype"``, ``"lights.ltype"``,
    ``"tables.node_bounds"``, ``"prim_material"``, ... as NumPy arrays, plus
    the static fields ``"tables.width"``, ``"bvh.max_depth"``,
    ``"num_lights"`` and ``"mat_runs"`` as Python values (``tables.*`` may
    be absent for a scene without wide tables).

    An instanced build adds ``"instances.fwd"``, ... with the static
    ``"instances.mesh_id"``; per registered mesh k the same ``tris.*``,
    ``bvh.*`` and ``tables.*`` keys under ``"blas.<k>."``; and
    ``"inst_tables.root"``, ``"inst_tables.affine"`` and
    ``"inst_tables.wide.*"`` when it has two-level tables.  An optional
    ``"env_radiance"`` (3 floats) sets the environment light (zero when
    absent)."""
    t = lambda k: torch.tensor(np.asarray(arrays[k]), device=device)
    tris, bvh, tables = _geometry_from_arrays(arrays, device)
    runs = arrays.get("mat_runs")
    instances, blas, inst_tables = None, (), None
    if "instances.fwd" in arrays:
        instances = InstanceTable(
            **{k: t(f"instances.{k}") for k in
               ("fwd", "inv", "nrm", "aabb_lo", "aabb_hi", "material")},
            mesh_id=tuple(int(m) for m in arrays["instances.mesh_id"]))
        blas = []
        while f"blas.{len(blas)}.tris.p0" in arrays:
            blas.append(MeshBlas(*_geometry_from_arrays(
                _sub(arrays, f"blas.{len(blas)}"), device)))
        blas = tuple(blas)
    if "inst_tables.root" in arrays:
        depth = max([bvh.max_depth] + [b.bvh.max_depth for b in blas])
        wide = WideTables.from_arrays(_sub(arrays, "inst_tables.wide"),
                                      width=arrays["inst_tables.wide.width"],
                                      depth=depth, device=device)
        inst_tables = InstancedTables(wide=wide, root=t("inst_tables.root"),
                                      affine=t("inst_tables.affine"))
    return Scene(
        tris=tris,
        bvh=bvh,
        materials=_material_table(_sub(arrays, "materials"), device),
        lights=LightTable.from_arrays(_sub(arrays, "lights"), device),
        prim_material=t("prim_material"),
        prim_light=t("prim_light"),
        tables=tables,
        num_lights=int(arrays["num_lights"]),
        mat_runs=None if runs is None else tuple(tuple(r) for r in runs),
        instances=instances,
        blas=blas,
        inst_tables=inst_tables,
        env_radiance=(t("env_radiance").to(torch.float32)
                      if "env_radiance" in arrays else None),
    )
