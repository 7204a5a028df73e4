"""Lights: SoA table + batched NEE sampling and pdf evaluation (port of
rtjax.scene.light).  Area lights embed their emitter triangle so NEE never
gathers from the scene's triangle tables."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import INVALID_INDEX
from ..core import vec
from ..core.geometry import intersect_triangle_v3
from ..core.sampling import sample_triangle_barycentric

POINT_LIGHT = 0
AREA_LIGHT = 1

LIGHT_FIELDS = ("ltype", "pos", "emit", "tri", "tri_p0", "tri_e1", "tri_e2",
                "tri_n")


@dataclasses.dataclass(frozen=True)
class LightTable:
    ltype: torch.Tensor   # [L] int32
    pos: torch.Tensor     # [L, 3] float32 (point lights)
    emit: torch.Tensor    # [L, 3] float32 (intensity or radiance)
    tri: torch.Tensor     # [L] int32 leaf-order emitter triangle
    tri_p0: torch.Tensor  # [L, 3] emitter triangle (zero for point lights)
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor

    @property
    def num(self) -> int:
        return self.ltype.shape[0]

    @staticmethod
    def from_arrays(arrays: dict, device) -> "LightTable":
        return LightTable(**{k: torch.tensor(np.asarray(arrays[k]),
                                             device=device)
                             for k in LIGHT_FIELDS})


def make_light_arrays(ltype, pos, emit, tri, tris) -> dict:
    """Host light table; ``tris`` (leaf-ordered host triangles with
    p0/e1/e2/n) supplies the embedded emitter-triangle fields."""
    n = max(len(ltype), 1)
    out = dict(ltype=np.zeros(n, np.int32), pos=np.zeros((n, 3), np.float32),
               emit=np.zeros((n, 3), np.float32),
               tri=np.full(n, INVALID_INDEX, np.int32))
    for k in ("tri_p0", "tri_e1", "tri_e2", "tri_n"):
        out[k] = np.zeros((n, 3), np.float32)
    if len(ltype):
        out["ltype"][:len(ltype)] = ltype
        out["pos"][:len(ltype)] = pos
        out["emit"][:len(ltype)] = emit
        out["tri"][:len(ltype)] = tri
        for li, ti in enumerate(out["tri"][:len(ltype)]):
            if ti != INVALID_INDEX:
                out["tri_p0"][li] = tris.p0[ti]
                out["tri_e1"][li] = tris.e1[ti]
                out["tri_e2"][li] = tris.e2[ti]
                out["tri_n"][li] = tris.n[ti]
    return out


def is_delta(ltype):
    return ltype == POINT_LIGHT


def gather_light_v3(lights: LightTable, pick):
    """Per-lane light record ``(ltype, pos, emit, tri, tri_p0, tri_e1,
    tri_e2, tri_n)`` with vectors as component triples."""
    rows3 = lambda table: tuple(vec.take_rows(table[:, k], pick)
                                for k in range(3))
    return (vec.take_rows(lights.ltype, pick), rows3(lights.pos),
            rows3(lights.emit), vec.take_rows(lights.tri, pick),
            rows3(lights.tri_p0), rows3(lights.tri_e1),
            rows3(lights.tri_e2), rows3(lights.tri_n))


def sample_li_v3(lights: LightTable, pick, isect_p, u1, u2, rec=None):
    """NEE sample of the picked light: ``(unit_wi, Li, t, pdf, ltri)``."""
    ltype, pos, emit, ltri, tp0, te1, te2, tn = \
        rec if rec is not None else gather_light_v3(lights, pick)

    to_l = vec.sub(pos, isect_p)
    t_pt = vec.length(to_l)
    wi_pt = vec.scale(1.0 / t_pt, to_l)
    li_pt = vec.scale(1.0 / (t_pt * t_pt), emit)
    pdf_pt = torch.ones_like(t_pt)

    su, sv = sample_triangle_barycentric(u1, u2)
    tri_p = vec.add(vec.sub(tp0, vec.scale(su, te1)), vec.scale(sv, te2))
    n_len = vec.length(tn)
    pdf_area = 1.0 / (0.5 * n_len)
    to_a = vec.sub(tri_p, isect_p)
    dist_sq = vec.length_squared(to_a)
    t_ar = torch.sqrt(dist_sq)
    wi_ar = vec.scale(1.0 / t_ar, to_a)
    # area -> solid-angle pdf with |cos| (double-sided emitter)
    pdf_ar = pdf_area * dist_sq * n_len / vec.abs_dot(tn, wi_ar)

    is_pt = ltype == POINT_LIGHT
    unit_wi = vec.where(is_pt, wi_pt, wi_ar)
    li = vec.where(is_pt, li_pt, emit)
    t = torch.where(is_pt, t_pt, t_ar)
    pdf = torch.where(is_pt, pdf_pt, pdf_ar)
    return unit_wi, li, t, pdf, ltri


def pdf_li_v3(lights: LightTable, pick, isect_p, unit_wi, rec=None):
    """Solid-angle pdf of reaching the picked area light along ``unit_wi``
    (0 for point lights and misses)."""
    ltype, _, _, _, tp0, te1, te2, tn = \
        rec if rec is not None else gather_light_v3(lights, pick)
    hit, _, hu, hv = intersect_triangle_v3(
        isect_p, unit_wi, float("inf"), tp0, te1, te2, tn)
    lp = vec.add(vec.sub(tp0, vec.scale(hu, te1)), vec.scale(hv, te2))
    n_len = vec.length(tn)
    area = 0.5 * n_len
    pdf = vec.length_squared(vec.sub(lp, isect_p)) * n_len / (
        area * vec.abs_dot(tn, unit_wi))
    valid = (ltype == AREA_LIGHT) & hit
    return torch.where(valid, pdf, 0.0)
