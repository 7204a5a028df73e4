"""Materials: SoA table + branchless batched BSDF sampling and evaluation
(port of rtjax.scene.material)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import INV_PI
from ..core import vec
from ..core.sampling import same_hemisphere_v3, uniform_sample_sphere_v3

MATTE = 0
MIRROR = 1
GLASS = 2


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    mtype: torch.Tensor   # [M] int32
    albedo: torch.Tensor  # [M, 3] float32
    ior: torch.Tensor     # [M] float32

    def gather(self, idx):
        """Per-lane ``(mtype, albedo [..., 3], ior)``; indices clamp."""
        mtype, albedo, ior = self.gather_v3(idx)
        return mtype, vec.to_array(albedo), ior

    def gather_v3(self, idx):
        """Per-lane ``(mtype, albedo triple, ior)``; indices clamp."""
        albedo = tuple(vec.take_rows(self.albedo[:, k], idx) for k in range(3))
        return (vec.take_rows(self.mtype, idx), albedo,
                vec.take_rows(self.ior, idx))


class MaterialBuilder:
    """Host-side material registry."""

    def __init__(self):
        self._mtype: list[int] = []
        self._albedo: list[tuple] = []
        self._ior: list[float] = []

    def _add(self, mtype, albedo, ior) -> int:
        self._mtype.append(mtype)
        self._albedo.append(albedo)
        self._ior.append(ior)
        return len(self._mtype) - 1

    def make_matte(self, albedo) -> int:
        return self._add(MATTE, tuple(albedo), 1.0)

    def make_mirror(self, albedo) -> int:
        return self._add(MIRROR, tuple(albedo), 1.0)

    def make_glass(self, index_of_refraction: float) -> int:
        return self._add(GLASS, (0.0, 0.0, 0.0), float(index_of_refraction))

    def arrays(self) -> dict:
        n = max(len(self._mtype), 1)
        out = dict(mtype=np.zeros(n, np.int32),
                   albedo=np.zeros((n, 3), np.float32),
                   ior=np.ones(n, np.float32))
        if self._mtype:
            out["mtype"][:] = self._mtype
            out["albedo"][:] = self._albedo
            out["ior"][:] = self._ior
        return out


def is_specular(mtype):
    return (mtype == MIRROR) | (mtype == GLASS)


def get_f_v3(mtype, albedo, unit_wo, unit_wi, unit_n):
    """BSDF evaluation for light-sampling MIS (matte only): ``(valid, f,
    pdf)``; ``valid`` is False for specular materials or same-side wo/wi."""
    valid = (mtype == MATTE) & same_hemisphere_v3(unit_wo, unit_wi, unit_n)
    f = vec.scale(INV_PI, albedo)
    pdf = vec.dot(unit_wi, unit_n) * INV_PI
    return valid, f, pdf


def get_f(mtype, albedo, unit_wo, unit_wi, unit_n):
    """:func:`get_f_v3` of ``[..., 3]`` tensors: ``(valid, f [..., 3],
    pdf)``."""
    a = vec.from_array
    valid, f, pdf = get_f_v3(mtype, a(albedo), a(unit_wo), a(unit_wi),
                             a(unit_n))
    return valid, vec.to_array(f), pdf


def sample_f_v3(mtype, albedo, ior, unit_wo, unit_n, u1, u2, u3):
    """Branchless BSDF sampling: ``(f, wi, pdf, n_out)``, every material
    branch computed and selected per lane.  ``unit_wo`` points into the
    surface; ``n_out`` is the possibly flipped normal for the spawn."""
    n_opp = vec.where(vec.dot(unit_wo, unit_n) > 0.0, vec.neg(unit_n), unit_n)

    wi_matte = vec.normalize(vec.add(n_opp, uniform_sample_sphere_v3(u1, u2)))
    pdf_matte = vec.dot(wi_matte, n_opp) * INV_PI
    f_matte = vec.scale(INV_PI, albedo)

    wi_mirror = vec.reflect(unit_wo, n_opp)
    pdf_mirror = torch.ones_like(pdf_matte)
    f_mirror = vec.scale(1.0 / vec.dot(wi_mirror, n_opp), albedo)

    cos_theta = vec.dot(unit_wo, unit_n)
    front = cos_theta < 0.0
    cos_theta = torch.abs(cos_theta)
    inv_cos = 1.0 / cos_theta
    eta_ratio = torch.where(front, 1.0 / ior, ior)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta_ratio * sin_theta > 1.0
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * vec.integer_pow(1.0 - cos_theta, 5)
    do_reflect = cannot_refract | (u3 < reflectance)

    n_front = vec.where(front, unit_n, vec.neg(unit_n))
    wi_refl = vec.reflect(unit_wo, n_front)
    pdf_refl = torch.where(cannot_refract, 1.0, reflectance)
    f_refl = torch.where(cannot_refract, inv_cos, reflectance * inv_cos)

    wi_refr = vec.refract(unit_wo, n_front, eta_ratio, cos_theta)
    pdf_refr = 1.0 - reflectance
    n_refr = vec.neg(n_front)
    # divides by the transmitted cosine (the already-flipped normal), as
    # the reference and rtjax do
    f_refr = pdf_refr * eta_ratio * eta_ratio / vec.dot(wi_refr, n_refr)

    wi_glass = vec.where(do_reflect, wi_refl, wi_refr)
    pdf_glass = torch.where(do_reflect, pdf_refl, pdf_refr)
    f_glass_s = torch.where(do_reflect, f_refl, f_refr)
    f_glass = (f_glass_s, f_glass_s, f_glass_s)
    n_glass = vec.where(do_reflect, n_front, n_refr)

    is_matte = mtype == MATTE
    is_mirror = mtype == MIRROR
    wi = vec.where(is_matte, wi_matte,
                   vec.where(is_mirror, wi_mirror, wi_glass))
    f = vec.where(is_matte, f_matte, vec.where(is_mirror, f_mirror, f_glass))
    pdf = torch.where(is_matte, pdf_matte,
                      torch.where(is_mirror, pdf_mirror, pdf_glass))
    n_out = vec.where(mtype == GLASS, n_glass, n_opp)
    return f, wi, pdf, n_out


def sample_f(mtype, albedo, ior, unit_wo, unit_n, u1, u2, u3):
    """:func:`sample_f_v3` of ``[..., 3]`` tensors: ``(f, wi, pdf,
    n_out)``, vectors ``[..., 3]``."""
    a = vec.from_array
    f, wi, pdf, n_out = sample_f_v3(mtype, a(albedo), ior, a(unit_wo),
                                    a(unit_n), u1, u2, u3)
    return vec.to_array(f), vec.to_array(wi), pdf, vec.to_array(n_out)
