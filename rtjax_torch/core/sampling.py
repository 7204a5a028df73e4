"""Sampling routines and MIS helpers (port of rtjax.core.sampling)."""

from __future__ import annotations

import torch

from ..constants import TWO_PI
from . import vec

# Wachter & Binder self-intersection offset: nudge the spawn origin along
# the normal by an integer number of ULPs, with a fixed-point fallback near
# zero.
_INT_SCALE = 256.0
_FLOAT_SCALE = 1.0 / 65536.0
_ORIGIN = 1.0 / 32.0


def _offset_component(p, n):
    of_i = torch.trunc(_INT_SCALE * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    nudged_bits = p_bits + torch.where(p < 0.0, -of_i, of_i)
    p_i = nudged_bits.view(torch.float32)
    return torch.where(torch.abs(p) < _ORIGIN, p + _FLOAT_SCALE * n, p_i)


def offset_ray_origin_v3(p, unit_n):
    """Robust self-intersection offset of a component-triple point."""
    return tuple(_offset_component(pk, nk) for pk, nk in zip(p, unit_n))


def offset_ray_origin(p, unit_n):
    """:func:`offset_ray_origin_v3` of ``[..., 3]`` tensors."""
    return vec.to_array(offset_ray_origin_v3(vec.from_array(p),
                                             vec.from_array(unit_n)))


def power_heuristic(f_pdf, g_pdf):
    """Power heuristic (beta = 2) MIS weight, both pdfs float."""
    f2 = f_pdf * f_pdf
    return f2 / (f2 + g_pdf * g_pdf)


def same_hemisphere_v3(wo, wi, n):
    """True when wo (pointing into the surface) and wi straddle n."""
    return vec.dot(wo, n) * vec.dot(wi, n) < 0.0


def same_hemisphere(wo, wi, n):
    """:func:`same_hemisphere_v3` of ``[..., 3]`` tensors."""
    return same_hemisphere_v3(vec.from_array(wo), vec.from_array(wi),
                              vec.from_array(n))


def uniform_sample_sphere_v3(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return (r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_sphere(u1, u2):
    """Uniform direction on the unit sphere, ``[..., 3]``."""
    return vec.to_array(uniform_sample_sphere_v3(u1, u2))


def random_in_unit_sphere(generator, shape, device):
    """Uniform points inside the unit ball, ``shape + (3,)``: a uniform
    direction scaled by a radius of CDF r^3 (the cube root of a uniform).
    rtjax draws from a JAX key; this draws from ``generator`` on
    ``device``, so the two agree in distribution only."""
    u = torch.rand((3,) + tuple(shape), generator=generator, device=device)
    d = uniform_sample_sphere(u[0], u[1])
    return d * torch.pow(u[2], 1.0 / 3.0)[..., None]


def uniform_sample_disk(u1, u2):
    """Uniform point on the unit disk: ``(x, y)``."""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def sample_triangle_barycentric(u1, u2):
    """Uniform barycentric (u, v) with p(u, v) = p0 - u*e1 + v*e2."""
    a = torch.sqrt(u1)
    return 1.0 - a, u2 * a
