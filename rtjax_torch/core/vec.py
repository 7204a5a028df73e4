"""Vector math over component triples ``(x, y, z)`` of ``[N]`` tensors.

The port of rtjax.core.v3 (plus the small-table row lookup of
rtjax.core.tables).  Per-lane vector state stays a 3-tuple of ``[N]``
tensors, as in rtjax, so that the two packages compare field for field.
Every expression keeps rtjax's operation order: float results then agree
bitwise wherever both sides round the same IEEE operations.
"""

from __future__ import annotations

import torch


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    """Hadamard product."""
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(s, a):
    """Scalar (or per-lane scalar) times vector."""
    return (s * a[0], s * a[1], s * a[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def abs_dot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length_squared(a):
    return dot(a, a)


def length(a):
    return torch.sqrt(length_squared(a))


def normalize(a):
    """1/length then scale (not rsqrt), like rtjax."""
    inv = 1.0 / length(a)
    return scale(inv, a)


def vmax(a):
    return torch.maximum(torch.maximum(a[0], a[1]), a[2])


def where(mask, a, b):
    """Per-lane select; ``mask`` is ``[N]``."""
    return (torch.where(mask, a[0], b[0]),
            torch.where(mask, a[1], b[1]),
            torch.where(mask, a[2], b[2]))


def reflect(v, unit_n):
    d = 2.0 * dot(v, unit_n)
    return (v[0] - d * unit_n[0], v[1] - d * unit_n[1], v[2] - d * unit_n[2])


def refract(unit_v, unit_n, eta_ratio, cos_theta):
    """Refraction with precomputed incident cosine; the sqrt argument is
    clamped so masked lanes cannot produce NaN."""
    par = scale(eta_ratio, add(unit_v, scale(cos_theta, unit_n)))
    perp_sq = torch.clamp(1.0 - length_squared(par), min=0.0)
    k = -torch.sqrt(perp_sq)
    return add(par, scale(k, unit_n))


def isfinite(a):
    """All three components finite, per lane."""
    return torch.isfinite(a[0]) & torch.isfinite(a[1]) & torch.isfinite(a[2])


def integer_pow(x, y: int):
    """``x ** y`` for a static positive int, by the same square-and-multiply
    chain as JAX's ``lax.integer_pow`` (so the rounding matches it)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def take_rows(table, idx):
    """``table[idx]`` with out-of-range indices clamped to the table
    (rtjax.core.tables.take_rows semantics)."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]
