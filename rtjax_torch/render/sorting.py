"""Ray sort keys, the stable multi-column sort, and the sort bundle's
packed encodings (port of rtjax.render.sorting).

Keys are int32; inactive lanes get 0x7FFFFFFF so they sort to the back.
The engine keys its dead lanes that still hold radiance 0x7FFFFFFE
(render/wavefront.py), so no live key may reach either value: every key
function here keeps live keys at or below ``MAX_LIVE_KEY``.
"""

from __future__ import annotations

import torch

from ..core import vec

INACTIVE_KEY = 0x7FFFFFFF
MAX_LIVE_KEY = 0x7FFFFFFD


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (Morton magic)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton(origin, lo, hi, cells_max):
    """Morton code of the origin's cell in a ``(cells_max + 1)^3`` grid
    over the scene root box (10 bits an axis at most)."""
    cells = []
    for k in range(3):
        g = (origin[k] - lo[k]) / torch.clamp(hi[k] - lo[k], min=1e-30)
        cells.append(torch.clamp(g * cells_max, 0.0, cells_max)
                     .to(torch.int32))
    return (_part1by2(cells[0]) | (_part1by2(cells[1]) << 1)
            | (_part1by2(cells[2]) << 2))


def _morton9(origin, lo, hi):
    """27-bit Morton code of the origin's cell in a 512^3 grid."""
    return _morton(origin, lo, hi, 511.0)


def _octant3_v3(direction):
    """3-bit octant of a component triple (bit k: component k < 0)."""
    return ((direction[0] < 0).to(torch.int32)
            | ((direction[1] < 0).to(torch.int32) << 1)
            | ((direction[2] < 0).to(torch.int32) << 2))



def ray_sort_keys_v3(origin, direction, lo, hi, active):
    """Octant-major keys: 3-bit octant | 27-bit origin Morton code."""
    key = (_octant3_v3(direction) << 27) | _morton9(origin, lo, hi)
    return torch.where(active, key, INACTIVE_KEY)


def ray_sort_keys_pos_v3(origin, direction, lo, hi, active):
    """Position-major keys: 27-bit origin Morton code | 3-bit octant."""
    key = (_morton9(origin, lo, hi) << 3) | _octant3_v3(direction)
    return torch.where(active, key, INACTIVE_KEY)


def ray_sort_keys_pos10_v3(origin, direction, lo, hi, active):
    """Finer position-major keys: the 30-bit origin Morton code of a
    1024^3 grid, no octant."""
    return torch.where(active, _morton(origin, lo, hi, 1023.0),
                       INACTIVE_KEY)


def _prim24(prim):
    return torch.clamp(prim, 0, (1 << 24) - 1)


def ray_sort_keys_prim_v3(prim, direction, active):
    """Tree-locality keys: 3-bit octant | 24-bit origin prim (leaf order is
    tree order; camera rays, prim -1, keep their slot order)."""
    key = (_octant3_v3(direction) << 24) | _prim24(prim)
    return torch.where(active, key, INACTIVE_KEY)


def ray_sort_keys_prim_pos_v3(prim, direction, active):
    """Prim-major keys: 24-bit origin prim | 3-bit octant."""
    key = (_prim24(prim) << 3) | _octant3_v3(direction)
    return torch.where(active, key, INACTIVE_KEY)


def ray_sort_keys_normal_pos_v3(origin, normal, lo, hi, active):
    """Position-major keys with the NORMAL's octant as the tie-break:
    27-bit origin Morton code | 3-bit normal octant."""
    key = (_morton9(origin, lo, hi) << 3) | _octant3_v3(normal)
    return torch.where(active, key, INACTIVE_KEY)


def ray_sort_keys_adaptive_v3(origin, normal, bounces, lo, hi, active,
                              deep_from=2):
    """Depth-adaptive keys: position-major (Morton | normal octant) below
    ``deep_from`` bounces, normal-octant-major (a top bit | octant |
    Morton) from there.

    rtjax's deep key reaches 0x7FFFFFFF at the far Morton corner with
    normal octant 7, the dead lanes' marker, and 0x7FFFFFFE one cell
    before it, the dirty dead lanes' key; live keys here are clamped to
    ``MAX_LIVE_KEY`` so that a live lane never sorts among the dead."""
    m = _morton9(origin, lo, hi)
    oc = _octant3_v3(normal)
    key = torch.where(bounces >= deep_from, (1 << 30) | (oc << 27) | m,
                      (m << 3) | oc)
    return torch.where(active, torch.clamp(key, max=MAX_LIVE_KEY),
                       INACTIVE_KEY)


def ray_sort_keys(origin, direction, lo, hi, active):
    """:func:`ray_sort_keys_v3` of ``[N, 3]`` origins and directions."""
    return ray_sort_keys_v3(vec.from_array(origin), vec.from_array(direction),
                            lo, hi, active)


def ray_sort_keys_prim(prim, direction, active):
    """:func:`ray_sort_keys_prim_v3` of ``[N, 3]`` directions."""
    return ray_sort_keys_prim_v3(prim, vec.from_array(direction), active)


def sort_permutation(keys):
    """Stable argsort and its inverse (for scattering results back)."""
    perm = torch.argsort(keys, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def sort_pytree_by_key(keys, tree):
    """Reorder every ``[N]`` tensor of a nested tuple by ascending ``keys``:
    one stable sort, then one gather per column.  Equal keys keep their
    slot order (deterministic images)."""
    return take_pytree(torch.sort(keys, stable=True).indices, tree)


def take_pytree(order, tree):
    """Gather every ``[N]`` tensor of a nested tuple at ``order``."""
    if isinstance(tree, tuple):
        return tuple(take_pytree(order, c) for c in tree)
    return tree[order]


def oct_encode_v3(n):
    """Component-triple direction -> one int32 (16+16-bit octahedral).
    Zero vectors encode to the +Z pole."""
    l1 = torch.abs(n[0]) + torch.abs(n[1]) + torch.abs(n[2])
    inv = 1.0 / torch.clamp(l1, min=1e-37)
    px, py = n[0] * inv, n[1] * inv
    sx = torch.where(px >= 0, 1.0, -1.0)
    sy = torch.where(py >= 0, 1.0, -1.0)
    fold = n[2] < 0
    px, py = (torch.where(fold, (1.0 - torch.abs(py)) * sx, px),
              torch.where(fold, (1.0 - torch.abs(px)) * sy, py))
    qx = torch.clamp((px + 1.0) * 32767.5, 0, 65535).to(torch.int32)
    qy = torch.clamp((py + 1.0) * 32767.5, 0, 65535).to(torch.int32)
    return (qx << 16) | qy


def oct_decode_v3(w):
    """Inverse of :func:`oct_encode_v3`; an unnormalised triple."""
    s = 2.0 / 65535.0
    px = ((w >> 16) & 0xFFFF).to(torch.float32) * s - 1.0
    py = (w & 0xFFFF).to(torch.float32) * s - 1.0
    z = 1.0 - torch.abs(px) - torch.abs(py)
    t = torch.clamp(-z, 0.0, 1.0)
    px = px + torch.where(px >= 0, -t, t)
    py = py + torch.where(py >= 0, -t, t)
    return (px, py, z)


def _f32_from_exponent(e):
    """2^(e - 127) built exactly from int32 exponent bits."""
    return (e << 23).view(torch.float32)


def rgb9e5_encode_v3(v):
    """Non-negative component triple -> one int32 (shared-exponent RGB9E5:
    9-bit mantissas under a 5-bit exponent).  Negative and NaN inputs clamp
    to 0; values above the format's max saturate."""
    maxv = 511.0 / 512.0 * 65536.0
    san = lambda c: torch.clamp(torch.where(torch.isfinite(c), c, 0.0),
                                0.0, maxv)
    r, g, b = san(v[0]), san(v[1]), san(v[2])
    m = torch.maximum(torch.maximum(r, g), b)
    eb = (torch.clamp(m, min=2e-10).view(torch.int32) >> 23) & 0xFF
    es = torch.clamp(eb - 127, -16, 15) + 1       # shared exponent
    scale = _f32_from_exponent(es + 118)          # 2^(es - 9)
    bump = torch.maximum(torch.maximum(torch.round(r / scale),
                                       torch.round(g / scale)),
                         torch.round(b / scale)) >= 512.0
    es = torch.where(bump, es + 1, es)
    scale = torch.where(bump, scale * 2.0, scale)
    enc = lambda c: torch.clamp(torch.round(c / scale), max=511.0) \
        .to(torch.int32)
    return enc(r) | (enc(g) << 9) | (enc(b) << 18) | ((es + 15) << 27)


def rgb9e5_decode_v3(w):
    """Inverse of :func:`rgb9e5_encode_v3` (exact for encoded values)."""
    es = (w >> 27) & 31
    scale = _f32_from_exponent(es + 103)
    return ((w & 511).to(torch.float32) * scale,
            ((w >> 9) & 511).to(torch.float32) * scale,
            ((w >> 18) & 511).to(torch.float32) * scale)
