"""The fused wavefront step: one iteration's per-lane stages as three
hand-written CUDA kernels around one stable key sort, their wrappers, and
their plain PyTorch versions.

rtjax runs an iteration (rtjax/render/wavefront.py:187-818) as one jitted
XLA program whose per-lane math XLA fuses into a few loops; it reaches no
``pallas_call``.  The port's op-by-op step (render/wavefront.py, on the
card only under ``step_kernels=False``) runs the same math as some 1,700
small torch ops an iteration.  Here it is three kernels
(``csrc/step_kernels.cu``, their device functions ``csrc/step_math.cuh``):

- ``route`` (rtjax :212-262 and the key and pack half of :263-436):
  emission, the environment light, Russian roulette, the material mask,
  the hit point, the ``sort_key`` key (``DIRTY_KEY`` for a dead slot that
  still holds radiance) and the compact sort bundle, encoded; it counts
  the continuing paths;
- the stable key sort between them (kernels/sort.py ``stable_order``,
  a hand-written radix sort; its plain version ``torch.sort(keys,
  stable=True)``), rtjax's ``lax.sort``;
- ``shade`` (rtjax :437-747): the bundle gathered by the sort's order (by
  the identity on a ``sort_every`` skip iteration, decided on the device)
  and decoded; NEE and both MIS channels, camera generation into the dead
  suffix, the framebuffer flush and the merge.  It writes the next path
  rays and state, and both shadow channels into ``[2N]`` columns that the
  one any-hit launch reads, and counts the path, NEE and BSDF-MIS rays.
  Only the dirty window (sorted positions ``[counts[0], counts[0] +
  counts[4])``) holds radiance to flush;
- ``resolve`` (rtjax :748-818): the shadow results added to the radiance,
  and the step's counters.

They cover every mode (:func:`step_mode`, render/wavefront.py
``step_kernels_cover``): the sorted engine with the compact bundle and,
as the full-record modes, its wide bundle, rtjax's unsorted engine and
``reference_parity``; each with one-sample MIS (but parity, which
refuses it) and ``detailed_stats`` (:data:`MODE_KERNELS`).  A CUDA tensor
goes to the kernels (built at first use, bound with ctypes, launched on
torch's current stream so that a captured graph holds them); a CPU tensor
to the plain versions.  There is no fallback between them.

Contract (the kernels' and the plain versions'):

- :func:`route` ``(scene, cfg, state, words) -> (keys [N] i32, bundle [N,
  10] i32, counts [5] i64)``.  ``words`` is the iteration's ``[5, N]`` int64
  block.  The bundle holds one 40-byte record a lane (:func:`pack_bundle`):
  the hit point x, y, z (float32 bits), RGB9E5 throughput, RGB9E5
  radiance, ``pixel | bounces << 21 | mat << 28`` (bounces clamped to 127,
  the dead sentinel), ``(prim + 1) | src << 23``, the octahedral normal
  and direction, the hit's material index (render/trace.py
  ``_hit_material_index``, clamped to the table).
  ``counts`` holds the continuing paths in [0], the dead lanes that still
  hold radiance (the dirty key class) in [4], and zeros, which
  :func:`shade` fills.
- :func:`shade` ``(scene, camera, cfg, state, fb, words, order, bundle,
  counts, it, cam_start, sort_every) -> Shaded``: the next path state
  (pixel, rays, throughput, bounces, the radiance after the flush), the
  traced mask, ``counts`` [1:] (path rays, NEE rays, BSDF-MIS rays), and
  with lights the shadow rays ``(origin, direction, tmax, exclude,
  mask)``, ``[2N]`` columns (NEE first, BSDF-MIS second), with the two
  channels' radiance.  The flush is added into ``fb`` in place.  The kernel
  writes the next state into ``state``'s own tensors and ``counts`` in
  place; the plain version returns new tensors.
- :func:`resolve` ``(cfg, sh, occluded, it, sort_every, cam_start,
  rays_traced, occ_sum, hits, hist) -> (acc, cam_start, work_left,
  rays_traced, occ_sum[, hist])``: ``occluded`` the ``[2N]`` any-hit
  result (None without lights), ``hits`` the path rays' closest hits,
  ``hist`` the bounce histogram (``detailed_stats``).  The kernel adds
  into ``sh.acc`` and ``hist`` in place.

The kernels mirror the plain versions op for op (the build uses
``--fmad=false``): every output agrees bit for bit but the framebuffer,
whose float atomic adds take another order than ``index_add_``'s (an
ordered flush cost more device time than it was allowed: PERF.md).

The first design (kept for same-run A/B and on no default path:
:func:`route_v1` / :func:`shade_v1`, ``V1_LAUNCHES``) writes the bundle as
nine ``[N]`` columns, ``[9, N]``, and gathers it column by column.

The full-record modes (:func:`route_full`, :func:`shade_full`,
:func:`resolve_full`; their kernels by mode in :data:`MODE_KERNELS`)
carry each lane's state at full precision in a 96-byte record
(:func:`pack_full`; the compact bundle's RGB9E5 codecs would change the
throughput and radiance), with no sort on the unsorted engine and, under
``reference_parity``, a sort by the keys without the dirty class.  Their
camera rays go by the exclusive prefix sum of the lanes that take one
(neither continuing nor in roulette's limbo), which shade computes by a
single-pass scan with decoupled look-back (:func:`scan_buffer`); every
such lane flushes.  Under parity, resolve restores each limbo lane's hit
from the record.  On the unsorted engine without parity route and shade
are one kernel (:func:`route_shade_unsorted`), the record kept in
registers.  The sorted engine's wide bundle ("wide", beyond
:func:`compact_bundle_ok`) is the default estimator over the full record
(the hit point in its origin words): keyed with the dirty class, the
camera rays into the dead suffix, the flush from the dirty window.

One-sample MIS (``*_1s``): shade emits the N NEE shadow rays alone (the
BSDF-MIS channel reuses the path sample, its mask in
``Shaded.chs_mask``) and resolve reads the path rays' closest hits for
the channel.  ``detailed_stats`` (``*_stats``): resolve adds the traced
lanes to the bounce histogram.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from ..config import SORT_KEYS
from ..constants import DEAD_BOUNCES, INVALID_INDEX
from ..core import rng, vec
from ..core.geometry import intersect_triangle_v3, spawn_offset_ray_v3
from ..core.sampling import power_heuristic
from ..render.sorting import (oct_decode_v3, oct_encode_v3,
                              ray_sort_keys_adaptive_v3,
                              ray_sort_keys_normal_pos_v3,
                              ray_sort_keys_pos10_v3, ray_sort_keys_pos_v3,
                              ray_sort_keys_prim_pos_v3,
                              ray_sort_keys_prim_v3, ray_sort_keys_v3,
                              rgb9e5_decode_v3, rgb9e5_encode_v3)
from ..render.trace import (_hit_material_index, gather_hit_materials_v3,
                            resolve_mode)
from ..scene.light import gather_light_v3, is_delta, pdf_li_v3, sample_li_v3
from ..scene.material import get_f_v3, is_specular, sample_f_v3
from . import _build

# random word ids: each word splits into two 16-bit uniforms
W_RR_PICK = 0      # (RR uniform, light pick)
W_BSDF1 = 1        # (u1, u2); the glass uniform u3 aliases u1
W_LIGHT_UV = 2     # light-triangle barycentrics
W_BSDF2 = 3        # (u1, u2); u3 aliases u1
W_GEN = 4          # subpixel jitter
NUM_RNG_WORDS = 5

DIRTY_KEY = 0x7FFFFFFE   # dead lanes that still hold radiance
BUNDLE_ROWS = 10         # int32 words of a lane's bundle record
V1_BUNDLE_ROWS = 9       # the first design's [9, N] column bundle
W_MATERIAL = 9           # the record's word of the hit's material index
# continuing paths, path rays, NEE rays, MIS rays, dirty lanes (limbo
# lanes in the full-record modes)
NUM_COUNTS = 5
# the full-precision record of the unsorted engine and reference_parity:
# 24 int32 words (96 B, six 16-byte loads) a lane, FULL_LAYOUT's fields
FULL_ROWS = 24
FULL_LAYOUT = (("ray_o", 0, 3), ("t", 3, 1), ("ray_d", 4, 3),
               ("pixel", 7, 1), ("normal", 8, 3), ("prim", 11, 1),
               ("beta", 12, 3), ("src", 15, 1), ("acc", 16, 3),
               ("bounces", 19, 1), ("flags", 20, 1), ("material", 21, 1))
# lanes a shade block ranks in the full-record modes (csrc kShadeBlock):
# the camera rank's scan keeps a ticket, a count of finished blocks and one
# status word a block (:func:`scan_buffer`)
SCAN_BLOCK = 128
# the step's engines and the kernels each launches under the default
# estimator without detailed_stats
ENGINE_KERNELS = {
    "default": ("route", "shade", "resolve"),
    "unsorted": ("route_shade_unsorted", "resolve"),
    "wide": ("route_wide", "shade_wide", "resolve"),
    "parity": ("route_parity", "shade_parity", "resolve_parity"),
    "parity_unsorted": ("route_parity_unsorted", "shade_parity_unsorted",
                        "resolve_parity")}
ONE_SAMPLE, STATS = "_1s", "_stats"   # the modes' suffixes


def _mode_kernels():
    """``{mode: kernels}``: each engine alone, with one-sample MIS (its
    shade and resolve instances ``*_1s``; not under parity, which refuses
    it) and with ``detailed_stats`` (its resolve instance ``*_stats``)."""
    out = {}
    for engine, (*route, shade_k, resolve_k) in ENGINE_KERNELS.items():
        for one in (False,) if engine.startswith("parity") else (False, True):
            for stats in (False, True):
                sfx = ONE_SAMPLE * one + STATS * stats
                out[engine + sfx] = (*route, shade_k + ONE_SAMPLE * one,
                                     resolve_k + sfx)
    return out


# the step kernels' modes (:func:`step_mode`) and the kernels each launches
MODE_KERNELS = _mode_kernels()

# the kernels the fused step runs: "record" (the default) or "v1"; a
# captured step belongs to the design it was captured under (render/graph.py
# keys its cache on it)
DESIGN = "record"

# kernel launches (wrapper, CUDA path) and plain-version calls, by kernel
LAUNCHES = {k: 0 for ks in MODE_KERNELS.values() for k in ks}
V1_LAUNCHES = {"route": 0, "shade": 0}
REF_CALLS = dict(LAUNCHES)

_lock = threading.Lock()
_lib = None


# ------------------------------------------------- the step's shared math

def accum(acc, value, mask):
    """Add ``value`` where ``mask`` and the contribution is finite
    (degenerate samples produce the occasional inf/NaN; they are dropped)."""
    ok = mask & vec.isfinite(value)
    return tuple(a + torch.where(ok, c, 0.0) for a, c in zip(acc, value))


def sort_keys(scene, cfg, state, hp, bounces, mat_mask):
    """The sort keys of ``cfg.sort_key`` (rtjax's dispatch): the origin
    prim, the hit point ``hp`` with the incoming direction, or the hit
    point with the normal (``adaptive`` by ``bounces`` too); the Morton
    grids span the scene's root box."""
    key = cfg.sort_key
    if key in ("prim", "prim_pos"):
        f = ray_sort_keys_prim_v3 if key == "prim" \
            else ray_sort_keys_prim_pos_v3
        return f(torch.where(mat_mask, state.prim, -1), state.ray_d,
                 mat_mask)
    lo, hi = scene.bvh.bmin[0], scene.bvh.bmax[0]
    if key == "normal_pos":
        return ray_sort_keys_normal_pos_v3(hp, state.normal, lo, hi,
                                           mat_mask)
    if key == "adaptive":
        return ray_sort_keys_adaptive_v3(hp, state.normal, bounces, lo, hi,
                                         mat_mask)
    f = {"morton_pos": ray_sort_keys_pos_v3, "morton": ray_sort_keys_v3,
         "morton_pos10": ray_sort_keys_pos10_v3}[key]
    return f(hp, state.ray_d, lo, hi, mat_mask)


def emit_and_roulette(scene, cfg, state, u_rr):
    """Emission at camera-ray hits, the environment light on misses and
    Russian roulette: ``(acc, beta, bounces, mat_mask, rr_kill, hp)``,
    ``bounces`` incremented and ``hp`` the hit point of the continuing
    paths (the ray origin elsewhere)."""
    num_lights = scene.num_lights
    if 0 < num_lights <= 16:
        # the light id by comparing the hit prim with the emitter triangles
        light_idx = torch.full_like(state.prim, INVALID_INDEX)
        for li in range(num_lights):
            ltri_l = scene.lights.tri[li]
            light_idx = torch.where((state.prim == ltri_l) & (ltri_l >= 0)
                                    & (state.src == 0), li, light_idx)
    else:
        light_idx = torch.where(
            state.src == 0, vec.take_rows(scene.prim_light, state.prim),
            INVALID_INDEX)
    emit0 = state.hit & (light_idx >= 0) & (state.bounces == 0)
    emit_li = torch.clamp(light_idx, min=0)
    emit_val = tuple(vec.take_rows(scene.lights.emit[:, k], emit_li)
                     for k in range(3))
    acc = accum(state.acc, emit_val, emit0)
    # the constant environment light on a miss (a BSDF-sampled channel
    # that NEE never samples, so it takes no MIS weight)
    env_mask = ~state.hit & (state.bounces <= cfg.max_bounces)
    env = scene.env_radiance
    acc = accum(acc, vec.mul(state.beta, (env[0], env[1], env[2])),
                env_mask)

    alive = state.bounces < cfg.max_bounces
    beta = state.beta
    beta_max = vec.vmax(beta)
    rr_cand = alive & state.hit & (state.bounces > cfg.rr_start) & \
        (beta_max < cfg.rr_threshold)
    p_term = torch.clamp(1.0 - beta_max, min=0.05)
    rr_kill = rr_cand & (u_rr < p_term)
    rr_boost = torch.where(rr_cand & ~rr_kill, 1.0 / (1.0 - p_term), 1.0)
    beta = vec.scale(rr_boost, beta)
    mat_mask = alive & state.hit & ~rr_kill
    hp_t = torch.where(mat_mask, state.t, 0.0)
    hp = vec.add(state.ray_o, vec.scale(hp_t, state.ray_d))
    return acc, beta, state.bounces + 1, mat_mask, rr_kill, hp


def shade_math(scene, cfg, src, prim, beta, p, wo, normal, mat_mask,
               u_bsdf1, u_pick, u_luv, u_bsdf2, mats=None):
    """The mat stage: next path ray, NEE shadow ray (light-sampling MIS)
    and the BSDF-sampling MIS ray toward the picked light (its target the
    triangle the path stands on under ``reference_parity``; no ray of its
    own under ``one_sample_mis``).  ``mats``: the hits' ``(mtype, albedo,
    ior)`` when the caller has them, else gathered from ``src`` and
    ``prim``."""
    num_lights = scene.num_lights
    mtype, albedo, ior = mats if mats is not None else \
        gather_hit_materials_v3(scene, src, prim)
    multiplier = vec.scale(float(num_lights), beta)
    n_g = vec.neg(vec.normalize(normal))

    f1, wi1, pdf1, n1 = sample_f_v3(mtype, albedo, ior, wo, n_g, *u_bsdf1)
    next_o, next_d, _ = spawn_offset_ray_v3(p, n1, wi1)
    next_beta = vec.mul(beta, vec.scale(vec.dot(wi1, n1) / pdf1, f1))
    nb_ok = vec.isfinite(next_beta)
    next_beta = tuple(torch.where(nb_ok, c, 0.0) for c in next_beta)
    out = dict(next_o=next_o, next_d=next_d, next_beta=next_beta)
    if num_lights == 0:
        return out

    pick = torch.clamp((u_pick * num_lights).to(torch.int32),
                       max=num_lights - 1)
    lrec = gather_light_v3(scene.lights, pick)
    l_type, l_emit = lrec[0], lrec[2]
    ltp0, lte1, lte2, ltn = lrec[4], lrec[5], lrec[6], lrec[7]
    delta = is_delta(l_type)

    # light-sampling MIS -> any-hit shadow ray
    wi_l, li, light_t, light_pdf, ltri = sample_li_v3(
        scene.lights, pick, p, u_luv[0], u_luv[1], rec=lrec)
    n_l = vec.where(vec.dot(n_g, wi_l) > 0.0, n_g, vec.neg(n_g))
    got_f, f_l, scat_pdf = get_f_v3(mtype, albedo, wo, wi_l, n_l)
    f_lc = vec.scale(vec.dot(wi_l, n_l), f_l)
    # the reference's power heuristic truncates its second pdf to an int
    g_l = torch.trunc(scat_pdf) if cfg.reference_parity else scat_pdf
    w_l = torch.where(delta, 1.0, power_heuristic(light_pdf, g_l))
    ah_L = vec.mul(multiplier,
                   vec.scale(w_l / light_pdf, vec.mul(f_lc, li)))
    ah_o, ah_d, ah_tmax = spawn_offset_ray_v3(p, n_l, wi_l, light_t)

    # BSDF-sampling MIS: a second BSDF sample (one_sample_mis: the path
    # ray's own) that must reach the target triangle unoccluded (direct MT
    # test + any-hit excluding it)
    if cfg.one_sample_mis:
        f2, wi2, pdf2, n2 = f1, wi1, pdf1, n1
    else:
        f2, wi2, pdf2, n2 = sample_f_v3(mtype, albedo, ior, wo, n_g,
                                        *u_bsdf2)
    f2c = vec.scale(vec.dot(wi2, n2), f2)
    spec = is_specular(mtype)
    lpdf2 = pdf_li_v3(scene.lights, pick, p, wi2, rec=lrec)
    g_2 = torch.trunc(lpdf2) if cfg.reference_parity else lpdf2
    w2 = torch.where(spec, 1.0, power_heuristic(pdf2, g_2))
    chs_mask = mat_mask & ~delta & (spec | (lpdf2 > 0.0))
    chs_L = vec.mul(multiplier, vec.scale(w2 / pdf2, vec.mul(f2c, l_emit)))
    out.update(ah_o=ah_o, ah_d=ah_d, ah_tmax=ah_tmax, ah_L=ah_L,
               ah_mask=mat_mask & got_f, ltri=ltri, chs_L=chs_L,
               chs_mask=chs_mask)
    if cfg.one_sample_mis:
        # the path ray's hit record answers "closest hit == the light"
        return out
    chs_o, chs_d, _ = spawn_offset_ray_v3(p, n2, wi2)
    if cfg.reference_parity:
        # the reference's target is the triangle the path stands on (an
        # instanced hit has none: the channel is masked off there)
        own = torch.clamp(prim, 0, scene.tris.num - 1).long()
        own_tri = tuple(tuple(getattr(scene.tris, f)[:, k][own]
                              for k in range(3))
                        for f in ("p0", "e1", "e2", "n"))
        chs_tgt = torch.where(src == 0, prim, INVALID_INDEX)
        chs_hit_l, chs_t, _, _ = intersect_triangle_v3(
            chs_o, chs_d, float("inf"), *own_tri)
        chs_mask = chs_mask & chs_hit_l & (src == 0)
    else:
        chs_tgt = ltri
        chs_hit_l, chs_t, _, _ = intersect_triangle_v3(
            chs_o, chs_d, float("inf"), ltp0, lte1, lte2, ltn)
        chs_mask = chs_mask & chs_hit_l
    out.update(chs_o=chs_o, chs_d=chs_d, chs_mask=chs_mask, chs_tgt=chs_tgt,
               chs_t=chs_t)
    return out


def blocked_order(cfg) -> bool:
    """Whether camera rays visit the screen in 16x16 blocks."""
    return (cfg.camera_order == "blocked"
            or (cfg.camera_order == "auto" and cfg.num_samples <= 8))


@functools.lru_cache(maxsize=8)
def blocked_pixel_table(width: int, height: int, device,
                        block: int = 16) -> torch.Tensor:
    """Rank -> pixel index visiting the screen in 16x16 blocks (row-major
    blocks, row-major within), int32 on ``device``.  Made once per size
    and device: a step reads it without a host-to-device copy, which a
    captured graph cannot hold."""
    y, x = np.mgrid[0:height, 0:width]
    nbx = (width + block - 1) // block
    key = (((y // block) * nbx + (x // block)) * (block * block)
           + (y % block) * block + (x % block))
    return torch.from_numpy(np.argsort(key.ravel(), kind="stable")
                            .astype(np.int32)).to(device)


def camera_rays(camera, cfg, cam_id, gen_u, gen_v):
    """Camera ray ids -> ``(pixel, origin, direction)``: the ray's pixel
    (blocked or scanline order) and its ray through the jittered pixel."""
    pix_rank = torch.clamp(torch.div(cam_id, cfg.num_samples,
                                     rounding_mode="floor"),
                           max=cfg.num_pixels - 1)
    if blocked_order(cfg):
        pix_new = blocked_pixel_table(cfg.width, cfg.height,
                                      cam_id.device)[pix_rank.long()]
    else:
        pix_new = pix_rank.to(torch.int32)
    ci = (pix_new % cfg.width).to(torch.float32)
    cj = torch.div(pix_new, cfg.width, rounding_mode="floor") \
        .to(torch.float32)
    cam_o, cam_d = camera.get_rays_v3((ci + gen_u) / cfg.width,
                                      (cj + gen_v) / cfg.height)
    return pix_new, cam_o, cam_d


def pack_bundle(hp, beta, acc, pixel, bounces, mat_mask, prim, src,
                normal, ray_d, material=None):
    """The compact sort bundle, one record a lane, ``[N, 10]`` int32: the
    hit point's bits, RGB9E5 throughput and radiance, pixel | bounces (7
    bits, 127 = dead) | mat bit, prim + 1 | src, the octahedral normal
    and direction, and the material index (``material``, zero when None):
    40-byte rows, 8-byte aligned."""
    b7 = torch.clamp(bounces, max=127)
    pbm = pixel | (b7 << 21) | (mat_mask.to(torch.int32) << 28)
    zero = torch.zeros_like(pbm)
    return torch.stack((
        *(c.view(torch.int32) for c in hp), rgb9e5_encode_v3(beta),
        rgb9e5_encode_v3(acc), pbm, (prim + 1) | (src << 23),
        oct_encode_v3(normal), oct_encode_v3(ray_d),
        zero if material is None else material.to(torch.int32)), 1)


def unpack_bundle(b):
    """Inverse of :func:`pack_bundle` (the codecs' rounding aside) for
    ``b`` ``[N, >= 9]``: ``(p, beta, acc, pixel, bounces, mat_mask, prim,
    src, normal, ray_d)``, bounces 127 back to ``DEAD_BOUNCES``."""
    w = [b[:, k] for k in range(V1_BUNDLE_ROWS)]
    b_dec = (w[5] >> 21) & 0x7F
    return (tuple(w[k].view(torch.float32) for k in range(3)),
            rgb9e5_decode_v3(w[3]), rgb9e5_decode_v3(w[4]), w[5] & 0x1FFFFF,
            torch.where(b_dec >= 127, DEAD_BOUNCES, b_dec),
            ((w[5] >> 28) & 1) != 0, (w[6] & 0x7FFFFF) - 1,
            (w[6] >> 23) & 0xFF, oct_decode_v3(w[7]), oct_decode_v3(w[8]))


def hit_material(scene, src, prim):
    """The hits' material index (render/trace.py ``_hit_material_index``)
    clamped to the material table, as its gather clamps it."""
    return torch.clamp(_hit_material_index(scene, src, prim), 0,
                       scene.materials.mtype.shape[0] - 1)


def cadence(counts, n, it, sort_every):
    """The device bool of a ``sort_every`` step: sort, generate and flush
    on every k-th iteration, or when the continuing paths (``counts[0]``)
    drop below 3/4 of the pool; None when every iteration does."""
    if sort_every <= 1:
        return None
    return (counts[0] * 4 < n * 3) | ((it % sort_every) == 0)


def compact_bundle_ok(scene, cfg) -> bool:
    """Ranges of the sorted engine's compact bundle: pixel 21 bits, prim+1
    23 bits (base scene and every BLAS), src 8 bits, bounces 7 bits with
    127 as the dead sentinel (render/wavefront.py ``_compact_bundle_ok``
    reads it)."""
    max_prim = max([scene.tris.num] + [b.tris.num for b in scene.blas])
    num_src = 1 + (scene.instances.num if scene.instances is not None else 0)
    return (cfg.num_pixels <= 1 << 21 and max_prim < (1 << 23) - 1
            and num_src <= 1 << 8 and cfg.max_bounces + 1 < 127)


def step_mode(scene, cfg, compact=None) -> str:
    """The step kernels' mode of ``cfg`` (a key of :data:`MODE_KERNELS`
    but for ``one_sample_mis`` under ``reference_parity``, which
    render/wavefront.py ``check_slice`` refuses): its engine, "default"
    for the sorted engine with the compact bundle (``compact``, by default
    :func:`compact_bundle_ok`), "wide" for the sorted engine beyond its
    ranges, "unsorted" for rtjax's unsorted engine (``sort_rays=False`` or
    the traversal "xla"), "parity" for ``reference_parity`` on the sorted
    engine and "parity_unsorted" on the unsorted one; then "_1s" under
    ``one_sample_mis`` and "_stats" under ``detailed_stats``."""
    sort = cfg.sort_rays and resolve_mode(scene, cfg) != "xla"
    if cfg.reference_parity:
        engine = "parity" if sort else "parity_unsorted"
    elif not sort:
        engine = "unsorted"
    else:
        if compact is None:
            compact = compact_bundle_ok(scene, cfg)
        engine = "default" if compact else "wide"
    return engine + ONE_SAMPLE * cfg.one_sample_mis + \
        STATS * cfg.detailed_stats


def engine_of(mode) -> str:
    """The engine of a :func:`step_mode` mode (its suffixes dropped)."""
    return mode.removesuffix(STATS).removesuffix(ONE_SAMPLE)


def kernels_of(cfg, mode):
    """The kernels of ``mode``'s engine under ``cfg``'s estimator and
    ``detailed_stats`` (:data:`MODE_KERNELS`): route first (none on the
    unsorted engine), then shade, then resolve."""
    return MODE_KERNELS[engine_of(mode) + ONE_SAMPLE * cfg.one_sample_mis
                        + STATS * cfg.detailed_stats]


def pack_full(state, bounces, beta, acc, mat, limbo, material):
    """The full-precision record of the unsorted engine and
    ``reference_parity``, ``[N, FULL_ROWS]`` int32 (:data:`FULL_LAYOUT`):
    the fields rtjax carries through its parity sort (pixel, ray, t,
    normal, prim, src, bounces, throughput, radiance, the mat and limbo
    flags in one word) with the hit's material index, floats as their
    bits, two zero words of padding."""
    f = lambda v: [c.view(torch.int32) for c in v]
    zero = torch.zeros_like(state.pixel)
    flags = mat.to(torch.int32) | (limbo.to(torch.int32) << 1)
    return torch.stack((
        *f(state.ray_o), *f((state.t,)), *f(state.ray_d), state.pixel,
        *f(state.normal), state.prim, *f(beta), state.src, *f(acc),
        bounces, flags, material.to(torch.int32), zero, zero), 1)


def unpack_full(r):
    """Inverse of :func:`pack_full` for ``r`` ``[N, FULL_ROWS]``: ``{field:
    value}`` with ``mat`` and ``limbo`` (bool) for ``flags``."""
    out = {}
    for name, w, k in FULL_LAYOUT:
        cols = [r[:, w + j] for j in range(k)]
        if name in ("ray_o", "t", "ray_d", "normal", "beta", "acc"):
            cols = [c.view(torch.float32) for c in cols]
        out[name] = tuple(cols) if k == 3 else cols[0]
    flags = out.pop("flags")
    out["mat"], out["limbo"] = (flags & 1) != 0, (flags & 2) != 0
    return out


def scan_words(n) -> int:
    """int64 words of the full-record modes' scan buffer over ``n`` lanes:
    the ticket, the finished blocks and one status word a shade block."""
    return 2 + (n + SCAN_BLOCK - 1) // SCAN_BLOCK


# ------------------------------------------------------ plain versions

@dataclasses.dataclass
class Shaded:
    """:func:`shade`'s outputs (see the module docstring)."""

    pixel: torch.Tensor
    ray_o: tuple
    ray_d: tuple
    beta: tuple
    bounces: torch.Tensor
    acc: tuple
    trace_mask: torch.Tensor
    counts: torch.Tensor
    shadow: tuple | None = None   # (origin, direction, tmax, exclude, mask)
    ah_L: tuple | None = None
    chs_L: tuple | None = None
    # the full-record modes: each position's limbo flag, and the record
    # with the sort's order (None: slot order) that resolve restores from
    limbo: torch.Tensor | None = None
    record: torch.Tensor | None = None
    order: torch.Tensor | None = None
    # one_sample_mis with lights: the BSDF-MIS channel's mask (its ray is
    # the path ray; ``shadow`` holds the N NEE rays alone)
    chs_mask: torch.Tensor | None = None


def route_ref(scene, cfg, state, words):
    """Plain PyTorch version of :func:`route` (same contract, any
    device)."""
    REF_CALLS["route"] += 1
    u_rr, _ = rng.u01_pair(words[W_RR_PICK])
    acc, beta, bounces, mat_mask, _, hp = emit_and_roulette(scene, cfg,
                                                            state, u_rr)
    dirty = ~mat_mask & ((acc[0] != 0.0) | (acc[1] != 0.0)
                         | (acc[2] != 0.0))
    keys = torch.where(dirty, DIRTY_KEY,
                       sort_keys(scene, cfg, state, hp, bounces, mat_mask))
    bundle = pack_bundle(hp, beta, acc, state.pixel, bounces, mat_mask,
                         state.prim, state.src, state.normal, state.ray_d,
                         hit_material(scene, state.src, state.prim))
    counts = torch.zeros(NUM_COUNTS, dtype=torch.int64, device=keys.device)
    counts[0] = mat_mask.sum()
    counts[4] = dirty.sum()
    return keys, bundle, counts


def shade_ref(scene, camera, cfg, state, fb, words, order, bundle, counts,
              it, cam_start, sort_every):
    """Plain PyTorch version of :func:`shade` (same contract, any device;
    ``state`` is not read)."""
    REF_CALLS[kernels_of(cfg, "default")[1]] += 1
    n = bundle.shape[0]
    dev = bundle.device
    draw_pair = lambda w: rng.u01_pair(words[w])
    num_mat = counts[0]
    do_gen = cadence(counts, n, it, sort_every)
    if do_gen is not None:
        # both branches are computed, as rtjax's lax.cond: the sorted or
        # the unsorted permutation is selected on the device
        order = torch.where(do_gen, order, torch.arange(n, device=dev))
    rec = bundle[order]
    (p, beta, acc, pixel, bounces, mat_mask, prim, src, normal,
     ray_d_p) = unpack_bundle(rec)
    gen_mask = ~mat_mask

    b1u1, b1u2 = draw_pair(W_BSDF1)
    b2u1, b2u2 = draw_pair(W_BSDF2)
    sh = shade_math(scene, cfg, src, prim, beta, p, ray_d_p, normal,
                    mat_mask, (b1u1, b1u2, b1u1), draw_pair(W_RR_PICK)[1],
                    draw_pair(W_LIGHT_UV), (b2u1, b2u2, b2u1),
                    mats=scene.materials.gather_v3(rec[:, W_MATERIAL]))

    # camera generation into the dead suffix: after the sort the
    # continuing lanes are exactly the prefix
    gen_u, gen_v = draw_pair(W_GEN)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    cam_id = cam_start + torch.clamp(idx - num_mat, min=0)
    got_ray = (idx >= num_mat) & (cam_id < cfg.total_camera_rays)
    # the slots that flush (their radiance leaves with them) and take a
    # camera ray: none on a sort_every skip iteration, whose dead lanes
    # idle one iteration
    flushing = gen_mask
    if do_gen is not None:
        got_ray = got_ray & do_gen
        flushing = gen_mask & do_gen
    pix_new, cam_o, cam_d = camera_rays(camera, cfg, cam_id, gen_u, gen_v)
    flush = torch.stack([torch.where(flushing, c, 0.0) for c in acc], 1)
    fb.index_add_(0, pixel.long(), flush)
    acc = tuple(torch.where(flushing, 0.0, c) for c in acc)

    # merge continued and regenerated rays
    trace_mask = mat_mask | got_ray
    out = Shaded(
        pixel=torch.where(got_ray, pix_new, pixel),
        ray_o=vec.where(mat_mask, sh["next_o"],
                        vec.where(got_ray, cam_o, p)),
        ray_d=vec.where(mat_mask, sh["next_d"],
                        vec.where(got_ray, cam_d, ray_d_p)),
        beta=tuple(torch.where(mat_mask, nb, torch.where(got_ray, 1.0, c))
                   for nb, c in zip(sh["next_beta"], beta)),
        bounces=torch.where(got_ray, 0,
                            torch.where(gen_mask, DEAD_BOUNCES, bounces)),
        acc=acc, trace_mask=trace_mask, counts=counts)
    return _with_shadows(scene, cfg, out, sh, counts)


def _with_shadows(scene, cfg, out, sh, counts):
    """``out`` (a :class:`Shaded`) with its counts and, with lights, both
    shadow channels of ``shade_math``'s ``sh``; ``counts`` route's."""
    n_traced = out.trace_mask.sum()
    zero = torch.zeros((), dtype=torch.int64, device=counts.device)
    if scene.num_lights == 0:
        out.counts = torch.stack((counts[0], n_traced, zero, zero,
                                  counts[4]))
        return out
    if cfg.one_sample_mis:
        # one N-ray any-hit launch, the NEE rays; the BSDF-MIS channel
        # (its radiance zero off its mask) waits for the path ray's
        # closest hit, in resolve, and traces no ray of its own
        out.shadow = (sh["ah_o"], sh["ah_d"], sh["ah_tmax"], sh["ltri"],
                      sh["ah_mask"])
        out.ah_L, out.chs_mask = sh["ah_L"], sh["chs_mask"]
        out.chs_L = tuple(torch.where(sh["chs_mask"], c, 0.0)
                          for c in sh["chs_L"])
        out.counts = torch.stack((counts[0], n_traced, sh["ah_mask"].sum(),
                                  zero, counts[4]))
        return out
    # both shadow channels ride one 2N any-hit launch
    cat = lambda a, b: torch.cat([a, b])
    cat3 = lambda a, b: tuple(cat(x, y) for x, y in zip(a, b))
    out.shadow = (cat3(sh["ah_o"], sh["chs_o"]), cat3(sh["ah_d"],
                                                      sh["chs_d"]),
                  cat(sh["ah_tmax"], sh["chs_t"]),
                  cat(sh["ltri"], sh["chs_tgt"]),
                  cat(sh["ah_mask"], sh["chs_mask"]))
    out.ah_L, out.chs_L = sh["ah_L"], sh["chs_L"]
    out.counts = torch.stack((counts[0], n_traced, sh["ah_mask"].sum(),
                              sh["chs_mask"].sum(), counts[4]))
    return out


def _add_shadows(sh, occluded, hits):
    """The radiance with the unoccluded shadow channels added (``occluded``
    the ``[2N]`` any-hit result, ``[N]`` under one-sample MIS, whose
    BSDF-MIS channel counts where the path ray's closest hit ``hits`` is
    the picked light's triangle; None without lights)."""
    n = sh.trace_mask.shape[0]
    acc = sh.acc
    if sh.shadow is not None:
        mask = sh.shadow[4]
        acc = accum(acc, sh.ah_L, mask[:n] & ~occluded[:n])
        if sh.chs_mask is None:
            acc = accum(acc, sh.chs_L, mask[n:] & ~occluded[n:])
        else:
            hit, _, _, prim, src = hits
            chs_ok = hit & (src == 0) & (prim == sh.shadow[3])
            acc = accum(acc, sh.chs_L, sh.chs_mask & chs_ok)
    return acc


def _check_hist(cfg, hist):
    if cfg.detailed_stats != (hist is not None):
        raise ValueError("resolve takes the bounce histogram exactly under "
                         "detailed_stats")


def _hist_ref(cfg, sh, hist):
    """``(hist,)`` with the step's traced lanes added at their depth,
    ``clamp(bounces, 0, max_bounces)`` (rtjax :809-815), under
    ``detailed_stats``; ``()`` without."""
    if hist is None:
        return ()
    depth = torch.clamp(sh.bounces, 0, cfg.max_bounces).long()
    return (hist.index_add(0, depth, sh.trace_mask.to(hist.dtype)),)


def resolve_ref(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
                occ_sum, hits=None, hist=None):
    """Plain PyTorch version of :func:`resolve` (same contract, any
    device)."""
    _check_hist(cfg, hist)
    REF_CALLS[kernels_of(cfg, "default")[-1]] += 1
    n = sh.trace_mask.shape[0]
    acc = _add_shadows(sh, occluded, hits)
    c = sh.counts
    num_gen = n - c[0]
    do_gen = cadence(c, n, it, sort_every)
    if do_gen is not None:
        num_gen = num_gen * do_gen
    return (acc, cam_start + num_gen, c[1] > 0,
            rays_traced + c[1:4].sum().to(torch.float64),
            occ_sum + c[1].to(torch.float64) / n) + _hist_ref(cfg, sh, hist)


def route_full_ref(scene, cfg, state, words, mode):
    """Plain PyTorch version of :func:`route_full` (same contract, any
    device)."""
    REF_CALLS[kernels_of(cfg, mode)[0]] += 1
    return _route_full(scene, cfg, state, words, mode)


def _route_full(scene, cfg, state, words, mode):
    engine = engine_of(mode)
    u_rr, _ = rng.u01_pair(words[W_RR_PICK])
    acc, beta, bounces, mat, rr_kill, hp = emit_and_roulette(scene, cfg,
                                                             state, u_rr)
    limbo = rr_kill if engine.startswith("parity") else \
        torch.zeros_like(rr_kill)
    material = hit_material(scene, state.src, state.prim)
    counts = torch.zeros(NUM_COUNTS, dtype=torch.int64, device=mat.device)
    if engine == "wide":
        # the sorted engine's wide bundle: keyed as :func:`route_ref`, the
        # hit point in the origin words, bounces (15 bits, 0x7FFF dead)
        # and the mat bit as the op-by-op step's one packed word gives
        # them back
        dirty = ~mat & ((acc[0] != 0.0) | (acc[1] != 0.0) | (acc[2] != 0.0))
        keys = torch.where(dirty, DIRTY_KEY,
                           sort_keys(scene, cfg, state, hp, bounces, mat))
        meta = torch.clamp(bounces, max=0x7FFF) | (mat.to(torch.int32) << 15)
        mat = ((meta >> 15) & 1) != 0
        b_dec = meta & 0x7FFF
        bounces = torch.where(b_dec >= 0x7FFF, DEAD_BOUNCES, b_dec)
        state = dataclasses.replace(state, ray_o=hp)
        counts[4] = dirty.sum()
    else:
        keys = sort_keys(scene, cfg, state, hp, bounces, mat) \
            if engine == "parity" else None
        counts[4] = limbo.sum()
    record = pack_full(state, bounces, beta, acc, mat, limbo, material)
    counts[0] = mat.sum()
    return keys, record, counts


def shade_full_ref(scene, camera, cfg, fb, words, order, record, counts,
                   cam_start, mode):
    """Plain PyTorch version of :func:`shade_full` (same contract, any
    device)."""
    REF_CALLS[kernels_of(cfg, mode)[1]] += 1
    return _shade_full(scene, camera, cfg, fb, words, order, record, counts,
                       cam_start, mode)


def route_shade_unsorted_ref(scene, camera, cfg, state, fb, words,
                             cam_start):
    """Plain PyTorch version of :func:`route_shade_unsorted` (same
    contract, any device): route's record, then shade of it."""
    REF_CALLS[kernels_of(cfg, "unsorted")[0]] += 1
    _, record, counts = _route_full(scene, cfg, state, words, "unsorted")
    out = _shade_full(scene, camera, cfg, fb, words, None, record, counts,
                      cam_start, "unsorted")
    out.limbo = out.record = None
    return out


def _shade_full(scene, camera, cfg, fb, words, order, record, counts,
                cam_start, mode):
    wide = engine_of(mode) == "wide"
    draw_pair = lambda w: rng.u01_pair(words[w])
    r = unpack_full(record if order is None else record[order])
    mat, limbo, beta = r["mat"], r["limbo"], r["beta"]
    ray_o, ray_d = r["ray_o"], r["ray_d"]
    # the hit point after the permutation, in rtjax's operation order (the
    # wide bundle carries it in the origin words)
    p = ray_o if wide else \
        vec.add(ray_o, vec.scale(torch.where(mat, r["t"], 0.0), ray_d))
    gen_mask = ~mat & ~limbo
    b1u1, b1u2 = draw_pair(W_BSDF1)
    b2u1, b2u2 = draw_pair(W_BSDF2)
    sh = shade_math(scene, cfg, r["src"], r["prim"], beta, p, ray_d,
                    r["normal"], mat, (b1u1, b1u2, b1u1),
                    draw_pair(W_RR_PICK)[1], draw_pair(W_LIGHT_UV),
                    (b2u1, b2u2, b2u1),
                    mats=scene.materials.gather_v3(r["material"]))

    gen_u, gen_v = draw_pair(W_GEN)
    if wide:
        # sorted with the dirty class: the continuing lanes are the prefix
        idx = torch.arange(gen_mask.shape[0], dtype=torch.int32,
                           device=gen_mask.device)
        cam_id = cam_start + torch.clamp(idx - counts[0], min=0)
        got_ray = (idx >= counts[0]) & (cam_id < cfg.total_camera_rays)
    else:
        # the dead lanes are not a suffix (unsorted, or limbo lanes among
        # them): camera rays go by the exclusive prefix sum of gen_mask
        cam_id = cam_start + (torch.cumsum(gen_mask, 0) - gen_mask.long())
        got_ray = gen_mask & (cam_id < cfg.total_camera_rays)
    pix_new, cam_o, cam_d = camera_rays(camera, cfg, cam_id, gen_u, gen_v)
    flush = torch.stack([torch.where(gen_mask, c, 0.0) for c in r["acc"]], 1)
    fb.index_add_(0, r["pixel"].long(), flush)
    acc = tuple(torch.where(gen_mask, 0.0, c) for c in r["acc"])

    trace_mask = mat | got_ray
    out = Shaded(
        pixel=torch.where(got_ray, pix_new, r["pixel"]),
        ray_o=vec.where(mat, sh["next_o"], vec.where(got_ray, cam_o, ray_o)),
        ray_d=vec.where(mat, sh["next_d"], vec.where(got_ray, cam_d, ray_d)),
        beta=tuple(torch.where(mat, nb, torch.where(got_ray, 1.0, c))
                   for nb, c in zip(sh["next_beta"], beta)),
        bounces=torch.where(got_ray, 0, torch.where(gen_mask, DEAD_BOUNCES,
                                                    r["bounces"])),
        acc=acc, trace_mask=trace_mask, counts=counts, limbo=limbo,
        record=record, order=order)
    return _with_shadows(scene, cfg, out, sh, counts)


def resolve_full_ref(cfg, sh, occluded, hits, cam_start, rays_traced,
                     occ_sum, mode, hist=None):
    """Plain PyTorch version of :func:`resolve_full` under the parity
    modes (same contract, any device)."""
    _check_hist(cfg, hist)
    REF_CALLS[kernels_of(cfg, mode)[-1]] += 1
    n = sh.trace_mask.shape[0]
    acc = _add_shadows(sh, occluded, hits)
    # limbo lanes did not trace: the payload the closest-hit kernel
    # cleared survives for the next re-roll, and the frame waits for them
    r = unpack_full(sh.record if sh.order is None else sh.record[sh.order])
    lim = sh.limbo
    hit, t, normal, prim, src = hits
    hits = (hit | lim, torch.where(lim, r["t"], t),
            vec.where(lim, r["normal"], normal),
            torch.where(lim, r["prim"], prim),
            torch.where(lim, r["src"], src))
    c = sh.counts
    return (acc, hits, cam_start + (n - c[0] - c[4]), (c[1] > 0) | (c[4] > 0),
            rays_traced + c[1:4].sum().to(torch.float64),
            occ_sum + c[1].to(torch.float64) / n) + _hist_ref(cfg, sh, hist)


def route_v1_ref(scene, cfg, state, words):
    """Plain version of :func:`route_v1`: :func:`route_ref` with the
    bundle as the first design's ``[9, N]`` columns."""
    keys, rec, counts = route_ref(scene, cfg, state, words)
    return keys, rec[:, :V1_BUNDLE_ROWS].T.contiguous(), counts


def shade_v1_ref(scene, camera, cfg, state, fb, words, order, bundle,
                 counts, it, cam_start, sort_every):
    """Plain version of :func:`shade_v1`: :func:`shade_ref` of the
    records the ``[9, N]`` columns hold (the material index from their
    prim and src, as the first design's kernel finds it)."""
    cols = bundle.T
    mi = hit_material(scene, (cols[:, 6] >> 23) & 0xFF,
                      (cols[:, 6] & 0x7FFFFF) - 1)
    rec = torch.cat((cols, mi[:, None]), 1)
    return shade_ref(scene, camera, cfg, state, fb, words, order, rec,
                     counts, it, cam_start, sort_every)


# ------------------------------------------------------------ CUDA path

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# the kernels' argument block, field for field csrc/step_math.cuh's
# ``StepArgs`` (tests/test_torch_step_kernels.py holds the two equal)
ARG_FIELDS = (
    # the path state [N]; shade writes the next one into it
    ("pixel", _P), ("ray_o", _P * 3), ("ray_d", _P * 3), ("hit", _P),
    ("t", _P), ("normal", _P * 3), ("prim", _P), ("src", _P),
    ("bounces", _P), ("beta", _P * 3), ("acc", _P * 3),
    ("words", _P),
    # route -> sort -> shade -> resolve
    ("keys", _P), ("bundle", _P), ("counts", _P), ("order", _P),
    ("it", _P), ("cam_start", _P), ("fb", _P), ("trace_mask", _P),
    ("sh_o", _P * 3), ("sh_d", _P * 3), ("sh_tmax", _P),
    ("sh_exclude", _P), ("sh_mask", _P), ("ah_L", _P * 3),
    ("chs_L", _P * 3), ("occluded", _P),
    ("rays_in", _P), ("occ_in", _P), ("cam_out", _P), ("work_out", _P),
    ("rays_out", _P), ("occ_out", _P),
    # the full-record modes: the scan, the limbo flags, resolve's hits
    ("scan", _P), ("limbo", _P), ("hit_out", _P), ("t_out", _P),
    ("normal_out", _P * 3), ("prim_out", _P), ("src_out", _P),
    # one-sample MIS's channel mask, detailed_stats' histogram
    ("chs_mask", _P), ("hist", _P),
    # the scene and the camera
    ("prim_light", _P), ("prim_material", _P), ("inst_material", _P),
    ("mtype", _P), ("albedo", _P), ("ior", _P),
    ("ltype", _P), ("lpos", _P), ("lemit", _P), ("ltri", _P),
    ("ltp0", _P), ("lte1", _P), ("lte2", _P), ("ltn", _P),
    ("env", _P), ("root_lo", _P), ("root_hi", _P),
    ("lookfrom", _P), ("upper_left", _P), ("horizontal", _P),
    ("vertical", _P), ("pixel_table", _P),
    ("tri_p0", _P), ("tri_e1", _P), ("tri_e2", _P), ("tri_n", _P),
    ("it_value", _I64),
    ("n", _I32), ("num_prims", _I32), ("num_tris", _I32),
    ("num_materials", _I32),
    ("num_light_rows", _I32), ("num_lights", _I32), ("max_bounces", _I32),
    ("rr_start", _I32), ("sort_key", _I32), ("sort_every", _I32),
    ("spp", _I32), ("num_pixels", _I32), ("width", _I32), ("height", _I32),
    ("cam_end", _I32),
    ("rr_threshold", _F32),
)


class StepArgs(ctypes.Structure):
    """The argument block; ``held`` keeps every tensor it points at alive
    for as long as the block is."""

    _fields_ = ARG_FIELDS


# entry point (``rtjax_step_<name>``) -> the counter its launch adds to
_COUNTERS = {**{k: (LAUNCHES, k) for k in LAUNCHES},
             "route_v1": (V1_LAUNCHES, "route"),
             "shade_v1": (V1_LAUNCHES, "shade")}
# kernel ids of ``rtjax_step_kernel_info``
KERNEL_IDS = {"route": 0, "shade": 1, "resolve": 2, "route_v1": 3,
              "shade_v1": 4, "route_shade_unsorted": 5, "route_parity": 6,
              "shade_parity": 7, "resolve_parity": 8,
              "route_parity_unsorted": 9, "shade_parity_unsorted": 10,
              "shade_1s": 11, "route_shade_unsorted_1s": 12,
              "route_wide": 13, "shade_wide": 14, "shade_wide_1s": 15,
              "resolve_1s": 16, "resolve_stats": 17, "resolve_1s_stats": 18,
              "resolve_parity_stats": 19}

def bind(lib):
    """Set the argument types of a step-kernel library's entry points
    (``ctypes.CDLL``) and return it."""
    for name in _COUNTERS:
        fn = getattr(lib, f"rtjax_step_{name}")
        fn.argtypes = [ctypes.POINTER(StepArgs), _P]
        fn.restype = _I32
    lib.rtjax_step_kernel_info.argtypes = [_I32] + [ctypes.POINTER(_I32)] * 4
    lib.rtjax_step_kernel_info.restype = _I32
    return lib


def kernel_info(name) -> dict:
    """A step kernel's registers, local (spill) bytes a thread, threads a
    block and resident blocks an SM at that block (the card's occupancy
    calculator), by :data:`KERNEL_IDS` name."""
    vals = [_I32() for _ in range(4)]
    rc = _kernels().rtjax_step_kernel_info(KERNEL_IDS[name],
                                           *map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"step kernel info of {name} failed: CUDA error "
                           f"{rc}")
    regs, local, block, blocks = (v.value for v in vals)
    return dict(registers=regs, local_bytes=local, block=block,
                blocks_per_sm=blocks, warps_per_sm=blocks * block // 32)


def _kernels():
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(_build.step_library())))
        return _lib


_scans: dict = {}   # (device, stream, words) -> the scan buffer


def scan_buffer(device, stream: int, n: int) -> torch.Tensor:
    """The full-record modes' scan buffer for shade launches of ``n`` lanes
    on ``stream``: ``scan_words(n)`` int64 zeros, made once and reused.

    Invariant: the buffer is zero between launches.  A shade launch takes
    its blocks' indices from the ticket and the block that finishes last
    zeroes the ticket, the count and every status word; a launch that
    fails on the card leaves the context in a sticky error, so no later
    launch on it returns results (as ``persist.work_buffer``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), stream, scan_words(n))
    with _lock:
        buf = _scans.get(key)
        if buf is None:
            buf = _scans[key] = torch.zeros(key[2], dtype=torch.int64,
                                            device=device)
    return buf


def _on_card(t) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _ptrs3(v):
    return (_P * 3)(*(c.data_ptr() for c in v))


def _need(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the state on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_READ = ("hit", "t", "normal", "prim", "src")   # route reads these too
_WRITTEN = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc")
_DTYPES = {"pixel": torch.int32, "hit": torch.bool, "prim": torch.int32,
           "src": torch.int32, "bounces": torch.int32}


def _read_contiguous(state):
    """``state`` with the fields route only reads made contiguous (they
    may come from a walk as column views)."""
    return dataclasses.replace(state, **{
        f: (tuple(c.contiguous() for c in v) if isinstance(v, tuple)
            else v.contiguous()) for f, v in vars(state).items()
        if f in _READ})


def _state_args(a, state, words, names):
    """Fill ``a``'s fields of the state columns ``names`` and the words,
    after checking each one."""
    n = state.pixel.shape[0]
    dev = state.pixel.device
    for name in names:
        v = getattr(state, name)
        dt = _DTYPES.get(name, torch.float32)
        if isinstance(v, tuple):
            for k, c in enumerate(v):
                _need(f"{name}[{k}]", c, dt, (n,), dev)
            setattr(a, name, _ptrs3(v))
        else:
            _need(name, v, dt, (n,), dev)
            setattr(a, name, v.data_ptr())
    _need("words", words, torch.int64, (NUM_RNG_WORDS, n), dev)
    a.words = words.data_ptr()
    a.n = n


def _scene_args(a, scene, camera, cfg, dev):
    """Fill ``a``'s scene, camera (unless None) and config fields after
    checking every table the kernels read."""
    f32, i32 = torch.float32, torch.int32
    lights, mats = scene.lights, scene.materials
    tables = [("prim_light", scene.prim_light, i32),
              ("prim_material", scene.prim_material, i32),
              ("mtype", mats.mtype, i32), ("albedo", mats.albedo, f32),
              ("ior", mats.ior, f32), ("ltype", lights.ltype, i32),
              ("lpos", lights.pos, f32), ("lemit", lights.emit, f32),
              ("ltri", lights.tri, i32), ("ltp0", lights.tri_p0, f32),
              ("lte1", lights.tri_e1, f32), ("lte2", lights.tri_e2, f32),
              ("ltn", lights.tri_n, f32), ("env", scene.env_radiance, f32),
              ("root_lo", scene.bvh.bmin, f32),
              ("root_hi", scene.bvh.bmax, f32)]
    if camera is not None:
        tables += [(name, getattr(camera, name), f32) for name in
                   ("lookfrom", "upper_left", "horizontal", "vertical")]
    if scene.instances is not None:
        tables.append(("inst_material", scene.instances.material, i32))
    if blocked_order(cfg):
        tables.append(("pixel_table", blocked_pixel_table(
            cfg.width, cfg.height, dev), i32))
    for name, t, dt in tables:
        _need(name, t, dt, t.shape, dev)
        setattr(a, name, t.data_ptr())
    a.num_prims = scene.prim_material.shape[0]
    a.num_materials = mats.mtype.shape[0]
    a.num_light_rows = lights.ltype.shape[0]
    a.num_lights = scene.num_lights
    a.max_bounces = cfg.max_bounces
    a.rr_start = cfg.rr_start
    a.rr_threshold = cfg.rr_threshold
    a.sort_key = SORT_KEYS.index(cfg.sort_key)
    a.spp = cfg.num_samples
    a.num_pixels = cfg.num_pixels
    a.width, a.height = cfg.width, cfg.height
    a.cam_end = cfg.total_camera_rays


def launch(name, a, dev):
    """Launch kernel ``name`` (an entry of ``_COUNTERS``: a kernel of
    :data:`MODE_KERNELS`, "route_v1" or "shade_v1") with the argument
    block ``a`` on ``dev``'s current stream; raise on a CUDA error code."""
    entry = getattr(_kernels(), f"rtjax_step_{name}")
    rc = entry(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step {name} kernel launch failed: CUDA error "
                           f"{rc}")
    counter, key = _COUNTERS[name]
    counter[key] += 1


def _scalar(name, t, dtype, dev):
    """Check a 0-d carry scalar; returns its pointer."""
    _need(name, t, dtype, (), dev)
    return t.data_ptr()


def _step_scalars(a, it, cam_start, dev):
    if torch.is_tensor(it):
        a.it = _scalar("it", it, torch.int64, dev)
    else:
        a.it, a.it_value = None, int(it)
    a.cam_start = _scalar("cam_start", cam_start, torch.int64, dev)


def route_args(scene, cfg, state, words, v1=False, mode="default"):
    """``(argument block, (keys, bundle, counts))`` of a route launch (the
    first design's with ``v1``), its outputs allocated (``counts``
    zeroed); under a full-record ``mode`` ``(keys or None, record,
    counts)`` (:func:`route_full`)."""
    n, dev = state.pixel.shape[0], state.pixel.device
    mode = engine_of(mode)
    state = _read_contiguous(state)
    a = StepArgs()
    _state_args(a, state, words, _READ + _WRITTEN)
    _scene_args(a, scene, None, cfg, dev)
    counts = torch.zeros(NUM_COUNTS, dtype=torch.int64, device=dev)
    if mode != "default":
        keys = torch.empty(n, dtype=torch.int32, device=dev) \
            if mode in ("parity", "wide") else None
        record = torch.empty((n, FULL_ROWS), dtype=torch.int32, device=dev)
        a.keys = None if keys is None else keys.data_ptr()
        a.bundle, a.counts = record.data_ptr(), counts.data_ptr()
        a.held = (state, words, keys, record, counts)
        return a, (keys, record, counts)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    bundle = torch.empty((V1_BUNDLE_ROWS, n) if v1 else (n, BUNDLE_ROWS),
                         dtype=torch.int32, device=dev)
    a.keys, a.bundle, a.counts = (keys.data_ptr(), bundle.data_ptr(),
                                  counts.data_ptr())
    a.held = (state, words, keys, bundle, counts)
    return a, (keys, bundle, counts)


def shade_args(scene, camera, cfg, state, fb, words, order, bundle, counts,
               it, cam_start, sort_every, v1=False, mode="default"):
    """``(argument block, Shaded)`` of a shade launch (the first design's
    with ``v1``; under a full-record ``mode`` :func:`shade_full`'s, with
    ``bundle`` the record, ``order`` None on the unsorted engine, and the
    scan buffer of the current stream where the camera rank needs it):
    the outputs the kernel writes beside the state allocated, the shadow
    columns ``[2N]`` (``[N]`` and the BSDF-MIS mask under
    ``one_sample_mis``)."""
    n, dev = state.pixel.shape[0], state.pixel.device
    mode = engine_of(mode)
    full = mode != "default"
    a = StepArgs()
    if mode == "unsorted":
        # route and shade in one kernel: route's inputs too, no record
        state = _read_contiguous(state)
        _state_args(a, state, words, _READ + _WRITTEN)
    else:
        _state_args(a, state, words, _WRITTEN)
        _need("bundle", bundle, torch.int32,
              (n, FULL_ROWS) if full else (V1_BUNDLE_ROWS, n) if v1
              else (n, BUNDLE_ROWS), dev)
        a.bundle = bundle.data_ptr()
    _scene_args(a, scene, camera, cfg, dev)
    _need("fb", fb, torch.float32, (cfg.num_pixels, 3), dev)
    if order is not None or mode in ("default", "wide", "parity"):
        _need("order", order, torch.int64, (n,), dev)
        a.order = order.data_ptr()
    _need("counts", counts, torch.int64, (NUM_COUNTS,), dev)
    _step_scalars(a, it, cam_start, dev)
    a.fb, a.counts = fb.data_ptr(), counts.data_ptr()
    a.sort_every = sort_every
    trace_mask = torch.empty(n, dtype=torch.bool, device=dev)
    a.trace_mask = trace_mask.data_ptr()
    out = Shaded(pixel=state.pixel, ray_o=state.ray_o, ray_d=state.ray_d,
                 beta=state.beta, bounces=state.bounces, acc=state.acc,
                 trace_mask=trace_mask, counts=counts)
    scan = None
    if full:
        out.record, out.order = bundle, order
    if full and mode != "wide":
        scan = scan_buffer(dev, torch.cuda.current_stream(dev).cuda_stream,
                           n)
        a.scan = scan.data_ptr()
        if mode.startswith("parity"):
            out.limbo = torch.empty(n, dtype=torch.bool, device=dev)
            a.limbo = out.limbo.data_ptr()
            for name in ("p0", "e1", "e2", "n"):
                t = getattr(scene.tris, name)
                _need(f"tris.{name}", t, torch.float32, (scene.tris.num, 3),
                      dev)
                setattr(a, f"tri_{name}", t.data_ptr())
            a.num_tris = scene.tris.num
    if scene.num_lights > 0:
        rays = n if cfg.one_sample_mis else 2 * n
        col = lambda dt, m=rays: torch.empty(m, dtype=dt, device=dev)
        f32 = torch.float32
        out.shadow = (tuple(col(f32) for _ in range(3)),
                      tuple(col(f32) for _ in range(3)), col(f32),
                      col(torch.int32), col(torch.bool))
        out.ah_L = tuple(col(f32, n) for _ in range(3))
        out.chs_L = tuple(col(f32, n) for _ in range(3))
        a.sh_o, a.sh_d = _ptrs3(out.shadow[0]), _ptrs3(out.shadow[1])
        a.sh_tmax, a.sh_exclude, a.sh_mask = (t.data_ptr()
                                              for t in out.shadow[2:])
        a.ah_L, a.chs_L = _ptrs3(out.ah_L), _ptrs3(out.chs_L)
        if cfg.one_sample_mis:
            out.chs_mask = col(torch.bool)
            a.chs_mask = out.chs_mask.data_ptr()
    a.held = (state, words, fb, order, bundle, it, cam_start, scan, out)
    return a, out


def _contiguous_hits(hits):
    return tuple(tuple(c.contiguous() for c in v) if isinstance(v, tuple)
                 else v.contiguous() for v in hits)


def resolve_args(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
                 occ_sum, hits=None, hist=None, restore=False):
    """``(argument block, (acc, cam_start, work_left, rays_traced,
    occ_sum))`` of a resolve launch, the new counters allocated, and under
    ``detailed_stats`` ``hist`` last (the kernel adds to it); with
    ``restore`` (the parity modes' resolve) ``(acc, hits, cam_start,
    ...)``, the closest ``hits`` made contiguous for the kernel to write.
    Under ``one_sample_mis`` the kernel reads ``hits``' hit, prim and
    src."""
    _check_hist(cfg, hist)
    n, dev = sh.trace_mask.shape[0], sh.trace_mask.device
    a = StepArgs()
    a.n = n
    # resolve reads num_lights only as "there are shadow rays"
    a.num_lights = 0 if sh.shadow is None else 1
    for k, c in enumerate(sh.acc):
        _need(f"acc[{k}]", c, torch.float32, (n,), dev)
    a.acc = _ptrs3(sh.acc)
    held = ()
    if hits is not None:
        hits = _contiguous_hits(hits)
    if sh.shadow is not None:
        one = sh.chs_mask is not None
        _need("occluded", occluded, torch.bool, ((1 if one else 2) * n,),
              dev)
        a.occluded, a.sh_mask = occluded.data_ptr(), sh.shadow[4].data_ptr()
        a.ah_L, a.chs_L = _ptrs3(sh.ah_L), _ptrs3(sh.chs_L)
        if one:
            # the BSDF-MIS channel lands where the path ray's closest hit
            # is the picked light's triangle (the NEE ray's exclude)
            if hits is None:
                raise ValueError("one_sample_mis's resolve takes the path "
                                 "rays' closest hits")
            hit, _, _, prim, src = hits
            for name, v, dt in (("hit", hit, torch.bool),
                                ("prim", prim, torch.int32),
                                ("src", src, torch.int32),
                                ("chs_mask", sh.chs_mask, torch.bool),
                                ("exclude", sh.shadow[3], torch.int32)):
                _need(name, v, dt, (n,), dev)
            a.hit, a.prim, a.src = (hit.data_ptr(), prim.data_ptr(),
                                    src.data_ptr())
            a.chs_mask, a.sh_exclude = (sh.chs_mask.data_ptr(),
                                        sh.shadow[3].data_ptr())
            held = (hits,)
    if hist is not None:
        _need("hist", hist, torch.int64, (cfg.max_bounces + 1,), dev)
        _need("bounces", sh.bounces, torch.int32, (n,), dev)
        _need("trace_mask", sh.trace_mask, torch.bool, (n,), dev)
        a.hist, a.bounces = hist.data_ptr(), sh.bounces.data_ptr()
        a.trace_mask, a.max_bounces = sh.trace_mask.data_ptr(), \
            cfg.max_bounces
    _step_scalars(a, it, cam_start, dev)
    _need("counts", sh.counts, torch.int64, (NUM_COUNTS,), dev)
    a.counts = sh.counts.data_ptr()
    a.sort_every = sort_every
    a.rays_in = _scalar("rays_traced", rays_traced, torch.float64, dev)
    a.occ_in = _scalar("occ_sum", occ_sum, torch.float64, dev)
    new = lambda dt: torch.empty((), dtype=dt, device=dev)
    cam, work, rays, occ = (new(torch.int64), new(torch.bool),
                            new(torch.float64), new(torch.float64))
    a.cam_out, a.work_out, a.rays_out, a.occ_out = (
        cam.data_ptr(), work.data_ptr(), rays.data_ptr(), occ.data_ptr())
    a.held = (sh, occluded, it, cam_start, rays_traced, occ_sum, cam, work,
              rays, occ, hist) + held
    tail = () if hist is None else (hist,)
    if not restore:
        return a, (sh.acc, cam, work, rays, occ) + tail
    hit, t, normal, prim, src = hits
    for name, v, dt in (("hit", hit, torch.bool), ("t", t, torch.float32),
                        ("prim", prim, torch.int32),
                        ("src", src, torch.int32), ("limbo", sh.limbo,
                                                    torch.bool)):
        _need(name, v, dt, (n,), dev)
    for k, c in enumerate(normal):
        _need(f"normal[{k}]", c, torch.float32, (n,), dev)
    _need("record", sh.record, torch.int32, (n, FULL_ROWS), dev)
    if sh.order is not None:
        _need("order", sh.order, torch.int64, (n,), dev)
        a.order = sh.order.data_ptr()
    a.hit_out, a.t_out, a.prim_out, a.src_out = (
        hit.data_ptr(), t.data_ptr(), prim.data_ptr(), src.data_ptr())
    a.normal_out = _ptrs3(normal)
    a.limbo, a.bundle = sh.limbo.data_ptr(), sh.record.data_ptr()
    a.held += (hits,)
    return a, (sh.acc, hits, cam, work, rays, occ) + tail


# ------------------------------------------------------------ wrappers

def route(scene, cfg, state, words):
    """Emission, Russian roulette, the sort keys and the packed bundle of
    one iteration: ``(keys, bundle, counts)`` (module docstring); the
    first design's under ``DESIGN = "v1"``."""
    if DESIGN == "v1":
        return route_v1(scene, cfg, state, words)
    if not _on_card(state.pixel):
        return route_ref(scene, cfg, state, words)
    a, out = route_args(scene, cfg, state, words)
    launch("route", a, state.pixel.device)
    return out


def shade(scene, camera, cfg, state, fb, words, order, bundle, counts, it,
          cam_start, sort_every):
    """Shading, camera generation, the flush and the merge of one
    iteration's sorted pool: a :class:`Shaded` (module docstring); the
    first design's under ``DESIGN = "v1"``."""
    if DESIGN == "v1":
        return shade_v1(scene, camera, cfg, state, fb, words, order, bundle,
                        counts, it, cam_start, sort_every)
    if not _on_card(state.pixel):
        return shade_ref(scene, camera, cfg, state, fb, words, order,
                         bundle, counts, it, cam_start, sort_every)
    a, out = shade_args(scene, camera, cfg, state, fb, words, order, bundle,
                        counts, it, cam_start, sort_every)
    launch(kernels_of(cfg, "default")[1], a, state.pixel.device)
    return out


def route_v1(scene, cfg, state, words):
    """:func:`route` in the first design: the bundle as ``[9, N]``
    columns."""
    if not _on_card(state.pixel):
        return route_v1_ref(scene, cfg, state, words)
    a, out = route_args(scene, cfg, state, words, v1=True)
    launch("route_v1", a, state.pixel.device)
    return out


def shade_v1(scene, camera, cfg, state, fb, words, order, bundle, counts,
             it, cam_start, sort_every):
    """:func:`shade` in the first design: the ``[9, N]`` columns gathered
    one at a time, the material looked up from prim and src, every dead
    lane's radiance added by float atomics."""
    if cfg.one_sample_mis:
        raise ValueError("the first design has no one_sample_mis instance")
    if not _on_card(state.pixel):
        return shade_v1_ref(scene, camera, cfg, state, fb, words, order,
                            bundle, counts, it, cam_start, sort_every)
    a, out = shade_args(scene, camera, cfg, state, fb, words, order, bundle,
                        counts, it, cam_start, sort_every, v1=True)
    launch("shade_v1", a, state.pixel.device)
    return out


def resolve(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
            occ_sum, hits=None, hist=None):
    """The shadow results into the radiance, and the step's counters:
    ``(acc, cam_start, work_left, rays_traced, occ_sum)`` (module
    docstring); under ``one_sample_mis`` the BSDF-MIS channel where the
    path rays' closest ``hits`` ``(hit, t, normal, prim, src)`` are the
    picked light's triangle; under ``detailed_stats`` ``hist`` (the bounce
    histogram, which the kernel adds to in place) with the step's traced
    lanes added, last."""
    if not _on_card(sh.trace_mask):
        return resolve_ref(cfg, sh, occluded, it, sort_every, cam_start,
                           rays_traced, occ_sum, hits, hist)
    a, out = resolve_args(cfg, sh, occluded, it, sort_every, cam_start,
                          rays_traced, occ_sum, hits, hist)
    launch(kernels_of(cfg, "default")[-1], a, sh.trace_mask.device)
    return out


def route_full(scene, cfg, state, words, mode):
    """Emission and Russian roulette of one iteration under a full-record
    mode with a route of its own (the engines "wide", "parity" and
    "parity_unsorted" of :func:`step_mode`): ``(keys, record, counts)``,
    ``keys`` the sort keys (with the dirty class under "wide"; None on the
    unsorted engine), ``record`` ``[N, FULL_ROWS]`` (:func:`pack_full`;
    under "wide" the hit point in the origin words) and ``counts`` the
    continuing paths in [0] and the limbo lanes in [4] (under "wide" the
    dirty lanes)."""
    if not _on_card(state.pixel):
        return route_full_ref(scene, cfg, state, words, mode)
    a, out = route_args(scene, cfg, state, words, mode=mode)
    launch(kernels_of(cfg, mode)[0], a, state.pixel.device)
    return out


def shade_full(scene, camera, cfg, state, fb, words, order, record, counts,
               cam_start, mode):
    """Shading, camera generation, the flush and the merge under a
    full-record mode of :func:`route_full`: a :class:`Shaded` (as
    :func:`shade`, with ``limbo``, ``record`` and ``order`` for
    :func:`resolve_full`).  ``order`` is the sort's permutation ("wide",
    "parity"), None on the unsorted engine.  Under the parity modes the
    camera rays go by the exclusive prefix sum of the lanes that take one
    and every such lane flushes; under "wide" they go to the dead suffix
    and the dirty window flushes, as :func:`shade`'s."""
    if not _on_card(state.pixel):
        return shade_full_ref(scene, camera, cfg, fb, words, order, record,
                              counts, cam_start, mode)
    a, out = shade_args(scene, camera, cfg, state, fb, words, order, record,
                        counts, 0, cam_start, 1, mode=mode)
    launch(kernels_of(cfg, mode)[1], a, state.pixel.device)
    return out


def route_shade_unsorted(scene, camera, cfg, state, fb, words, cam_start):
    """:func:`route_full` and :func:`shade_full` of the unsorted engine
    (``step_mode`` "unsorted") as one kernel, route's record kept in
    registers: a :class:`Shaded` without ``limbo`` and ``record``, its
    ``counts`` the continuing paths in [0] (no lane is in limbo)."""
    if not _on_card(state.pixel):
        return route_shade_unsorted_ref(scene, camera, cfg, state, fb, words,
                                        cam_start)
    dev = state.pixel.device
    a, out = shade_args(scene, camera, cfg, state, fb, words, None, None,
                        torch.zeros(NUM_COUNTS, dtype=torch.int64,
                                    device=dev), 0, cam_start, 1,
                        mode="unsorted")
    launch(kernels_of(cfg, "unsorted")[0], a, dev)
    return out


def resolve_full(cfg, sh, occluded, hits, cam_start, rays_traced, occ_sum,
                 mode, hist=None):
    """:func:`resolve` under a full-record mode: ``(acc, hits, cam_start,
    work_left, rays_traced, occ_sum)`` (and ``hist`` under
    ``detailed_stats``), ``hits`` the closest hits ``(hit, t, normal,
    prim, src)``; under the parity modes each limbo lane's hit, t, normal,
    prim and src restored from the record (the kernel writes them into
    ``hits``' own tensors) and the frame held while a lane is in limbo.
    The unsorted engine and the wide bundle have no limbo lanes:
    :func:`resolve` at ``sort_every`` 1."""
    if not engine_of(mode).startswith("parity"):
        acc, *rest = resolve(cfg, sh, occluded, 0, 1, cam_start,
                             rays_traced, occ_sum, hits, hist)
        return (acc, hits, *rest)
    if not _on_card(sh.trace_mask):
        return resolve_full_ref(cfg, sh, occluded, hits, cam_start,
                                rays_traced, occ_sum, mode, hist)
    a, out = resolve_args(cfg, sh, occluded, 0, 1, cam_start, rays_traced,
                          occ_sum, hits, hist, restore=True)
    launch(kernels_of(cfg, mode)[-1], a, sh.trace_mask.device)
    return out
