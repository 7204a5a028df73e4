"""The fused wavefront step: one iteration's per-lane stages as three
hand-written CUDA kernels around one ``torch.sort``, their wrappers, and
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
- ``torch.sort(keys, stable=True)`` between them, rtjax's ``lax.sort``;
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

They cover the default estimator of the sorted engine with the compact
bundle (render/wavefront.py ``step_kernels_cover``).  A CUDA tensor goes to
the kernels (built at first use, bound with ctypes, launched on torch's
current stream so that a captured graph holds them); a CPU tensor to the
plain versions.  There is no fallback between them.

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
  rays_traced, occ_sum) -> (acc, cam_start, work_left, rays_traced,
  occ_sum)``: ``occluded`` the ``[2N]`` any-hit result (None without
  lights).  The kernel adds into ``sh.acc`` in place.

The kernels mirror the plain versions op for op (the build uses
``--fmad=false``): every output agrees bit for bit but the framebuffer,
whose float atomic adds take another order than ``index_add_``'s (an
ordered flush cost more device time than it was allowed: PERF.md).

The first design (kept for same-run A/B and on no default path:
:func:`route_v1` / :func:`shade_v1`, ``V1_LAUNCHES``) writes the bundle as
nine ``[N]`` columns, ``[9, N]``, and gathers it column by column.
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
from ..render.trace import _hit_material_index, gather_hit_materials_v3
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
# continuing paths, path rays, NEE rays, MIS rays, dirty lanes
NUM_COUNTS = 5

# the kernels the fused step runs: "record" (the default) or "v1"; a
# captured step belongs to the design it was captured under (render/graph.py
# keys its cache on it)
DESIGN = "record"

# kernel launches (wrapper, CUDA path) and plain-version calls, by kernel
LAUNCHES = {"route": 0, "shade": 0, "resolve": 0}
V1_LAUNCHES = {"route": 0, "shade": 0}
REF_CALLS = {"route": 0, "shade": 0, "resolve": 0}

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
    REF_CALLS["shade"] += 1
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
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if scene.num_lights == 0:
        out.counts = torch.stack((num_mat, trace_mask.sum(), zero, zero,
                                  counts[4]))
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
    out.counts = torch.stack((num_mat, trace_mask.sum(), sh["ah_mask"].sum(),
                              sh["chs_mask"].sum(), counts[4]))
    return out


def resolve_ref(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
                occ_sum):
    """Plain PyTorch version of :func:`resolve` (same contract, any
    device)."""
    REF_CALLS["resolve"] += 1
    n = sh.trace_mask.shape[0]
    acc = sh.acc
    if sh.shadow is not None:
        mask = sh.shadow[4]
        acc = accum(acc, sh.ah_L, mask[:n] & ~occluded[:n])
        acc = accum(acc, sh.chs_L, mask[n:] & ~occluded[n:])
    c = sh.counts
    num_gen = n - c[0]
    do_gen = cadence(c, n, it, sort_every)
    if do_gen is not None:
        num_gen = num_gen * do_gen
    return (acc, cam_start + num_gen, c[1] > 0,
            rays_traced + c[1:4].sum().to(torch.float64),
            occ_sum + c[1].to(torch.float64) / n)


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
    # the scene and the camera
    ("prim_light", _P), ("prim_material", _P), ("inst_material", _P),
    ("mtype", _P), ("albedo", _P), ("ior", _P),
    ("ltype", _P), ("lpos", _P), ("lemit", _P), ("ltri", _P),
    ("ltp0", _P), ("lte1", _P), ("lte2", _P), ("ltn", _P),
    ("env", _P), ("root_lo", _P), ("root_hi", _P),
    ("lookfrom", _P), ("upper_left", _P), ("horizontal", _P),
    ("vertical", _P), ("pixel_table", _P),
    ("it_value", _I64),
    ("n", _I32), ("num_prims", _I32), ("num_materials", _I32),
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
_COUNTERS = {"route": (LAUNCHES, "route"), "shade": (LAUNCHES, "shade"),
             "resolve": (LAUNCHES, "resolve"),
             "route_v1": (V1_LAUNCHES, "route"),
             "shade_v1": (V1_LAUNCHES, "shade")}
# kernel ids of ``rtjax_step_kernel_info``
KERNEL_IDS = {"route": 0, "shade": 1, "resolve": 2, "route_v1": 3,
              "shade_v1": 4}

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
    """Launch kernel ``name`` (an entry of ``_COUNTERS``: "route",
    "shade", "resolve", "route_v1" or "shade_v1") with the
    argument block ``a`` on ``dev``'s current stream; raise on a CUDA
    error code."""
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


def route_args(scene, cfg, state, words, v1=False):
    """``(argument block, (keys, bundle, counts))`` of a route launch (the
    first design's with ``v1``), its outputs allocated (``counts``
    zeroed)."""
    n, dev = state.pixel.shape[0], state.pixel.device
    # the fields route only reads may come from a walk as column views
    state = dataclasses.replace(state, **{
        f: (tuple(c.contiguous() for c in v) if isinstance(v, tuple)
            else v.contiguous()) for f, v in vars(state).items()
        if f in _READ})
    a = StepArgs()
    _state_args(a, state, words, _READ + _WRITTEN)
    _scene_args(a, scene, None, cfg, dev)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    bundle = torch.empty((V1_BUNDLE_ROWS, n) if v1 else (n, BUNDLE_ROWS),
                         dtype=torch.int32, device=dev)
    counts = torch.zeros(NUM_COUNTS, dtype=torch.int64, device=dev)
    a.keys, a.bundle, a.counts = (keys.data_ptr(), bundle.data_ptr(),
                                  counts.data_ptr())
    a.held = (state, words, keys, bundle, counts)
    return a, (keys, bundle, counts)


def shade_args(scene, camera, cfg, state, fb, words, order, bundle, counts,
               it, cam_start, sort_every, v1=False):
    """``(argument block, Shaded)`` of a shade launch (the first design's
    with ``v1``): the outputs the kernel writes beside the state
    allocated."""
    n, dev = state.pixel.shape[0], state.pixel.device
    a = StepArgs()
    _state_args(a, state, words, _WRITTEN)
    _scene_args(a, scene, camera, cfg, dev)
    _need("fb", fb, torch.float32, (cfg.num_pixels, 3), dev)
    _need("order", order, torch.int64, (n,), dev)
    _need("bundle", bundle, torch.int32,
          (V1_BUNDLE_ROWS, n) if v1 else (n, BUNDLE_ROWS), dev)
    _need("counts", counts, torch.int64, (NUM_COUNTS,), dev)
    _step_scalars(a, it, cam_start, dev)
    a.fb, a.order, a.bundle, a.counts = (fb.data_ptr(), order.data_ptr(),
                                         bundle.data_ptr(),
                                         counts.data_ptr())
    a.sort_every = sort_every
    trace_mask = torch.empty(n, dtype=torch.bool, device=dev)
    a.trace_mask = trace_mask.data_ptr()
    out = Shaded(pixel=state.pixel, ray_o=state.ray_o, ray_d=state.ray_d,
                 beta=state.beta, bounces=state.bounces, acc=state.acc,
                 trace_mask=trace_mask, counts=counts)
    if scene.num_lights > 0:
        col = lambda dt, m=2 * n: torch.empty(m, dtype=dt, device=dev)
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
    a.held = (state, words, fb, order, bundle, it, cam_start, out)
    return a, out


def resolve_args(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
                 occ_sum):
    """``(argument block, (acc, cam_start, work_left, rays_traced,
    occ_sum))`` of a resolve launch, the new counters allocated."""
    n, dev = sh.trace_mask.shape[0], sh.trace_mask.device
    a = StepArgs()
    a.n = n
    # resolve reads num_lights only as "there are shadow rays"
    a.num_lights = 0 if sh.shadow is None else 1
    for k, c in enumerate(sh.acc):
        _need(f"acc[{k}]", c, torch.float32, (n,), dev)
    a.acc = _ptrs3(sh.acc)
    if sh.shadow is not None:
        _need("occluded", occluded, torch.bool, (2 * n,), dev)
        a.occluded, a.sh_mask = occluded.data_ptr(), sh.shadow[4].data_ptr()
        a.ah_L, a.chs_L = _ptrs3(sh.ah_L), _ptrs3(sh.chs_L)
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
              rays, occ)
    return a, (sh.acc, cam, work, rays, occ)


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
    launch("shade", a, state.pixel.device)
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
    if not _on_card(state.pixel):
        return shade_v1_ref(scene, camera, cfg, state, fb, words, order,
                            bundle, counts, it, cam_start, sort_every)
    a, out = shade_args(scene, camera, cfg, state, fb, words, order, bundle,
                        counts, it, cam_start, sort_every, v1=True)
    launch("shade_v1", a, state.pixel.device)
    return out


def resolve(cfg, sh, occluded, it, sort_every, cam_start, rays_traced,
            occ_sum):
    """The shadow results into the radiance, and the step's counters:
    ``(acc, cam_start, work_left, rays_traced, occ_sum)`` (module
    docstring)."""
    if not _on_card(sh.trace_mask):
        return resolve_ref(cfg, sh, occluded, it, sort_every, cam_start,
                           rays_traced, occ_sum)
    a, out = resolve_args(cfg, sh, occluded, it, sort_every, cam_start,
                          rays_traced, occ_sum)
    launch("resolve", a, sh.trace_mask.device)
    return out
