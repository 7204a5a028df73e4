"""The wavefront path-tracing engine (port of rtjax.render.wavefront).

A persistent pool of path slots; each iteration is one bounce for every
slot in flight: emission / Russian roulette / routing, ONE stable sort of
the packed path state (continuing paths first, grouped by the
``sort_key``'s locality key; dead slots that still hold radiance next;
clean dead slots last), NEE + MIS shading, camera-ray generation into the
dead suffix, the framebuffer flush, then the closest-hit traversal of the
path rays and one any-hit traversal of both shadow channels (2N rays).

The sort carries the compact bundle (packed words, octahedral normals and
directions, RGB9E5 throughput and radiance) where its ranges hold
(``_compact_bundle_ok``: at most 2^21 pixels, 255 instances, 125
bounces), and the wide bundle (every field at full precision) beyond.
rtjax's unsorted engine runs where ``sort_rays`` is False or the
traversal is "xla" (render/trace.py ``resolve_mode``), as rtjax runs it:
every slot keeps its place, and regenerated slots are ranked by a prefix
sum.

Estimator modes (``RenderConfig``), as in rtjax:

- ``one_sample_mis``: the BSDF-sampling MIS channel reuses the path ray's
  sample, and its "closest hit is the picked light's triangle" test reads
  the path ray's own hit, so the any-hit launch traces N rays, not 2N, and
  ``rays_traced`` counts only the traversals made;
- ``reference_parity``: the reference's three estimator quirks (the
  truncated second pdf of the power heuristic, the BSDF-MIS target on the
  triangle the path stands on, and Russian-roulette "limbo": a killed path
  keeps its hit and re-rolls on later iterations, neither shading, tracing
  nor regenerating meanwhile); it sorts every iteration, carries the path
  state unpacked through the sort and ranks regenerated slots by a prefix
  sum, as rtjax does;
- the constant environment light (``Scene.env_radiance``) adds
  ``beta * env`` where a path misses (zero in every built-in scene);
- ``detailed_stats``: the bounce histogram of traced path rays and the
  traversal kernels' node visits and leaf rows (persist kernels only), all
  accumulated on the device.

Differences from rtjax, none of which changes a result:

- ``lax.while_loop`` becomes a Python loop whose condition reads one
  device value per iteration (``render_frame_linear``).
- rtjax windows three stages to the live part of the sorted pool: the
  prefix-windowed shading (``shade_chunks``), the 1/8-chunked camera
  generation and the chunked flush.  Lanes outside the windows compute
  values that every consumer masks off, so the results are bitwise the
  same; this port runs the three stages at full width.  Whether the windows
  pay on the H100 is an open A/B (ROADMAP Queue S 2).
- The random words of an iteration come from the caller (``words``);
  ``render_frame`` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import RenderConfig
from ..constants import DEAD_BOUNCES, INVALID_INDEX
from ..core import rng, vec
from ..core.geometry import intersect_triangle_v3, spawn_offset_ray_v3
from ..core.sampling import power_heuristic
from ..scene.camera import Camera
from ..scene.light import gather_light_v3, is_delta, pdf_li_v3, sample_li_v3
from ..scene.material import get_f_v3, is_specular, sample_f_v3
from ..scene.scene import Scene
from .sorting import (oct_decode_v3, oct_encode_v3,
                      ray_sort_keys_adaptive_v3, ray_sort_keys_normal_pos_v3,
                      ray_sort_keys_pos10_v3, ray_sort_keys_pos_v3,
                      ray_sort_keys_prim_pos_v3, ray_sort_keys_prim_v3,
                      ray_sort_keys_v3, rgb9e5_decode_v3, rgb9e5_encode_v3,
                      sort_pytree_by_key)
from .trace import (check_config, gather_hit_materials_v3, resolve_mode,
                    trace_anyhit, trace_closest)

# random word ids: each word splits into two 16-bit uniforms
_W_RR_PICK = 0      # (RR uniform, light pick)
_W_BSDF1 = 1        # (u1, u2); the glass uniform u3 aliases u1
_W_LIGHT_UV = 2     # light-triangle barycentrics
_W_BSDF2 = 3        # (u1, u2); u3 aliases u1
_W_GEN = 4          # subpixel jitter
NUM_RNG_WORDS = 5

_DIRTY_KEY = 0x7FFFFFFE   # dead lanes that still hold radiance


@dataclasses.dataclass
class PathState:
    """SoA path payload, one entry per pool slot; vector fields are
    component triples of ``[N]`` tensors."""

    pixel: torch.Tensor    # [N] int32
    ray_o: tuple           # 3 x [N] float32
    ray_d: tuple           # 3 x [N] float32
    hit: torch.Tensor      # [N] bool
    t: torch.Tensor        # [N] float32 hit distance (inf on a miss)
    normal: tuple          # 3 x [N] float32 unnormalised geometric normal
    prim: torch.Tensor     # [N] int32 leaf-order triangle (-1 = none)
    src: torch.Tensor      # [N] int32 hit source (0 = base scene)
    bounces: torch.Tensor  # [N] int32
    beta: tuple            # 3 x [N] float32 throughput
    acc: tuple             # 3 x [N] float32 radiance not yet flushed


def make_initial_state(n: int, device) -> PathState:
    """Fresh pool: every slot dead, so iteration 0 routes all to gen."""
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
    i = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)
    return PathState(
        pixel=i(0), ray_o=(f(0.0), f(0.0), f(0.0)),
        ray_d=(f(0.0), f(0.0), f(1.0)),
        hit=torch.zeros(n, dtype=torch.bool, device=device),
        t=f(float("inf")), normal=(f(0.0), f(0.0), f(0.0)),
        prim=i(INVALID_INDEX), src=i(0), bounces=i(DEAD_BOUNCES),
        beta=(f(1.0), f(1.0), f(1.0)), acc=(f(0.0), f(0.0), f(0.0)))


@functools.lru_cache(maxsize=8)
def _blocked_pixel_order(width: int, height: int, block: int = 16):
    """Rank -> pixel index visiting the screen in 16x16 blocks (row-major
    blocks, row-major within)."""
    y, x = np.mgrid[0:height, 0:width]
    nbx = (width + block - 1) // block
    key = (((y // block) * nbx + (x // block)) * (block * block)
           + (y % block) * block + (x % block))
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


def _compact_bundle_ok(scene, cfg) -> bool:
    """Ranges of the packed sort bundle: pixel 21 bits, prim+1 23 bits (base
    scene and every BLAS), src 8 bits, bounces 7 bits with 127 as the dead
    sentinel."""
    max_prim = max([scene.tris.num] + [b.tris.num for b in scene.blas])
    num_src = 1 + (scene.instances.num if scene.instances is not None else 0)
    return (cfg.num_pixels <= 1 << 21 and max_prim < (1 << 23) - 1
            and num_src <= 1 << 8 and cfg.max_bounces + 1 < 127)


def resolve_sort_every(scene, cfg) -> int:
    """The sort/gen/flush cadence k: ``cfg.sort_every``, or on 0 (auto) 2
    for scenes of at most 1024 effective triangles (base + every instance's
    BLAS) and 1 above."""
    if cfg.sort_every > 0:
        return cfg.sort_every
    eff_tris = scene.tris.num
    if scene.instances is not None:
        eff_tris += sum(scene.blas[m].tris.num
                        for m in scene.instances.mesh_id)
    return 2 if eff_tris <= 1024 else 1


def check_slice(scene: Scene, cfg: RenderConfig) -> None:
    """Raise ValueError for modes that exclude each other, and for walker
    and traversal values the scene cannot take (trace.check_config)."""
    if cfg.one_sample_mis and cfg.reference_parity:
        raise ValueError("one_sample_mis replaces the reference's second "
                         "BSDF draw; it cannot be combined with "
                         "reference_parity")
    check_config(scene, cfg)


def _sort_keys(scene, cfg, state, hp, bounces, mat_mask):
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


def _accum(acc, value, mask):
    """Add ``value`` where ``mask`` and the contribution is finite
    (degenerate samples produce the occasional inf/NaN; they are dropped)."""
    ok = mask & vec.isfinite(value)
    return tuple(a + torch.where(ok, c, 0.0) for a, c in zip(acc, value))


def _shade(scene, cfg, src, prim, beta, p, wo, normal, mat_mask,
           u_bsdf1, u_pick, u_luv, u_bsdf2):
    """The mat stage: next path ray, NEE shadow ray (light-sampling MIS)
    and the BSDF-sampling MIS ray toward the picked light (its target the
    triangle the path stands on under ``reference_parity``; no ray of its
    own under ``one_sample_mis``)."""
    num_lights = scene.num_lights
    mtype, albedo, ior = gather_hit_materials_v3(scene, src, prim)
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


def wavefront_step(scene: Scene, camera: Camera, cfg: RenderConfig, words,
                   carry):
    """One wavefront iteration.  ``words`` is the iteration's ``[5, N]``
    block of 32-bit random words (int64); ``carry`` is ``(state, fb,
    cam_start, it, work_left, rays_traced, occ_sum)`` with ``it`` a Python
    int and the rest tensors on the scene's device, and under
    ``detailed_stats`` five more: the bounce histogram ``[max_bounces + 1]``
    and the node-step, leaf-visit, any-hit step and any-hit visit sums
    (int64).  The framebuffer ``fb`` is accumulated in place
    (``index_add_``) rather than copied."""
    state, fb, cam_start, it, _, rays_traced, occ_sum, *extra = carry
    n = state.pixel.shape[0]
    dev = state.pixel.device
    num_lights = scene.num_lights
    parity = cfg.reference_parity
    cam_end = cfg.total_camera_rays
    draw_pair = lambda w: rng.u01_pair(words[w])
    u_rr, u_pick = draw_pair(_W_RR_PICK)

    # ---- emission, Russian roulette, routing ------------------------------
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
    acc = _accum(state.acc, emit_val, emit0)
    # the constant environment light on a miss (a BSDF-sampled channel
    # that NEE never samples, so it takes no MIS weight)
    env_mask = ~state.hit & (state.bounces <= cfg.max_bounces)
    env = scene.env_radiance
    acc = _accum(acc, vec.mul(state.beta, (env[0], env[1], env[2])),
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
    bounces = state.bounces + 1
    mat_mask = alive & state.hit & ~rr_kill

    # ---- the sort: the iteration's one compaction step -------------------
    hp_t = torch.where(mat_mask, state.t, 0.0)
    hp = vec.add(state.ray_o, vec.scale(hp_t, state.ray_d))
    state_sorted = cfg.sort_rays and resolve_mode(scene, cfg) != "xla"
    # the reference's RR "limbo" (parity): a killed path keeps its payload
    # (and hit) for later re-rolls; it neither shades, traces nor
    # regenerates
    limbo = rr_kill if parity else None
    do_gen = True
    if not state_sorted:
        # the unsorted engine: every lane keeps its slot
        pixel, ray_o_p, ray_d_p, t_p, normal, prim, src = (
            state.pixel, state.ray_o, state.ray_d, state.t, state.normal,
            state.prim, state.src)
        p = hp
    elif parity:
        # every iteration sorts, with the full state
        bundle = (state.pixel, state.ray_o, state.ray_d, state.t,
                  state.normal, state.prim, state.src, bounces, beta, acc,
                  mat_mask, limbo)
        (pixel, ray_o_p, ray_d_p, t_p, normal, prim, src, bounces, beta, acc,
         mat_mask, limbo) = sort_pytree_by_key(
             _sort_keys(scene, cfg, state, hp, bounces, mat_mask), bundle)
        p = vec.add(ray_o_p, vec.scale(torch.where(mat_mask, t_p, 0.0),
                                       ray_d_p))
    else:
        compact = _compact_bundle_ok(scene, cfg)
        k_req = resolve_sort_every(scene, cfg) if compact else 1
        if k_req > 1:
            # sort, gen and flush only every k-th iteration, or when the
            # live part drops below 3/4 of the pool (one device read)
            num_mat_pre = int(mat_mask.sum())
            do_gen = (it % k_req) == 0 or num_mat_pre * 4 < n * 3
        if do_gen:
            dirty = ~mat_mask & ((acc[0] != 0.0) | (acc[1] != 0.0)
                                 | (acc[2] != 0.0))
            skeys = torch.where(dirty, _DIRTY_KEY, _sort_keys(
                scene, cfg, state, hp, bounces, mat_mask))
        sort = lambda bundle: sort_pytree_by_key(skeys, bundle) \
            if do_gen else bundle
        if compact:
            # packed bundle: pixel | bounces (7 bits, 127 = dead) | mat
            # bit; prim + 1 | src; octahedral normal and direction;
            # RGB9E5 beta and acc
            b7 = torch.clamp(bounces, max=127)
            pbm = state.pixel | (b7 << 21) | (mat_mask.to(torch.int32) << 28)
            sp = (state.prim + 1) | (state.src << 23)
            p, b9, a9, pbm, sp, onrm, od = sort((
                hp, rgb9e5_encode_v3(beta), rgb9e5_encode_v3(acc), pbm, sp,
                oct_encode_v3(state.normal), oct_encode_v3(state.ray_d)))
            ray_d_p = oct_decode_v3(od)
            beta = rgb9e5_decode_v3(b9)
            acc = rgb9e5_decode_v3(a9)
            pixel = pbm & 0x1FFFFF
            b_dec = (pbm >> 21) & 0x7F
            bounces = torch.where(b_dec >= 127, DEAD_BOUNCES, b_dec)
            mat_mask = ((pbm >> 28) & 1) != 0
            prim = (sp & 0x7FFFFF) - 1
            src = (sp >> 23) & 0xFF
            normal = oct_decode_v3(onrm)
        else:
            # the wide bundle (frames above 2^21 pixels, more than 255
            # instances, max_bounces >= 126): every field at full
            # precision, bounces (15 bits, 0x7FFF = dead) and the mat bit
            # in one word.  src rides in a column of its own: rtjax packs
            # it in 12 bits, which an instance id above 4,095 overflows
            # into the mat bit.
            meta = torch.clamp(bounces, max=0x7FFF) | \
                (mat_mask.to(torch.int32) << 15)
            pixel, p, ray_d_p, normal, prim, src, beta, acc, meta = sort((
                state.pixel, hp, state.ray_d, state.normal, state.prim,
                state.src, beta, acc, meta))
            mat_mask = ((meta >> 15) & 1) != 0
            b_dec = meta & 0x7FFF
            bounces = torch.where(b_dec >= 0x7FFF, DEAD_BOUNCES, b_dec)
        ray_o_p = p  # a dead lane's ray is never read
    gen_mask = ~mat_mask & ~limbo if parity else ~mat_mask

    # ---- shading (full width; see the module docstring) -------------------
    b1u1, b1u2 = draw_pair(_W_BSDF1)
    b2u1, b2u2 = draw_pair(_W_BSDF2)
    sh = _shade(scene, cfg, src, prim, beta, p, ray_d_p, normal, mat_mask,
                (b1u1, b1u2, b1u1), u_pick, draw_pair(_W_LIGHT_UV),
                (b2u1, b2u2, b2u1))

    # ---- camera generation into the dead suffix ---------------------------
    gen_u, gen_v = draw_pair(_W_GEN)
    if do_gen:
        num_gen = gen_mask.sum()
        if parity or not state_sorted:
            # the dead lanes are not a suffix (unsorted, or limbo lanes
            # among them): rank by a prefix sum
            gen_rank = torch.cumsum(gen_mask, 0) - gen_mask.long()
            cam_id = cam_start + gen_rank
            got_ray = gen_mask & (cam_id < cam_end)
        else:
            # after the sort the continuing lanes are exactly the prefix
            num_mat = n - num_gen
            idx = torch.arange(n, dtype=torch.int32, device=dev)
            gen_rank = torch.clamp(idx - num_mat, min=0)
            cam_id = cam_start + gen_rank
            got_ray = (idx >= num_mat) & (cam_id < cam_end)
        pix_rank = torch.clamp(torch.div(cam_id, cfg.num_samples,
                                         rounding_mode="floor"),
                               max=cfg.num_pixels - 1)
        blocked = (cfg.camera_order == "blocked"
                   or (cfg.camera_order == "auto" and cfg.num_samples <= 8))
        if blocked:
            order = torch.tensor(_blocked_pixel_order(cfg.width,
                                                      cfg.height), device=dev)
            pix_new = order[pix_rank.long()]
        else:
            pix_new = pix_rank.to(torch.int32)
        ci = (pix_new % cfg.width).to(torch.float32)
        cj = torch.div(pix_new, cfg.width, rounding_mode="floor") \
            .to(torch.float32)
        cam_o, cam_d = camera.get_rays_v3((ci + gen_u) / cfg.width,
                                          (cj + gen_v) / cfg.height)
        # flush the radiance of slots leaving their pixel
        flush = torch.stack([torch.where(gen_mask, c, 0.0) for c in acc], 1)
        fb.index_add_(0, pixel.long(), flush)
        acc = tuple(torch.where(gen_mask, 0.0, c) for c in acc)
    else:
        num_gen = torch.zeros((), dtype=torch.int64, device=dev)
        got_ray = torch.zeros(n, dtype=torch.bool, device=dev)
        pix_new = torch.zeros(n, dtype=torch.int32, device=dev)
        zf = torch.zeros(n, dtype=torch.float32, device=dev)
        cam_o = cam_d = (zf, zf, zf)

    # ---- merge continued and regenerated rays ------------------------------
    ray_o = vec.where(mat_mask, sh["next_o"],
                      vec.where(got_ray, cam_o, ray_o_p))
    ray_d = vec.where(mat_mask, sh["next_d"],
                      vec.where(got_ray, cam_d, ray_d_p))
    pixel = torch.where(got_ray, pix_new, pixel)
    beta = tuple(torch.where(mat_mask, nb, torch.where(got_ray, 1.0, b))
                 for nb, b in zip(sh["next_beta"], beta))
    bounces = torch.where(got_ray, 0,
                          torch.where(gen_mask, DEAD_BOUNCES, bounces))

    # ---- traversal ---------------------------------------------------------
    stats = cfg.detailed_stats
    trace_mask = mat_mask | got_ray
    ray_o = tuple(c.contiguous() for c in ray_o)
    ray_d = tuple(c.contiguous() for c in ray_d)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    hit, ht, hprim, hsrc, hnrm, *cst = trace_closest(
        scene, cfg, ray_o, ray_d, inf, trace_mask, with_stats=stats)
    traced = trace_mask.sum(dtype=torch.float64)
    ast = None
    if num_lights > 0 and cfg.one_sample_mis:
        # the BSDF-MIS channel's "closest hit == the picked light's
        # triangle" is read off the path ray's hit: one N-ray any-hit
        # launch, and only its traversals are counted
        occluded = trace_anyhit(scene, cfg, sh["ah_o"], sh["ah_d"],
                                sh["ah_tmax"], sh["ltri"], sh["ah_mask"],
                                with_stats=stats)
        if stats:
            occluded, ast = occluded
        chs_ok = hit & (hsrc == 0) & (hprim == sh["ltri"])
        acc = _accum(acc, sh["ah_L"], sh["ah_mask"] & ~occluded)
        acc = _accum(acc, sh["chs_L"], sh["chs_mask"] & chs_ok)
        traced = traced + sh["ah_mask"].sum(dtype=torch.float64)
    elif num_lights > 0:
        # both shadow channels ride one 2N any-hit launch
        cat = lambda a, b: torch.cat([a, b])
        cat3 = lambda a, b: tuple(cat(x, y) for x, y in zip(a, b))
        occ2 = trace_anyhit(scene, cfg, cat3(sh["ah_o"], sh["chs_o"]),
                            cat3(sh["ah_d"], sh["chs_d"]),
                            cat(sh["ah_tmax"], sh["chs_t"]),
                            cat(sh["ltri"], sh["chs_tgt"]),
                            cat(sh["ah_mask"], sh["chs_mask"]),
                            with_stats=stats)
        if stats:
            occ2, ast = occ2
        occluded, chs_occ = occ2[:n], occ2[n:]
        acc = _accum(acc, sh["ah_L"], sh["ah_mask"] & ~occluded)
        acc = _accum(acc, sh["chs_L"], sh["chs_mask"] & ~chs_occ)
        traced = traced + sh["ah_mask"].sum(dtype=torch.float64) + \
            sh["chs_mask"].sum(dtype=torch.float64)

    work_left = trace_mask.any()
    if parity:
        # limbo slots did not trace: the payload the kernel cleared
        # survives for the next re-roll, and the frame waits for them
        hit = hit | limbo
        ht = torch.where(limbo, t_p, ht)
        hnrm = vec.where(limbo, normal, hnrm)
        hprim = torch.where(limbo, prim, hprim)
        hsrc = torch.where(limbo, src, hsrc)
        work_left = work_left | limbo.any()

    new_state = PathState(pixel=pixel, ray_o=ray_o, ray_d=ray_d, hit=hit,
                          t=ht, normal=hnrm, prim=hprim, src=hsrc,
                          bounces=bounces, beta=beta, acc=acc)
    occupancy = trace_mask.sum(dtype=torch.float64) / n
    if stats:
        # bounce-depth histogram of traced path rays (depth 0 = camera
        # rays) and the traversal counts, summed on the device
        hist, steps, leafs, ah_steps, ah_leafs = extra
        depth = torch.clamp(bounces, 0, cfg.max_bounces).long()
        hist = hist.index_add(0, depth, trace_mask.to(hist.dtype))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ast = ast if ast is not None else (zero, zero)
        extra = (hist, steps + cst[0][0], leafs + cst[0][1],
                 ah_steps + ast[0], ah_leafs + ast[1])
    return (new_state, fb, cam_start + num_gen, it + 1, work_left,
            rays_traced + traced, occ_sum + occupancy) + tuple(extra)


def initial_carry(cfg: RenderConfig, device):
    """The carry of a fresh frame (see :func:`wavefront_step`)."""
    n = cfg.pool_size
    zero = lambda dt: torch.zeros((), dtype=dt, device=device)
    carry = (make_initial_state(n, device),
             torch.zeros(cfg.num_pixels, 3, dtype=torch.float32,
                         device=device),
             zero(torch.int64), 0, zero(torch.bool), zero(torch.float64),
             zero(torch.float64))
    if cfg.detailed_stats:
        carry += (torch.zeros(cfg.max_bounces + 1, dtype=torch.int64,
                              device=device),) + (zero(torch.int64),) * 4
    return carry


def render_frame_linear(scene: Scene, camera: Camera, cfg: RenderConfig,
                        generator: torch.Generator):
    """Render a frame; returns the LINEAR sample-sum framebuffer ``[H*W, 3]``
    and stats ``{"iterations", "rays_traced", "avg_occupancy"}``; under
    ``detailed_stats`` also ``"bounce_histogram"`` (``[max_bounces + 1]``
    int64 on the CPU: path rays traced per bounce depth), ``"node_steps"``
    and ``"leaf_visits"`` (the traversal kernels' node visits and leaf rows
    over the frame, both channels) and ``"anyhit_steps"`` /
    ``"anyhit_visits"`` (the any-hit launches' share of them)."""
    check_slice(scene, cfg)
    dev = scene.device
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the scene on "
                         f"{dev}")
    n = cfg.pool_size
    carry = initial_carry(cfg, dev)
    total = cfg.total_camera_rays
    while True:
        cam_start, it, work_left = carry[2], carry[3], carry[4]
        if cfg.max_iterations is not None and it >= cfg.max_iterations:
            break
        # the loop condition: one device -> host read per iteration
        if not bool(work_left | (cam_start < total)):
            break
        words = rng.bits_block(generator, NUM_RNG_WORDS, n)
        carry = wavefront_step(scene, camera, cfg, words, carry)
    _, fb, _, it, _, rays, occ, *extra = carry
    stats = {"iterations": it, "rays_traced": float(rays),
             "avg_occupancy": float(occ) / max(it, 1)}
    if cfg.detailed_stats:
        hist, steps, leafs, ah_steps, ah_leafs = extra
        stats.update(bounce_histogram=hist.cpu(),
                     node_steps=int(steps + ah_steps),
                     leaf_visits=int(leafs + ah_leafs),
                     anyhit_steps=int(ah_steps), anyhit_visits=int(ah_leafs))
    return fb, stats


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 generator: torch.Generator):
    """Render a full frame: ``(framebuffer [H*W, 3], stats)`` after the
    sqrt(mean) gamma-2 post-process."""
    fb, stats = render_frame_linear(scene, camera, cfg, generator)
    return torch.sqrt(fb / cfg.num_samples), stats
