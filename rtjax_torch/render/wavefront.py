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

rtjax's step is one jitted XLA program whose per-lane stages XLA fuses.
The port's counterpart is the step kernels (kernels/step.py: route, one
``torch.sort``, shade, the traversals, resolve) in every mode
(:func:`step_kernels_cover`): the sorted engine with the compact bundle,
and through a full-precision record its wide bundle, the unsorted engine
(no sort) and ``reference_parity``, each with instances for
``one_sample_mis`` and ``detailed_stats``.  Only ``step_kernels=False``
(the card's A/B and reference) runs the step op by op.  On the card the
kernels write the next path state into the carry's own tensors.

rtjax runs the whole frame as one jitted ``lax.while_loop`` whose condition
is computed on the device.  So does this port: the loop condition and the
``sort_every`` cadence are device values, and ``render_frame_linear`` reads
the condition back once every ``STEPS_PER_READ`` steps.  On the card each
step replays one captured CUDA graph (render/graph.py), the counterpart of
rtjax's ``jit``, in every mode; on the CPU, and under ``graph=False``, the
same chunked loop runs op by op.

Differences from rtjax, none of which changes a result:

- The loop runs in chunks of ``STEPS_PER_READ`` steps; a step after the
  condition turned false inside a chunk holds ``it`` and ``cam_start`` and
  adds zeros everywhere else, and its random words and launch counts are
  taken back after the chunk's read.
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

import torch

from ..config import RenderConfig
from ..constants import DEAD_BOUNCES, INVALID_INDEX
from ..core import rng, vec
from ..kernels import counts
from ..kernels import sort as sort_mod
from ..kernels import step as step_kernels_mod
from ..kernels.step import (DIRTY_KEY as _DIRTY_KEY, NUM_RNG_WORDS,
                            W_BSDF1 as _W_BSDF1, W_BSDF2 as _W_BSDF2,
                            W_GEN as _W_GEN, W_LIGHT_UV as _W_LIGHT_UV,
                            W_RR_PICK as _W_RR_PICK, accum as _accum,
                            blocked_order as _blocked_order,
                            blocked_pixel_table, camera_rays,
                            emit_and_roulette, pack_bundle,
                            shade_math as _shade, sort_keys as _sort_keys,
                            unpack_bundle)
from ..scene.camera import Camera
from ..scene.scene import Scene
# the codecs stay importable here: tests/test_torch_frame_loop.py keeps a
# copy of the earlier host-decision step that reads them from this module
from .sorting import (oct_decode_v3, oct_encode_v3,  # noqa: F401
                      rgb9e5_decode_v3, rgb9e5_encode_v3, sort_pytree_by_key,
                      take_pytree)
from .trace import check_config, resolve_mode, trace_anyhit, trace_closest


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


def _compact_bundle_ok(scene, cfg) -> bool:
    """Ranges of the packed sort bundle (kernels/step.py
    ``compact_bundle_ok``); both steps read them here, where tests patch
    them."""
    return step_kernels_mod.compact_bundle_ok(scene, cfg)


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


def step_kernels_cover(scene, cfg) -> bool:
    """Whether the step kernels (kernels/step.py) run this mode's step:
    every mode :func:`check_slice` accepts (``step.MODE_KERNELS``), the
    sorted engine with the compact bundle or the wide one (beyond
    ``_compact_bundle_ok``), the unsorted engine (``sort_rays=False`` or
    the traversal "xla") and ``reference_parity``, each under
    ``one_sample_mis`` (but parity, which refuses it) and
    ``detailed_stats``."""
    return _step_mode(scene, cfg) in step_kernels_mod.MODE_KERNELS


def _step_mode(scene, cfg) -> str:
    return step_kernels_mod.step_mode(scene, cfg,
                                      compact=_compact_bundle_ok(scene, cfg))


def _fused_step(scene, camera, cfg, words, carry):
    """:func:`wavefront_step` through the step kernels: route, one stable
    sort (kernels/sort.py), shade (on the unsorted engine route and shade
    in one kernel and no sort), the two traversals, resolve.  On the card
    the kernels write the next path state into ``carry``'s own tensors,
    and under ``detailed_stats`` resolve adds to its bounce histogram."""
    S = step_kernels_mod
    state, fb, cam_start, it, _, rays_traced, occ_sum, *extra = carry
    n = state.pixel.shape[0]
    mode = _step_mode(scene, cfg)
    engine = S.engine_of(mode)
    stats = cfg.detailed_stats
    hist = extra[0] if stats else None
    if engine == "default":
        k = resolve_sort_every(scene, cfg)
        keys, bundle, cnt = S.route(scene, cfg, state, words)
        # on a sort_every skip iteration the kernels return at once and
        # shade reads the identity
        order = sort_mod.stable_order(keys, (cnt, it, k) if k > 1 else None)
        sh = S.shade(scene, camera, cfg, state, fb, words, order, bundle,
                     cnt, it, cam_start, k)
    elif engine == "unsorted":
        sh = S.route_shade_unsorted(scene, camera, cfg, state, fb, words,
                                    cam_start)
    else:
        keys, record, cnt = S.route_full(scene, cfg, state, words, mode)
        order = None if keys is None else sort_mod.stable_order(keys)
        sh = S.shade_full(scene, camera, cfg, state, fb, words, order,
                          record, cnt, cam_start, mode)
    inf = torch.full((n,), float("inf"), dtype=torch.float32,
                     device=fb.device)
    hit, ht, hprim, hsrc, hnrm, *cst = trace_closest(
        scene, cfg, sh.ray_o, sh.ray_d, inf, sh.trace_mask, with_stats=stats)
    hits = (hit, ht, hnrm, hprim, hsrc)
    occluded = ast = None
    if sh.shadow is not None:
        # one any-hit launch: both channels' 2N rays, or the N NEE rays
        # under one_sample_mis
        occluded = trace_anyhit(scene, cfg, *sh.shadow, with_stats=stats)
        if stats:
            occluded, ast = occluded
    if engine == "default":
        acc, cam_start, work_left, rays_traced, occ_sum, *hist = S.resolve(
            cfg, sh, occluded, it, k, cam_start, rays_traced, occ_sum, hits,
            hist)
    else:
        acc, hits, cam_start, work_left, rays_traced, occ_sum, *hist = \
            S.resolve_full(cfg, sh, occluded, hits, cam_start, rays_traced,
                           occ_sum, mode, hist)
    hit, ht, hnrm, hprim, hsrc = hits
    new_state = PathState(pixel=sh.pixel, ray_o=sh.ray_o, ray_d=sh.ray_d,
                          hit=hit, t=ht, normal=hnrm, prim=hprim, src=hsrc,
                          bounces=sh.bounces, beta=sh.beta, acc=acc)
    out = (new_state, fb, cam_start, it + 1, work_left, rays_traced, occ_sum)
    if stats:
        # the traversal counts, summed as the op-by-op step sums them
        _, steps, leafs, ah_steps, ah_leafs = extra
        zero = torch.zeros((), dtype=torch.int64, device=fb.device)
        ast = ast if ast is not None else (zero, zero)
        out += (hist[0], steps + cst[0][0], leafs + cst[0][1],
                ah_steps + ast[0], ah_leafs + ast[1])
    return out


def wavefront_step(scene: Scene, camera: Camera, cfg: RenderConfig, words,
                   carry, *, step_kernels: bool = True):
    """One wavefront iteration.  ``words`` is the iteration's ``[5, N]``
    block of 32-bit random words (int64); ``carry`` is ``(state, fb,
    cam_start, it, work_left, rays_traced, occ_sum)`` with ``it`` a Python
    int or a 0-d int64 tensor (returned as the same type) and the rest
    tensors on the scene's device, and under
    ``detailed_stats`` five more: the bounce histogram ``[max_bounces + 1]``
    and the node-step, leaf-visit, any-hit step and any-hit visit sums
    (int64).  The framebuffer ``fb`` is accumulated in place
    (``index_add_``) rather than copied.  The step reads nothing back to
    the host (but repass's passes, render/trace.py), so that a CUDA graph
    can hold it.

    The modes :func:`step_kernels_cover` names, every mode
    :func:`check_slice` accepts, run the step kernels (kernels/step.py; on
    the CPU their plain versions), which on the card write the next path
    state into ``carry``'s own tensors; ``step_kernels=False`` runs the
    step op by op (the card's A/B and the kernels' reference)."""
    if step_kernels and step_kernels_cover(scene, cfg):
        return _fused_step(scene, camera, cfg, words, carry)
    state, fb, cam_start, it, _, rays_traced, occ_sum, *extra = carry
    n = state.pixel.shape[0]
    dev = state.pixel.device
    num_lights = scene.num_lights
    parity = cfg.reference_parity
    cam_end = cfg.total_camera_rays
    draw_pair = lambda w: rng.u01_pair(words[w])
    u_rr, u_pick = draw_pair(_W_RR_PICK)

    # ---- emission, Russian roulette, routing ------------------------------
    acc, beta, bounces, mat_mask, rr_kill, hp = emit_and_roulette(
        scene, cfg, state, u_rr)

    # ---- the sort: the iteration's one compaction step -------------------
    state_sorted = cfg.sort_rays and resolve_mode(scene, cfg) != "xla"
    # the reference's RR "limbo" (parity): a killed path keeps its payload
    # (and hit) for later re-rolls; it neither shades, traces nor
    # regenerates
    limbo = rr_kill if parity else None
    do_gen = None   # None: every iteration sorts, generates and flushes
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
        dirty = ~mat_mask & ((acc[0] != 0.0) | (acc[1] != 0.0)
                             | (acc[2] != 0.0))
        order = torch.sort(torch.where(dirty, _DIRTY_KEY, _sort_keys(
            scene, cfg, state, hp, bounces, mat_mask)), stable=True).indices
        if k_req > 1:
            # sort, gen and flush only every k-th iteration, or when the
            # live part drops below 3/4 of the pool.  The decision is a
            # device bool, as rtjax's lax.cond: both branches are computed
            # and the sorted or the unsorted permutation is selected.
            do_gen = (mat_mask.sum() * 4 < n * 3) | ((it % k_req) == 0)
            order = torch.where(do_gen, order,
                                torch.arange(n, device=dev))
        if compact:
            (p, beta, acc, pixel, bounces, mat_mask, prim, src, normal,
             ray_d_p) = unpack_bundle(pack_bundle(
                 hp, beta, acc, state.pixel, bounces, mat_mask, state.prim,
                 state.src, state.normal, state.ray_d)[order])
        else:
            # the wide bundle (frames above 2^21 pixels, more than 255
            # instances, max_bounces >= 126): every field at full
            # precision, bounces (15 bits, 0x7FFF = dead) and the mat bit
            # in one word.  src rides in a column of its own: rtjax packs
            # it in 12 bits, which an instance id above 4,095 overflows
            # into the mat bit.
            meta = torch.clamp(bounces, max=0x7FFF) | \
                (mat_mask.to(torch.int32) << 15)
            pixel, p, ray_d_p, normal, prim, src, beta, acc, meta = \
                take_pytree(order, (state.pixel, hp, state.ray_d,
                                    state.normal, state.prim, state.src,
                                    beta, acc, meta))
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
    num_gen = gen_mask.sum()
    if parity or not state_sorted:
        # the dead lanes are not a suffix (unsorted, or limbo lanes among
        # them): rank by a prefix sum
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
    # the slots that flush (their radiance leaves with them) and take a
    # camera ray: none on a sort_every skip iteration, whose dead lanes
    # idle one iteration
    flushing = gen_mask
    if do_gen is not None:
        got_ray = got_ray & do_gen
        num_gen = num_gen * do_gen
        flushing = gen_mask & do_gen
    pix_new, cam_o, cam_d = camera_rays(camera, cfg, cam_id, gen_u, gen_v)
    flush = torch.stack([torch.where(flushing, c, 0.0) for c in acc], 1)
    fb.index_add_(0, pixel.long(), flush)
    acc = tuple(torch.where(flushing, 0.0, c) for c in acc)

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
                              device=device),) + tuple(
            zero(torch.int64) for _ in range(4))
    return carry


# steps of the frame loop between two blocking reads of its condition;
# tests patch it (not a RenderConfig field)
STEPS_PER_READ = 8


def _more(carry, cfg):
    """rtjax's loop condition, a device bool: paths still traced, or
    camera rays still to generate (``max_iterations`` is the host's)."""
    return carry[4] | (carry[2] < cfg.total_camera_rays)


def frame_step(scene: Scene, camera: Camera, cfg: RenderConfig, words,
               carry, *, step_kernels: bool = True):
    """One step of the frame loop: :func:`wavefront_step` with ``it`` (a
    0-d device tensor here) and ``cam_start`` held where the loop condition
    was already false.  Such a step finds every slot dead and no camera ray
    left, so it traces nothing and adds zeros: the framebuffer, rays,
    occupancy and ``detailed_stats`` sums stay bitwise as they were."""
    more = _more(carry, cfg)
    out = wavefront_step(scene, camera, cfg, words, carry,
                         step_kernels=step_kernels)
    return out[:2] + (torch.where(more, out[2], carry[2]),
                      carry[3] + more) + out[4:]


class _EagerSteps:
    """Steps run op by op: the loop on the CPU, and on the card under
    ``graph=False``."""

    graphed = False

    def __init__(self, scene, camera, cfg, carry, step_kernels=True):
        self._step = functools.partial(frame_step, scene, camera, cfg,
                                       step_kernels=step_kernels)
        self._n = cfg.pool_size
        self.carry = carry

    def step(self, generator):
        self.carry = self._step(
            rng.bits_block(generator, NUM_RNG_WORDS, self._n), self.carry)

    def totals(self):
        """No device loops: every launch was counted as it ran."""
        return torch.zeros(0, dtype=torch.int64, device=self.carry[1].device)

    def account(self, runs):
        pass


def _run_chunks(loop, cfg: RenderConfig, generator) -> tuple:
    """rtjax's ``while_loop`` (wavefront.py:841-850) with the condition on
    the device: chunks of ``STEPS_PER_READ`` steps, each ended by one
    blocking read of ``(more, it)``; a chunk never runs past
    ``cfg.max_iterations``.  Steps after the condition turned false
    mid-chunk change nothing but the random words they drew and the
    launches they counted; both are taken back, so the generator and the
    kernels' counters end as a loop reading every step would leave them.
    Returns ``(iterations, reads)``."""
    if STEPS_PER_READ < 1:
        raise ValueError(f"STEPS_PER_READ must be >= 1, got "
                         f"{STEPS_PER_READ}")
    cap = cfg.max_iterations
    it = reads = 0
    while cap is None or it < cap:
        k = STEPS_PER_READ if cap is None else min(STEPS_PER_READ, cap - it)
        marks = []
        for _ in range(k):
            marks.append((generator.get_state(), counts.snapshot()))
            loop.step(generator)
        carry = loop.carry
        more, now, *runs = torch.cat((torch.stack((
            _more(carry, cfg).long(), carry[3])), loop.totals())).tolist()
        reads += 1
        if now - it < k:
            state, snap = marks[now - it]
            generator.set_state(state)
            counts.restore(snap)
        loop.account(runs)   # the device loops' bodies, as they ran
        it = now
        if not more:
            break
    return it, reads


def render_frame_linear(scene: Scene, camera: Camera, cfg: RenderConfig,
                        generator: torch.Generator, *, graph: bool = True,
                        step_kernels: bool = True):
    """Render a frame; returns the LINEAR sample-sum framebuffer ``[H*W, 3]``
    and stats ``{"iterations", "rays_traced", "avg_occupancy", "graphed",
    "host_reads"}``; under ``detailed_stats`` also ``"bounce_histogram"``
    (``[max_bounces + 1]`` int64 on the CPU: path rays traced per bounce
    depth), ``"node_steps"`` and ``"leaf_visits"`` (the traversal kernels'
    node visits and leaf rows over the frame, both channels) and
    ``"anyhit_steps"`` / ``"anyhit_visits"`` (the any-hit launches' share
    of them).

    On the card the steps replay a captured CUDA graph (render/graph.py;
    ``"graphed"`` True, with ``"capture_s"``, the seconds this frame spent
    capturing, 0 when the graph was cached, and ``"graph_pool_bytes"``),
    in every mode; ``graph=False`` runs the same loop op by op.
    ``step_kernels=False`` runs the step op by op, not through the step
    kernels (the A/B and reference of the card's checks).
    ``"host_reads"`` counts the loop's blocking device reads."""
    check_slice(scene, cfg)
    dev = scene.device
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the scene on "
                         f"{dev}")
    carry = initial_carry(cfg, dev)
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64,
                                     device=dev),) + carry[4:]
    if _blocked_order(cfg):
        blocked_pixel_table(cfg.width, cfg.height, carry[0].pixel.device)
    if graph and dev.type == "cuda":
        from .graph import frame_steps
        loop = frame_steps(scene, camera, cfg, carry, step_kernels)
    else:
        loop = _EagerSteps(scene, camera, cfg, carry, step_kernels)
    it, reads = _run_chunks(loop, cfg, generator)
    _, fb, _, _, _, rays, occ, *extra = loop.carry
    rays, occ = torch.stack((rays, occ)).tolist()
    stats = {"iterations": it, "rays_traced": rays,
             "avg_occupancy": occ / max(it, 1), "graphed": loop.graphed,
             "host_reads": reads + 1 + bool(extra)}
    if loop.graphed:
        fb = fb.clone()   # the graph's carry is reused by the next frame
        stats.update(capture_s=loop.capture_s,
                     graph_pool_bytes=loop.pool_bytes)
    if cfg.detailed_stats:
        hist, *sums = torch.cat((extra[0], torch.stack(extra[1:]))).cpu() \
            .split((cfg.max_bounces + 1, 1, 1, 1, 1))
        steps, leafs, ah_steps, ah_leafs = (int(v) for v in sums)
        stats.update(bounce_histogram=hist, node_steps=steps + ah_steps,
                     leaf_visits=leafs + ah_leafs, anyhit_steps=ah_steps,
                     anyhit_visits=ah_leafs)
    return fb, stats


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig,
                 generator: torch.Generator, *, graph: bool = True,
                 step_kernels: bool = True):
    """Render a full frame: ``(framebuffer [H*W, 3], stats)`` after the
    sqrt(mean) gamma-2 post-process; ``graph`` and ``step_kernels`` as in
    :func:`render_frame_linear`."""
    fb, stats = render_frame_linear(scene, camera, cfg, generator,
                                    graph=graph, step_kernels=step_kernels)
    return torch.sqrt(fb / cfg.num_samples), stats
