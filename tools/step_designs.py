#!/usr/bin/env python3
"""The fused step's two designs on one CUDA card.

    python3 tools/step_designs.py [--its 0,1,2,5,12] [--time-it 12]
    python3 tools/step_designs.py --variants [--cells "parity frame"]
    python3 tools/step_designs.py --variants --names shade_128 --cells headline

The step kernels (kernels/step.py, csrc/step_kernels.cu) in two arms:

- ``record``, the engine's: one 40-byte bundle record a lane, the
  material index carried in it, the scene's small tables in shared
  memory, one float atomic a non-zero component of a dirty-window lane;
- ``v1``: the first design (nine bundle columns, the material
  looked up in shade, three float atomics a dead lane).

On the headline cell (``bench.py``'s frame: ``cornell_bunny``, 256x256 @
64 spp, 10 bounces, pool 2^18) it

1. prints each kernel's registers, spill bytes, threads a block and
   resident warps an SM (the card's occupancy calculator);
2. steps a pool op by op and, on the states of ``--its``, holds route,
   shade and resolve of both designs bit for bit against their plain
   versions (every output; the framebuffer within rtol 1e-5 of the plain
   version's), and the two designs' next state and shadow columns equal;
3. on the state of ``--time-it`` times, in turns (``_launch_ms``: CUDA
   events between launches queued behind a spin kernel), route against
   route_v1 and shade against shade_v1, and resolve, each with its byte
   bound, and one wrapper call of each (host launch included).

``--variants`` times the mode's route, shade and resolve and the first
designs' (``first_designs``, ``resolve_first_design``) in copies of the
library patched for timing
(``STEP_VARIANTS``, built under ``build/rtjax_torch/variants/``):
default shade's launch bounds at ``(128)`` alone against the library's
``(128, 1)`` (``shade_128``, on the headline), and on the parity modes'
shades (``shade_parity`` and ``shade_parity_v1``, and their unsorted
instances) the BSDF-MIS channel's own-triangle test taken out (wrong
results, timing only), launch bounds for 20 and 24 resident warps an SM
and the parity routes' for 48; on the unsorted engine's route and shade
(``route_shade_unsorted``, ``_1s``) the look-back taken before the
shading (``unsorted_rank_first``, arm B) and launch bounds of one block
an SM at least (``unsorted_16_warps``; the library's are five); on the
sorted engine's one-sample shade its tile walk with no prefetch
(``shade_1s_no_prefetch``, arm B: each tile's loads issued when it is
shaded) and launch bounds for 20 and 24 resident warps
(``shade_1s_20_warps``, ``shade_1s_24_warps``); by
default every parity variant on the states of iteration 30 of
``chip_smoke.py``'s parity frame (2^19 lanes) and the headline's parity
frame under ``traversal="xla"`` (2^18), each library in turns (engine,
variants..., variants reversed, engine), with each copy's registers,
spill bytes and resident warps.  Beside them, the mode's route and
shade against the first design's in turns (step 3).

    python3 tools/step_designs.py --variants --names \
        unsorted_rank_first,unsorted_16_warps \
        --cells "headline xla,headline one_sample no_sort"
    python3 tools/step_designs.py --variants --names \
        shade_1s_no_prefetch,shade_1s_20_warps,shade_1s_24_warps \
        --cells "headline one_sample,headline parity stats"

Steps 2-3 (:func:`check_and_time`, :func:`check_state`,
:func:`time_state`) take any mode of the step kernels (kernels/step.py
``step_mode``; the full-record modes' route, shade and resolve, or the
unsorted engine's route-and-shade and resolve) and are what
``chip_smoke.py``'s phase 14 and ``tools/mode_steps.py`` check and time
with; phase 14 profiles both designs' captured frames in phase 13's busy
job.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FB_RTOL, FB_ATOL = 1e-5, 1e-7


def kernel_table():
    """``{name: step.kernel_info(name)}`` of every step kernel."""
    from rtjax_torch.kernels import step as S
    return {name: S.kernel_info(name) for name in S.KERNEL_IDS}


def _copy(st):
    return dataclasses.replace(st, **{
        f: tuple(c.clone() for c in v) if isinstance(v, tuple) else v.clone()
        for f, v in vars(st).items()})


SHADE_FIELDS = ("pixel", "ray_o", "ray_d", "beta", "bounces", "acc",
                "trace_mask", "counts", "shadow", "ah_L", "chs_L",
                "chs_mask")
RESOLVE_FIELDS = ("acc[0]", "acc[1]", "acc[2]")
HIT_FIELDS = ("hit", "t", "normal[0]", "normal[1]", "normal[2]", "prim",
              "src")
COUNTER_FIELDS = ("cam_start", "work_left", "rays_traced", "occ_sum")


def flush_atomics(bundle, order, counts, do_gen):
    """Atomic operations a shade launch issues for its flush: ``{design:
    count}`` (record: one float atomic a non-zero component of a
    dirty-window lane; v1: three float atomics a dead lane), with the
    dirty window's lanes that hold radiance (``lanes``) and how many land
    on one pixel."""
    import torch
    from rtjax_torch.kernels import step as S
    if do_gen is not None and not bool(do_gen):
        return dict(record=0, v1=0, lanes=0)
    _, _, acc, pixel, _, mat, *_ = S.unpack_bundle(bundle[order])
    lo, hi = int(counts[0]), int(counts[0]) + int(counts[4])
    a = torch.stack(acc, 1)[lo:hi]
    some = (a != 0).any(1)
    lanes = torch.bincount(pixel[lo:hi][some].long())
    lanes = lanes[lanes > 0]
    edges = (1, 2, 4, 8, 16, 32, 64)
    return dict(record=int((a != 0).sum()), v1=3 * int((~mat).sum()),
                lanes=int(some.sum()), pixels=int(lanes.numel()),
                lanes_per_pixel={f"<={e}": int((lanes <= e).sum())
                                 for e in edges} | {
                    "max": int(lanes.max()) if lanes.numel() else 0})


def check_state(scene, camera, cfg, state, words, fb, it, cam_start):
    """The step kernels of ``cfg``'s mode (kernels/step.py ``step_mode``,
    ``MODE_KERNELS``) against their plain versions on one state, the
    kernels on copies of what they write in place: ``({kernel: {field:
    mismatching lanes}}, {kernel: framebuffer gap}, checked)``, the gap
    the largest absolute one to the plain version's framebuffer of each
    kernel that writes it; ``checked`` holds what :func:`time_state`
    needs.  Every output bit for bit; the
    framebuffer within FB_RTOL of the plain version's (its atomic adds'
    order).  Under the default mode also the first design (route_v1,
    shade_v1) against the same plain versions and shade against shade_v1;
    under the parity modes their first design (``FIRST_DESIGNS``: route's
    against its plain version, which carries no rank, shade's against
    shade's plain version and kernel).
    Resolve takes a random occlusion and, under ``detailed_stats``, a
    random bounce histogram; under the parity modes and one-sample MIS the
    closest hits it reads (parity: restores limbo lanes into) are a
    traversal of the plain version's rays."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render.trace import trace_closest
    from rtjax_torch.render import wavefront as WF
    mode = S.step_mode(scene, cfg)
    engine = S.engine_of(mode)
    kernels = S.MODE_KERNELS[mode]
    shade_k, resolve_k = kernels[-2:]
    n, dev = cfg.pool_size, state.pixel.device
    k = WF.resolve_sort_every(scene, cfg)
    v1 = first_designs(mode)
    r_v1 = resolve_first_design(mode)
    sorts = engine in ("default", "wide", "parity")
    bad = {name: {} for name in kernels + v1 + ((r_v1,) if r_v1 else ())
           + ("key_sort",) * sorts}

    def tally(kernel, names, got, want):
        got, want = C._flat_out(got), C._flat_out(want)
        if len(got) != len(want):
            raise RuntimeError(f"{kernel}: {len(got)} outputs against the "
                               f"plain version's {len(want)}")
        for name, x, y in zip(names, got, want, strict=True):
            bad[kernel][name] = bad[kernel].get(name, 0) + \
                C._lanes_differ(x, y)

    fb0, fb1, fb2 = fb.clone(), fb.clone(), fb.clone()
    c = dict(mode=mode, keys=None, order=None, do_gen=None)
    if engine == "default":
        want = S.route_ref(scene, cfg, state, words)
        tally("route", ("keys", "bundle", "counts"),
              S.route(scene, cfg, state, words), want)
        keys, bundle, counts = want
        order = torch.sort(keys, stable=True).indices
        do_gen = S.cadence(counts, n, it, k)
        # the kernels' sort returns at once on a skip iteration, its order
        # as it was: shade reads the identity then
        k_order = SO.stable_order(keys, (counts, it, k) if k > 1 else None)
        if do_gen is None or bool(do_gen):
            tally("key_sort", ("order",), k_order, order)
        sh0 = S.shade_ref(scene, camera, cfg, state, fb0, words, order,
                          bundle, counts, it, cam_start, k)
        sh1 = S.shade(scene, camera, cfg, _copy(state), fb1, words, k_order,
                      bundle, counts.clone(), it, cam_start, k)
        c.update(keys=keys, order=order, bundle=bundle, counts=counts,
                 do_gen=do_gen)
        if v1 and mode != "default":
            # the one-sample shade's first design, on the same record
            sh2 = S.shade_1s_v1(scene, camera, cfg, _copy(state), fb2, words,
                                k_order, bundle, counts.clone(), it,
                                cam_start, k)
        elif v1:
            want_v1 = S.route_v1_ref(scene, cfg, state, words)
            tally("route_v1", ("keys", "bundle", "counts"),
                  S.route_v1(scene, cfg, state, words), want_v1)
            sh2 = S.shade_v1(scene, camera, cfg, _copy(state), fb2, words,
                             order, want_v1[1], counts.clone(), it,
                             cam_start, k)
            c.update(bundle_v1=want_v1[1])
    elif engine == "unsorted":
        sh0 = S.route_shade_unsorted_ref(scene, camera, cfg, state, fb0,
                                         words, cam_start)
        sh1 = S.route_shade_unsorted(scene, camera, cfg, _copy(state), fb1,
                                     words, cam_start)
        sh2 = S.route_shade_unsorted_v1(scene, camera, cfg, _copy(state),
                                        fb2, words, cam_start)
        c.update(record=S._route_full(scene, cfg, state, words, mode)[1],
                 counts=sh0.counts)
    else:
        want = S.route_full_ref(scene, cfg, state, words, mode)
        tally(kernels[0], ("keys",) * (want[0] is not None)
              + ("record", "counts"),
              S.route_full(scene, cfg, state, words, mode), want)
        keys, record, counts = want
        order = k_order = None
        if keys is not None:
            order = torch.sort(keys, stable=True).indices
            k_order = SO.stable_order(keys)
            tally("key_sort", ("order",), k_order, order)
        sh0 = S.shade_full_ref(scene, camera, cfg, fb0, words, order, record,
                               counts, cam_start, mode)
        sh1 = S.shade_full(scene, camera, cfg, _copy(state), fb1, words,
                           k_order, record, counts.clone(), cam_start, mode)
        c.update(keys=keys, order=order, record=record, counts=counts)
        if v1:
            want_v1 = S.route_full_v1_ref(scene, cfg, state, words, mode)
            tally(v1[0], ("keys",) * (want_v1[0] is not None)
                  + ("record", "counts"),
                  S.route_full_v1(scene, cfg, state, words, mode), want_v1)
            sh2 = S.shade_full_v1(scene, camera, cfg, _copy(state), fb2,
                                  words, k_order, want_v1[1], counts.clone(),
                                  cam_start, mode)
            c.update(record_v1=want_v1[1])
    fields = SHADE_FIELDS + (("limbo",) if mode.startswith("parity") else ())
    for f in fields:
        want_f = C._flat_out(getattr(sh0, f))
        names = [f"{f}[{j}]" for j in range(len(want_f))]
        tally(shade_k, names, getattr(sh1, f), want_f)
        if v1:
            tally(v1[-1], names, getattr(sh2, f), want_f)
            tally(v1[-1], [f"= shade {x}" for x in names],
                  getattr(sh2, f), getattr(sh1, f))
    gaps = {}
    for kernel, got in ((shade_k, fb1),) + (((v1[-1], fb2),) if v1
                                            else ()):
        gaps[kernel] = float((got - fb0).abs().max())
        if not torch.allclose(got, fb0, rtol=FB_RTOL, atol=FB_ATOL):
            bad[kernel]["fb beyond rtol"] = 1
    g = torch.Generator(device=dev).manual_seed(9)
    occ = None if sh0.shadow is None else \
        torch.rand(sh0.shadow[4].shape[0], generator=g, device=dev) < 0.3
    hist = None if not cfg.detailed_stats else torch.randint(
        0, 1 << 20, (cfg.max_bounces + 1,), generator=g, device=dev)
    rays = torch.tensor(7.0, dtype=torch.float64, device=dev)
    occ_sum = torch.tensor(0.5, dtype=torch.float64, device=dev)
    acc_copy = dataclasses.replace(sh0, acc=tuple(x.clone() for x in sh0.acc))
    hits = None
    if mode.startswith("parity") or cfg.one_sample_mis:
        inf = torch.full((n,), float("inf"), device=dev)
        hits = trace_closest(scene, cfg, sh0.ray_o, sh0.ray_d, inf,
                             sh0.trace_mask)
        hits = (hits[0], hits[1], hits[4], hits[2], hits[3])
    tail = ("hist",) * cfg.detailed_stats
    if not mode.startswith("parity"):
        # the unsorted engine and the wide bundle: the default resolve at
        # sort_every 1
        r_it, r_k = (it, k) if engine == "default" else (0, 1)
        r0 = S.resolve_ref(cfg, sh0, occ, r_it, r_k, cam_start, rays,
                           occ_sum, hits, _clone(hist))
        r1 = S.resolve(cfg, acc_copy, occ, r_it, r_k, cam_start, rays,
                       occ_sum, hits, _clone(hist))
        names = RESOLVE_FIELDS + COUNTER_FIELDS + tail
    else:
        r0 = S.resolve_full_ref(cfg, sh0, occ, hits, cam_start, rays,
                                occ_sum, mode, _clone(hist))
        r1 = S.resolve_full(cfg, acc_copy, occ, _clone(hits), cam_start,
                            rays, occ_sum, mode, _clone(hist))
        names = RESOLVE_FIELDS + HIT_FIELDS + COUNTER_FIELDS + tail
        if r_v1:
            tally(r_v1, names, S.resolve_full_v1(
                cfg, dataclasses.replace(sh0, acc=tuple(
                    x.clone() for x in sh0.acc)), occ, _clone(hits),
                cam_start, rays, occ_sum, mode, _clone(hist)), r0)
    tally(resolve_k, names, r1, r0)
    c.update(sh=sh0, occ=occ, hits=hits, hist=hist)
    return bad, gaps, c


def merge_gaps(into, gaps):
    """``into`` (``{kernel: framebuffer gap}``) updated to the larger of
    its gap and ``gaps``' for each kernel."""
    for k, v in gaps.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


def first_designs(mode):
    """The first design's route and shade that ``mode``'s kernels are
    checked and timed against in turns: ``("route_v1", "shade_v1")``
    under the default mode, the parity modes' (kernels/step.py
    ``PARITY_V1``) under parity, the unsorted engine's route-and-shade
    (``UNSORTED_V1``) on it, the sorted engine's one-sample shade's
    (``MODE_V1``: ``shade_1s_v1``, beside the same route) under
    ``one_sample_mis``, else ()."""
    from rtjax_torch.kernels import step as S
    engine = S.engine_of(mode)
    if mode == "default":
        return ("route_v1", "shade_v1")
    if engine.startswith("parity"):
        return tuple(S.PARITY_V1[k] for k in S.MODE_KERNELS[mode][:2])
    if engine == "unsorted":
        return (S.UNSORTED_V1[S.MODE_KERNELS[mode][0]],)
    shade = S.MODE_KERNELS[mode][1]
    return (S.MODE_V1[shade],) if shade in S.MODE_V1 else ()


def resolve_first_design(mode):
    """The first design of ``mode``'s resolve (kernels/step.py
    ``MODE_V1``: the stats resolve's under parity), or None."""
    from rtjax_torch.kernels import step as S
    return S.MODE_V1.get(S.MODE_KERNELS[mode][-1])


def turns_of(mode):
    """``mode``'s kernels in the order they are timed, each after its first
    design (:func:`first_designs`, :func:`resolve_first_design`)."""
    from rtjax_torch.kernels import step as S
    kernels = S.MODE_KERNELS[mode]
    v1 = first_designs(mode)
    engine = S.engine_of(mode)
    if mode == "default" or engine.startswith("parity"):
        firsts = dict(zip(kernels[:2], v1))
    elif engine == "unsorted":
        firsts = {kernels[0]: v1[0]}
    else:   # the sorted engine's shade
        firsts = dict(zip(kernels[1:2], v1))
    if resolve_first_design(mode):
        firsts[kernels[-1]] = resolve_first_design(mode)
    return tuple(x for k in kernels for x in (firsts.get(k), k) if x)


def _clone(v):
    if v is None:
        return None
    return tuple(_clone(x) for x in v) if isinstance(v, tuple) else v.clone()


# bytes a lane moves under the full-record modes, each input read once and
# each output written once (the default mode's are chip_smoke.py's
# ROUTE_BYTES ...): route reads the state (81 B) and its word (8 B) and
# writes the record's 88 bytes of payload (and, under "parity" and
# "wide", its key, 4 B); shade reads the record's payload (88 B; under
# "wide" 84 B, no t; under "parity" and "wide" through the sort's order, 8
# B) and five words (40 B), writes the next state (56 B), the traced flag
# and under the parity modes the limbo flag (1 B each), with lights two
# shadow rays (66 B) and their radiance (24 B), and a flushing lane's pixel
# is read and written (24 B); route and shade in one kernel (the unsorted
# engine) read the state and five words (121 B) and write what shade
# writes; resolve under parity reads the default's 40 B and the limbo flag
# and writes the radiance (12 B), and a limbo lane's order (under
# "parity", 8 B) and record words (24 B) are read and its hit written (21
# B).  Under the parity modes route writes and shade reads the camera
# rank too (4 B; not in the first design's record words).  Under
# one-sample MIS shade reads four words (32 B) and writes one
# shadow ray (33 B), the channel's mask (1 B) and both channels' radiance
# (24 B); resolve reads the radiance and both channels' (36 B), the NEE
# mask and occlusion, the channel's mask and the hit flag (4 B), the hit's
# prim and src and the picked triangle (12 B) and writes the radiance (12
# B).  Under detailed_stats resolve also reads the traced flag and bounces
# (5 B) and writes the histogram once (8 B a bin)
ROUTE_FULL_BYTES, ROUTE_KEY = 81 + 8 + 88, 4
SHADE_FULL_BYTES, SHADE_FLAG, SHADE_ORDER = 88 + 40 + 56 + 1, 1, 8
WIDE_NO_T = 4
MERGED_BYTES = 81 + 40 + 56 + 1
SHADE_LIGHTS, SHADE_FLUSH = 90, 24
RESOLVE_FULL_BYTES, RESOLVE_LIMBO, RESOLVE_ORDER = 53, 45, 8
ONE_SAMPLE_WORD, SHADE_LIGHTS_1S, RESOLVE_1S_BYTES = 8, 58, 64
RESOLVE_STATS, HIST_BIN = 5, 8
RANK_WORD = 4


def _bounds(scene, cfg, c):
    """``({kernel: bound}, work)``: each kernel of ``c``'s mode (from
    :func:`check_state`) with its byte and operation bound on this
    state's data, and the data-dependent work (flushing and limbo lanes;
    under the default mode its flush atomics)."""
    import chip_smoke as C
    from rtjax_torch.kernels import step as S
    mode, n = c["mode"], cfg.pool_size
    engine = S.engine_of(mode)
    one, stats = cfg.one_sample_mis, cfg.detailed_stats
    lights = scene.num_lights > 0
    kernels = S.MODE_KERNELS[mode]
    shade_l = (SHADE_LIGHTS_1S if one else SHADE_LIGHTS) * lights
    words = ONE_SAMPLE_WORD * one   # the word one-sample MIS does not read
    resolve = (RESOLVE_1S_BYTES if one and lights else C.RESOLVE_BYTES) + \
        RESOLVE_STATS * stats
    hist = HIST_BIN * (cfg.max_bounces + 1) * stats
    if engine == "default":
        do_gen = True if c["do_gen"] is None else bool(c["do_gen"])
        atomics = flush_atomics(c["bundle"], c["order"], c["counts"],
                                c["do_gen"])
        shade_b = n * (C.SHADE_BYTES - words + shade_l
                       + C.SHADE_ORDER * do_gen) + C.SHADE_FLUSH * atomics[
                           "lanes"]
        b = {kernels[0]: C._step_bound(n * C.ROUTE_BYTES, n * C.ROUTE_OPS),
             kernels[1]: C._step_bound(shade_b, n * C.SHADE_OPS),
             kernels[2]: C._step_bound(n * resolve + hist,
                                       n * C.RESOLVE_OPS)}
        if mode == "default":
            b.update(route_v1=b["route"], shade_v1=b["shade"])
        for first in first_designs(mode) if mode != "default" else ():
            b[first] = b[kernels[1]]
        _without_hist(b, kernels[2], n, hist, stats)
        return b, dict(flush_atomics=atomics)
    r = S.unpack_full(c["record"] if c["order"] is None
                      else c["record"][c["order"]])
    gen = ~r["mat"] & ~r["limbo"]
    flushing = int((gen & ((r["acc"][0] != 0) | (r["acc"][1] != 0)
                           | (r["acc"][2] != 0))).sum())
    limbo = int(r["limbo"].sum())
    v1 = first_designs(mode)
    if engine == "unsorted":
        nbytes = (n * (MERGED_BYTES - words + shade_l)
                  + SHADE_FLUSH * flushing, n * resolve + hist)
        ops = (C.ROUTE_OPS + C.SHADE_OPS, C.RESOLVE_OPS)
        b = {k: C._step_bound(x, n * o)
             for k, x, o in zip(kernels, nbytes, ops, strict=True)}
        b[v1[0]] = b[kernels[0]]
        _without_hist(b, kernels[-1], n, hist, stats)
        return b, dict(flushing=flushing, limbo=limbo)
    else:
        parity = engine.startswith("parity")
        sort = engine in ("parity", "wide")
        wide = engine == "wide"
        nbytes = (n * (ROUTE_FULL_BYTES + ROUTE_KEY * sort
                       + RANK_WORD * parity),
                  n * (SHADE_FULL_BYTES - WIDE_NO_T * wide - words
                       + SHADE_FLAG * parity + SHADE_ORDER * sort + shade_l
                       + RANK_WORD * parity)
                  + SHADE_FLUSH * flushing,
                  (n * resolve + hist) if wide else
                  n * (RESOLVE_FULL_BYTES + RESOLVE_STATS * stats) + hist
                  + limbo * (RESOLVE_LIMBO + RESOLVE_ORDER * sort))
        ops = (C.ROUTE_OPS, C.SHADE_OPS, C.RESOLVE_OPS)
    b = {k: C._step_bound(x, n * o)
         for k, x, o in zip(kernels, nbytes, ops, strict=True)}
    # the first design's record carries no rank: its bounds are the
    # function's, which the parity modes' route and shade are held to
    # beside their own (the rank word is the design's cost)
    for k, first, x, o in zip(kernels, v1, nbytes, ops):
        b[first] = C._step_bound(x - n * RANK_WORD, n * o)
        b[k].update(function_bound_ms=b[first]["bound_ms"],
                    function_bound_us=b[first]["bound_us"])
    if resolve_first_design(mode):
        b[resolve_first_design(mode)] = b[kernels[-1]]
    _without_hist(b, kernels[-1], n, hist, stats)
    return b, dict(flushing=flushing, limbo=limbo)


def _without_hist(b, resolve, n, hist, stats):
    """Under ``detailed_stats`` the bound of ``resolve`` without its
    histogram (:func:`plain_resolve`'s kernel: the same lanes, neither the
    traced flags and bounces read nor the bins written) into ``b``."""
    import chip_smoke as C
    if stats:
        b[plain_resolve(resolve)] = C._step_bound(
            b[resolve]["bytes"] - n * RESOLVE_STATS - hist,
            n * C.RESOLVE_OPS)


def plain_resolve(resolve):
    """The resolve kernel ``resolve`` is without ``detailed_stats`` (its
    histogram's cost is their difference, timed in turns)."""
    return resolve[:-len("_stats")] if resolve.endswith("_stats") else None


def design_blocks(scene, camera, cfg, state, words, fb, it, cam_start, c,
                  resolve=False):
    """``{kernel: make}`` of the route and shade launches of the mode of
    ``c`` (from :func:`check_state`) and of its first design's
    (:func:`first_designs`), for timing: ``make()`` gives an argument
    block, made once on copies of what it writes; on the unsorted engine,
    whose route-and-shade writes the next state over the one it reads, a
    new one on its own copies at each call (:func:`blocks_of`).  With
    ``resolve`` the mode's resolve and its first design's too (one block
    on copies of what it writes, which each launch adds to again)."""
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    mode = c["mode"]
    engine = S.engine_of(mode)
    v1 = first_designs(mode)
    out = {}
    if resolve:
        kernel = S.MODE_KERNELS[mode][-1]
        parity = engine.startswith("parity")
        r_it, r_k = (it, WF.resolve_sort_every(scene, cfg)) \
            if engine == "default" else (0, 1)
        rays = torch.zeros((), dtype=torch.float64, device=fb.device)
        a_res = S.resolve_args(
            cfg, dataclasses.replace(c["sh"], acc=tuple(
                x.clone() for x in c["sh"].acc)), c["occ"], r_it, r_k,
            cam_start, rays, rays.clone(), _clone(c["hits"]),
            _clone(c["hist"]), restore=parity)[0]
        for name in (kernel, resolve_first_design(mode)):
            if name:
                out[name] = lambda a=a_res: a
    if engine == "unsorted":
        def make(first):
            return lambda: S.shade_args(
                scene, camera, cfg, _copy(state), fb.clone(), words, None,
                None, torch.zeros(S.NUM_COUNTS, dtype=torch.int64,
                                  device=state.pixel.device), 0, cam_start,
                1, v1=first, mode=mode)[0]
        return {S.MODE_KERNELS[mode][0]: make(False), v1[0]: make(True),
                **out}
    default = engine == "default"
    rec = "bundle" if default else "record"
    # the full-record modes' shade takes no cadence
    it, k = (it, WF.resolve_sort_every(scene, cfg)) if default else (0, 1)
    # the one-sample shade's first design reads the same record
    pairs = ((False, S.MODE_KERNELS[mode][:2]),
             *((True, v1),) * (mode == "default" or not default and
                               bool(v1)))
    for first, (route_k, shade_k) in pairs:
        a_r = S.route_args(scene, cfg, state, words, v1=first, mode=mode)[0]
        a_s = S.shade_args(
            scene, camera, cfg, _copy(state), fb.clone(), words, c["order"],
            c[rec + "_v1" * first], c["counts"].clone(), it, cam_start, k,
            v1=first, mode=mode)[0]
        out[route_k], out[shade_k] = (lambda a=a_r: a), (lambda a=a_s: a)
    if default and v1 and mode != "default":
        a_s = S.shade_args(
            scene, camera, cfg, _copy(state), fb.clone(), words, c["order"],
            c["bundle"], c["counts"].clone(), it, cam_start, k)[0]
        out[v1[0]] = lambda a=a_s: a
    return out


def blocks_of(make, count):
    """An iterator of ``count`` argument blocks from ``make`` (one of
    :func:`design_blocks`), then the same again: a timing that runs past
    ``count`` launches (a retried ``_launch_ms``) reads blocks a launch
    has written."""
    import itertools
    return itertools.cycle([make() for _ in range(count)])


def time_state(scene, camera, cfg, state, words, fb, it, cam_start, c,
               reps=5):
    """The mode's kernels on one state (``c`` from :func:`check_state`):
    each kernel's device ms a launch (``chip_smoke._launch_ms`` of its
    entry point called with argument blocks made before), in turns:
    first, ..., last, last, ..., first (under the default mode route_v1
    before route and shade_v1 before shade), and a launch in a chain
    (``chain_ms``, ``chip_smoke._chain_ms``); its byte bound and share,
    registers and resident warps; one wrapper call and one plain call of
    each of the mode's kernels (CUDA events, median); the key sort of
    the keys in turns with torch.sort (:func:`sort_timing`, ``key_sort``;
    ``sort_ms`` torch.sort's), and on the sorted engine's compact bundle
    ``index_add_`` of the
    flush.  A launch that writes the next state over the one it reads (the
    unsorted engine's route-and-shade) takes a copy of its own.  Under
    ``detailed_stats`` the mode's resolve without the histogram is timed
    in turns too (:func:`plain_resolve`: the histogram's own cost is the
    difference).  Returns
    ``{"kernels": {kernel: {...}}, "sort_ms", ...}``."""
    import ctypes

    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    mode = c["mode"]
    engine = S.engine_of(mode)
    kernels = S.MODE_KERNELS[mode]
    k = WF.resolve_sort_every(scene, cfg)
    n, dev = cfg.pool_size, state.pixel.device
    lib = S._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    call = lambda name, blocks: (lambda: getattr(lib, f"rtjax_step_{name}")(
        ctypes.byref(next(blocks)), stream))
    sh, occ = c["sh"], c["occ"]
    rays = torch.zeros((), dtype=torch.float64, device=dev)
    sh_copy = lambda: dataclasses.replace(
        sh, acc=tuple(x.clone() for x in sh.acc))
    hits = lambda: _clone(c["hits"])
    hist = lambda: _clone(c["hist"])
    parity = engine.startswith("parity")
    r_it, r_k = (it, k) if engine == "default" else (0, 1)
    # two turns of a warm-up and ``reps`` launches, with room for retries
    blocks = 6 * (reps + 1)
    a_res = S.resolve_args(cfg, sh_copy(), occ, r_it, r_k, cam_start, rays,
                           rays.clone(), hits(), hist(), restore=parity)[0]
    makes = design_blocks(scene, camera, cfg, state, words, fb, it,
                          cam_start, c)
    makes[kernels[-1]] = lambda: a_res
    v1 = first_designs(mode)
    r_v1 = resolve_first_design(mode)
    if r_v1:
        makes[r_v1] = lambda: a_res
    turns = turns_of(mode)
    base = plain_resolve(kernels[-1])
    if base:
        # the same resolve without the histogram, on the same lanes
        a_base = S.resolve_args(
            dataclasses.replace(cfg, detailed_stats=False), sh_copy(), occ,
            r_it, r_k, cam_start, rays, rays.clone(), hits(), None,
            restore=parity)[0]
        makes[base] = lambda: a_base
        turns += (base,)
    fns = {name: call(name, blocks_of(make, blocks))
           for name, make in makes.items()}
    bounds, work = _bounds(scene, cfg, c)
    out = {name: dict(ms=[], **bounds[name]) for name in turns}
    for name in turns + turns[::-1]:
        out[name]["ms"].append(C._launch_ms(fns[name], reps)[0])
    for name, r in out.items():
        r["mean_ms"] = statistics.mean(r["ms"])
        r["share"] = r["bound_ms"] / r["mean_ms"]
        if "function_bound_ms" in r:
            r["function_share"] = r["function_bound_ms"] / r["mean_ms"]
        r.update(S.kernel_info(name))
    # [C 5]: each timed kernel in a chain of C.CHAIN_CALLS between two
    # events (one launch alone between events carries their ~5 us floor),
    # the chain's argument blocks made before it: under the default mode
    # each launch on its own (shade and resolve on copies of what they
    # write); elsewhere the blocks the events' timing launches on (the
    # unsorted engine's route-and-shade a new one on its own copies each
    # launch, :func:`design_blocks`)
    if mode == "default":
        makes |= {
            kernels[0]: lambda: S.route_args(scene, cfg, state, words)[0],
            kernels[1]: lambda: S.shade_args(
                scene, camera, cfg, _copy(state), fb.clone(), words,
                c["order"], c["bundle"], c["counts"].clone(), it, cam_start,
                k)[0],
            kernels[2]: lambda: S.resolve_args(
                cfg, sh_copy(), occ, r_it, r_k, cam_start, rays,
                rays.clone(), hits(), hist(), restore=parity)[0]}
    for name, r in out.items():
        r["chain_ms"] = C._chain_ms(None, lambda make=makes[name], name=name: [
            call(name, iter([make()])) for _ in range(C.CHAIN_CALLS)])
        r["chain_share"] = r["bound_ms"] / r["chain_ms"]
    # one wrapper call (the host's launch included) and one plain call of
    # each of the mode's kernels
    st = _copy(state)
    if engine == "default":
        one = {kernels[0]: lambda: S.route(scene, cfg, state, words),
               kernels[1]: lambda: S.shade(
                   scene, camera, cfg, st, fb.clone(), words, c["order"],
                   c["bundle"], c["counts"].clone(), it, cam_start, k)}
        plain = {kernels[0]: lambda: S.route_ref(scene, cfg, state, words),
                 kernels[1]: lambda: S.shade_ref(
                     scene, camera, cfg, state, fb.clone(), words,
                     c["order"], c["bundle"], c["counts"], it, cam_start, k)}
    elif engine == "unsorted":
        st1 = _copy(state)
        one = {kernels[0]: lambda: S.route_shade_unsorted(
            scene, camera, cfg, st, fb.clone(), words, cam_start),
            v1[0]: lambda: S.route_shade_unsorted_v1(
                scene, camera, cfg, st1, fb.clone(), words, cam_start)}
        plain = {k: lambda: S.route_shade_unsorted_ref(
            scene, camera, cfg, state, fb.clone(), words, cam_start)
            for k in (kernels[0], v1[0])}
    else:
        one = {kernels[0]: lambda: S.route_full(scene, cfg, state, words,
                                                mode),
               kernels[1]: lambda: S.shade_full(
                   scene, camera, cfg, st, fb.clone(), words, c["order"],
                   c["record"], c["counts"].clone(), cam_start, mode)}
        plain = {kernels[0]: lambda: S.route_full_ref(scene, cfg, state,
                                                      words, mode),
                 kernels[1]: lambda: S.shade_full_ref(
                     scene, camera, cfg, fb.clone(), words, c["order"],
                     c["record"], c["counts"], cam_start, mode)}
    if not parity:
        one[kernels[-1]] = lambda: S.resolve(
            cfg, sh_copy(), occ, r_it, r_k, cam_start, rays, rays.clone(),
            hits(), hist())
        plain[kernels[-1]] = lambda: S.resolve_ref(
            cfg, sh, occ, r_it, r_k, cam_start, rays, rays, c["hits"],
            c["hist"])
    else:
        one[kernels[-1]] = lambda: S.resolve_full(
            cfg, sh_copy(), occ, hits(), cam_start, rays, rays.clone(), mode,
            hist())
        plain[kernels[-1]] = lambda: S.resolve_full_ref(
            cfg, sh, occ, c["hits"], cam_start, rays, rays, mode, c["hist"])
    if engine == "default" and v1 and mode != "default":
        one[v1[0]] = lambda: S.shade_1s_v1(
            scene, camera, cfg, _copy(state), fb.clone(), words, c["order"],
            c["bundle"], c["counts"].clone(), it, cam_start, k)
        plain[v1[0]] = plain[kernels[1]]
    if r_v1:
        one[r_v1] = lambda: S.resolve_full_v1(
            cfg, sh_copy(), occ, hits(), cam_start, rays, rays.clone(), mode,
            hist())
        plain[r_v1] = plain[kernels[-1]]
    if parity:
        v1 = first_designs(mode)
        one[v1[0]] = lambda: S.route_full_v1(scene, cfg, state, words, mode)
        one[v1[1]] = lambda: S.shade_full_v1(
            scene, camera, cfg, _copy(state), fb.clone(), words, c["order"],
            c["record_v1"], c["counts"].clone(), cam_start, mode)
        plain[v1[0]] = lambda: S.route_full_v1_ref(scene, cfg, state, words,
                                                   mode)
        plain[v1[1]] = lambda: S.shade_full_v1_ref(
            scene, camera, cfg, fb.clone(), words, c["order"],
            c["record_v1"], c["counts"], cam_start, mode)
    if base:
        cfg0 = dataclasses.replace(cfg, detailed_stats=False)
        if parity:
            one[base] = lambda: S.resolve_full(
                cfg0, sh_copy(), occ, hits(), cam_start, rays, rays.clone(),
                mode)
            plain[base] = lambda: S.resolve_full_ref(
                cfg0, sh, occ, c["hits"], cam_start, rays, rays, mode)
        else:
            one[base] = lambda: S.resolve(
                cfg0, sh_copy(), occ, r_it, r_k, cam_start, rays,
                rays.clone(), hits())
            plain[base] = lambda: S.resolve_ref(
                cfg0, sh, occ, r_it, r_k, cam_start, rays, rays, c["hits"])
    for name in one:
        out[name]["one_call_ms"] = C._median_ms(one[name])
        out[name]["plain_ms"] = C._median_ms(plain[name])
    t = dict(kernels=out, lanes=n, **work)
    t["key_sort"] = sort_timing(scene, cfg, c, it, reps)
    t["sort_ms"] = None if c["keys"] is None else \
        t["key_sort"]["mean"]["torch"]
    if engine == "default":
        order = c["order"] if c["do_gen"] is None else torch.where(
            c["do_gen"], c["order"], torch.arange(n, device=dev))
        _, _, acc, pixel, _, mat, *_ = S.unpack_bundle(c["bundle"][order])
        flush = torch.stack([torch.where(~mat, x, 0.0) for x in acc], 1)
        fbx, pix = fb.clone(), pixel.long()
        t["index_add_ms"] = C._launch_ms(
            lambda: fbx.index_add_(0, pix, flush), reps)[0]
    return t


def sort_timing(scene, cfg, c, it, reps=5):
    """The step's sort on one state's route keys (``c`` from
    :func:`check_state`; None on the unsorted engine):
    tools/sort_designs.py ``time_sort`` in turns with torch.sort, and on a
    ``sort_every`` skip iteration ``skip_ms``, the device ms of a launch
    that returns at once."""
    import chip_smoke as C
    import sort_designs as SDs
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    keys = c["keys"]
    if keys is None:
        return None
    t = SDs.time_sort(keys, reps=reps)
    t["lanes"] = keys.shape[0]
    # [C 5]: a sort (its five kernels) in a chain between two events
    t["chain_ms"] = C._chain_ms(lambda: SO.stable_order(keys))
    k = WF.resolve_sort_every(scene, cfg)
    if S.engine_of(c["mode"]) == "default" and k > 1 and \
            not bool(c["do_gen"]):
        cadence = (c["counts"], it, k)
        t["skip_ms"] = C._launch_ms(lambda: SO.stable_order(keys, cadence),
                                    reps)[0]
    return t


def headline():
    """``(scene, camera, cfg)`` of the headline cell."""
    import chip_smoke as C
    from rtjax_torch.scenes import cornell_bunny
    scene, camera = cornell_bunny(device="cuda")
    return scene, camera, C._headline_cfg()


def check_and_time(scene, camera, cfg, its=(0, 1, 2, 5, 12), time_it=12,
                   label="headline", card="", seed=7, log=print,
                   sort_it=None, sort_out=None, variants=None):
    """The step kernels of ``cfg``'s mode on one cell: the pool stepped op
    by op from a fresh carry with seeded words, :func:`check_state` on the
    states of ``its`` and :func:`time_state` on the state of ``time_it``
    (None: none); returns ``(mismatching lanes by kernel, framebuffer gap
    by kernel, timings)``.  With ``sort_it`` (one of ``its``) the sort alone is timed
    on that state's keys (:func:`sort_timing`) into the dict
    ``sort_out``.  With ``variants`` (``(names, libraries)``) the
    state of ``time_it`` also times them (:func:`time_variants`, under
    ``timed["variants"]``)."""
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    n, dev = cfg.pool_size, scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    carry = WF.initial_carry(cfg, dev)
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64,
                                     device=dev),) + carry[4:]
    worst, gap, timed = {}, {}, None
    for it in range(max(its) + 1):
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=dev,
                              dtype=torch.int64)
        if it in its:
            bad, err, c = check_state(scene, camera, cfg, carry[0], words,
                                      carry[1], carry[3], carry[2])
            merge_gaps(gap, err)
            total = {k: sum(v.values()) for k, v in bad.items()}
            for k, v in total.items():
                worst[k] = worst.get(k, 0) + v
            dg, cnt = c["do_gen"], c["counts"]
            engine = S.engine_of(c["mode"])
            kind = "in limbo" if engine.startswith("parity") else "dirty"
            sorts = "" if engine != "default" else (
                ", sorts" if dg is None or bool(dg) else ", skips")
            log(f"[step kernels {label} it {it}] {card}: {int(cnt[0])} of "
                f"{n} continue, {int(cnt[4])} {kind}{sorts}; mismatching "
                "lanes " + ", ".join(f"{k} {v}" for k, v in total.items())
                + "; framebuffer largest gap " + ", ".join(
                    f"{k} {v:.3e}" for k, v in err.items()))
            for k, v in bad.items():
                if sum(v.values()):
                    log(f"  {k} mismatches by field: "
                        f"{ {f: m for f, m in v.items() if m} }")
            if it == time_it:
                timed = time_state(scene, camera, cfg, carry[0], words,
                                   carry[1], carry[3], carry[2], c)
                if variants is not None:
                    timed["variants"] = time_variants(
                        scene, camera, cfg, carry[0], words, carry[1],
                        carry[3], carry[2], c, *variants)
            if it == sort_it:
                sort_out.update(sort_timing(scene, cfg, c, carry[3]) or {})
        carry = WF.wavefront_step(scene, camera, cfg, words, carry,
                                  step_kernels=False)
    return worst, gap, timed


# --variants: copies of the step library patched for timing, ``{name:
# [(file, old, new), ...]}``, the patches in order, each on a text that
# occurs once: default shade's launch bounds at (128) alone; on the parity
# modes the own-triangle test out (the BSDF-MIS channel's target rows
# unread and no ray-triangle test: its mask and tmax are wrong), the
# parity shades' launch bounds at 5 and 6 blocks of 128 threads an SM,
# and the parity routes' at 6 blocks of 256 threads (48 warps, as
# route_parity_v1's); on the unsorted engine its route and shade with the
# look-back before the shading (arm B) and at one block of 128 threads an
# SM at least (the library's first bounds: 16 warps at 101 registers)
_OWN_TRI = ("step_math.cuh",
            "    chs_hit = intersect_triangle(chs_o, s2.wi, INFINITY, "
            "row3(a.tri_p0, own),\n"
            "                                 row3(a.tri_e1, own), "
            "row3(a.tri_e2, own),\n"
            "                                 row3(a.tri_n, own), &chs_t, "
            "&u, &v) &&\n"
            "              src == 0;",
            "    chs_t = 1.0f;\n    u = v = 0.0f;\n"
            "    chs_hit = src == 0 && own >= 0;")
PARITY_SHADES = ("shade_parity_kernel", "shade_parity_unsorted_kernel",
                 "shade_parity_v1_kernel", "shade_parity_unsorted_v1_kernel")
UNSORTED_SHADES = ("route_shade_unsorted_kernel",
                   "route_shade_unsorted_1s_kernel")
# the unsorted engine's route and shade with the look-back taken before
# the shading (arm B: the persistent scratch and the warp's look-back, in
# the first design's order; one barrier more), the text moved in
# csrc/step_kernels.cu route_shade
_LOOKBACK = ("  if (warp == 0) {\n"
             "    const unsigned p = rank_lookback(scratch + 1, b, total, "
             "parity, lane);\n"
             "    if (lane == 0) prefix = p;\n"
             "  }\n")
_PUBLISH = ("  if (threadIdx.x == 0) rank_publish(scratch + 1, b, total, "
            "parity);\n")
_RANK_FIRST = [("step_kernels.cu", _LOOKBACK + "  __syncthreads();\n",
                "  __syncthreads();\n"),
               ("step_kernels.cu", _PUBLISH,
                _PUBLISH + _LOOKBACK + "  __syncthreads();\n")]


# the sorted engine's one-sample shade with no prefetch (arm B: the same
# resident grid and tile walk, each tile's order, then its record and
# words, fetched and waited for when it is shaded), the text replaced in
# step_math.cuh shade_1s_walk
_PIPELINE = ("  fetch_order(0);\n"
             "  __pipeline_commit();\n"
             "  fetch_order(1);\n"
             "  __pipeline_commit();\n"
             "  __pipeline_wait_prior(1);\n"
             "  fetch_lane(0);\n"
             "  __pipeline_commit();\n"
             "  for (int k = 0; tile(k) < tiles; ++k) {\n"
             "    __pipeline_wait_prior(0);  // tile k's lane and tile k + 1's "
             "order in\n"
             "    fetch_lane(k + 1);\n"
             "    fetch_order(k + 2);\n"
             "    __pipeline_commit();\n")
_NO_PREFETCH = ("  for (int k = 0; tile(k) < tiles; ++k) {\n"
                "    fetch_order(k);\n"
                "    __pipeline_commit();\n"
                "    __pipeline_wait_prior(0);\n"
                "    fetch_lane(k);\n"
                "    __pipeline_commit();\n"
                "    __pipeline_wait_prior(0);\n")


def _bounds_patch(kernels, old, new):
    return [("step_kernels.cu", f"__launch_bounds__({old})\n    {k}(",
             f"__launch_bounds__({new})\n    {k}(") for k in kernels]


# the cells --variants times on by default (chip_smoke.py _mode_cells)
VARIANT_CELLS = ("parity frame", "headline parity xla")
PARITY_VARIANTS = ("no_own_triangle", "20_warps", "24_warps",
                   "route_48_warps")
STEP_VARIANTS = {
    "shade_128": _bounds_patch(("shade_kernel",), "kShadeBlock, 1",
                               "kShadeBlock"),
    "no_own_triangle": [_OWN_TRI],
    "20_warps": _bounds_patch(PARITY_SHADES, "kShadeBlock, 1",
                              "kShadeBlock, 5"),
    "24_warps": _bounds_patch(PARITY_SHADES, "kShadeBlock, 1",
                              "kShadeBlock, 6"),
    "route_48_warps": _bounds_patch(
        ("route_parity_kernel", "route_parity_unsorted_kernel"), "kBlock",
        "kBlock, kRouteBlocks"),
    "unsorted_rank_first": _RANK_FIRST,
    "unsorted_16_warps": _bounds_patch(UNSORTED_SHADES, "kShadeBlock, 5",
                                       "kShadeBlock, 1"),
    "shade_1s_no_prefetch": [("step_math.cuh", _PIPELINE, _NO_PREFETCH)],
    "shade_1s_20_warps": _bounds_patch(("shade_1s_kernel",),
                                       "kShadeBlock, 1", "kShadeBlock, 5"),
    "shade_1s_24_warps": _bounds_patch(("shade_1s_kernel",),
                                       "kShadeBlock, 1", "kShadeBlock, 6")}


def variant_source(name):
    """``{file name: text}`` of csrc/step_kernels.cu and step_math.cuh
    patched by ``STEP_VARIANTS[name]``, its patches in order, each on a
    text that occurs once."""
    from rtjax_torch.kernels import _build
    text = {f.name: f.read_text() for f in (_build.STEP_SOURCE,
                                            _build.STEP_HEADER)}
    for file, old, new in STEP_VARIANTS[name]:
        if text[file].count(old) != 1:
            raise RuntimeError(f"step variant {name}: a patch does not "
                               f"apply to csrc/{file}")
        text[file] = text[file].replace(old, new)
    return text


def patched_library(name, text):
    """The step library built from ``text`` (``{file name: text}`` of
    csrc/step_kernels.cu and step_math.cuh) under
    ``build/rtjax_torch/variants/step_<name>/``: its path."""
    from rtjax_torch.kernels import _build
    d = _build.BUILD_DIR / "variants" / f"step_{name}"
    d.mkdir(parents=True, exist_ok=True)
    for file, t in text.items():
        if not (d / file).exists() or (d / file).read_text() != t:
            (d / file).write_text(t)
    return _build._build(d / f"libstep_{name}.so", [d / "step_kernels.cu"],
                         [_build.nvcc_path()] + _build.NVCC_FLAGS,
                         (d / "step_math.cuh",))


def build_variants(names):
    """``{name: library path}`` of the variants ``names``, built at once
    (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        paths = pool.map(lambda k: patched_library(k, variant_source(k)),
                         names)
        return dict(zip(names, paths))


def time_variants(scene, camera, cfg, state, words, fb, it, cam_start, c,
                  names, libs, reps=5):
    """The mode's route, shade and resolve and its first designs' (``c``
    from :func:`check_state`) in the engine's library and in each of ``libs``
    (``{name: library}``), in turns: ``{lib: {kernel: {"ms": [...],
    "mean_ms", registers...}}}``."""
    import ctypes
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import step as S
    stream = torch.cuda.current_stream().cuda_stream
    makes = design_blocks(scene, camera, cfg, state, words, fb, it,
                          cam_start, c, resolve=True)
    every = {"engine": S._kernels(), **libs}
    rounds = ("engine", *names, *names[::-1], "engine")
    blocks = {k: blocks_of(make, len(rounds) * (reps + 1) + 2 * reps)
              for k, make in makes.items()}
    out = {lib: {k: dict(ms=[], **S.kernel_info(k, every[lib]))
                 for k in blocks} for lib in every}
    for lib in rounds:
        for k, pool in blocks.items():
            entry = getattr(every[lib], f"rtjax_step_{k}")
            out[lib][k]["ms"].append(C._launch_ms(
                lambda: entry(ctypes.byref(next(pool)), stream), reps)[0])
    for r in out.values():
        for t in r.values():
            t["mean_ms"] = statistics.mean(t["ms"])
    return out


def _no_sort_frame():
    """chip_smoke.py's parity frame (MODE_SIZE^2 @ MODE_SPP, a pool of
    2^19 lanes) on the unsorted engine without parity: the
    route-and-shade's look-back over 4,096 blocks."""
    import chip_smoke as C
    from rtjax_torch import RenderConfig
    return RenderConfig(width=C.MODE_SIZE, height=C.MODE_SIZE,
                        num_samples=C.MODE_SPP, max_bounces=C.BOUNCES,
                        sort_rays=False)


def variants(names=None, cells=VARIANT_CELLS, time_it=30, card="",
             log=print):
    """``--variants``: the libraries of ``names`` (default: every parity
    variant, ``PARITY_VARIANTS``) built, then on each cell's state of
    ``time_it`` (``"headline"``, ``"no_sort frame"``, or a cell of
    chip_smoke.py ``_mode_cells``) the
    kernels checked (:func:`check_and_time`: the mode's and the first
    design's route and shade in turns) and the variants timed
    (:func:`time_variants`)."""
    import ctypes
    import chip_smoke as C
    from rtjax_torch.kernels import step as S
    scene, camera = C.phase2_scene()
    names = tuple(names or PARITY_VARIANTS)
    libs = {k: S.bind(ctypes.CDLL(str(p)))
            for k, p in build_variants(names).items()}
    all_cells = {"headline": (scene, camera, C._headline_cfg()),
                 **C._mode_cells(scene, camera),
                 "no_sort frame": (scene, camera, _no_sort_frame())}
    out = {}
    for name in cells:
        sc, cam, cfg = all_cells[name]
        worst, _, timed = check_and_time(
            sc, cam, cfg, (time_it,), time_it, label=name, card=card,
            log=log, variants=(names, libs))
        if any(worst.values()):
            raise RuntimeError(f"{name}: the step kernels differ from their "
                               f"plain versions: {worst}")
        for k, r in timed["kernels"].items():
            log(f"[step time {name} {k}] {card}: {r['mean_ms']:.4f} ms a "
                f"launch (in turns {r['ms']}), {100 * r['share']:.2f}% of "
                f"its bound ({r['bound_us']:.3f} us)")
        for lib, r in timed["variants"].items():
            log(f"[step variants {name} {lib}] {card}: " + "; ".join(
                f"{k} {t['mean_ms']:.4f} ms (in turns {t['ms']}), "
                f"{t['registers']} registers, {t['local_bytes']} local "
                f"bytes, {t['warps_per_sm']} warps an SM"
                for k, t in r.items()))
        out[name] = timed
    return out


def run(its=(0, 1, 2, 5, 12), time_it=12):
    """Steps 1-3 on the headline; returns their numbers."""
    scene, camera, cfg = headline()
    table = kernel_table()
    for name, r in table.items():
        print(f"[step kernel {name}] {r['registers']} registers, "
              f"{r['local_bytes']} local bytes, {r['block']} threads a "
              f"block, {r['blocks_per_sm']} blocks = {r['warps_per_sm']} "
              "warps an SM")
    worst, gap, timed = check_and_time(scene, camera, cfg, its, time_it)
    for name, r in timed["kernels"].items():
        print(f"[step time {name}] {r['mean_ms']:.4f} ms a launch "
              f"({r['ms']}), bound {r['bound_us']:.3f} us by "
              f"{r['bound_by']}, {100 * r['share']:.2f}% of it"
              + (f"; one call {r['one_call_ms']:.4f} ms" if "one_call_ms"
                 in r else ""))
    print(f"[step flush] flush atomics a shade launch "
          f"{timed['flush_atomics']}; torch.sort {timed['sort_ms']:.4f} ms; "
          f"the key sort {timed['key_sort']['mean']['kernels']:.4f} ms")
    if any(worst.values()):
        raise RuntimeError(f"the step kernels differ from their plain "
                           f"versions: {worst}")
    return dict(kernels=table, mismatches=worst, fb_gap=gap, times=timed)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--its", default="0,1,2,5,12")
    ap.add_argument("--time-it", type=int, default=12)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--names", help="the variants to time (--variants; "
                    "default the parity ones)")
    ap.add_argument("--cells", default=",".join(VARIANT_CELLS))
    ap.add_argument("--out")
    args = ap.parse_args()
    import chip_smoke as C
    card = C.phase0_device()
    print(f"[card] {card}")
    C.phase1_build()
    if args.variants:
        out = variants(args.names and args.names.split(","),
                       args.cells.split(","), card=card)
    else:
        out = run(tuple(int(x) for x in args.its.split(",")), args.time_it)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
