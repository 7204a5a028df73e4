#!/usr/bin/env python3
"""The fused step's two designs on one CUDA card.

    python3 tools/step_designs.py [--its 0,1,2,5,12] [--time-it 12]
    python3 tools/step_designs.py --bounds-ab

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

``--bounds-ab`` instead builds two patched copies of the library, shade
with ``__launch_bounds__(128, 1)`` (the library's) and with ``(128)``
alone, prints ptxas's line for each shade, and times shade on the state
of ``--time-it`` with each, in turns (steps 2-3 for each copy).

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
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FB_RTOL, FB_ATOL = 1e-5, 1e-7
# --bounds-ab: shade's launch bounds in the library, and the other arm
SHADE_BOUNDS = {"128x1": "__launch_bounds__(kShadeBlock, 1)",
                "128": "__launch_bounds__(kShadeBlock)"}


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
    mismatching lanes}}, framebuffer gap, checked)``; ``checked`` holds
    what :func:`time_state` needs.  Every output bit for bit; the
    framebuffer within FB_RTOL of the plain version's (its atomic adds'
    order).  Under the default mode also the first design (route_v1,
    shade_v1) against the same plain versions and shade against shade_v1.
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
    v1 = mode == "default"
    sorts = engine in ("default", "wide", "parity")
    bad = {name: {} for name in kernels + (
        ("route_v1", "shade_v1") if v1 else ()) + ("key_sort",) * sorts}

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
        if v1:
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
    fields = SHADE_FIELDS + (("limbo",) if mode.startswith("parity") else ())
    for f in fields:
        want_f = C._flat_out(getattr(sh0, f))
        names = [f"{f}[{j}]" for j in range(len(want_f))]
        tally(shade_k, names, getattr(sh1, f), want_f)
        if v1:
            tally("shade_v1", names, getattr(sh2, f), want_f)
            tally("shade_v1", [f"= shade {x}" for x in names],
                  getattr(sh2, f), getattr(sh1, f))
    gap = float((fb1 - fb0).abs().max())
    for kernel, got in ((shade_k, fb1),) + ((("shade_v1", fb2),) if v1
                                            else ()):
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
    tally(resolve_k, names, r1, r0)
    c.update(sh=sh0, occ=occ, hits=hits, hist=hist)
    return bad, gap, c


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
# B).  Under one-sample MIS shade reads four words (32 B) and writes one
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
        return b, dict(flush_atomics=atomics)
    r = S.unpack_full(c["record"] if c["order"] is None
                      else c["record"][c["order"]])
    gen = ~r["mat"] & ~r["limbo"]
    flushing = int((gen & ((r["acc"][0] != 0) | (r["acc"][1] != 0)
                           | (r["acc"][2] != 0))).sum())
    limbo = int(r["limbo"].sum())
    if engine == "unsorted":
        nbytes = (n * (MERGED_BYTES - words + shade_l)
                  + SHADE_FLUSH * flushing, n * resolve + hist)
        ops = (C.ROUTE_OPS + C.SHADE_OPS, C.RESOLVE_OPS)
    else:
        parity = engine.startswith("parity")
        sort = engine in ("parity", "wide")
        wide = engine == "wide"
        nbytes = (n * (ROUTE_FULL_BYTES + ROUTE_KEY * sort),
                  n * (SHADE_FULL_BYTES - WIDE_NO_T * wide - words
                       + SHADE_FLAG * parity + SHADE_ORDER * sort + shade_l)
                  + SHADE_FLUSH * flushing,
                  (n * resolve + hist) if wide else
                  n * (RESOLVE_FULL_BYTES + RESOLVE_STATS * stats) + hist
                  + limbo * (RESOLVE_LIMBO + RESOLVE_ORDER * sort))
        ops = (C.ROUTE_OPS, C.SHADE_OPS, C.RESOLVE_OPS)
    return ({k: C._step_bound(b, n * o)
             for k, b, o in zip(kernels, nbytes, ops, strict=True)},
            dict(flushing=flushing, limbo=limbo))


def time_state(scene, camera, cfg, state, words, fb, it, cam_start, c,
               reps=5):
    """The mode's kernels on one state (``c`` from :func:`check_state`):
    each kernel's device ms a launch (``chip_smoke._launch_ms`` of its
    entry point called with argument blocks made before), in turns:
    first, ..., last, last, ..., first (under the default mode route_v1
    before route and shade_v1 before shade); its byte bound and share,
    registers and resident warps; one wrapper call and one plain call of
    each of the mode's kernels (CUDA events, median); the key sort of
    the keys in turns with torch.sort (:func:`sort_timing`, ``key_sort``;
    ``sort_ms`` torch.sort's), and on the sorted engine's compact bundle
    ``index_add_`` of the
    flush.  A launch that writes the next state over the one it reads (the
    unsorted engine's route-and-shade) takes a copy of its own.  Returns
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
    blocks = 6 * (reps + 1)
    a_res = S.resolve_args(cfg, sh_copy(), occ, r_it, r_k, cam_start, rays,
                           rays.clone(), hits(), hist(), restore=parity)[0]
    fns = {kernels[-1]: call(kernels[-1], iter([a_res] * blocks))}
    if engine == "default":
        for v1 in (False, True)[:1 + (mode == "default")]:
            suffix = "_v1" if v1 else ""
            route_k = "route" + suffix
            shade_k = "shade_v1" if v1 else kernels[1]
            a_r = S.route_args(scene, cfg, state, words, v1=v1)[0]
            a_s = S.shade_args(scene, camera, cfg, _copy(state), fb.clone(),
                               words, c["order"], c["bundle" + suffix],
                               c["counts"].clone(), it, cam_start, k,
                               v1=v1)[0]
            fns[route_k] = call(route_k, iter([a_r] * blocks))
            fns[shade_k] = call(shade_k, iter([a_s] * blocks))
        turns = ("route_v1", "route", "shade_v1", "shade", "resolve") \
            if mode == "default" else kernels
    elif engine == "unsorted":
        zero = lambda: torch.zeros(S.NUM_COUNTS, dtype=torch.int64,
                                   device=dev)
        merged = [S.shade_args(scene, camera, cfg, _copy(state), fb.clone(),
                               words, None, None, zero(), 0, cam_start, 1,
                               mode=mode)[0] for _ in range(blocks)]
        fns[kernels[0]] = call(kernels[0], iter(merged))
        turns = kernels
    else:
        a_r = S.route_args(scene, cfg, state, words, mode=mode)[0]
        a_s = S.shade_args(scene, camera, cfg, _copy(state), fb.clone(),
                           words, c["order"], c["record"],
                           c["counts"].clone(), 0, cam_start, 1,
                           mode=mode)[0]
        fns[kernels[0]] = call(kernels[0], iter([a_r] * blocks))
        fns[kernels[1]] = call(kernels[1], iter([a_s] * blocks))
        turns = kernels
    bounds, work = _bounds(scene, cfg, c)
    out = {name: dict(ms=[], **bounds[name]) for name in turns}
    for name in turns + turns[::-1]:
        out[name]["ms"].append(C._launch_ms(fns[name], reps)[0])
    for name, r in out.items():
        r["mean_ms"] = statistics.mean(r["ms"])
        r["share"] = r["bound_ms"] / r["mean_ms"]
        r.update(S.kernel_info(name))
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
        one = {kernels[0]: lambda: S.route_shade_unsorted(
            scene, camera, cfg, st, fb.clone(), words, cam_start)}
        plain = {kernels[0]: lambda: S.route_shade_unsorted_ref(
            scene, camera, cfg, state, fb.clone(), words, cam_start)}
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
    for name in kernels:
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
                   sort_it=None, sort_out=None):
    """The step kernels of ``cfg``'s mode on one cell: the pool stepped op
    by op from a fresh carry with seeded words, :func:`check_state` on the
    states of ``its`` and :func:`time_state` on the state of ``time_it``
    (None: none); returns ``(mismatching lanes by kernel, framebuffer gap,
    timings)``.  With ``sort_it`` (one of ``its``) the sort alone is timed
    on that state's keys (:func:`sort_timing`) into the dict
    ``sort_out``."""
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    n, dev = cfg.pool_size, scene.device
    g = torch.Generator(device=dev).manual_seed(seed)
    carry = WF.initial_carry(cfg, dev)
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64,
                                     device=dev),) + carry[4:]
    worst, gap, timed = {}, 0.0, None
    for it in range(max(its) + 1):
        words = torch.randint(0, 1 << 32, (5, n), generator=g, device=dev,
                              dtype=torch.int64)
        if it in its:
            bad, err, c = check_state(scene, camera, cfg, carry[0], words,
                                      carry[1], carry[3], carry[2])
            gap = max(gap, err)
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
                + f"; framebuffer largest gap {err:.3e}")
            for k, v in bad.items():
                if sum(v.values()):
                    log(f"  {k} mismatches by field: "
                        f"{ {f: m for f, m in v.items() if m} }")
            if it == time_it:
                timed = time_state(scene, camera, cfg, carry[0], words,
                                   carry[1], carry[3], carry[2], c)
            if it == sort_it:
                sort_out.update(sort_timing(scene, cfg, c, carry[3]) or {})
        carry = WF.wavefront_step(scene, camera, cfg, words, carry,
                                  step_kernels=False)
    return worst, gap, timed


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


def bounds_library(bounds):
    """A copy of the step library built under ``build/`` with shade's
    launch bounds ``SHADE_BOUNDS[bounds]``: ``(path, ptxas's line of
    shade)``."""
    from rtjax_torch.kernels import _build
    src = _build.STEP_SOURCE.read_text()
    tail = "\n    shade_kernel(const StepArgs a)"
    if SHADE_BOUNDS["128x1"] + tail not in src:
        raise RuntimeError("shade's launch bounds in csrc/step_kernels.cu "
                           "are not SHADE_BOUNDS['128x1']")
    d = _build.BUILD_DIR / f"step_bounds_{bounds}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "step_kernels.cu").write_text(src.replace(
        SHADE_BOUNDS["128x1"] + tail, SHADE_BOUNDS[bounds] + tail))
    shutil.copy(_build.STEP_HEADER, d / "step_math.cuh")
    lib = _build._build(d / f"libstep_bounds_{bounds}.so",
                        [d / "step_kernels.cu"],
                        [_build.nvcc_path()] + _build.NVCC_FLAGS,
                        (d / "step_math.cuh",))
    line = [res for name, res in _build.ptxas_report(lib)
            if "shade_kernel" in name and "v1" not in name]
    return lib, line[0]


def bounds_ab(time_it=12):
    """``--bounds-ab``: ``{bounds: [shade ms, ...]}``, each copy's steps
    2-3 in turns (128x1, 128, 128, 128x1)."""
    import ctypes
    from rtjax_torch.kernels import step as S
    scene, camera, cfg = headline()
    libs = {b: bounds_library(b) for b in SHADE_BOUNDS}
    for b, (_, line) in libs.items():
        print(f"[step shade bounds {b}] {line}")
    old, ms = S._lib, {}
    try:
        for b in ("128x1", "128", "128", "128x1"):
            S._lib = S.bind(ctypes.CDLL(str(libs[b][0])))
            worst, _, timed = check_and_time(scene, camera, cfg, (time_it,),
                                             time_it, label=f"bounds {b}")
            if any(worst.values()):
                raise RuntimeError(f"shade with bounds {b} differs from its "
                                   f"plain version: {worst}")
            ms.setdefault(b, []).append(timed["kernels"]["shade"]["mean_ms"])
    finally:
        S._lib = old
    for b, v in ms.items():
        print(f"[step shade bounds {b}] shade {statistics.mean(v):.5f} ms a "
              f"launch, in turns {v}")
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--its", default="0,1,2,5,12")
    ap.add_argument("--time-it", type=int, default=12)
    ap.add_argument("--bounds-ab", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import chip_smoke as C
    card = C.phase0_device()
    print(f"[card] {card}")
    C.phase1_build()
    if args.bounds_ab:
        out = bounds_ab(args.time_it)
    else:
        out = run(tuple(int(x) for x in args.its.split(",")), args.time_it)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
