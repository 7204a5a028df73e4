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
2. steps a pool op by op and, on the states of ``--its``, holds route and
   shade of both designs bit for bit against their plain versions (every
   output; the framebuffer within rtol 1e-5 of the plain version's
   ``index_add_`` run on the CPU), and the two designs' next state and
   shadow columns equal;
3. on the state of ``--time-it`` times, in turns (``_launch_ms``: CUDA
   events between launches queued behind a spin kernel), route against
   route_v1 and shade against shade_v1, and resolve, each with its byte
   bound, and one wrapper call of each (host launch included).

``--bounds-ab`` instead builds two patched copies of the library, shade
with ``__launch_bounds__(128, 1)`` (the library's) and with ``(128)``
alone, prints ptxas's line for each shade, and times shade on the state
of ``--time-it`` with each, in turns (steps 2-3 for each copy).

Its timing (:func:`time_state`) is also called by ``chip_smoke.py``'s
phase 14, which profiles both designs' captured frames in phase 13's busy
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
                "trace_mask", "counts", "shadow", "ah_L", "chs_L")


def plain_flush_cpu(fb, bundle, order, do_gen):
    """The framebuffer after the plain version's flush, ``index_add_`` of
    every lane's radiance in sorted position, run on the CPU (one add a
    lane, in order)."""
    import torch
    from rtjax_torch.kernels import step as S
    n = bundle.shape[0]
    if do_gen is not None:
        order = torch.where(do_gen, order, torch.arange(n, device=fb.device))
    _, _, acc, pixel, _, mat, *_ = S.unpack_bundle(bundle[order])
    flushing = ~mat if do_gen is None else ~mat & do_gen
    flush = torch.stack([torch.where(flushing, c, 0.0) for c in acc], 1)
    return fb.cpu().index_add_(0, pixel.long().cpu(), flush.cpu())


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
    """Route and shade of both designs against their plain versions on
    one state: ``({check: mismatching lanes}, framebuffer gap,
    checked)``; ``checked`` holds what :func:`time_state` needs."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    k = WF.resolve_sort_every(scene, cfg)
    n = cfg.pool_size
    bad = {}

    def tally(what, got, want):
        for x, y in zip(C._flat_out(got), C._flat_out(want), strict=True):
            bad[what] = bad.get(what, 0) + C._lanes_differ(x, y)

    want = S.route_ref(scene, cfg, state, words)
    tally("route", S.route(scene, cfg, state, words), want)
    want_v1 = S.route_v1_ref(scene, cfg, state, words)
    tally("route_v1", S.route_v1(scene, cfg, state, words), want_v1)
    keys, bundle, counts = want
    order = torch.sort(keys, stable=True).indices
    do_gen = S.cadence(counts, n, it, k)
    sh0 = S.shade_ref(scene, camera, cfg, state, fb.clone(), words, order,
                      bundle, counts, it, cam_start, k)
    fb1, fb2 = fb.clone(), fb.clone()
    sh1 = S.shade(scene, camera, cfg, _copy(state), fb1, words, order,
                  bundle, counts.clone(), it, cam_start, k)
    sh2 = S.shade_v1(scene, camera, cfg, _copy(state), fb2, words, order,
                     want_v1[1], counts.clone(), it, cam_start, k)
    for f in SHADE_FIELDS:
        tally("shade", getattr(sh1, f), getattr(sh0, f))
        tally("shade_v1", getattr(sh2, f), getattr(sh0, f))
        tally("shade = shade_v1", getattr(sh1, f), getattr(sh2, f))
    want_fb = plain_flush_cpu(fb, bundle, order, do_gen)
    gap = float((fb1.cpu() - want_fb).abs().max())
    if not torch.allclose(fb1.cpu(), want_fb, rtol=FB_RTOL, atol=FB_ATOL):
        bad["framebuffer beyond rtol"] = 1
    if not torch.allclose(fb2.cpu(), want_fb, rtol=FB_RTOL, atol=FB_ATOL):
        bad["framebuffer v1 beyond rtol"] = 1
    return bad, gap, dict(keys=keys, order=order, bundle=bundle,
                          bundle_v1=want_v1[1], counts=counts, sh=sh0,
                          do_gen=do_gen)


def time_state(scene, camera, cfg, state, words, fb, it, cam_start, c,
               reps=5):
    """Step 3 on one state (``c`` from :func:`check_state`): ``{kernel:
    {ms, mean_ms, bound_ms, share, ...}}``, in turns."""
    import ctypes

    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render.trace import trace_anyhit
    from rtjax_torch.render import wavefront as WF
    k = WF.resolve_sort_every(scene, cfg)
    n = cfg.pool_size
    lib = S._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    entry = lambda name, a: (lambda: getattr(lib, f"rtjax_step_{name}")(
        ctypes.byref(a), stream))
    do_gen = True if c["do_gen"] is None else bool(c["do_gen"])
    a_route, _ = S.route_args(scene, cfg, state, words)
    a_route_v1, _ = S.route_args(scene, cfg, state, words, v1=True)
    shade_in = lambda v1=False: (
        scene, camera, cfg, _copy(state), fb.clone(), words, c["order"],
        c["bundle_v1"] if v1 else c["bundle"], c["counts"].clone(), it,
        cam_start, k)
    a_shade, _ = S.shade_args(*shade_in())
    a_v1, _ = S.shade_args(*shade_in(True), v1=True)
    sh = c["sh"]
    occ = trace_anyhit(scene, cfg, *sh.shadow)
    rays = torch.zeros((), dtype=torch.float64, device="cuda")
    a_res, _ = S.resolve_args(cfg, dataclasses.replace(
        sh, acc=tuple(x.clone() for x in sh.acc)), occ, it, k, cam_start,
        rays, rays.clone())
    atomics = flush_atomics(c["bundle"], c["order"], c["counts"],
                            c["do_gen"])
    # bytes: the payload of a lane's record (36 B), not its padding
    lights = scene.num_lights > 0
    shade_b = n * (C.SHADE_BYTES + C.SHADE_LIGHTS * lights
                   + C.SHADE_ORDER * do_gen) + C.SHADE_FLUSH * atomics[
                       "lanes"]
    bounds = dict(route=C._step_bound(n * C.ROUTE_BYTES, n * C.ROUTE_OPS),
                  shade=C._step_bound(shade_b, n * C.SHADE_OPS),
                  resolve=C._step_bound(n * C.RESOLVE_BYTES,
                                        n * C.RESOLVE_OPS))
    out = {}

    def put(name, ms, kernel):
        r = out.setdefault(name, dict(ms=[], **bounds[kernel]))
        r["ms"].extend(ms)

    # route against route_v1: v1, new, new, v1
    for name, a in (("route_v1", a_route_v1), ("route", a_route),
                    ("route", a_route), ("route_v1", a_route_v1)):
        put(name, [C._launch_ms(entry(name, a), reps)[0]], "route")
    # shade against shade_v1: v1, new, new, v1
    for name, a in (("shade_v1", a_v1), ("shade", a_shade),
                    ("shade", a_shade), ("shade_v1", a_v1)):
        put(name, [C._launch_ms(entry(name, a), reps)[0]], "shade")
    put("resolve", [C._launch_ms(entry("resolve", a_res), reps)[0]],
        "resolve")
    for r in out.values():
        r["mean_ms"] = statistics.mean(r["ms"])
        r["share"] = r["bound_ms"] / r["mean_ms"]
    # one wrapper call each, the host's launch included (CUDA events)
    st = _copy(state)
    one = {"route": lambda: S.route(scene, cfg, state, words),
           "shade": lambda: S.shade(scene, camera, cfg, st, fb.clone(),
                                    words, c["order"], c["bundle"],
                                    c["counts"].clone(), it, cam_start, k),
           "resolve": lambda: S.resolve(cfg, dataclasses.replace(
               sh, acc=tuple(x.clone() for x in sh.acc)), occ, it, k,
               cam_start, rays, rays.clone())}
    calls = {name: C._median_ms(fn) for name, fn in one.items()}
    return dict(kernels=out, one_call=calls, flush_atomics=atomics, lanes=n,
                sort_ms=C._launch_ms(lambda: torch.sort(
                    c["keys"], stable=True), reps)[0])


def headline():
    """``(scene, camera, cfg)`` of the headline cell."""
    import chip_smoke as C
    from rtjax_torch.scenes import cornell_bunny
    scene, camera = cornell_bunny(device="cuda")
    return scene, camera, C._headline_cfg()


def check_and_time(scene, camera, cfg, its=(0, 1, 2, 5, 12), time_it=12,
                   label="headline", seed=7):
    """Steps 2-3 on one cell: the pool stepped op by op from a fresh
    carry with seeded words; returns ``(mismatches, gap, timings)``."""
    import torch
    from rtjax_torch.render import wavefront as WF
    n = cfg.pool_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    carry = WF.initial_carry(cfg, "cuda")
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64,
                                     device="cuda"),) + carry[4:]
    worst, gap, timed = {}, 0.0, None
    for it in range(max(its) + 1):
        words = torch.randint(0, 1 << 32, (5, n), generator=g,
                              device="cuda", dtype=torch.int64)
        if it in its:
            bad, err, checked = check_state(scene, camera, cfg, carry[0],
                                            words, carry[1], carry[3],
                                            carry[2])
            gap = max(gap, err)
            for k_, v in bad.items():
                worst[k_] = worst.get(k_, 0) + v
            dg = checked["do_gen"]
            print(f"[step designs {label} it {it}] "
                  f"{int(checked['counts'][0])} of {n} continue, "
                  f"{int(checked['counts'][4])} dirty, "
                  f"{'sorts' if dg is None or bool(dg) else 'skips'}; "
                  "mismatching lanes " + ", ".join(
                      f"{k_} {v}" for k_, v in bad.items())
                  + f"; framebuffer gap {err:.3e}")
            if it == time_it:
                timed = time_state(scene, camera, cfg, carry[0], words,
                                   carry[1], carry[3], carry[2], checked)
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
              f"{r['bound_by']}, {100 * r['share']:.2f}% of it")
    print(f"[step one call] {timed['one_call']}; flush atomics a shade "
          f"launch {timed['flush_atomics']}; torch.sort "
          f"{timed['sort_ms']:.4f} ms")
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
