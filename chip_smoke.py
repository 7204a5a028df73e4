#!/usr/bin/env python3
"""GPU smoke run of rtjax_torch, the PyTorch + CUDA port of rtjax.

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises and
the script exits non-zero):

0. device: require CUDA; print the card's name and power limit, and the
   torch and CUDA versions;
1. build: the BVH builder and the three kernel libraries from this
   checkout's sources, into build/rtjax_torch/, all four compilers
   started together;
2. scene: the bunny Cornell box (69,463 triangles) on the card;
3. kernels: each persistent-walker kernel against its plain PyTorch version
   on the card at the main path's shapes (2^18 closest-hit rays, 2^19
   any-hit rays): zero hit/occlusion mismatches and equal t/prim/normal,
   plus median times over 5 runs; then the packet and lane kernels against
   the plain group walk on the same rays: zero hit, t, prim, normal and
   occlusion mismatches, correct dead lanes, hits and occlusion equal to
   the persist kernels' (the equal-t ties, where the two walks may keep
   another prim, are counted), kernel medians over 5 runs and one timed
   plain call;
4. main path: render_frame of the headline frame (256x256 at 64 spp, 10
   bounces, default RenderConfig): one warm-up and two timed runs; both
   kernels must have launched and no plain version may have run; the image
   must be finite and non-negative and agree with the rtjax render in
   artifacts/ at the noise floor (MSE <= 2x the port's own seed-to-seed MSE
   plus the 8-bit quantisation term); then the same frame under each
   walker, alternated (persist, packet, lane, lane, packet, persist; seeds
   2, 2, 2, 3, 3, 3; walker="packet" with anyhit_walker="packet"), launch
   counts read from zero per frame: exactly one launch per iteration of
   the walker's own closest-hit and any-hit kernels and no other, no plain
   version, each image at the noise-floor gate and within 0.1x the
   seed-to-seed MSE of the persist image of its seed;
5. two-level kernels: eval config 4 (16 instanced bunnies, 1.11M effective
   triangles) built on the card; each two-level kernel against its plain
   version at the config's shapes (2^17 closest-hit rays: half camera
   rays, half random rays over the instance field, 10% inactive; 2^18
   any-hit rays with random exclusions): zero hit, t, prim, inst, normal
   and occlusion mismatches, correct dead lanes, median times over 5 runs;
   then the persist, packet and lane kernels against their plain versions,
   as in phase 3, at the two other shapes config 4 gives them: the baked
   scene's tables (the same placements in one single-level scene, 1.11M
   triangles; 2^17 / 2^18 rays) and the shared BLAS with the rays of
   repass's first pass (each ray in the frame of the nearest instance box
   it meets, active only where it meets one, no exclusion);
6. config 4 end to end (256x256 at 8 spp, 5 bounces, default
   RenderConfig): (a) two_level="auto" (repass over the persist kernels)
   with seeds 1 (warm-up), 2 and 3; (b) two_level="kernel" (the two-level
   kernels) with seed 2; (c) the same bunnies baked into one single-level
   scene, seed 2; (d) repass under walker="packet" and
   anyhit_walker="packet", seed 2.  Each run's launch counts are read from
   zero: (a) and (c) launch only the persist kernels, (b) only the
   two-level ones, (d) only the packet ones, and no plain version runs.
   Frames are finite and non-negative; MSE((a), (b)) and MSE((a), (d)) <=
   0.1x and MSE((a), (c)) <= 2x the seed-to-seed MSE of (a) (plus the
   quantisation term for (c)).  Images go to build/rtjax_torch/.

The last two lines of standard output are a JSON object with per-kernel
numbers and then ``{"ok": true, "device": {...}}``.  ``launches`` is each
kernel's count in its main-path frame: phase 4's for the persist kernels,
its packet and lane frames (seed 2) for those kernels, 6(b) for the
two-level ones.  lane_traverse_anyhit is on no engine path (rtjax's
``anyhit_walker`` takes "persist" or "packet" only), so its count is 0.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH = HEIGHT = 256
SPP = 64
BOUNCES = 10
ARTIFACT = os.path.join(ROOT, "artifacts", "cornell_bunny_256_64spp.ppm")
REPS = 5

# config 4 (benchmarks/run_configs.py:198-226)
C4_SPP = 8
C4_BOUNCES = 5

KERNELS = {
    "closest": dict(name="persist_traverse_closest",
                    replaces="rtjax/kernels/pallas_lane_persist.py:526"),
    "anyhit": dict(name="persist_traverse_anyhit",
                   replaces="rtjax/kernels/pallas_lane_persist.py:600"),
}
INST_KERNELS = {
    "closest": dict(name="wide_traverse_closest_inst",
                    replaces="rtjax/kernels/pallas_wide.py:1598"),
    "anyhit": dict(name="wide_traverse_anyhit_inst",
                   replaces="rtjax/kernels/pallas_wide.py:1666"),
}
GROUP_KERNELS = {
    ("packet", "closest"): dict(name="wide_traverse_closest",
                                replaces="rtjax/kernels/pallas_wide.py:1482"),
    ("packet", "anyhit"): dict(name="wide_traverse_anyhit",
                               replaces="rtjax/kernels/pallas_wide.py:1552"),
    ("lane", "closest"): dict(name="lane_traverse_closest",
                              replaces="rtjax/kernels/pallas_lane.py:549"),
    ("lane", "anyhit"): dict(name="lane_traverse_anyhit",
                             replaces="rtjax/kernels/pallas_lane.py:608"),
}
SOURCE = "rtjax_torch/csrc/persist_traverse.cu"
INST_SOURCE = "rtjax_torch/csrc/wide_inst_traverse.cu"
GROUP_SOURCE = "rtjax_torch/csrc/packet_traverse.cu"
# walker settings of the headline frames of phase 4
WALKERS = {"persist": dict(walker="persist", anyhit_walker="persist"),
           "packet": dict(walker="packet", anyhit_walker="packet"),
           "lane": dict(walker="lane")}


def phase0_device():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__},"
          f" CUDA {torch.version.cuda}")
    return card


def phase1_build():
    from rtjax_torch.kernels import _build
    builds = {"bvh builder": _build.bvh_library,
              "persist kernels": _build.persist_library,
              "two-level kernels": _build.wide_inst_library,
              "packet and lane kernels": _build.packet_library}

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        secs = dict(zip(builds, pool.map(timed, builds.values())))
    print(f"[build] " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" (in parallel, {time.perf_counter() - t0:.1f} s wall), into "
          f"{_build.BUILD_DIR}")


def phase2_scene():
    from rtjax_torch.scenes import cornell_bunny
    t0 = time.perf_counter()
    scene, camera = cornell_bunny(device="cuda")
    tab = scene.tables
    print(f"[scene] {scene.tris.num} triangles, {tab.num_wide_nodes} "
          f"{tab.width}-wide nodes, {tab.num_leaf_rows} leaf rows, "
          f"{tab.nbytes / 2**20:.2f} MiB of tables, depth {tab.depth}, "
          f"built in {time.perf_counter() - t0:.1f} s")
    return scene, camera


def _median_ms(fn):
    """Median device time of ``fn`` over REPS runs (CUDA events), after
    one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timed_ms(fn):
    """``(fn(), device ms of that one call)`` (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _test_rays(scene, camera, gen):
    """2^18 closest-hit rays (half headline camera rays, half random rays
    inside the box) and 2^19 shadow-like rays with random ``exclude``."""
    import torch
    from rtjax_torch.core import vec
    dev = torch.device("cuda")
    n = 1 << 18
    half = n // 2
    rnd = lambda *s: torch.rand(*s, generator=gen, device=dev)
    pix = torch.arange(half, device=dev) % (WIDTH * HEIGHT)
    x = ((pix % WIDTH).float() + rnd(half)) / WIDTH
    y = ((pix // WIDTH).float() + rnd(half)) / HEIGHT
    cam_o, cam_d = camera.get_rays_v3(x, y)

    def in_box(m):
        return (rnd(m), rnd(m), -rnd(m))

    def random_dir(m):
        g = torch.randn(3, m, generator=gen, device=dev)
        return vec.normalize((g[0], g[1], g[2]))

    o2, d2 = in_box(half), random_dir(half)
    o = tuple(torch.cat([a, b]).contiguous() for a, b in zip(cam_o, o2))
    d = tuple(torch.cat([a, b]).contiguous() for a, b in zip(cam_d, d2))
    closest = dict(o=o, d=d, tmax=torch.full((n,), float("inf"), device=dev),
                   active=rnd(n) > 0.1)

    m = 2 * n
    so, target = in_box(m), in_box(m)
    to = vec.sub(target, so)
    dist = vec.length(to)
    sd = tuple(c.contiguous() for c in vec.scale(1.0 / dist, to))
    ex = torch.randint(-1, scene.tris.num, (m,), generator=gen, device=dev,
                       dtype=torch.int32)
    anyhit = dict(o=so, d=sd, tmax=dist, exclude=ex, active=rnd(m) > 0.1)
    return closest, anyhit


def _check_persist(label, tab, cl, ah, card):
    """Hold both persist kernels against their plain versions on ``tab``
    with the closest-hit rays ``cl`` and the any-hit rays ``ah``: zero
    hit/occlusion mismatches, equal t/prim/normal and correct dead lanes,
    or raise.  Returns ``{"closest": (max |t diff|, ms, plain ms),
    "anyhit": (...)}`` with median times over REPS runs."""
    import torch
    from rtjax_torch.kernels import persist as P
    out = {}
    args = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    hk, tk, pk, nk = P.persist_traverse_closest(*args)
    hp, tp, pp, np_ = P.persist_traverse_closest_ref(*args)
    torch.cuda.synchronize()
    hit_mis = int((hk != hp).sum())
    both = hk & hp
    t_mis = int((tk[both] != tp[both]).sum())
    # equal-t ties may pick another prim; the two walk one order, so none
    # are expected
    prim_mis = int((pk[both] != pp[both]).sum())
    nrm_mis = int(sum((a[both] != b[both]).sum() for a, b in zip(nk, np_)))
    dead = ~cl["active"]
    dead_ok = bool((~hk[dead]).all() and (tk[dead] == P.BIG).all()
                   and (pk[dead] == -1).all()
                   and all((c[dead] == 0).all() for c in nk))
    err = float((tk[both] - tp[both]).abs().max()) if bool(both.any()) \
        else 0.0
    rel = float(((tk[both] - tp[both]).abs() / tp[both].abs()).max()) \
        if bool(both.any()) else 0.0
    ms = _median_ms(lambda: P.persist_traverse_closest(*args))
    plain_ms = _median_ms(lambda: P.persist_traverse_closest_ref(*args))
    print(f"[{label} closest] {card}: {cl['tmax'].numel()} rays "
          f"({int(cl['active'].sum())} active) over {tab.width}-wide "
          f"tables, {int(hk.sum())} hits, hit mismatches {hit_mis}, t "
          f"mismatches {t_mis} (max rel diff {rel:.3g}), prim mismatches "
          f"{prim_mis}, normal mismatches {nrm_mis}, dead lanes ok "
          f"{dead_ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (median "
          f"of {REPS})")
    if hit_mis or t_mis or prim_mis or nrm_mis or not dead_ok \
            or int(hk.sum()) == 0:
        raise RuntimeError(f"{label}: closest-hit kernel disagrees with its "
                           "plain version")
    out["closest"] = (err, ms, plain_ms)

    args = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    ok_ = P.persist_traverse_anyhit(*args)
    op = P.persist_traverse_anyhit_ref(*args)
    torch.cuda.synchronize()
    occ_mis = int((ok_ != op).sum())
    dead_ok = bool((~ok_[~ah["active"]]).all())
    ms = _median_ms(lambda: P.persist_traverse_anyhit(*args))
    plain_ms = _median_ms(lambda: P.persist_traverse_anyhit_ref(*args))
    print(f"[{label} anyhit] {card}: {ah['tmax'].numel()} rays "
          f"({int(ah['active'].sum())} active) over {tab.width}-wide "
          f"tables, {int(ok_.sum())} occluded, occlusion mismatches "
          f"{occ_mis}, dead lanes ok {dead_ok}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (median of {REPS})")
    if occ_mis or not dead_ok or int(ok_.sum()) == 0:
        raise RuntimeError(f"{label}: any-hit kernel disagrees with its "
                           "plain version")
    out["anyhit"] = (float(occ_mis), ms, plain_ms)
    return out


def _check_group(label, tab, cl, ah, card):
    """Hold the packet and lane kernels against the plain group walk at
    their group sizes on ``tab`` with the rays of :func:`_check_persist`:
    zero hit, t, prim, normal and occlusion mismatches and correct dead
    lanes, or raise; hits and occlusion must also equal the persist
    kernels' (t and prim may differ at equal-t ties, which are counted).
    Returns ``{(walk, kind): (max |t diff|, ms, plain ms)}``: kernel
    medians over REPS runs, one timed plain call."""
    import torch
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    walks = {"packet": (WD.PACKET, WD.wide_traverse_closest,
                        WD.wide_traverse_anyhit),
             "lane": (L.LANE, L.lane_traverse_closest,
                      L.lane_traverse_anyhit)}
    cargs = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    aargs = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    ph, pt, pp, _ = P.persist_traverse_closest(*cargs)
    pocc = P.persist_traverse_anyhit(*aargs)
    dead = ~cl["active"]
    out = {}
    for walk, (group, closest, anyhit) in walks.items():
        hk, tk, pk, nk = closest(*cargs)
        (hp, tp, pp_, np_), plain_ms = _timed_ms(
            lambda: WD.group_traverse_closest_ref(*cargs, group))
        mis = {"hit": int((hk != hp).sum()), "t": int((tk != tp).sum()),
               "prim": int((pk != pp_).sum()),
               "normal": int(sum((a != b).sum() for a, b in zip(nk, np_)))}
        dead_ok = bool((~hk[dead]).all() and (tk[dead] == P.BIG).all()
                       and (pk[dead] == -1).all()
                       and all((c[dead] == 0).all() for c in nk))
        both = hk & ph
        vs_persist = {"hit": int((hk != ph).sum()),
                      "t": int((tk[both] != pt[both]).sum()),
                      "ties": int(((tk == pt) & (pk != pp))[both].sum())}
        err = float((tk[hk] - tp[hk]).abs().max()) if bool(hk.any()) \
            else 0.0
        ms = _median_ms(lambda: closest(*cargs))
        print(f"[{label} {walk} closest] {card}: group {group}, "
              f"{cl['tmax'].numel()} rays ({int(cl['active'].sum())} active) "
              f"over {tab.width}-wide tables, {int(hk.sum())} hits, "
              f"mismatches vs plain {mis}, dead lanes ok {dead_ok}; vs the "
              f"persist kernel: hit mismatches {vs_persist['hit']}, t "
              f"mismatches {vs_persist['t']}, equal-t ties with another "
              f"prim {vs_persist['ties']}; kernel {ms:.3f} ms (median of "
              f"{REPS}), plain {plain_ms:.3f} ms (one call)")
        if any(mis.values()) or not dead_ok or vs_persist["hit"] \
                or int(hk.sum()) == 0:
            raise RuntimeError(f"{label}: {walk} closest-hit kernel "
                               "disagrees with its plain version or the "
                               "persist kernel's hits")
        out[(walk, "closest")] = (err, ms, plain_ms)

        ok_ = anyhit(*aargs)
        op, plain_ms = _timed_ms(
            lambda: WD.group_traverse_anyhit_ref(*aargs, group))
        occ_mis = int((ok_ != op).sum())
        persist_mis = int((ok_ != pocc).sum())
        dead_ok = bool((~ok_[~ah["active"]]).all())
        ms = _median_ms(lambda: anyhit(*aargs))
        print(f"[{label} {walk} anyhit] {card}: group {group}, "
              f"{ah['tmax'].numel()} rays ({int(ah['active'].sum())} active),"
              f" {int(ok_.sum())} occluded, occlusion mismatches {occ_mis} "
              f"vs plain and {persist_mis} vs the persist kernel, dead "
              f"lanes ok {dead_ok}; kernel {ms:.3f} ms (median of {REPS}), "
              f"plain {plain_ms:.3f} ms (one call)")
        if occ_mis or persist_mis or not dead_ok or int(ok_.sum()) == 0:
            raise RuntimeError(f"{label}: {walk} any-hit kernel disagrees "
                               "with its plain version or the persist "
                               "kernel")
        out[(walk, "anyhit")] = (float(occ_mis), ms, plain_ms)
    return out


def phase3_kernels(scene, camera, card):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    out = _check_persist("kernel", scene.tables, cl, ah, card)
    persist = [dict(KERNELS[k], route="cuda", source=SOURCE,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms)
               for k, (err, ms, plain_ms) in out.items()]
    group = {k: dict(GROUP_KERNELS[k], route="cuda", source=GROUP_SOURCE,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms)
             for k, (err, ms, plain_ms) in
             _check_group("kernel", scene.tables, cl, ah, card).items()}
    return persist, group


def _u8_image(fb):
    import numpy as np
    from rtjax_torch.render.film import to_u8
    return to_u8(fb.cpu().numpy(), WIDTH, HEIGHT).astype(np.float64) / 255.0


def phase4_main_path(scene, camera, card):
    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.render.film import read_ppm, write_ppm
    from rtjax_torch.render.wavefront import render_frame

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                       max_bounces=BOUNCES)
    for k in P.LAUNCHES:
        P.LAUNCHES[k] = 0
        P.REF_CALLS[k] = 0
    runs = []
    for seed in (1, 2, 3):  # warm-up, then two timed runs
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb, stats = render_frame(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, stats))
    launches = dict(P.LAUNCHES)
    ref_calls = sum(P.REF_CALLS.values())

    secs = [r[0] for r in runs[1:]]
    stats = runs[1][2]
    mrays = stats["rays_traced"] / min(secs) / 1e6
    print(f"[main path] {card}: {WIDTH}x{HEIGHT} @ {SPP} spp, {BOUNCES} "
          f"bounces, pool {cfg.pool_size}: {stats['iterations']} iterations,"
          f" {stats['rays_traced']:.0f} rays traced, {secs[0]:.3f} s and "
          f"{secs[1]:.3f} s (warm-up {runs[0][0]:.3f} s), "
          f"{mrays:.3f} Mrays/s; launches {launches}, plain-version calls "
          f"{ref_calls}")
    if min(launches.values()) == 0 or ref_calls != 0:
        raise RuntimeError("the main path did not run through both kernels")

    fb = runs[1][1]
    if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
        raise RuntimeError("framebuffer has non-finite or negative values")
    img, img2 = _u8_image(fb), _u8_image(runs[2][1])
    ref = read_ppm(ARTIFACT).astype(np.float64) / 255.0
    seed_mse = float(np.mean((img - img2) ** 2))
    ref_mse = float(np.mean((img - ref) ** 2))
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    gate = 2.0 * seed_mse + quant
    out = _build.BUILD_DIR / "cornell_bunny_256_64spp.ppm"
    write_ppm(out, fb.cpu().numpy(), WIDTH, HEIGHT, binary=True)
    print(f"[image] vs {os.path.relpath(ARTIFACT, ROOT)}: mean |d| "
          f"{float(np.mean(np.abs(img - ref))):.5f}, MSE {ref_mse:.3e}; "
          f"seed-to-seed MSE {seed_mse:.3e}, gate {gate:.3e}; mean "
          f"{img.mean():.4f} vs {ref.mean():.4f}; written to {out}")
    if ref_mse > gate:
        raise RuntimeError("image differs from the rtjax render beyond the "
                           "noise floor")
    return launches, dict(ref=ref, seed_mse=seed_mse, gate=gate)


def phase4_walkers(scene, camera, card, floor):
    """The headline frame under each walker, alternated; returns the
    launch counts of the seed-2 packet and lane frames."""
    import dataclasses

    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                       max_bounces=BOUNCES)
    # each walker's (closest, any-hit) kernels
    want = {"persist": (("persist", "closest"), ("persist", "anyhit")),
            "packet": (("packet", "closest"), ("packet", "anyhit")),
            "lane": (("lane", "closest"), ("persist", "anyhit"))}
    imgs, counts = {}, {}
    for walker, seed in (("persist", 2), ("packet", 2), ("lane", 2),
                         ("lane", 3), ("packet", 3), ("persist", 3)):
        runs, c = _drive(scene, camera,
                         dataclasses.replace(cfg, **WALKERS[walker]), (seed,))
        secs, fb, st = runs[0]
        its = st["iterations"]
        expect = {(kernel, kind): 0 for kernel in _KERNEL_SETS
                  for kind in ("closest", "anyhit")}
        for key in want[walker]:
            expect[key] = its
        got = {(kernel, kind): c[kernel][kind] for kernel in _KERNEL_SETS
               for kind in ("closest", "anyhit")}
        print(f"[walkers {walker} seed {seed}] {card}: {WIDTH}x{HEIGHT} @ "
              f"{SPP} spp, {BOUNCES} bounces: {its} iterations, "
              f"{st['rays_traced']:.0f} rays traced, {secs:.3f} s, "
              f"{st['rays_traced'] / secs / 1e6:.3f} Mrays/s; launches "
              f"{ {k: v for k, v in c.items() if k != 'plain'} }, "
              f"plain-version calls {c['plain']}")
        if got != expect or c["plain"] != 0:
            raise RuntimeError(f"walker={walker!r} did not run exactly its "
                               "own kernels, once per iteration each")
        imgs[walker, seed] = _u8_image(fb)
        if seed == 2:
            counts[walker] = c
            write_ppm(_build.BUILD_DIR / f"headline_{walker}.ppm",
                      fb.cpu().numpy(), WIDTH, HEIGHT, binary=True)
    for walker in ("packet", "lane"):
        for seed in (2, 3):
            ref_mse = float(np.mean((imgs[walker, seed] - floor["ref"]) ** 2))
            tie_mse = float(np.mean((imgs[walker, seed]
                                     - imgs["persist", seed]) ** 2))
            print(f"[walkers image] {walker} seed {seed}: MSE vs "
                  f"{os.path.relpath(ARTIFACT, ROOT)} {ref_mse:.3e} (gate "
                  f"{floor['gate']:.3e}); vs persist seed {seed} "
                  f"{tie_mse:.3e} (gate {0.1 * floor['seed_mse']:.3e})")
            if ref_mse > floor["gate"] or tie_mse > 0.1 * floor["seed_mse"]:
                raise RuntimeError(f"walker={walker!r} image differs beyond "
                                   "its gate")
    return counts


def phase5_scene():
    from rtjax_torch.scenes import instanced_bunnies, instanced_bunnies_baked
    t0 = time.perf_counter()
    scene, camera = instanced_bunnies(device="cuda")
    secs = time.perf_counter() - t0
    blas, it = scene.blas[0], scene.inst_tables
    print(f"[config4 scene] {scene.instances.num} instances of "
          f"{blas.tris.num} triangles ({scene.instances.num * blas.tris.num}"
          f" effective) over {scene.tris.num} base triangles; BLAS "
          f"{blas.tables.num_wide_nodes} {blas.tables.width}-wide nodes, "
          f"{blas.tables.num_leaf_rows} leaf rows, "
          f"{blas.tables.nbytes / 2**20:.2f} MiB, depth {blas.tables.depth};"
          f" concatenated {it.wide.num_wide_nodes} nodes, "
          f"{it.wide.num_leaf_rows} leaf rows, "
          f"{it.wide.nbytes / 2**20:.2f} MiB, {it.num_instances} instance "
          f"records; built in {secs:.1f} s")
    t0 = time.perf_counter()
    baked, _ = instanced_bunnies_baked(device="cuda")
    tab = baked.tables
    print(f"[config4 baked scene] {baked.tris.num} triangles, "
          f"{tab.num_wide_nodes} {tab.width}-wide nodes, "
          f"{tab.num_leaf_rows} leaf rows, {tab.nbytes / 2**20:.2f} MiB, "
          f"depth {tab.depth}, built in {time.perf_counter() - t0:.1f} s")
    return scene, baked, camera


def _field_rays(scene, camera, gen):
    """2^17 closest-hit rays (half config-4 camera rays, half random rays
    over the instance field) and 2^18 shadow-like rays with random base
    exclusions, half of them toward the area light."""
    import torch
    from rtjax_torch.core import vec
    dev = torch.device("cuda")
    n = 1 << 17
    half = n // 2
    rnd = lambda *s: torch.rand(*s, generator=gen, device=dev)
    pix = torch.arange(half, device=dev) % (WIDTH * HEIGHT)
    x = ((pix % WIDTH).float() + rnd(half)) / WIDTH
    y = ((pix // WIDTH).float() + rnd(half)) / HEIGHT
    cam_o, cam_d = camera.get_rays_v3(x, y)

    def in_field(m):
        return (rnd(m) * 6.4 - 3.2, rnd(m) * 1.45 + 0.05, rnd(m) * 6.4 - 3.2)

    def random_dir(m):
        g = torch.randn(3, m, generator=gen, device=dev)
        return vec.normalize((g[0], g[1], g[2]))

    o2, d2 = in_field(half), random_dir(half)
    o = tuple(torch.cat([a, b]).contiguous() for a, b in zip(cam_o, o2))
    d = tuple(torch.cat([a, b]).contiguous() for a, b in zip(cam_d, d2))
    closest = dict(o=o, d=d, tmax=torch.full((n,), float("inf"), device=dev),
                   active=rnd(n) > 0.1)

    m = 2 * n
    so = in_field(m)
    light = (rnd(m // 2) * 2 - 1, torch.full((m // 2,), 3.0, device=dev),
             rnd(m // 2) * 2 - 1)
    target = tuple(torch.cat([a, b]) for a, b in zip(light, in_field(m // 2)))
    to = vec.sub(target, so)
    dist = vec.length(to)
    sd = tuple(c.contiguous() for c in vec.scale(1.0 / dist, to))
    ex = torch.randint(-1, scene.tris.num, (m,), generator=gen, device=dev,
                       dtype=torch.int32)
    anyhit = dict(o=tuple(c.contiguous() for c in so), d=sd, tmax=dist,
                  exclude=ex, active=rnd(m) > 0.1)
    return closest, anyhit


def phase5_inst_kernels(scene, camera, card):
    import torch
    from rtjax_torch.kernels import wide_inst as WI
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cl, ah = _field_rays(scene, camera, gen)
    it = scene.inst_tables
    results = []

    args = (it, cl["o"], cl["d"], cl["tmax"], cl["active"])
    hk, tk, pk, ik, nk = WI.wide_traverse_closest_inst(*args)
    hp, tp, pp, ip, np_ = WI.wide_traverse_closest_inst_ref(*args)
    torch.cuda.synchronize()
    mis = {"hit": int((hk != hp).sum()), "t": int((tk != tp).sum()),
           "prim": int((pk != pp).sum()), "inst": int((ik != ip).sum()),
           "normal": int(sum((a != b).sum() for a, b in zip(nk, np_)))}
    dead = ~cl["active"]
    dead_ok = bool((~hk[dead]).all() and (tk[dead] == WI.BIG).all()
                   and (pk[dead] == -1).all() and (ik[dead] == 0).all()
                   and all((c[dead] == 0).all() for c in nk))
    both = hk & hp
    err = float((tk[both] - tp[both]).abs().max()) if bool(both.any()) \
        else 0.0
    ms = _median_ms(lambda: WI.wide_traverse_closest_inst(*args))
    plain_ms = _median_ms(lambda: WI.wide_traverse_closest_inst_ref(*args))
    print(f"[kernel closest_inst] {card}: {cl['tmax'].numel()} rays, "
          f"{int(hk.sum())} hits ({int((ik > 0).sum())} on instances, "
          f"{int(ik.max())} the highest instance), mismatches {mis}, dead "
          f"lanes ok {dead_ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(median of {REPS})")
    if any(mis.values()) or not dead_ok or int((ik > 0).sum()) == 0:
        raise RuntimeError("two-level closest-hit kernel disagrees with its "
                           "plain version")
    results.append(dict(INST_KERNELS["closest"], route="cuda",
                        source=INST_SOURCE, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms))

    args = (it, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    ok_ = WI.wide_traverse_anyhit_inst(*args)
    op = WI.wide_traverse_anyhit_inst_ref(*args)
    torch.cuda.synchronize()
    occ_mis = int((ok_ != op).sum())
    dead_ok = bool((~ok_[~ah["active"]]).all())
    ms = _median_ms(lambda: WI.wide_traverse_anyhit_inst(*args))
    plain_ms = _median_ms(lambda: WI.wide_traverse_anyhit_inst_ref(*args))
    print(f"[kernel anyhit_inst] {card}: {ah['tmax'].numel()} rays, "
          f"{int(ok_.sum())} occluded, occlusion mismatches {occ_mis}, dead "
          f"lanes ok {dead_ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(median of {REPS})")
    if occ_mis or not dead_ok or int(ok_.sum()) == 0:
        raise RuntimeError("two-level any-hit kernel disagrees with its "
                           "plain version")
    results.append(dict(INST_KERNELS["anyhit"], route="cuda",
                        source=INST_SOURCE, max_abs_err=float(occ_mis),
                        ms=ms, plain_ms=plain_ms))
    return results


def _instance_frame(inst, rays):
    """``rays`` as the first repass pass hands them to the persist kernels:
    each ray moved into the frame of the nearest instance whose world box
    it meets, by that instance's world->local rows (the direction not
    renormalised), active only where it was active and meets a box, with
    no exclusion."""
    import torch
    from rtjax_torch.accel.instancing import (apply_affine_point,
                                              apply_affine_vector)
    from rtjax_torch.render.trace import _repass_setup
    ent, meets = _repass_setup(inst, list(range(inst.num)), rays["o"],
                               rays["d"])
    pick = torch.argmin(torch.where(meets, ent, 3.0e38), dim=0)
    rows = inst.inv[pick]
    out = dict(rays, o=tuple(c.contiguous()
                             for c in apply_affine_point(rows, rays["o"])),
               d=tuple(c.contiguous()
                       for c in apply_affine_vector(rows, rays["d"])),
               active=rays["active"] & meets.any(0))
    if "exclude" in rays:
        out["exclude"] = torch.full_like(rays["exclude"], -1)
    return out


def phase5_persist(scene, baked, camera, card):
    """The persist, packet and lane kernels at the two other shapes config
    4 gives them: the baked scene's tables, and the shared BLAS under
    repass.  Returns the group checks' results, as :func:`_check_group`
    does, per shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5678)
    cl, ah = _field_rays(baked, camera, gen)
    _check_persist("config4 baked persist", baked.tables, cl, ah, card)
    group = [_check_group("config4 baked", baked.tables, cl, ah, card)]
    if set(scene.instances.mesh_id) != {0}:
        raise RuntimeError("config 4 should place one BLAS")
    cl, ah = _field_rays(scene, camera, gen)
    cl = _instance_frame(scene.instances, cl)
    ah = _instance_frame(scene.instances, ah)
    _check_persist("config4 blas persist", scene.blas[0].tables, cl, ah,
                   card)
    group.append(_check_group("config4 blas", scene.blas[0].tables, cl, ah,
                              card))
    return group


_KERNEL_SETS = ("persist", "two_level", "packet", "lane")


def _counters():
    """``{set: (LAUNCHES, REF_CALLS or None)}`` of every kernel module."""
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.kernels import wide_inst as WI
    return {"persist": (P.LAUNCHES, P.REF_CALLS),
            "two_level": (WI.LAUNCHES, WI.REF_CALLS),
            "packet": (WD.LAUNCHES, WD.REF_CALLS),
            "lane": (L.LAUNCHES, None)}


def _drive(scene, camera, cfg, seeds):
    """Render one frame per seed with every launch count read from zero:
    ``([(seconds, framebuffer, stats), ...], counts)``; counts hold each
    kernel set's launches and ``plain``, the plain-version calls."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    counters = _counters()
    for launches, refs in counters.values():
        for c in (launches, refs):
            for k in c or ():
                c[k] = 0
    runs = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb, stats = render_frame(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, stats))
        if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
            raise RuntimeError("framebuffer has non-finite or negative "
                               "values")
    counts = {name: dict(launches) for name, (launches, _) in
              counters.items()}
    counts["plain"] = sum(sum(refs.values()) for _, refs in
                          counters.values() if refs is not None)
    return runs, counts


def _only(counts, kernel_set):
    """True when ``kernel_set`` launched both its kernels and no other set
    launched any."""
    return min(counts[kernel_set].values()) > 0 and not any(
        v for name in _KERNEL_SETS if name != kernel_set
        for v in counts[name].values())


def phase6_config4(scene, baked, camera, card):
    import dataclasses

    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=C4_SPP,
                       max_bounces=C4_BOUNCES)

    def report(label, runs, counts):
        for secs, _, st in runs:
            print(f"[config4 {label}] {card}: {WIDTH}x{HEIGHT} @ {C4_SPP} "
                  f"spp, {C4_BOUNCES} bounces, pool {cfg.pool_size}: "
                  f"{st['iterations']} iterations, {st['rays_traced']:.0f} "
                  f"rays traced, {secs:.3f} s, "
                  f"{st['rays_traced'] / secs / 1e6:.3f} Mrays/s")
        print(f"[config4 {label}] launches {counts}")

    def require(ok, what):
        if not ok:
            raise RuntimeError(what)

    a_runs, a = _drive(scene, camera, cfg, (1, 2, 3))
    report("a: two_level=auto (repass), seeds 1 (warm-up), 2, 3", a_runs, a)
    its = sum(r[2]["iterations"] for r in a_runs)
    print(f"[config4 a] repass passes per iteration: closest "
          f"{a['persist']['closest'] / its - 1:.2f}, any-hit "
          f"{a['persist']['anyhit'] / its - 1:.2f} (beyond the base launch)")
    require(_only(a, "persist") and a["plain"] == 0,
            "repass did not run through the persist kernels alone")

    b_runs, b = _drive(scene, camera,
                       dataclasses.replace(cfg, two_level="kernel"), (2,))
    report("b: two_level=kernel, seed 2", b_runs, b)
    require(_only(b, "two_level") and b["plain"] == 0,
            "two_level='kernel' did not run through the two-level kernels "
            "alone")

    c_runs, c = _drive(baked, camera, cfg, (2,))
    report("c: baked single-level, seed 2", c_runs, c)
    require(_only(c, "persist") and c["plain"] == 0,
            "the baked scene did not run through the persist kernels")

    d_runs, d = _drive(scene, camera,
                       dataclasses.replace(cfg, **WALKERS["packet"]), (2,))
    report("d: repass, walker=packet, seed 2", d_runs, d)
    require(_only(d, "packet") and d["plain"] == 0,
            "repass under walker='packet' did not run through the packet "
            "kernels alone")

    img_a2, img_a3 = _u8_image(a_runs[1][1]), _u8_image(a_runs[2][1])
    img_b, img_c = _u8_image(b_runs[0][1]), _u8_image(c_runs[0][1])
    img_d = _u8_image(d_runs[0][1])
    packet_mse = float(np.mean((img_a2 - img_d) ** 2))
    seed_mse = float(np.mean((img_a2 - img_a3) ** 2))
    kb_mse = float(np.mean((img_a2 - img_b) ** 2))
    baked_mse = float(np.mean((img_a2 - img_c) ** 2))
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    names = {"a_seed2": a_runs[1][1], "a_seed3": a_runs[2][1],
             "b_kernel": b_runs[0][1], "c_baked": c_runs[0][1],
             "d_packet": d_runs[0][1]}
    for name, fb in names.items():
        write_ppm(_build.BUILD_DIR / f"config4_{name}.ppm", fb.cpu().numpy(),
                  WIDTH, HEIGHT, binary=True)
    print(f"[config4 image] seed-to-seed MSE {seed_mse:.3e}; kernel vs "
          f"repass MSE {kb_mse:.3e}, packet repass vs repass MSE "
          f"{packet_mse:.3e} (gate {0.1 * seed_mse:.3e}); baked vs "
          f"instanced MSE {baked_mse:.3e} (gate "
          f"{2.0 * seed_mse + quant:.3e}); means {img_a2.mean():.4f} "
          f"{img_b.mean():.4f} {img_c.mean():.4f} {img_d.mean():.4f}; "
          f"written to "
          f"{_build.BUILD_DIR}/config4_*.ppm")
    require(seed_mse > 0.0, "two seeds rendered the same image")
    require(kb_mse <= 0.1 * seed_mse,
            "two_level='kernel' and repass images differ beyond ties")
    require(packet_mse <= 0.1 * seed_mse,
            "repass under the packet walker differs from repass over the "
            "persist walkers beyond ties")
    require(baked_mse <= 2.0 * seed_mse + quant,
            "the instanced image differs from the baked one beyond the "
            "noise floor")
    return b["two_level"]


def main():
    card = phase0_device()
    import torch
    phase1_build()
    scene, camera = phase2_scene()
    kernels, group = phase3_kernels(scene, camera, card)
    launches, floor = phase4_main_path(scene, camera, card)
    for k in kernels:
        k["launches"] = launches["closest" if "closest" in k["name"]
                                 else "anyhit"]
    walker_counts = phase4_walkers(scene, camera, card, floor)
    for (walk, kind), k in group.items():
        k["launches"] = walker_counts[walk][walk][kind]
    group["lane", "anyhit"]["note"] = ("on no engine path: anyhit_walker "
                                       "takes persist or packet, as in rtjax")
    c4_scene, baked, c4_camera = phase5_scene()
    inst_kernels = phase5_inst_kernels(c4_scene, c4_camera, card)
    for shape in phase5_persist(c4_scene, baked, c4_camera, card):
        for key, (err, _, _) in shape.items():
            group[key]["max_abs_err"] = max(group[key]["max_abs_err"], err)
    inst_launches = phase6_config4(c4_scene, baked, c4_camera, card)
    for k in inst_kernels:
        k["launches"] = inst_launches["closest" if "closest" in k["name"]
                                      else "anyhit"]
    print(json.dumps({"kernels": kernels + list(group.values())
                      + inst_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
