#!/usr/bin/env python3
"""GPU smoke run of rtjax_torch, the PyTorch + CUDA port of rtjax.

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises and
the script exits non-zero):

0. device: require CUDA; print the card's name and power limit, and the
   torch and CUDA versions;
1. build: the BVH builder and the traversal kernels from this checkout's
   sources, into build/rtjax_torch/;
2. scene: the bunny Cornell box (69,463 triangles) on the card;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes (2^18 closest-hit rays, 2^19 any-hit rays):
   zero hit/occlusion mismatches and equal t/prim/normal, plus median
   times over 5 runs;
4. main path: render_frame of the headline frame (256x256 at 64 spp, 10
   bounces, default RenderConfig): one warm-up and two timed runs; both
   kernels must have launched and no plain version may have run; the image
   must be finite and non-negative and agree with the rtjax render in
   artifacts/ at the noise floor (MSE <= 2x the port's own seed-to-seed MSE
   plus the 8-bit quantisation term).

The last two lines of standard output are a JSON object with per-kernel
numbers and then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH = HEIGHT = 256
SPP = 64
BOUNCES = 10
ARTIFACT = os.path.join(ROOT, "artifacts", "cornell_bunny_256_64spp.ppm")
REPS = 5

KERNELS = {
    "closest": dict(name="persist_traverse_closest",
                    replaces="rtjax/kernels/pallas_lane_persist.py:526"),
    "anyhit": dict(name="persist_traverse_anyhit",
                   replaces="rtjax/kernels/pallas_lane_persist.py:600"),
}
SOURCE = "rtjax_torch/csrc/persist_traverse.cu"


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
    t0 = time.perf_counter()
    _build.bvh_library()
    t1 = time.perf_counter()
    _build.persist_library()
    t2 = time.perf_counter()
    print(f"[build] bvh builder {t1 - t0:.1f} s, traversal kernels "
          f"{t2 - t1:.1f} s, into {_build.BUILD_DIR}")


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


def phase3_kernels(scene, camera, card):
    import torch
    from rtjax_torch.kernels import persist as P
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    tab = scene.tables
    results = []

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
    print(f"[kernel closest] {card}: {cl['tmax'].numel()} rays, "
          f"{int(hk.sum())} hits, hit mismatches {hit_mis}, t mismatches "
          f"{t_mis} (max rel diff {rel:.3g}), prim mismatches {prim_mis}, "
          f"normal mismatches {nrm_mis}, dead lanes ok {dead_ok}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms (median of {REPS})")
    if hit_mis or t_mis or prim_mis or nrm_mis or not dead_ok:
        raise RuntimeError("closest-hit kernel disagrees with its plain "
                           "version")
    results.append(dict(KERNELS["closest"], route="cuda", source=SOURCE,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))

    args = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    ok_ = P.persist_traverse_anyhit(*args)
    op = P.persist_traverse_anyhit_ref(*args)
    torch.cuda.synchronize()
    occ_mis = int((ok_ != op).sum())
    dead_ok = bool((~ok_[~ah["active"]]).all())
    ms = _median_ms(lambda: P.persist_traverse_anyhit(*args))
    plain_ms = _median_ms(lambda: P.persist_traverse_anyhit_ref(*args))
    print(f"[kernel anyhit] {card}: {ah['tmax'].numel()} rays, "
          f"{int(ok_.sum())} occluded, occlusion mismatches {occ_mis}, dead "
          f"lanes ok {dead_ok}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(median of {REPS})")
    if occ_mis or not dead_ok:
        raise RuntimeError("any-hit kernel disagrees with its plain version")
    results.append(dict(KERNELS["anyhit"], route="cuda", source=SOURCE,
                        max_abs_err=float(occ_mis), ms=ms,
                        plain_ms=plain_ms))
    return results


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
    return launches


def main():
    card = phase0_device()
    import torch
    phase1_build()
    scene, camera = phase2_scene()
    kernels = phase3_kernels(scene, camera, card)
    launches = phase4_main_path(scene, camera, card)
    for k in kernels:
        k["launches"] = launches["closest" if "closest" in k["name"]
                                 else "anyhit"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
