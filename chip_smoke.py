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
   started together; ptxas's registers, stack frame and spills of the
   persist, two-level, packet and lane kernels (both designs, widths 8
   and 16, the two-level fetch kernels with the instance records staged
   or global);
2. scene: the bunny Cornell box (69,463 triangles) on the card;
3. kernels: each persistent-walker kernel, in the fetch design that the
   engine runs and in the first (stride) design, against its plain PyTorch
   version on the card at the main path's shapes (2^18 closest-hit rays,
   2^19 any-hit rays): zero hit/occlusion mismatches, equal
   t/prim/normal, correct dead lanes; the two designs' device times in
   turns (stride, fetch, fetch, stride; 5 launches each, queued behind a
   spin kernel and timed by CUDA events between them),
   one call's time in CUDA events, the plain version's; the plain walk's
   work count and the kernel's bound; then the packet and lane kernels
   against the plain group walk on the same rays: zero hit, t, prim,
   normal and occlusion mismatches, correct dead lanes, hits, t and
   occlusion equal to the persist kernels' (the equal-t ties, where the
   two walks may keep another prim, are counted), device and call times,
   one timed plain call, and the persist walk's bound on the same rays;
   each one's first design (the packet kernels' leader design, the lane
   kernels' group design) held to the persist kernels' hits and
   occlusion and timed in turns with the new design (first, new, new,
   first), and the plain group walk's own work count and bound beside the
   persist walk's;
4. main path: render_frame of the headline frame (256x256 at 64 spp, 10
   bounces, default RenderConfig): one warm-up and two timed runs; both
   kernels must have launched, and no plain version and no stride-design
   kernel may have run; the image must be finite and non-negative and
   agree with the rtjax render in artifacts/ at the noise floor (MSE <= 2x
   the port's own seed-to-seed MSE plus the 8-bit quantisation term).  The
   warm-up frame keeps the rays of launch 38 of each persist kernel
   (render/trace.py's names rebound for that frame), and phase 3's check,
   A/B and bound run again on them.  Then the same frame under each walker,
   alternated
   (persist, packet, lane, lane, packet, persist; seeds 2, 2, 2, 3, 3, 3;
   walker="packet" with anyhit_walker="packet"), launch counts read from
   zero per frame: exactly one launch per iteration of the walker's own
   closest-hit and any-hit kernels and no other, no plain version, each
   image at the noise-floor gate and within 0.1x the seed-to-seed MSE of
   the persist image of its seed.  The seed-2 packet frame keeps the rays
   of launch 38 of each packet kernel, the seed-2 lane frame those of
   launch 38 of its lane closest-hit and persist any-hit kernels, and
   phase 3's packet and lane checks, A/Bs and bounds run again on them;
5. two-level kernels: eval config 4 (16 instanced bunnies, 1.11M effective
   triangles) built on the card; each two-level kernel, in the fetch
   design that the engine runs and in the first (stride) design, against
   its plain version at the config's shapes (2^17 closest-hit rays: half
   camera rays, half random rays over the instance field, 10% inactive;
   2^18 any-hit rays with random exclusions): zero hit, t, prim, inst,
   normal and occlusion mismatches, correct dead lanes, both designs'
   device times in turns as in phase 3, one call's time, the plain
   version's, the two-level plain walk's work count and the bound; the
   same on the same kind of rays over MANY_INST instances of the bunny
   (the share of the instance rescan);
   then the persist (both designs), packet and lane kernels against their
   plain versions, as in phase 3, at the two other shapes config 4 gives
   them: the baked
   scene's tables (the same placements in one single-level scene, 1.11M
   triangles; 2^17 / 2^18 rays) and the shared BLAS with the rays of
   repass's first pass (each ray in the frame of the nearest instance box
   it meets, active only where it meets one, no exclusion);
6. config 4 end to end (256x256 at 8 spp, 5 bounces, default
   RenderConfig): (a) two_level="auto" (repass over the persist kernels)
   with seeds 1 (warm-up), 2 and 3; (b) two_level="kernel" (the two-level
   kernels) with seed 2, keeping the rays of launch C4_CAPTURE_AT of each
   two-level kernel, on which phase 5's check, A/B and bound run again
   after this phase; (c) the same bunnies baked into one single-level
   scene, seed 2; (d) repass under walker="packet" and
   anyhit_walker="packet", seed 2.  Each run's launch counts are read from
   zero: (a) and (c) launch only the persist kernels, (b) only the
   two-level ones in the fetch design, (d) only the packet ones, and no
   plain version or stride-design kernel runs.
   Frames are finite and non-negative; MSE((a), (b)) and MSE((a), (d)) <=
   0.1x and MSE((a), (c)) <= 2x the seed-to-seed MSE of (a) (plus the
   quantisation term for (c)).  Images go to build/rtjax_torch/;
7. the two persist kernels' device time over one whole headline frame,
   the two packet kernels' over one walker="packet" headline frame, the
   lane closest-hit kernel's over one walker="lane" headline frame (its
   any hit the persist kernel's), then the two two-level kernels' over
   one config-4 two_level="kernel" frame
   (torch.profiler; every launch of the frame must be recorded, or the
   frame is profiled again, once) under each design, first design, new,
   new, first (render/trace.py's names rebound to the first design for its
   frames).

A ``[time]`` line after each phase gives the seconds since the start.

A kernel's bound is the least time the card could take for its work:
the larger of the bytes it must move (every ray's active flag and results,
the other inputs of the active rays, and of the tables what the plain
walk needs: the child boxes, metas and info word of every node it visited
and the real triangles and prim ids of every leaf row it tested, each
once; ``persist.work_table_bytes``) over 3.35 TB/s and its float operations (the plain walk's counted slab and
triangle tests, OPS_* each) over 67 TFLOP/s.  Rows 1-4 and 7-8 take the
persist walk's count on their rays, rows 5-6 the two-level walk's; rows
3-4 and 7-8 also carry the share of the group walk's own bound
(``group_share``), which counts the nodes and leaves every ray of a group
pays for.

The last two lines of standard output are a JSON object with per-kernel
numbers and then ``{"ok": true, "device": {...}}``.  ``ms`` is a kernel's
device time per launch, the mean of ``timed_launches`` launches queued
back to back (:func:`_launch_ms`), ``call_ms`` one call in CUDA events,
host launch included, as earlier runs reported it.  ``launches`` is each
kernel's count in its main-path run: phase 4's three frames for the
persist kernels, its packet and lane frames (seed 2) for those kernels,
6(b) for the two-level ones.  lane_traverse_anyhit is on no engine path
(rtjax's ``anyhit_walker`` takes "persist" or "packet" only), so its count
is 0.  Every row also carries ``ab``: both designs on each ray set
(persist, packet and lane: phase 3, the in-frame launch, config 4's baked
tables and BLAS; two-level: config 4's field rays, MANY_INST instances,
6(b)'s in-frame launch), and all but lane any hit ``frame_ms``: the
kernel's device time over a whole frame under each design.
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
# phase 4 keeps the rays of this launch of each persist kernel (of the
# warm-up frame's 77)
CAPTURE_AT = 38

# A launch's bound (the least time the card could take for its work): the
# larger of the bytes it must move over the memory rate and its float
# operations over the float32 rate outside the tensor cores (NVIDIA H100 SXM
# data sheet).  Bytes: every ray's active flag and results, the other
# inputs of the active rays, and the table bytes the plain walk needs,
# once each (persist.work_table_bytes).  Operations: the plain walk's counted tests (persist.new_work)
# times the float operations of one test, counted from csrc/wide_walk.cuh
# and csrc/wide_inst_traverse.cu.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
OPS_SLAB = 25   # a box slab test: 6 mul, 6 add, 10 min/max, 3 to accept
OPS_TRI = 42    # a Moeller-Trumbore test: 3 sub, 9 cross, 6 det, 3 x 6
                # (u, v, t), 6 to accept
OPS_INST = 51   # a ray into an instance's frame: 33 affine, 18 slab setup
RAY_IN = 28     # bytes of an active ray: origin, direction, tmax
EXCLUDE = 4     # any hit: the excluded prim
CLOSEST_OUT = 21  # hit, t, prim, normal
INST_OUT = 25     # the two-level closest hit adds inst
AFF_RECORD = 76   # per instance: the root and 18 affine floats

# config 4 (benchmarks/run_configs.py:198-226)
C4_SPP = 8
C4_BOUNCES = 5
# phase 6(b) keeps the rays of this launch of each two-level kernel (of the
# frame's 13)
C4_CAPTURE_AT = 7
# instances of the many-instance set of phase 5 (config 4's bunny, field)
MANY_INST = 64

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
GROUP_SOURCES = {"packet": "rtjax_torch/csrc/packet_traverse.cu",
                 "lane": "rtjax_torch/csrc/lane_walk.cuh"}
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
    for lib in (_build.persist_library(), _build.wide_inst_library()):
        for name, res in _build.ptxas_report(lib):
            print(f"[ptxas] {_kernel_label(name)}: {res}")
    for name, res in _build.ptxas_report(_build.packet_library()):
        print(f"[ptxas] {_group_label(name)}: {res}")


def _kernel_label(mangled):
    """"persist fetch closest, width 16" for a persist or two-level
    kernel's mangled name."""
    import re
    m = re.search(r"(fetch_kernel|stride_closest_kernel|stride_anyhit_kernel"
                  r"|inst_fetch|stride_closest|stride_anyhit)"
                  r"ILi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?", mangled)
    if m is None:
        return mangled
    kernels = "two-level" if "Insts" in mangled else "persist"
    design = "fetch" if "fetch" in m[1] else "stride"
    anyhit = m[3] == "1" if design == "fetch" else "anyhit" in m[1]
    label = (f"{kernels} {design} {'any-hit' if anyhit else 'closest'}, "
             f"width {m[2]}")
    if m[4] is not None:
        label += ", records " + ("staged" if m[4] == "1" else "global")
    return label


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


# the spin that holds the stream while the host queues the timed calls
# (torch.cuda._sleep cycles: ~34 ms at the H100's 1.98 GHz)
SPIN_CYCLES = 1 << 26


def _launch_ms(fn, reps=REPS):
    """``(mean, least, most)`` device time (ms) of one call of ``fn``, over
    ``reps`` calls after one warm-up.  The calls are queued behind a spin
    kernel (``torch.cuda._sleep``) with a CUDA event before and after each,
    so the events time the card's work back to back, each call's own
    launch, and not the host's launch, which is most of a short kernel's
    time in CUDA events around one synchronised call (:func:`_median_ms`).
    The stream must still be busy with the spin when the last event is
    queued; if it is not, the spin is lengthened and the timing made again,
    and after three tries the check fails.  Every call of ``fn`` must
    launch one kernel and nothing else."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(cycles)
        ev[0].record()
        for e in ev[1:]:
            fn()
            e.record()
        held = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        if held:
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            return statistics.mean(ms), min(ms), max(ms)
        cycles *= 4
    raise RuntimeError("the host queued the timed calls for longer than "
                       "the spin held the stream, three times")


def _device_ms(fn, reps=REPS):
    """Mean device time (ms) of one launch of ``fn``'s kernel, over
    ``reps`` launches (:func:`_launch_ms`)."""
    return _launch_ms(fn, reps)[0]


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


def _ab_ms(new, old):
    """The fetch design (``new``) against the stride design (``old``) in
    turns, old, new, new, old, each the device time of REPS calls
    (:func:`_device_ms`): ``([new, new], [old, old])``."""
    o1 = _device_ms(old)
    n1 = _device_ms(new)
    n2 = _device_ms(new)
    o2 = _device_ms(old)
    return [n1, n2], [o1, o2]


def _bound(work, n, n_active, in_bytes, out_bytes, tables, extra_bytes=0):
    """``{bound_ms, bound_us, bound_by, ops, bytes, table_bytes}`` of a launch of ``n`` rays
    (``n_active`` active) over ``tables`` from the plain walk's ``work``
    on them."""
    from rtjax_torch.kernels import persist as P
    ops = (OPS_SLAB * (work["slab_tests"] + work.get("inst_tests", 0))
           + OPS_TRI * work["tri_slots"]
           + OPS_INST * work.get("inst_visits", 0))
    table_bytes = P.work_table_bytes(work, tables)
    nbytes = n * (1 + out_bytes) + n_active * in_bytes + table_bytes \
        + extra_bytes
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_us=max(t_ops, t_bytes)
                * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, bytes=nbytes, table_bytes=table_bytes)


def _work_text(work, b):
    """One line's account of a counted walk and its bound."""
    return (f"work: {work['node_visits']} node visits, {work['slab_tests']} "
            f"slab tests, {work['leaf_rows']} leaf rows, {work['tri_slots']} "
            f"triangle slots"
            + (f", {work['inst_tests']} instance box tests, "
               f"{work['inst_visits']} instance visits"
               if "inst_tests" in work else "")
            + f", {int(work['node_seen'].sum())} node and "
            f"{int(work['leaf_seen'].sum())} leaf rows read "
            f"({b['table_bytes']} B of them needed); bound "
            f"{b['bound_us']:.3f} us by {b['bound_by']} ({b['bytes']} B at "
            f"{PEAK_BYTES / 1e12} TB/s, {b['ops']} float ops at "
            f"{PEAK_FLOPS / 1e12} TFLOP/s)")


def _test_rays(scene, camera, gen, n=1 << 18):
    """``n`` closest-hit rays (half headline camera rays, half random rays
    inside the box) and ``2 n`` shadow-like rays with random ``exclude``,
    on ``gen``'s device."""
    import torch
    from rtjax_torch.core import vec
    dev = gen.device
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
    """Hold both persist kernels, in the fetch design and in the first
    (stride) design, against their plain versions on ``tab`` with the
    closest-hit rays ``cl`` and the any-hit rays ``ah``: zero hit/occlusion
    mismatches, equal t/prim/normal and correct dead lanes, or raise.  Time
    the two designs in turns (:func:`_ab_ms`) and the plain version
    (median of REPS), count the plain walk's work and give each kernel its
    bound.  Returns ``{"closest": {...}, "anyhit": {...}}``: max |t diff|,
    the fetch design's ms (mean of its two medians), the stride design's,
    the plain ms, both designs' medians and the bound."""
    import torch
    from rtjax_torch.kernels import persist as P
    out = {}
    args = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    work = P.new_work()
    hp, tp, pp, np_ = P.persist_traverse_closest_ref(*args, work=work)
    dead = ~cl["active"]
    mis = {}
    for design, fn in (("fetch", P.persist_traverse_closest),
                       ("stride", P.persist_traverse_closest_stride)):
        hk, tk, pk, nk = fn(*args)
        torch.cuda.synchronize()
        both = hk & hp
        # equal-t ties may pick another prim; the two walk one order, so
        # none are expected
        mis[design] = {
            "hit": int((hk != hp).sum()), "t": int((tk[both] != tp[both])
                                                   .sum()),
            "prim": int((pk[both] != pp[both]).sum()),
            "normal": int(sum((a[both] != b[both]).sum()
                              for a, b in zip(nk, np_))),
            "dead": int(not ((~hk[dead]).all() and (tk[dead] == P.BIG).all()
                             and (pk[dead] == -1).all()
                             and all((c[dead] == 0).all() for c in nk)))}
        if design == "fetch":
            err = float((tk[both] - tp[both]).abs().max()) \
                if bool(both.any()) else 0.0
            hits = int(hk.sum())
    new, old = _ab_ms(lambda: P.persist_traverse_closest(*args),
                      lambda: P.persist_traverse_closest_stride(*args))
    call_ms = _median_ms(lambda: P.persist_traverse_closest(*args))
    plain_ms = _median_ms(lambda: P.persist_traverse_closest_ref(*args))
    n, n_act = cl["tmax"].numel(), int(cl["active"].sum())
    b = _bound(work, n, n_act, RAY_IN, CLOSEST_OUT, tab)
    out["closest"] = _ab_result(err, new, old, call_ms, plain_ms, b)
    print(f"[{label} closest] {card}: {n} rays ({n_act} active) over "
          f"{tab.width}-wide tables, {hits} hits; mismatches vs plain "
          f"(hit, t, prim, normal, dead lanes): fetch {mis['fetch']}, "
          f"stride {mis['stride']}; " + _ab_text(out["closest"])
          + f"; {_work_text(work, b)}")
    if any(v for m in mis.values() for v in m.values()) or hits == 0:
        raise RuntimeError(f"{label}: closest-hit kernel disagrees with its "
                           "plain version")

    args = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    work = P.new_work()
    op = P.persist_traverse_anyhit_ref(*args, work=work)
    mis = {}
    for design, fn in (("fetch", P.persist_traverse_anyhit),
                       ("stride", P.persist_traverse_anyhit_stride)):
        ok_ = fn(*args)
        torch.cuda.synchronize()
        mis[design] = {"occlusion": int((ok_ != op).sum()),
                       "dead": int(bool(ok_[~ah["active"]].any()))}
        if design == "fetch":
            occluded = int(ok_.sum())
    new, old = _ab_ms(lambda: P.persist_traverse_anyhit(*args),
                      lambda: P.persist_traverse_anyhit_stride(*args))
    call_ms = _median_ms(lambda: P.persist_traverse_anyhit(*args))
    plain_ms = _median_ms(lambda: P.persist_traverse_anyhit_ref(*args))
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _bound(work, n, n_act, RAY_IN + EXCLUDE, 1, tab)
    out["anyhit"] = _ab_result(float(mis["fetch"]["occlusion"]), new, old,
                               call_ms, plain_ms, b)
    print(f"[{label} anyhit] {card}: {n} rays ({n_act} active) over "
          f"{tab.width}-wide tables, {occluded} occluded; mismatches vs "
          f"plain (occlusion, dead lanes): fetch {mis['fetch']}, stride "
          f"{mis['stride']}; " + _ab_text(out["anyhit"])
          + f"; {_work_text(work, b)}")
    if any(v for m in mis.values() for v in m.values()) or occluded == 0:
        raise RuntimeError(f"{label}: any-hit kernel disagrees with its "
                           "plain version")
    return out


def _ab_result(err, new, old, call_ms, plain_ms, b):
    ms, stride_ms = statistics.mean(new), statistics.mean(old)
    return dict(max_abs_err=err, ms=ms, stride_ms=stride_ms,
                call_ms=call_ms, plain_ms=plain_ms, fetch_device_ms=new,
                stride_device_ms=old, speedup=stride_ms / ms,
                share=b["bound_ms"] / ms,
                stride_share=b["bound_ms"] / stride_ms, **b)


def _ab_text(r):
    return (f"device time (mean of {REPS} queued launches, in "
            f"turns stride, fetch, fetch, stride): fetch "
            f"{r['fetch_device_ms'][0]:.4f} / {r['fetch_device_ms'][1]:.4f}"
            f" ms, stride {r['stride_device_ms'][0]:.4f} / "
            f"{r['stride_device_ms'][1]:.4f} ms, fetch {r['speedup']:.2f}x "
            f"faster; one fetch call {r['call_ms']:.4f} ms (CUDA events, "
            f"median of {REPS}); plain {r['plain_ms']:.3f} ms; share of the "
            f"bound: fetch {100 * r['share']:.2f}%, stride "
            f"{100 * r['stride_share']:.2f}%")


# each group walk's (group size, new design's wrappers, first design's
# wrappers, the two designs' names); both new designs decide first
def _group_walks():
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import wide as WD
    return {"packet": (WD.PACKET, WD.wide_traverse_closest,
                       WD.wide_traverse_anyhit,
                       WD.wide_traverse_closest_leader,
                       WD.wide_traverse_anyhit_leader, ("packet", "leader")),
            "lane": (L.LANE, L.lane_traverse_closest,
                     L.lane_traverse_anyhit, L.lane_traverse_closest_group,
                     L.lane_traverse_anyhit_group, ("lane", "lane_group"))}


def _check_group(label, tab, cl, ah, card, bounds, walks=("packet", "lane")):
    """Hold the packet and lane kernels, each in its new design and its
    first design, against the plain group walk at their group sizes on
    ``tab`` with the closest-hit rays ``cl`` and the any-hit rays ``ah``:
    the new design bit for bit (zero hit, t, prim, normal and occlusion
    mismatches, correct dead lanes) and with hits, t and occlusion equal to
    the persist kernels' (the prim may differ at equal-t ties, which are
    counted); the first design (the packet kernels' leader design, the lane
    kernels' group design) against the persist kernels' hits, t and
    occlusion; or raise.  The two designs are timed in turns (first, new,
    new, first) and each gets its share of the persist walk's bound
    (``bounds``, by kind, from :func:`_bound`) and of the group walk's own
    (its work counted).  ``walks`` picks "packet" and / or "lane".  Returns
    ``{(walk, kind): {...}}``: max |t diff| or the occlusion mismatches,
    device ms (the mean of the A/B's new-design times), one call in CUDA
    events (median of REPS), one timed plain call, and the A/B record
    (:func:`_group_ab`)."""
    import torch
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    cargs = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    aargs = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    ph, pt, pp, _ = P.persist_traverse_closest(*cargs)
    pocc = P.persist_traverse_anyhit(*aargs)
    dead = ~cl["active"]
    out = {}
    for walk in walks:
        group, closest, anyhit, old_closest, old_anyhit, names = \
            _group_walks()[walk]
        work = {"closest": P.new_work(), "anyhit": P.new_work()}
        hk, tk, pk, nk = closest(*cargs)
        (hp, tp, pp_, np_), plain_ms = _timed_ms(
            lambda: WD.group_traverse_closest_ref(*cargs, group,
                                                  work=work["closest"]))
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
        oh, ot, op_, _ = old_closest(*cargs)
        old = {"hit": int((oh != ph).sum()),
               "t": int((ot[both] != pt[both]).sum()),
               "ties": int(((ot == pt) & (op_ != pp))[both].sum())}
        r = {"err": err, "plain_ms": plain_ms,
             "call_ms": _median_ms(lambda: closest(*cargs))}
        r.update(_group_ab(lambda: closest(*cargs),
                           lambda: old_closest(*cargs), bounds["closest"],
                           work["closest"], cl, tab, CLOSEST_OUT, RAY_IN,
                           names))
        print(f"[{label} {walk} closest] {card}: group {group}, "
              f"{cl['tmax'].numel()} rays ({int(cl['active'].sum())} active) "
              f"over {tab.width}-wide tables, {int(hk.sum())} hits, "
              f"mismatches vs plain {mis}, dead lanes ok {dead_ok}; vs the "
              f"persist kernel: hit mismatches {vs_persist['hit']}, t "
              f"mismatches {vs_persist['t']}, equal-t ties with another "
              f"prim {vs_persist['ties']}; one call {r['call_ms']:.4f} ms "
              f"(CUDA events, median of {REPS}), plain {plain_ms:.3f} ms "
              f"(one call); {names[1]} design vs the persist kernel {old}; "
              + _group_ab_text(r) + "; group walk "
              + _work_text(work["closest"], r["group_bound"]))
        if any(mis.values()) or not dead_ok or vs_persist["hit"] \
                or vs_persist["t"] or old["hit"] or old["t"] \
                or int(hk.sum()) == 0:
            raise RuntimeError(f"{label}: {walk} closest-hit kernel "
                               "disagrees with its plain version or the "
                               "persist kernel's hits")
        out[(walk, "closest")] = r

        ok_ = anyhit(*aargs)
        op, plain_ms = _timed_ms(lambda: WD.group_traverse_anyhit_ref(
            *aargs, group, work=work["anyhit"]))
        occ_mis = int((ok_ != op).sum())
        persist_mis = int((ok_ != pocc).sum())
        dead_ok = bool((~ok_[~ah["active"]]).all())
        old = int((old_anyhit(*aargs) != pocc).sum())
        r = {"err": float(occ_mis), "plain_ms": plain_ms,
             "call_ms": _median_ms(lambda: anyhit(*aargs))}
        r.update(_group_ab(lambda: anyhit(*aargs),
                           lambda: old_anyhit(*aargs), bounds["anyhit"],
                           work["anyhit"], ah, tab, 1, RAY_IN + EXCLUDE,
                           names))
        print(f"[{label} {walk} anyhit] {card}: group {group}, "
              f"{ah['tmax'].numel()} rays ({int(ah['active'].sum())} active),"
              f" {int(ok_.sum())} occluded, occlusion mismatches {occ_mis} "
              f"vs plain and {persist_mis} vs the persist kernel, dead "
              f"lanes ok {dead_ok}; one call {r['call_ms']:.4f} ms (CUDA "
              f"events, median of {REPS}), plain {plain_ms:.3f} ms (one "
              f"call); {names[1]} design occlusion mismatches vs the persist "
              f"kernel {old}; " + _group_ab_text(r) + "; group walk "
              + _work_text(work["anyhit"], r["group_bound"]))
        if occ_mis or persist_mis or not dead_ok or old \
                or int(ok_.sum()) == 0:
            raise RuntimeError(f"{label}: {walk} any-hit kernel disagrees "
                               "with its plain version or the persist "
                               "kernel")
        out[(walk, "anyhit")] = r
    return out


def _group_ab(new, old, b, work, rays, tab, out_bytes, in_bytes, names):
    """The new design (``new``) against the first design (``old``) in
    turns (:func:`_ab_ms`), with the share of the persist walk's bound
    ``b`` and of the group walk's own (from its ``work`` on ``rays``);
    ``names``: the two designs' names ("packet", "leader" or "lane",
    "lane_group"), which key their times."""
    n_new, n_old = _ab_ms(new, old)
    n, n_act = rays["tmax"].numel(), int(rays["active"].sum())
    g = _bound(work, n, n_act, in_bytes, out_bytes, tab)
    ms, old_ms = statistics.mean(n_new), statistics.mean(n_old)
    new_name, old_name = names
    return {"names": names, f"{new_name}_device_ms": n_new,
            f"{old_name}_device_ms": n_old, "ms": ms, f"{old_name}_ms": old_ms,
            "speedup": old_ms / ms, "bound_us": b["bound_us"],
            "bound_by": b["bound_by"], "share": b["bound_ms"] / ms,
            f"{old_name}_share": b["bound_ms"] / old_ms,
            "group_bound_us": g["bound_us"], "group_bound_by": g["bound_by"],
            "group_share": g["bound_ms"] / ms, "group_bound": g,
            "group_work": {k: work[k] for k in ("node_visits", "slab_tests",
                                                "leaf_rows", "tri_slots")}}


def _group_ab_text(r):
    new, old = r["names"]
    return (f"device time (mean of {REPS} queued launches, in turns {old}, "
            f"{new}, {new}, {old}): {new} "
            f"{r[f'{new}_device_ms'][0]:.4f} / {r[f'{new}_device_ms'][1]:.4f}"
            f" ms, {old} {r[f'{old}_device_ms'][0]:.4f} / "
            f"{r[f'{old}_device_ms'][1]:.4f} ms, {new} {r['speedup']:.2f}x "
            f"faster; share of the persist walk's bound ({r['bound_us']:.3f}"
            f" us): {new} {100 * r['share']:.2f}%, {old} "
            f"{100 * r[f'{old}_share']:.2f}%; of the group walk's "
            f"({r['group_bound_us']:.3f} us by {r['group_bound_by']}): {new} "
            f"{100 * r['group_share']:.2f}%")


def _group_ab_record(r):
    """A group walk's A/B and bounds of one ray set, for the kernels
    line."""
    new, old = r["names"]
    return {k: r[k] for k in (f"{new}_device_ms", f"{old}_device_ms",
                              "speedup", "call_ms", "bound_us", "bound_by",
                              "share", f"{old}_share", "group_bound_us",
                              "group_bound_by", "group_share", "group_work")}


_BOUND_KEYS = ("bound_ms", "bound_us", "bound_by")


def phase3_kernels(scene, camera, card):
    """Rows 1-4 and 7-8 at the headline's shapes; each row's bound is the
    persist walk's work on its rays (a packet or lane walk does more work
    for the same result, and the bound counts the work, not how a kernel
    does it)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    out = _check_persist("kernel", scene.tables, cl, ah, card)
    persist = {}
    for k, r in out.items():
        persist[k] = dict(KERNELS[k], route="cuda", source=SOURCE,
                          max_abs_err=r["max_abs_err"], ms=r["ms"],
                          call_ms=r["call_ms"], plain_ms=r["plain_ms"],
                          library_ms=None, **{b: r[b] for b in _BOUND_KEYS},
                          share=r["share"], stride_ms=r["stride_ms"],
                          timed_launches=2 * REPS,
                          ab={"phase3": _ab_record(r)})
    group = {}
    for (walk, kind), r in _check_group("kernel", scene.tables, cl, ah, card,
                                        out).items():
        b = out[kind]
        old = r["names"][1]
        group[walk, kind] = dict(
            GROUP_KERNELS[walk, kind], route="cuda", source=GROUP_SOURCES[walk],
            max_abs_err=r["err"], ms=r["ms"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], library_ms=None,
            **{k: b[k] for k in _BOUND_KEYS}, share=b["bound_ms"] / r["ms"],
            timed_launches=2 * REPS, **{f"{old}_ms": r[f"{old}_ms"]},
            group_bound_us=r["group_bound_us"],
            group_bound_by=r["group_bound_by"], group_share=r["group_share"],
            ab={"phase3": _group_ab_record(r)})
    return persist, group


def _ab_record(r):
    """The A/B and bound of one ray set, for the kernels line."""
    return {k: r[k] for k in ("fetch_device_ms", "stride_device_ms",
                              "speedup", "call_ms", "bound_us", "bound_by",
                              "share", "stride_share")}


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
        P.STRIDE_LAUNCHES[k] = 0
    runs = []
    for seed in (1, 2, 3):  # warm-up, then two timed runs
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if seed == 1:
            captured, restore = _capture_launch(CAPTURE_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb, stats = render_frame(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, stats))
        if seed == 1:
            restore()
    launches = dict(P.LAUNCHES)
    ref_calls = sum(P.REF_CALLS.values()) + sum(P.STRIDE_LAUNCHES.values())

    secs = [r[0] for r in runs[1:]]
    stats = runs[1][2]
    mrays = stats["rays_traced"] / min(secs) / 1e6
    print(f"[main path] {card}: {WIDTH}x{HEIGHT} @ {SPP} spp, {BOUNCES} "
          f"bounces, pool {cfg.pool_size}: {stats['iterations']} iterations,"
          f" {stats['rays_traced']:.0f} rays traced, {secs[0]:.3f} s and "
          f"{secs[1]:.3f} s (warm-up {runs[0][0]:.3f} s), "
          f"{mrays:.3f} Mrays/s; launches {launches}, plain-version and "
          f"stride-design calls {ref_calls}")
    if min(launches.values()) == 0 or ref_calls != 0:
        raise RuntimeError("the main path did not run through both kernels")
    if set(captured) != {"closest", "anyhit"}:
        raise RuntimeError(f"launch {CAPTURE_AT} of each persist kernel was "
                           "not captured")

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
    return launches, dict(ref=ref, seed_mse=seed_mse, gate=gate), captured


PERSIST_NAMES = {"closest": "persist_traverse_closest",
                 "anyhit": "persist_traverse_anyhit"}
PACKET_NAMES = {"closest": "wide_traverse_closest",
                "anyhit": "wide_traverse_anyhit"}
INST_NAMES = {"closest": "wide_traverse_closest_inst",
              "anyhit": "wide_traverse_anyhit_inst"}
# a walker="lane" frame traces closest hit with the lane kernels and any
# hit with the persist kernels (anyhit_walker takes persist or packet)
LANE_NAMES = {"closest": "lane_traverse_closest",
              "anyhit": "persist_traverse_anyhit"}
WALKER_NAMES = {"persist": PERSIST_NAMES, "packet": PACKET_NAMES,
                "lane": LANE_NAMES}


def _capture_launch(at, names=PERSIST_NAMES):
    """Rebind kernel names in render/trace.py (``names``: by kind, the
    names it looks up; the persist kernels' by default) so that the
    ``at``-th call of each keeps a copy of its rays and then runs as
    before: ``(captured, restore)``, where ``captured`` fills with
    ``{"closest": (tables, rays), "anyhit": ...}`` and ``restore()`` puts
    the names back."""
    from rtjax_torch.render import trace
    captured, saved = {}, {}

    def copy(a):
        return tuple(c.clone() for c in a) if isinstance(a, (tuple, list)) \
            else a.clone()

    for kind, name in names.items():
        fn = saved[name] = getattr(trace, name)
        calls = [0]

        def wrapper(tables, *args, _fn=fn, _kind=kind, _calls=calls):
            _calls[0] += 1
            if _calls[0] == at:
                keys = ("o", "d", "tmax", "active") if _kind == "closest" \
                    else ("o", "d", "tmax", "exclude", "active")
                captured[_kind] = (tables, dict(zip(keys, map(copy, args))))
            return _fn(tables, *args)

        setattr(trace, name, wrapper)

    def restore():
        for name, fn in saved.items():
            setattr(trace, name, fn)

    return captured, restore


def _persist_kind(key):
    """"closest" / "anyhit" for a profiler key of a persist kernel (either
    design), else None."""
    if "fetch_kernel" in key:
        return "anyhit" if (", true>" in key or "Lb1E" in key) else "closest"
    if "stride_closest_kernel" in key:
        return "closest"
    if "stride_anyhit_kernel" in key:
        return "anyhit"
    return None


def _packet_kind(key):
    """"closest" / "anyhit" for a profiler key of a packet kernel (either
    design; the lane kernels' group design runs the leader design's walk at
    32 rays), else None."""
    import re
    m = re.search(r"(packet|group)_(closest|anyhit)_kernel"
                  r"(?:<\d+(?:, (\d+))?>|ILi\d+E(?:Li(\d+)E)?)", key)
    if m is None or (m[1] == "group" and "256" not in (m[3], m[4])):
        return None
    return m[2]


def _lane_kind(key):
    """"closest" for a profiler key of a lane closest-hit kernel (either
    design), "anyhit" for the persist any-hit kernel that a ``walker="lane"``
    frame runs beside it, else None."""
    import re
    if re.search(r"lane_kernel(?:<\d+, false>|ILi\d+ELb0E)", key) or \
            re.search(r"group_closest_kernel(?:<\d+, 32>|ILi\d+ELi32E)", key):
        return "closest"
    return "anyhit" if _persist_kind(key) == "anyhit" else None


def _group_label(mangled):
    """"packet closest, width 16" for a mangled name of the packet library
    ("packet leader ..." for the packet kernels' leader design, "lane ..."
    for the lane kernels, "lane group ..." for their group design)."""
    import re
    m = re.search(r"lane_kernelILi(\d+)ELb([01])E", mangled)
    if m is not None:
        return f"lane {'any-hit' if m[2] == '1' else 'closest'}, width {m[1]}"
    m = re.search(r"(packet|group)_(closest|anyhit)_kernelILi(\d+)E"
                  r"(?:Li(\d+)E)?", mangled)
    if m is None:
        return mangled
    kind = "closest" if m[2] == "closest" else "any-hit"
    design = "packet" if m[1] == "packet" else \
        "packet leader" if m[4] == "256" else "lane group"
    return f"{design} {kind}, width {m[3]}"


def _inst_kind(key):
    """"closest" / "anyhit" for a profiler key of a two-level kernel
    (either design: only they take ``Insts``), else None."""
    import re
    if "Insts" not in key:
        return None
    m = re.search(r"inst_fetch(?:<\d+, (true|false)|ILi\d+ELb([01]))", key)
    if m:
        return "anyhit" if "true" in m.groups() or "1" in m.groups() \
            else "closest"
    return "anyhit" if "stride_anyhit" in key else "closest"


def _frame_kernel_ms(scene, camera, cfg, seed, rebind, kind_of):
    """Device time and launches of one frame's traversal kernels
    (torch.profiler, CUDA activity): ``{"closest": [ms, launches],
    "anyhit": [...], "iterations": n}``, the kernels picked by ``kind_of``
    (a kernel name -> "closest", "anyhit" or None).  ``rebind`` maps
    render/trace.py names to the functions the engine calls for this frame
    (the stride design's); they are put back after it.  The profile's raw
    device events are summed: ``key_averages()`` first builds every
    event's tree, which took most of the phase's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rtjax_torch.render import trace
    from rtjax_torch.render.wavefront import render_frame
    saved = {k: getattr(trace, k) for k in rebind}
    for k, fn in rebind.items():
        setattr(trace, k, fn)
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, stats = render_frame(scene, camera, cfg, gen)
            torch.cuda.synchronize()
    finally:
        for k, fn in saved.items():
            setattr(trace, k, fn)
    out = {"closest": [0.0, 0], "anyhit": [0.0, 0],
           "iterations": stats["iterations"]}
    for e in prof.profiler.kineto_results.events():
        kind = kind_of(e.name()) if e.device_type() == DeviceType.CUDA \
            else None
        if kind is not None:
            out[kind][0] += e.duration_ns() / 1e6
            out[kind][1] += 1
    return out


def phase4_in_frame(scene, card, captured):
    """Both designs on the captured mid-frame launch of each kernel."""
    tab, cl = captured["closest"]
    tab_a, ah = captured["anyhit"]
    if tab is not tab_a or tab is not scene.tables:
        raise RuntimeError("the captured launches used other tables")
    return _check_persist(f"in-frame launch {CAPTURE_AT}", tab, cl, ah, card)


def phase7_frames(scene, camera, card, c4_scene, c4_camera):
    """The traversal kernels' device time over whole frames under each
    design (first design, new, new, first; seeds 4 and 5): the two persist
    kernels over a headline frame (stride, fetch), the two packet kernels
    over a ``walker="packet"`` headline frame (leader, packet), the lane
    closest-hit kernel over a ``walker="lane"`` headline frame (group,
    lane; its any hit is the persist kernel's, timed beside it), then the
    two two-level kernels over a config-4 ``two_level="kernel"`` frame
    (stride, fetch).  Returns ``{"persist": {kind: {design: [ms, ms]}},
    "packet": ..., "lane": ..., "two_level": ...}``.  A frame whose profile holds fewer launches
    of either kernel than the frame's iterations is profiled again, once;
    then the phase fails.  Last, because torch.profiler recorded no kernel
    rows in later profiles once it had traced whole frames."""
    import dataclasses

    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.kernels import wide_inst as WI
    headline = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                            max_bounces=BOUNCES)
    # kernels -> (first design, new design, the first design's rebinding)
    designs = {"persist": ("stride", "fetch", {
        "persist_traverse_closest": P.persist_traverse_closest_stride,
        "persist_traverse_anyhit": P.persist_traverse_anyhit_stride}),
        "packet": ("leader", "packet", {
            "wide_traverse_closest": WD.wide_traverse_closest_leader,
            "wide_traverse_anyhit": WD.wide_traverse_anyhit_leader}),
        "lane": ("group", "lane", {
            "lane_traverse_closest": L.lane_traverse_closest_group}),
        "two_level": ("stride", "fetch", {
            "wide_traverse_closest_inst": WI.wide_traverse_closest_inst_stride,
            "wide_traverse_anyhit_inst": WI.wide_traverse_anyhit_inst_stride})}
    runs = {"persist": (scene, camera, headline, _persist_kind, "headline"),
            "packet": (scene, camera, dataclasses.replace(
                headline, **WALKERS["packet"]), _packet_kind,
                "walker=packet headline"),
            "lane": (scene, camera, dataclasses.replace(
                headline, **WALKERS["lane"]), _lane_kind,
                "walker=lane headline (any hit: the persist kernel)"),
            "two_level": (c4_scene, c4_camera, dataclasses.replace(
                RenderConfig(width=WIDTH, height=HEIGHT,
                             num_samples=C4_SPP, max_bounces=C4_BOUNCES),
                two_level="kernel"), _inst_kind, "config-4 kernel")}
    out = {}
    for kernels, (sc, cam, cfg, kind_of, what) in runs.items():
        old, new, rebind_old = designs[kernels]
        frames = {new: [], old: []}
        for design, seed in ((old, 4), (new, 4), (new, 5), (old, 5)):
            rebind = rebind_old if design == old else {}
            for attempt in (1, 2):
                k = _frame_kernel_ms(sc, cam, cfg, seed, rebind, kind_of)
                print(f"[frame kernels {kernels} {design} seed {seed}] "
                      f"{card}: one {what} frame under torch.profiler: "
                      f"closest {k['closest'][0]:.3f} ms in "
                      f"{k['closest'][1]} launches, any-hit "
                      f"{k['anyhit'][0]:.3f} ms in {k['anyhit'][1]} "
                      f"launches, together "
                      f"{k['closest'][0] + k['anyhit'][0]:.3f} ms; "
                      f"{k['iterations']} iterations")
                if k["closest"][1] == k["anyhit"][1] == k["iterations"]:
                    break
                if attempt == 2:
                    raise RuntimeError(f"the profiler recorded fewer "
                                       f"{kernels} launches than the frame "
                                       "made, twice")
            frames[design].append(k)
        out[kernels] = {kind: {d: [f[kind][0] for f in fs]
                               for d, fs in frames.items()}
                        for kind in ("closest", "anyhit")}
    return out


def phase4_walkers(scene, camera, card, floor):
    """The headline frame under each walker, alternated; returns the
    launch counts of the seed-2 packet and lane frames and, by walker, the
    rays of launch CAPTURE_AT of each of its kernels in its seed-2 frame
    (the lane frame's any hit is the persist kernel's)."""
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
    imgs, counts, captured = {}, {}, {}
    for walker, seed in (("persist", 2), ("packet", 2), ("lane", 2),
                         ("lane", 3), ("packet", 3), ("persist", 3)):
        capture = walker in ("packet", "lane") and seed == 2
        if capture:
            captured[walker], restore = _capture_launch(CAPTURE_AT,
                                                        WALKER_NAMES[walker])
        try:
            runs, c = _drive(scene, camera,
                             dataclasses.replace(cfg, **WALKERS[walker]),
                             (seed,))
        finally:
            if capture:
                restore()
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
    for walker, got in captured.items():
        if set(got) != {"closest", "anyhit"}:
            raise RuntimeError(f"launch {CAPTURE_AT} of each kernel of the "
                               f"walker={walker!r} frame was not captured")
    return counts, captured


def _persist_bounds(label, tab, cl, ah):
    """The persist walk's bound of each kind on the rays ``cl`` / ``ah``
    (:func:`_bound` of the plain persist walks' work), each printed with
    its work count."""
    from rtjax_torch.kernels import persist as P
    wc, wa = P.new_work(), P.new_work()
    P.persist_traverse_closest_ref(tab, cl["o"], cl["d"], cl["tmax"],
                                   cl["active"], work=wc)
    P.persist_traverse_anyhit_ref(tab, ah["o"], ah["d"], ah["tmax"],
                                  ah["exclude"], ah["active"], work=wa)
    out = {"closest": _bound(wc, cl["tmax"].numel(), int(cl["active"].sum()),
                             RAY_IN, CLOSEST_OUT, tab),
           "anyhit": _bound(wa, ah["tmax"].numel(), int(ah["active"].sum()),
                            RAY_IN + EXCLUDE, 1, tab)}
    for kind, work in (("closest", wc), ("anyhit", wa)):
        print(f"[{label} persist walk {kind}] "
              + _work_text(work, out[kind]))
    return out


def phase4_group_in_frame(scene, card, captured, walk):
    """Both designs of the ``walk`` kernels ("packet" or "lane") on launch
    CAPTURE_AT of the seed-2 ``walker=walk`` frame (for "lane", its lane
    closest-hit launch and the persist any-hit launch of that iteration)."""
    tab, cl = captured["closest"]
    tab_a, ah = captured["anyhit"]
    if tab is not tab_a or tab is not scene.tables:
        raise RuntimeError(f"the captured {walk} launches used other tables")
    label = f"{walk} in-frame launch {CAPTURE_AT}"
    return _check_group(label, tab, cl, ah, card,
                        _persist_bounds(label, tab, cl, ah), (walk,))


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


def _check_inst(label, it, cl, ah, card):
    """Hold both two-level kernels, in the fetch design that the engine
    runs and in the first (stride) design, against their plain versions on
    the instanced tables ``it`` with the closest-hit rays ``cl`` and the
    any-hit rays ``ah``: zero hit, t, prim, inst, normal and occlusion
    mismatches and correct dead lanes, or raise.  Time both designs and the
    plain version, count the plain walk's work and give each kernel its
    bound, as :func:`_check_persist` does; returns the same dict."""
    import torch
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide_inst as WI
    records = it.num_instances * AFF_RECORD
    out = {}
    args = (it, cl["o"], cl["d"], cl["tmax"], cl["active"])
    work = P.new_work()
    hp, tp, pp, ip, np_ = WI.wide_traverse_closest_inst_ref(*args, work=work)
    dead = ~cl["active"]
    mis = {}
    for design, fn in (("fetch", WI.wide_traverse_closest_inst),
                       ("stride", WI.wide_traverse_closest_inst_stride)):
        hk, tk, pk, ik, nk = fn(*args)
        torch.cuda.synchronize()
        mis[design] = {
            "hit": int((hk != hp).sum()), "t": int((tk != tp).sum()),
            "prim": int((pk != pp).sum()), "inst": int((ik != ip).sum()),
            "normal": int(sum((a != b).sum() for a, b in zip(nk, np_))),
            "dead": int(not ((~hk[dead]).all() and (tk[dead] == P.BIG).all()
                             and (pk[dead] == -1).all()
                             and (ik[dead] == 0).all()
                             and all((c[dead] == 0).all() for c in nk)))}
        if design == "fetch":
            both = hk & hp
            err = float((tk[both] - tp[both]).abs().max()) \
                if bool(both.any()) else 0.0
            hits, on_inst = int(hk.sum()), int((ik > 0).sum())
            top = int(ik.max())
    new, old = _ab_ms(lambda: WI.wide_traverse_closest_inst(*args),
                      lambda: WI.wide_traverse_closest_inst_stride(*args))
    call_ms = _median_ms(lambda: WI.wide_traverse_closest_inst(*args))
    plain_ms = _median_ms(lambda: WI.wide_traverse_closest_inst_ref(*args))
    n, n_act = cl["tmax"].numel(), int(cl["active"].sum())
    b = _bound(work, n, n_act, RAY_IN, INST_OUT, it.wide, records)
    out["closest"] = _ab_result(err, new, old, call_ms, plain_ms, b)
    stack, staged = WI.launch_shape(it)
    print(f"[{label} closest_inst] {card}: {n} rays ({n_act} active) over "
          f"{it.num_instances} instances, {it.wide.width}-wide tables, "
          f"stack {stack}, records {'staged' if staged else 'global'}; "
          f"{hits} hits ({on_inst} on instances, {top} the highest "
          f"instance); mismatches vs plain (hit, t, prim, inst, normal, "
          f"dead lanes): fetch {mis['fetch']}, stride {mis['stride']}; "
          + _ab_text(out["closest"]) + f"; {_work_text(work, b)}")
    if any(v for m in mis.values() for v in m.values()) or on_inst == 0:
        raise RuntimeError(f"{label}: two-level closest-hit kernel "
                           "disagrees with its plain version")

    args = (it, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    work = P.new_work()
    op = WI.wide_traverse_anyhit_inst_ref(*args, work=work)
    mis = {}
    for design, fn in (("fetch", WI.wide_traverse_anyhit_inst),
                       ("stride", WI.wide_traverse_anyhit_inst_stride)):
        ok_ = fn(*args)
        torch.cuda.synchronize()
        mis[design] = {"occlusion": int((ok_ != op).sum()),
                       "dead": int(bool(ok_[~ah["active"]].any()))}
        if design == "fetch":
            occluded = int(ok_.sum())
    new, old = _ab_ms(lambda: WI.wide_traverse_anyhit_inst(*args),
                      lambda: WI.wide_traverse_anyhit_inst_stride(*args))
    call_ms = _median_ms(lambda: WI.wide_traverse_anyhit_inst(*args))
    plain_ms = _median_ms(lambda: WI.wide_traverse_anyhit_inst_ref(*args))
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _bound(work, n, n_act, RAY_IN + EXCLUDE, 1, it.wide, records)
    out["anyhit"] = _ab_result(float(mis["fetch"]["occlusion"]), new, old,
                               call_ms, plain_ms, b)
    print(f"[{label} anyhit_inst] {card}: {n} rays ({n_act} active) over "
          f"{it.num_instances} instances, {occluded} occluded; mismatches "
          f"vs plain (occlusion, dead lanes): fetch {mis['fetch']}, stride "
          f"{mis['stride']}; " + _ab_text(out["anyhit"])
          + f"; {_work_text(work, b)}")
    if any(v for m in mis.values() for v in m.values()) or occluded == 0:
        raise RuntimeError(f"{label}: two-level any-hit kernel disagrees "
                           "with its plain version")
    return out


def phase5_inst_kernels(scene, camera, card):
    """Rows 5-6: both designs on config 4's field rays, then on the field
    rays over MANY_INST instances of the same bunny (the rescan's share).
    Returns the rows, by kind, with an ``ab`` record per ray set."""
    import torch
    from rtjax_torch.scenes import instanced_bunnies
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cl, ah = _field_rays(scene, camera, gen)
    out = _check_inst("kernel", scene.inst_tables, cl, ah, card)
    rows = {}
    for kind, r in out.items():
        rows[kind] = dict(INST_KERNELS[kind], route="cuda",
                          source=INST_SOURCE, max_abs_err=r["max_abs_err"],
                          ms=r["ms"], call_ms=r["call_ms"],
                          plain_ms=r["plain_ms"], library_ms=None,
                          **{b: r[b] for b in _BOUND_KEYS}, share=r["share"],
                          stride_ms=r["stride_ms"], timed_launches=2 * REPS,
                          ab={"field": _ab_record(r)})
    t0 = time.perf_counter()
    many, many_camera = instanced_bunnies("cuda", n_inst=MANY_INST)
    print(f"[config4 x{MANY_INST} scene] {many.instances.num} instances, "
          f"built in {time.perf_counter() - t0:.1f} s")
    cl, ah = _field_rays(many, many_camera, gen)
    _record_ab(rows, _check_inst(f"{MANY_INST} instances", many.inst_tables,
                                 cl, ah, card), "many_instances")
    return rows


def _record_group(group, out, key):
    """Add one ray set's group checks to the packet and lane rows: their
    A/B, every row's largest error."""
    for (walk, kind), r in out.items():
        row = group[walk, kind]
        row["max_abs_err"] = max(row["max_abs_err"], r["err"])
        row["ab"][key] = _group_ab_record(r)


def _record_ab(rows, out, key):
    """Add one ray set's A/B to the kernels' rows; keep their largest
    error."""
    for kind, r in out.items():
        rows[kind]["ab"][key] = _ab_record(r)
        rows[kind]["max_abs_err"] = max(rows[kind]["max_abs_err"],
                                        r["max_abs_err"])


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
    repass.  Returns the persist checks' results and the group checks'
    results (as :func:`_check_group` returns them), each by shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5678)
    cl, ah = _field_rays(baked, camera, gen)
    persist = {"config4_baked": _check_persist(
        "config4 baked persist", baked.tables, cl, ah, card)}
    group = {"config4_baked": _check_group(
        "config4 baked", baked.tables, cl, ah, card,
        persist["config4_baked"])}
    if set(scene.instances.mesh_id) != {0}:
        raise RuntimeError("config 4 should place one BLAS")
    cl, ah = _field_rays(scene, camera, gen)
    cl = _instance_frame(scene.instances, cl)
    ah = _instance_frame(scene.instances, ah)
    persist["config4_blas"] = _check_persist(
        "config4 blas persist", scene.blas[0].tables, cl, ah, card)
    group["config4_blas"] = _check_group(
        "config4 blas", scene.blas[0].tables, cl, ah, card,
        persist["config4_blas"])
    return persist, group


_KERNEL_SETS = ("persist", "two_level", "packet", "lane", "stride",
                "inst_stride", "packet_leader", "lane_group")


def _counters():
    """``{set: (LAUNCHES, REF_CALLS or None)}`` of every kernel module."""
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.kernels import wide_inst as WI
    return {"persist": (P.LAUNCHES, P.REF_CALLS),
            "two_level": (WI.LAUNCHES, WI.REF_CALLS),
            "packet": (WD.LAUNCHES, WD.REF_CALLS),
            "lane": (L.LAUNCHES, None),
            "stride": (P.STRIDE_LAUNCHES, None),
            "inst_stride": (WI.STRIDE_LAUNCHES, None),
            "packet_leader": (WD.LEADER_LAUNCHES, None),
            "lane_group": (L.GROUP_LAUNCHES, None)}


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

    captured, restore = _capture_launch(C4_CAPTURE_AT, INST_NAMES)
    try:
        b_runs, b = _drive(scene, camera,
                           dataclasses.replace(cfg, two_level="kernel"), (2,))
    finally:
        restore()
    report("b: two_level=kernel, seed 2", b_runs, b)
    require(set(captured) == {"closest", "anyhit"},
            f"launch {C4_CAPTURE_AT} of each two-level kernel was not "
            "captured")
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
    return b["two_level"], captured


def phase6_in_frame(scene, card, captured):
    """Both two-level designs on the captured launch of 6(b)'s frame."""
    tab, cl = captured["closest"]
    tab_a, ah = captured["anyhit"]
    if tab is not tab_a or tab is not scene.inst_tables:
        raise RuntimeError("the captured two-level launches used other "
                           "tables")
    return _check_inst(f"config4 in-frame launch {C4_CAPTURE_AT}", tab, cl,
                       ah, card)


def main():
    t0 = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s")

    card = phase0_device()
    import torch
    phase1_build()
    stamp("phase 1 (build)")
    scene, camera = phase2_scene()
    persist, group = phase3_kernels(scene, camera, card)
    stamp("phase 3 (kernels)")
    launches, floor, captured = phase4_main_path(scene, camera, card)
    for kind, k in persist.items():
        k["launches"] = launches[kind]
    for kind, r in phase4_in_frame(scene, card, captured).items():
        persist[kind]["ab"]["in_frame"] = _ab_record(r)
    walker_counts, walker_captured = phase4_walkers(scene, camera, card,
                                                    floor)
    for (walk, kind), k in group.items():
        k["launches"] = walker_counts[walk][walk][kind]
    for walk in ("packet", "lane"):
        _record_group(group, phase4_group_in_frame(
            scene, card, walker_captured[walk], walk), "in_frame")
    group["lane", "anyhit"]["note"] = ("on no engine path: anyhit_walker "
                                       "takes persist or packet, as in rtjax")
    stamp("phase 4 (main path, walkers, in-frame launches)")
    c4_scene, baked, c4_camera = phase5_scene()
    inst = phase5_inst_kernels(c4_scene, c4_camera, card)
    by_shape, group_shapes = phase5_persist(c4_scene, baked, c4_camera, card)
    stamp("phase 5 (config 4 kernels)")
    for shape, out in by_shape.items():
        for kind, r in out.items():
            persist[kind]["ab"][shape] = _ab_record(r)
            persist[kind]["max_abs_err"] = max(persist[kind]["max_abs_err"],
                                               r["max_abs_err"])
    for shape, out in group_shapes.items():
        _record_group(group, out, shape)
    inst_launches, inst_captured = phase6_config4(c4_scene, baked, c4_camera,
                                                  card)
    for kind, k in inst.items():
        k["launches"] = inst_launches[kind]
    _record_ab(inst, phase6_in_frame(c4_scene, card, inst_captured),
               "in_frame")
    stamp("phase 6 (config 4 frames)")
    frames = phase7_frames(scene, camera, card, c4_scene, c4_camera)
    stamp("phase 7 (frame kernels)")
    for rows_, kernels in ((persist, "persist"), (inst, "two_level")):
        for kind, ms in frames[kernels].items():
            rows_[kind]["frame_ms"] = ms
    for kind, ms in frames["packet"].items():
        group["packet", kind]["frame_ms"] = ms
    group["lane", "closest"]["frame_ms"] = frames["lane"]["closest"]
    rows = [*persist.values(), *group.values(), *inst.values()]
    for k in rows:
        print(f"[bound] {k['name']}: {k['bound_us']:.3f} us by "
              f"{k['bound_by']}, kernel {k['ms']:.4f} ms device time, "
              f"{100 * k['share']:.2f}% of the bound; launches {k['launches']}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
