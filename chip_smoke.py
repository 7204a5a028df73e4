#!/usr/bin/env python3
"""GPU smoke run of rtjax_torch, the PyTorch + CUDA port of rtjax.

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises and
the script exits non-zero):

0. device: require CUDA; print the card's name and power limit, and the
   torch and CUDA versions;
1. build: the BVH builder and the four kernel libraries from this
   checkout's sources, into build/rtjax_torch/, all five compilers
   started together; ptxas's registers, stack frame and spills of the
   persist, two-level, packet and lane kernels (both designs, widths 8
   and 16, the two-level fetch kernels with the instance records staged
   or global; the binary-walk kernels' in phase 9);
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
8. the user's render path (run after phase 6, before phase 7's profiles;
   every path's launch counts read from zero just before it and just
   after): (a) ``python -m rtjax_torch render`` at its defaults (the
   reference demo, cornell_bunny 600x600 @ 10 spp, 10 bounces, on cuda)
   through ``cli.main``, seeds 1 and 2: the persist kernels once an
   iteration, framebuffers finite and non-negative, the two means within
   four standard errors of their difference; (b) a headline frame under
   ``detailed_stats``: only the persist kernels' stats instances, once an
   iteration, the bounce histogram summing to the path rays traced, the
   image at the headline gate; the stats instances' node visits and leaf
   rows equal to the plain walk's ``new_work()`` counts and their results
   bit for bit the default instances', on phase 3's rays and on launch
   CAPTURE_AT of that frame, timed in turns with the default instances;
   the default instances' ptxas registers unchanged (DEFAULT_REGISTERS);
   (c) cornell_bunny at MODE_SIZE^2 @ MODE_SPP under
   ``reference_parity`` and the default estimator: the parity mean within
   PARITY_MEAN_TOL of rtjax's parity artifact and the parity / default
   ratio within PARITY_RATIO_TOL of BASELINE's 1.0158; a
   ``one_sample_mis`` headline frame at the headline gate; (d) eval config
   5 (1920x1080, 10 bounces) through ``render_checkpointed``: 8 spp as 2
   batches of 4 saved under build/rtjax_torch/, resumed to 12 spp (one
   batch rendered), the uninterrupted 12-spp image within C5_RTOL /
   C5_ATOL, then the sustained rate of 64 spp as 4 batches of 16;
9. rtjax's other traversal and sort modes (run after phase 8, before
   phase 7's profiles; launch counts from zero around every frame):
   (a) the binary-BVH walk's two kernels (csrc/binary_traverse.cu) against
   their plain versions on phase 3's rays over the headline scene's binary
   BVH: zero mismatches in hit, t, u, v, prim, normal and occlusion,
   correct dead lanes, hits, t and occlusion equal to the persist
   kernels' (equal-t ties counted), the stats instances' counts equal to
   the plain walk's and their results the default instances' bit for bit,
   device time per launch, one call, one plain call, the plain walk's
   counts and the bound, and the four instances' ptxas lines; (b) the
   headline frame under traversal="xla", seeds 2 and 3, alternated with
   persist frames (xla, persist, persist, xla): only the binary kernels,
   once an iteration, each image at phase 4's gate, frame seconds; (c) the
   headline frame under every other sort key and with sort_rays=False:
   only the persist kernels, once an iteration, each at phase 4's gate;
   (d) cornell_bunny at WIDE_SIZE^2 (above 2^21 pixels: the wide sort
   bundle) against two compact frames at half the width, the wide frame's
   linear radiance box-downsampled 2x2 within 2x their seed-to-seed MSE
   of the first; (e) eval config 4 under traversal="xla" (rtjax's
   per-instance loop): only the binary kernels, 1 + 16 launches of each an
   iteration, the image within 2x phase 6(a)'s seed-to-seed MSE (plus
   the 8-bit term) of its seed-2 frame;
10. detailed_stats under every walker, and multi-GPU rendering (run after
   phase 9, before phase 7's profiles; launch counts from zero around
   every frame): (a) the stats instances of the packet and lane kernels
   on phase 3's rays and of the two-level kernels on phase 5's field rays
   over config 4 and over MANY_INST instances: node visits and leaf rows
   equal to the plain walk's ``new_work()`` counts, results bit for bit
   the default instances', device times in turns with them (default,
   stats, stats, default), and the default instances' ptxas registers
   held to DEFAULT_WALK_REGISTERS, the parent's; (b) detailed_stats
   frames launching only stats instances, once an iteration: the
   headline under walker="packet" (packet any hit) and under
   walker="lane" with anyhit_walker="packet", each at phase 4's gate, and
   config 4 under two_level="kernel" within 2x + the 8-bit term of repass;
   (c) ``init_multihost`` at a world of one with the default backend
   (NCCL) in a subprocess: the headline frame through
   ``render_frame_sharded`` equal in iterations and rays to the unsharded
   frame from ``rank_generator(2, 0)``, at phase 4's gate; (d) two
   subprocesses on the one card over gloo with CUDA tensors, 32 spp a
   rank: equal checksums of the reduced framebuffer on both, rays the sum
   of the ranks' and iterations their maximum, at phase 4's gate, the
   frame's seconds beside one process's; (e) the same two ranks render
   eval config 5 for C5_SHARDED_SPP spp in batches of C5_SHARDED_BATCH
   through ``render_checkpointed(mesh=)``, rank 0 saving, and a resume
   from a file one batch short within C5_RTOL / C5_ATOL, with its
   sustained Mrays/s; (f) ``python -m torch.distributed.run --standalone
   --nproc_per_node=1 -m rtjax_torch render --sharded`` (NCCL over
   ``env://``) writes its PPM;
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
6(b) for the two-level ones, phase 8(b)'s frame for the persist kernels'
stats instances (rows of their own, ``(with_stats)``, with the default
instances' time beside theirs), phase 9(b)'s two xla frames for the
binary-walk kernels (rows 9-10: rtjax's XLA walk, ``replaces`` naming
its functions, which reach no ``pallas_call``; their bound counts each
node pair and triangle the plain walk read, once, ``_binary_bound``),
phase 10(b)'s frames for the packet, lane and two-level kernels' stats
instances (rows of their own, ``(with_stats)``).  lane_traverse_anyhit is on no engine path
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
              "packet and lane kernels": _build.packet_library,
              "binary-walk kernels": _build.binary_library}

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
    m = re.search(r"(fetch_kernel|fetch_stats_kernel|stride_closest_kernel"
                  r"|stride_anyhit_kernel|inst_fetch|stride_closest"
                  r"|stride_anyhit)"
                  r"ILi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?(?:Lb([01])E)?",
                  mangled)
    if m is None:
        return mangled
    kernels = "two-level" if "Insts" in mangled else "persist"
    design = "fetch" if "fetch" in m[1] else "stride"
    anyhit = m[3] == "1" if design == "fetch" else "anyhit" in m[1]
    if m[1] == "fetch_stats_kernel" or m[5] == "1":
        design = "fetch stats"
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
        P.STATS_LAUNCHES[k] = 0
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
    ref_calls = sum(P.REF_CALLS.values()) + sum(P.STRIDE_LAUNCHES.values()) \
        + sum(P.STATS_LAUNCHES.values())

    secs = [r[0] for r in runs[1:]]
    stats = runs[1][2]
    mrays = stats["rays_traced"] / min(secs) / 1e6
    print(f"[main path] {card}: {WIDTH}x{HEIGHT} @ {SPP} spp, {BOUNCES} "
          f"bounces, pool {cfg.pool_size}: {stats['iterations']} iterations,"
          f" {stats['rays_traced']:.0f} rays traced, {secs[0]:.3f} s and "
          f"{secs[1]:.3f} s (warm-up {runs[0][0]:.3f} s), "
          f"{mrays:.3f} Mrays/s; launches {launches}, plain-version, "
          f"stride-design and stats-instance calls {ref_calls}")
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

        def wrapper(tables, *args, _fn=fn, _kind=kind, _calls=calls, **kw):
            _calls[0] += 1
            if _calls[0] == at:
                keys = ("o", "d", "tmax", "active") if _kind == "closest" \
                    else ("o", "d", "tmax", "exclude", "active")
                captured[_kind] = (tables, dict(zip(keys, map(copy, args))))
            return _fn(tables, *args, **kw)

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
                  r"(?:<\d+(?:, (\d+|false))?>|ILi\d+E(?:Li(\d+)E|Lb0E)?)",
                  key)
    if m is None or (m[1] == "group" and "256" not in (m[3], m[4])):
        return None
    return m[2]


def _lane_kind(key):
    """"closest" for a profiler key of a lane closest-hit kernel (either
    design), "anyhit" for the persist any-hit kernel that a ``walker="lane"``
    frame runs beside it, else None."""
    import re
    if re.search(r"lane_kernel(?:<\d+, false, false>|ILi\d+ELb0ELb0E)",
                 key) or \
            re.search(r"group_closest_kernel(?:<\d+, 32>|ILi\d+ELi32E)", key):
        return "closest"
    return "anyhit" if _persist_kind(key) == "anyhit" else None


def _group_label(mangled):
    """"packet closest, width 16" for a mangled name of the packet library
    ("packet leader ..." for the packet kernels' leader design, "lane ..."
    for the lane kernels, "lane group ..." for their group design)."""
    import re
    m = re.search(r"lane_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if m is not None:
        return (f"lane{' stats' if m[3] == '1' else ''} "
                f"{'any-hit' if m[2] == '1' else 'closest'}, width {m[1]}")
    m = re.search(r"(packet|group)_(closest|anyhit)_kernelILi(\d+)E"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?", mangled)
    if m is None:
        return mangled
    kind = "closest" if m[2] == "closest" else "any-hit"
    design = ("packet stats" if m[5] == "1" else "packet") \
        if m[1] == "packet" else \
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
                "inst_stride", "packet_leader", "lane_group", "persist_stats",
                "binary", "binary_stats", "packet_stats", "lane_stats",
                "two_level_stats")


def _counters():
    """``{set: (LAUNCHES, REF_CALLS or None)}`` of every kernel module."""
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import traversal as T
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.kernels import wide_inst as WI
    return {"persist": (P.LAUNCHES, P.REF_CALLS),
            "two_level": (WI.LAUNCHES, WI.REF_CALLS),
            "packet": (WD.LAUNCHES, WD.REF_CALLS),
            "lane": (L.LAUNCHES, None),
            "stride": (P.STRIDE_LAUNCHES, None),
            "inst_stride": (WI.STRIDE_LAUNCHES, None),
            "packet_leader": (WD.LEADER_LAUNCHES, None),
            "lane_group": (L.GROUP_LAUNCHES, None),
            "persist_stats": (P.STATS_LAUNCHES, None),
            "binary": (T.LAUNCHES, T.REF_CALLS),
            "binary_stats": (T.STATS_LAUNCHES, None),
            "packet_stats": (WD.STATS_LAUNCHES, None),
            "lane_stats": (L.STATS_LAUNCHES, None),
            "two_level_stats": (WI.STATS_LAUNCHES, None)}


def _zero_counts():
    """Set every launch and plain-call count to 0."""
    for launches, refs in _counters().values():
        for c in (launches, refs):
            for k in c or ():
                c[k] = 0


def _read_counts():
    counts = {name: dict(launches) for name, (launches, _) in
              _counters().items()}
    counts["plain"] = sum(sum(refs.values()) for _, refs in
                          _counters().values() if refs is not None)
    return counts


def _drive(scene, camera, cfg, seeds):
    """Render one frame per seed with every launch count read from zero:
    ``([(seconds, framebuffer, stats), ...], counts)``; counts hold each
    kernel set's launches and ``plain``, the plain-version calls."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    _zero_counts()
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
    return runs, _read_counts()


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
    return b["two_level"], captured, dict(img_a2=img_a2, seed_mse=seed_mse,
                                          quant=quant)


def phase6_in_frame(scene, card, captured):
    """Both two-level designs on the captured launch of 6(b)'s frame."""
    tab, cl = captured["closest"]
    tab_a, ah = captured["anyhit"]
    if tab is not tab_a or tab is not scene.inst_tables:
        raise RuntimeError("the captured two-level launches used other "
                           "tables")
    return _check_inst(f"config4 in-frame launch {C4_CAPTURE_AT}", tab, cl,
                       ah, card)


# ---------------------------------------------------------------- phase 8

# (a) the reference demo through the command line, at its defaults
DEMO_SEEDS = (1, 2)
# (c) the estimator frames (BASELINE.md's parity protocol scene, cut to
# 16 spp) and the rtjax artifact the parity frame is held to
MODE_SIZE, MODE_SPP = 1024, 16
PARITY_ARTIFACT = os.path.join(ROOT, "artifacts",
                               "parity_reference_1024_1024spp.ppm")
# BASELINE.md:84-85: the parity mean is the fixed estimator's + 1.58%
PARITY_RATIO = 1.0158
# the fixed estimator's 1,024-spp render of the same frame (its pair)
FIXED_ARTIFACT = os.path.join(ROOT, "artifacts",
                              "parity_fixed_1024_1024spp.ppm")
# the gates of (c): |parity mean - the artifact's mean| and |parity /
# default mean ratio - PARITY_RATIO|, each the largest offset of four
# seeds plus four standard deviations (tools/mode_bands.py on an NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md).  At 16 spp both offsets are
# systematic, not noise: the 8-bit mean of sqrt(a 16-spp estimate) lies
# below the 1,024-spp artifact's, and the ratio above BASELINE's.
PARITY_MEAN_TOL = 0.00168
PARITY_RATIO_TOL = 0.00275
# (d) eval config 5 (benchmarks/run_configs.py:228-265): the headline
# scene at 1920x1080, 10 bounces, default pool
C5_WIDTH, C5_HEIGHT, C5_BOUNCES = 1920, 1080, 10
C5_SUSTAINED_SPP, C5_BATCH_SPP = 64, 16
# resumed vs uninterrupted 12 spp: index_add_'s float atomics order each
# pixel's sums differently from run to run
C5_RTOL, C5_ATOL = 1e-5, 1e-6
# ptxas registers of the persist kernels' default instances (fetch design)
# before the stats instances were added, on the card's toolkit
# (PERF.md): they must not change
DEFAULT_REGISTERS = {"persist fetch closest, width 8": 96,
                     "persist fetch closest, width 16": 96,
                     "persist fetch any-hit, width 8": 92,
                     "persist fetch any-hit, width 16": 94}


def _only_set(counts, kernel_set, iterations=None):
    """True when ``kernel_set`` launched both kernels (``iterations``
    times each when given), no other set launched and no plain version
    ran."""
    ok = _only(counts, kernel_set) and counts["plain"] == 0
    if iterations is not None:
        ok = ok and all(v == iterations
                        for v in counts[kernel_set].values())
    return ok


def phase8_cli(card):
    """(a) ``python -m rtjax_torch render`` at its defaults (the reference
    demo: cornell_bunny 600x600 @ 10 spp, 10 bounces, on cuda) through
    ``cli.main``, seeds 1 (the default) and 2, counts from zero around
    each: the persist kernels once an iteration and nothing else; each
    framebuffer finite and non-negative; the two images' means within four
    standard errors of their difference (sqrt(MSE / pixels))."""
    import numpy as np
    import torch
    import rtjax_torch.render as R
    from rtjax_torch import cli
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import read_ppm
    frames = []
    orig = R.render_frame

    def keep(*args, **kw):
        fb, st = orig(*args, **kw)
        frames.append((fb, st))
        return fb, st

    imgs = []
    R.render_frame = keep
    try:
        for seed in DEMO_SEEDS:
            out = _build.BUILD_DIR / f"demo_seed{seed}.ppm"
            argv = ["render", "-o", str(out)]
            if seed != 1:
                argv[1:1] = ["--seed", str(seed)]
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            secs = time.perf_counter() - t0
            counts = _read_counts()
            fb, st = frames[-1]
            print(f"[cli demo seed {seed}] {card}: python -m rtjax_torch "
                  f"{' '.join(argv)}: rc {rc}, {st['iterations']} "
                  f"iterations, {st['rays_traced']:.0f} rays, {secs:.3f} s "
                  f"with the scene build and the PPM; launches "
                  f"{ {k: v for k, v in counts.items() if k != 'plain'} }, "
                  f"plain {counts['plain']}")
            if rc != 0 or not _only_set(counts, "persist", st["iterations"]):
                raise RuntimeError("the CLI demo did not run through the "
                                   "persist kernels, once an iteration")
            if fb.shape != (600 * 600, 3) or not bool(
                    torch.isfinite(fb).all()) or bool((fb < 0).any()):
                raise RuntimeError("the CLI demo's framebuffer is not finite"
                                   " and non-negative at 600x600")
            imgs.append(read_ppm(out).astype(np.float64) / 255.0)
    finally:
        R.render_frame = orig
    a, b = imgs
    diff = float(a.mean() - b.mean())
    se = float(np.sqrt(np.mean((a - b) ** 2) / (a.shape[0] * a.shape[1])))
    print(f"[cli demo image] means {a.mean():.5f} / {b.mean():.5f}, "
          f"difference {diff:.2e}, gate 4 x {se:.2e}")
    if abs(diff) > 4.0 * se or a.mean() <= 0.0:
        raise RuntimeError("the CLI demo's two seeds differ beyond the "
                           "noise floor")


def _registers(text):
    import re
    m = re.search(r"(\d+) registers", text)
    return int(m[1]) if m else None


def _stats_ptxas():
    """``({label: registers} of the default fetch instances, {label:
    registers} of the stats instances)``, printed, and the default ones
    held to DEFAULT_REGISTERS."""
    from rtjax_torch.kernels import _build
    default, stats = {}, {}
    for name, res in _build.ptxas_report(_build.persist_library()):
        label = _kernel_label(name)
        if "fetch_stats_kernel" in name:
            stats[label] = _registers(res)
        elif label.startswith("persist fetch"):
            default[label] = _registers(res)
    print(f"[stats ptxas] default instances {default}; stats instances "
          f"{stats}; before the stats instances {DEFAULT_REGISTERS}")
    if len(default) != 4 or len(stats) != 4:
        raise RuntimeError("ptxas did not report the four default and four "
                           "stats instances")
    if DEFAULT_REGISTERS is not None and default != DEFAULT_REGISTERS:
        raise RuntimeError("the default instances' registers changed")
    return default, stats


def _flat(x):
    """The tensors of a nest of tuples, in order."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _check_counting(label, kinds, card):
    """The stats instance of each kind of ``kinds`` (``{kind: (args,
    wrapper, plain, in_bytes, out_bytes, tables, bound or None,
    extra_bytes)}``; ``plain(*args, work=)`` the plain walk the wrapper's
    kernel walks): its node visits and leaf rows equal the plain walk's
    ``new_work()`` counts exactly and its results the default instance's
    bit for bit, and the default instance's the plain walk's, or raise;
    both instances timed in turns (default, stats, stats, default; the
    stats call includes the zero fill of its buffer), and the plain walk's
    one counting call.  ``bound`` None: from this plain walk's work.
    Returns ``{kind: row}``."""
    import torch
    from rtjax_torch.kernels import persist as P
    out = {}
    for kind, (args, fn, plain, in_b, out_b, tab, bound, extra) in \
            kinds.items():
        work = P.new_work()
        ref, plain_ms = _timed_ms(lambda: plain(*args, work=work))
        base = fn(*args)
        got = fn(*args, with_stats=True)
        torch.cuda.synchronize()
        counts = tuple(int(c) for c in got[-1])
        want = (work["node_visits"], work["leaf_rows"])

        def mismatches(a, b):
            a, b = _flat(a), _flat(b)
            return sum(int((x != y).sum()) for x, y in zip(a, b)) \
                + abs(len(a) - len(b))

        mism = mismatches(got[:-1], base)
        mism_plain = mismatches(base, ref)
        new, old = _ab_ms(lambda: fn(*args, with_stats=True),
                          lambda: fn(*args))
        rays = args[3]
        n, n_act = rays.numel(), int(args[-1].sum())
        if bound is None:
            bound = _bound(work, n, n_act, in_b, out_b, tab, extra)
        r = dict(max_abs_err=float(mism), ms=statistics.mean(new),
                 default_ms=statistics.mean(old), stats_device_ms=new,
                 default_device_ms=old, plain_ms=plain_ms, counts=counts,
                 **{k: bound[k] for k in _BOUND_KEYS})
        r["cost"] = r["ms"] / r["default_ms"]
        r["share"] = bound["bound_ms"] / r["ms"]
        out[kind] = r
        print(f"[{label} stats {kind}] {card}: {n} rays ({n_act} active): "
              f"counts (node visits, leaf rows) {counts}, plain walk {want}"
              f"; result mismatches vs the default instance {mism} (default"
              f" vs plain {mism_plain}); device "
              f"time (mean of {REPS} queued launches, in turns default, "
              f"stats, stats, default): stats {new[0]:.4f} / {new[1]:.4f} "
              f"ms, default {old[0]:.4f} / {old[1]:.4f} ms, stats / default "
              f"{r['cost']:.3f}; bound {bound['bound_us']:.3f} us by "
              f"{bound['bound_by']}, stats {100 * r['share']:.2f}% of it; "
              f"plain walk counting {plain_ms:.3f} ms (one call)")
        if counts != want or mism or mism_plain or min(counts) <= 0:
            raise RuntimeError(f"{label}: the {kind} stats instance's counts "
                               "or results disagree")
    return out


def phase8_stats(scene, camera, card, floor):
    """(b) A headline frame under ``detailed_stats`` (seed 2), counts from
    zero: only the stats instances, once an iteration; the histogram sums
    to the path rays traced (the closest-hit launches' active rays) and
    its depth 0 to the camera rays; the image at the headline's noise-floor
    gate.  Then the stats instances against the plain walk and the
    default instances on phase 3's rays and on launch CAPTURE_AT of this
    frame, timed in turns with the default instances, and the ptxas
    registers of both."""
    import dataclasses

    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import trace
    cfg = dataclasses.replace(RenderConfig(
        width=WIDTH, height=HEIGHT, num_samples=SPP, max_bounces=BOUNCES),
        detailed_stats=True)
    captured, restore = _capture_launch(CAPTURE_AT)
    path_rays = torch.zeros((), dtype=torch.int64, device="cuda")
    inner = trace.persist_traverse_closest

    def count(tables, o, d, tmax, active, **kw):
        path_rays.add_(active.sum())
        return inner(tables, o, d, tmax, active, **kw)

    trace.persist_traverse_closest = count
    try:
        runs, c = _drive(scene, camera, cfg, (2,))
    finally:
        trace.persist_traverse_closest = inner
        restore()
    secs, fb, st = runs[0]
    hist = st["bounce_histogram"]
    ref_mse = float(np.mean((_u8_image(fb) - floor["ref"]) ** 2))
    print(f"[stats frame] {card}: {WIDTH}x{HEIGHT} @ {SPP} spp, "
          f"detailed_stats, seed 2: {st['iterations']} iterations, "
          f"{st['rays_traced']:.0f} rays, {secs:.3f} s; histogram "
          f"{hist.tolist()} (sum {int(hist.sum())}), path rays "
          f"{int(path_rays)}; node steps {st['node_steps']}, leaf visits "
          f"{st['leaf_visits']} (any hit {st['anyhit_steps']} / "
          f"{st['anyhit_visits']}); MSE vs {os.path.relpath(ARTIFACT, ROOT)} "
          f"{ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
          f"{ {k: v for k, v in c.items() if k != 'plain'} }")
    if not _only_set(c, "persist_stats", st["iterations"]):
        raise RuntimeError("the detailed_stats frame did not run the stats "
                           "instances alone, once an iteration")
    if int(hist.sum()) != int(path_rays) or \
            int(hist[0]) != WIDTH * HEIGHT * SPP:
        raise RuntimeError("the bounce histogram does not sum to the path "
                           "rays traced")
    if ref_mse > floor["gate"]:
        raise RuntimeError("the detailed_stats frame differs from the rtjax "
                           "render beyond the noise floor")
    if set(captured) != {"closest", "anyhit"}:
        raise RuntimeError(f"launch {CAPTURE_AT} of the stats frame was not "
                           "captured")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    out = {"phase3": _check_counting("kernel", _persist_kinds(
        scene.tables, cl, ah), card)}
    tab, cl = captured["closest"]
    _, ah = captured["anyhit"]
    out["in_frame"] = _check_counting(f"in-frame launch {CAPTURE_AT}",
                                      _persist_kinds(tab, cl, ah), card)
    default, stats = _stats_ptxas()
    return out, c["persist_stats"], dict(default=default, stats=stats)


def _persist_kinds(tab, cl, ah):
    """:func:`_check_counting`'s kinds of the persist kernels on ``tab``
    with the rays ``cl`` / ``ah``."""
    from rtjax_torch.kernels import persist as P
    return {"closest": ((tab, cl["o"], cl["d"], cl["tmax"], cl["active"]),
                        P.persist_traverse_closest,
                        P.persist_traverse_closest_ref, RAY_IN, CLOSEST_OUT,
                        tab, None, 0),
            "anyhit": ((tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                        ah["active"]), P.persist_traverse_anyhit,
                       P.persist_traverse_anyhit_ref, RAY_IN + EXCLUDE, 1,
                       tab, None, 0)}


def _mean_u8(fb, width, height):
    import numpy as np
    from rtjax_torch.render.film import to_u8
    return float(to_u8(fb.cpu().numpy(), width, height)
                 .astype(np.float64).mean() / 255.0)


def phase8_modes(scene, camera, card, floor):
    """(c) cornell_bunny at MODE_SIZE^2 @ MODE_SPP under
    ``reference_parity`` and under the default estimator, seed 1, counts
    from zero around each (persist kernels alone, once an iteration): the
    parity frame's mean within PARITY_MEAN_TOL of the parity artifact's,
    and its ratio to the default frame's within PARITY_RATIO_TOL of
    PARITY_RATIO; then a ``one_sample_mis`` headline frame at the
    headline gate against the artifact, its any-hit launches N rays
    each."""
    import dataclasses

    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.render.film import read_ppm
    base = RenderConfig(width=MODE_SIZE, height=MODE_SIZE,
                        num_samples=MODE_SPP, max_bounces=BOUNCES)
    means = {}
    for name, cfg in (("parity", dataclasses.replace(
            base, reference_parity=True)), ("default", base)):
        runs, c = _drive(scene, camera, cfg, (1,))
        secs, fb, st = runs[0]
        means[name] = _mean_u8(fb, MODE_SIZE, MODE_SIZE)
        print(f"[modes {name}] {card}: {MODE_SIZE}x{MODE_SIZE} @ {MODE_SPP} "
              f"spp, seed 1: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {secs:.3f} s, "
              f"{st['rays_traced'] / secs / 1e6:.3f} Mrays/s; image mean "
              f"{means[name]:.5f}; launches {c['persist']}")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the persist "
                               "kernels alone, once an iteration")
    art = float(read_ppm(PARITY_ARTIFACT).astype(np.float64).mean() / 255.0)
    fixed = float(read_ppm(FIXED_ARTIFACT).astype(np.float64).mean() / 255.0)
    ratio = means["parity"] / means["default"]
    print(f"[modes parity] mean {means['parity']:.5f} vs "
          f"{os.path.relpath(PARITY_ARTIFACT, ROOT)} {art:.5f} (difference "
          f"{means['parity'] - art:+.5f}, gate {PARITY_MEAN_TOL}); parity / "
          f"default {ratio:.5f} (BASELINE {PARITY_RATIO}, gate "
          f"{PARITY_RATIO_TOL}); the default frame vs "
          f"{os.path.relpath(FIXED_ARTIFACT, ROOT)} {fixed:.5f} (difference "
          f"{means['default'] - fixed:+.5f})")
    if abs(means["parity"] - art) > PARITY_MEAN_TOL \
            or abs(ratio - PARITY_RATIO) > PARITY_RATIO_TOL:
        raise RuntimeError("the parity frame is outside its band")

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                       max_bounces=BOUNCES, one_sample_mis=True)
    runs, c = _drive(scene, camera, cfg, (2,))
    secs, fb, st = runs[0]
    ref_mse = float(np.mean((_u8_image(fb) - floor["ref"]) ** 2))
    print(f"[modes one_sample_mis] {card}: {WIDTH}x{HEIGHT} @ {SPP} spp, "
          f"seed 2: {st['iterations']} iterations, {st['rays_traced']:.0f} "
          f"rays, {secs:.3f} s; MSE vs {os.path.relpath(ARTIFACT, ROOT)} "
          f"{ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
          f"{c['persist']}")
    if not _only_set(c, "persist", st["iterations"]) or \
            ref_mse > floor["gate"]:
        raise RuntimeError("the one_sample_mis frame failed its gate")
    return dict(means, artifact=art, ratio=ratio, osm_mse=ref_mse)


def phase8_config5(scene, camera, card):
    """(d) Eval config 5 through ``render_checkpointed``: 8 spp as 2
    batches of 4, saved after each under build/rtjax_torch/; 12 spp
    resuming at batch 2 (one batch rendered); an uninterrupted 12-spp run
    of the same seed within C5_RTOL / C5_ATOL of the resumed image; then
    C5_SUSTAINED_SPP spp as batches of C5_BATCH_SPP, saved at the end,
    with the rays per spp from a 4-spp probe frame
    (benchmarks/run_configs.py:243-250).  Counts from zero around each
    run: the persist kernels alone."""
    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render import wavefront
    from rtjax_torch.render.checkpoint import render_checkpointed
    from rtjax_torch.render.film import write_ppm

    def cfg(spp):
        return RenderConfig(width=C5_WIDTH, height=C5_HEIGHT,
                            num_samples=spp, max_bounces=C5_BOUNCES)

    batches = []
    orig = wavefront.render_frame_linear

    def count(*args, **kw):
        batches.append(1)
        return orig(*args, **kw)

    def run(label, c, path, batch_spp, save_every):
        batches.clear()
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavefront.render_frame_linear = count
        try:
            img = render_checkpointed(scene, camera, c, path,
                                      batch_spp=batch_spp,
                                      save_every=save_every, verbose=False)
        finally:
            wavefront.render_frame_linear = orig
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _read_counts()
        print(f"[config5 {label}] {card}: {C5_WIDTH}x{C5_HEIGHT} @ "
              f"{c.num_samples} spp in batches of {batch_spp}: "
              f"{len(batches)} batches rendered, {secs:.3f} s; launches "
              f"{counts['persist']}")
        if not _only_set(counts, "persist"):
            raise RuntimeError(f"config 5 {label} did not run the persist "
                               "kernels alone")
        if not bool(torch.isfinite(img).all()) or bool((img < 0).any()):
            raise RuntimeError("config 5's image is not finite and "
                               "non-negative")
        return img, secs, len(batches)

    path = str(_build.BUILD_DIR / "config5.npz")
    if os.path.exists(path):
        os.remove(path)
    run("8 spp", cfg(8), path, 4, 1)
    with np.load(path) as ck:
        done8 = int(ck["batches_done"])
    resumed, _, n_resumed = run("12 spp resumed", cfg(12), path, 4, 1)
    with np.load(path) as ck:
        done12 = int(ck["batches_done"])
    full, _, _ = run("12 spp uninterrupted", cfg(12), None, 4, 1)
    close = bool(torch.allclose(resumed, full, rtol=C5_RTOL, atol=C5_ATOL))
    rel = float(((resumed - full).abs() / full.abs().clamp(min=1e-30))
                .max())
    print(f"[config5 resume] batches done {done8} then {done12}, batches "
          f"rendered on resume {n_resumed}; resumed vs uninterrupted: max "
          f"|d| {float((resumed - full).abs().max()):.3e}, max relative "
          f"{rel:.3e}, equal bit for bit {bool(torch.equal(resumed, full))},"
          f" within rtol {C5_RTOL} / atol {C5_ATOL} {close}")
    if (done8, done12, n_resumed) != (2, 3, 1) or not close:
        raise RuntimeError("config 5 did not resume to the uninterrupted "
                           "image")
    write_ppm(_build.BUILD_DIR / "config5_12spp.ppm", resumed.cpu().numpy(),
              C5_WIDTH, C5_HEIGHT, binary=True)

    probe, c = _drive(scene, camera, cfg(4), (1,))
    p_secs, _, p_st = probe[0]
    rays_per_spp = p_st["rays_traced"] / 4
    print(f"[config5 probe] {card}: 4 spp, {p_st['iterations']} iterations,"
          f" {p_st['rays_traced']:.0f} rays, {p_secs:.3f} s, "
          f"{p_st['rays_traced'] / p_secs / 1e6:.3f} Mrays/s, pool "
          f"{cfg(4).pool_size}")
    if not _only_set(c, "persist", p_st["iterations"]):
        raise RuntimeError("config 5's probe did not run the persist "
                           "kernels alone")
    path = str(_build.BUILD_DIR / "config5_sustained.npz")
    if os.path.exists(path):
        os.remove(path)
    _, secs, n = run(f"{C5_SUSTAINED_SPP} spp sustained",
                     cfg(C5_SUSTAINED_SPP), path, C5_BATCH_SPP,
                     C5_SUSTAINED_SPP // C5_BATCH_SPP)
    rays = rays_per_spp * C5_SUSTAINED_SPP
    mrays = rays / secs / 1e6
    print(f"[config5 sustained] {card}: {C5_WIDTH}x{C5_HEIGHT} @ "
          f"{C5_SUSTAINED_SPP} spp as {n} batches of {C5_BATCH_SPP} "
          f"(batch pool {cfg(C5_BATCH_SPP).pool_size}): {secs:.3f} s, "
          f"~{rays:.4g} rays (probe's rays per spp x spp), {mrays:.3f} "
          f"Mrays/s sustained")
    return dict(seconds=secs, mrays=mrays, rays=rays, resume_max_rel=rel)


def _stats_rows(stats, launches):
    """The kernels line's rows of the two stats instances."""
    rows = {}
    for kind in ("closest", "anyhit"):
        r = stats["phase3"][kind]
        rows[kind] = dict(
            name=f"{KERNELS[kind]['name']} (with_stats)",
            replaces=KERNELS[kind]["replaces"], route="cuda", source=SOURCE,
            launches=launches[kind], max_abs_err=max(
                stats[s][kind]["max_abs_err"] for s in stats),
            ms=r["ms"], plain_ms=r["plain_ms"], library_ms=None,
            **{k: r[k] for k in _BOUND_KEYS}, share=r["share"],
            default_ms=r["default_ms"], cost=r["cost"],
            timed_launches=2 * REPS,
            ab={s: {k: stats[s][kind][k] for k in (
                "stats_device_ms", "default_device_ms", "cost", "counts")}
                for s in stats},
            note="the persist kernel with its node visits and leaf rows "
                 "counted (detailed_stats); bound as the default instance's;"
                 " plain_ms the plain walk counting")
    return rows


# ---------------------------------------------------------------- phase 9
# rtjax's binary-BVH walk (traversal="xla"), the sort keys, the unsorted
# engine and the wide sort bundle
BINARY_KERNELS = {
    "closest": dict(name="binary_traverse_closest",
                    replaces="rtjax/kernels/traversal.py:210"),
    "anyhit": dict(name="binary_traverse_anyhit",
                   replaces="rtjax/kernels/traversal.py:240"),
}
BINARY_SOURCE = "rtjax_torch/csrc/binary_traverse.cu"
# a binary walk's bound, counted from csrc/binary_traverse.cu's loads and
# arithmetic: a node-pair step reads two boxes (24 B each) and the two
# children's left_first and num_prims words (64 B), a triangle test
# p0, e1, e2 and n (48 B)
PAIR_BYTES = 64
TRI_BYTES = 48
OPS_BSLAB = 23  # a slab test: 6 selects, 6 mul, 6 add, 4 min/max, 1 compare
BIN_CLOSEST_OUT = 29   # hit, t, u, v, prim, normal
RAY_FLAGS = 1          # the active flag, read for every ray


def _binary_bound(work, n, n_active, in_bytes, out_bytes):
    """The least time for a binary walk of ``n`` rays (``n_active``
    active) whose plain walk counted ``work``: each ray's flag and results
    and an active ray's inputs, and each node pair and triangle the walk
    read, once; two slab tests a step and one Moeller-Trumbore test a
    triangle tested.  ``loads`` is the bytes the kernel loads, re-reads
    included."""
    pairs = int(work["pair_seen"].sum())
    tris = int(work["tri_seen"].sum())
    nbytes = n * (RAY_FLAGS + out_bytes) + n_active * in_bytes \
        + pairs * PAIR_BYTES + tris * TRI_BYTES
    ops = 2 * OPS_BSLAB * work["steps"] + OPS_TRI * work["tri_tests"]
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_us=max(t_ops, t_bytes)
                * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, bytes=nbytes, pairs=pairs, tris=tris,
                loads=work["steps"] * PAIR_BYTES + work["tri_tests"]
                * TRI_BYTES)


def _binary_text(work, b):
    return (f"work: {work['steps']} node-pair steps, {work['leafs']} leaf "
            f"visits, {work['tri_tests']} triangles tested, {b['pairs']} "
            f"node pairs and {b['tris']} triangles read ({b['loads']} B "
            f"loaded, re-reads included); bound {b['bound_us']:.3f} us by "
            f"{b['bound_by']} ({b['bytes']} B at {PEAK_BYTES / 1e12} TB/s, "
            f"{b['ops']} float ops at {PEAK_FLOPS / 1e12} TFLOP/s)")


def phase9_binary_kernels(scene, camera, card):
    """(a) Both binary-walk kernels against their plain versions on phase
    3's rays over the headline scene's binary BVH (2^18 closest-hit, 2^19
    any-hit rays): zero mismatches in hit, t, u, v, prim, normal and
    occlusion, correct dead lanes; hits, t and occlusion equal to the
    persist kernels' on the same rays (equal-t ties, where the two walks
    keep another prim, counted); device time per launch, one call, one
    plain call; the plain walk's counts and the bound; the stats
    instances' counts equal to the plain walk's and their results the
    default instances' bit for bit; the four instances' ptxas lines."""
    import torch
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import traversal as T
    for name, res in _build.ptxas_report(_build.binary_library()):
        print(f"[binary ptxas] {name}: {res}")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    bvh, tris = scene.bvh, scene.tris
    print(f"[binary scene] {bvh.num_nodes} nodes, depth {bvh.max_depth}, "
          f"stack {T.stack_len(bvh)} entries a ray")
    out = {}

    args = (bvh, tris, cl["o"], cl["d"], cl["tmax"], cl["active"])
    work = T.new_work()
    ref, plain_ms = _timed_ms(lambda: T.traverse_closest_ref(*args,
                                                             work=work))
    got = T.traverse_closest(*args)   # the first call loads the library
    _, call_ms = _timed_ms(lambda: T.traverse_closest(*args))
    hk, tk, uk, vk, pk, nk = got
    dead = ~cl["active"]
    names = ("hit", "t", "u", "v", "prim", "normal")
    mis = {k: int((a != b).sum()) for k, a, b in zip(names[:5], got, ref)}
    mis["normal"] = int(sum((a != b).sum() for a, b in zip(nk, ref[5])))
    mis["dead"] = int(not (
        (~hk[dead]).all() and torch.isinf(tk[dead]).all()
        and (uk[dead] == 0).all() and (vk[dead] == 0).all()
        and (pk[dead] == -1).all() and all((c[dead] == 0).all()
                                           for c in nk)))
    sk = T.traverse_closest(*args, with_stats=True)
    torch.cuda.synchronize()
    smis = sum(int((a != b).sum()) for a, b in zip(sk[:5], got[:5])) + \
        int(sum((a != b).sum() for a, b in zip(sk[5], nk)))
    counts = (int(sk[6][0]), int(sk[6][1]))
    hp, tp, pp, _ = P.persist_traverse_closest(scene.tables, *args[2:])
    both = hk & hp
    vs = {"hit": int((hk != hp).sum()), "t": int((tk[both] != tp[both])
                                                  .sum()),
          "ties": int((pk[both] != pp[both]).sum())}
    ms = _launch_ms(lambda: T.traverse_closest(*args))
    n, n_act = cl["tmax"].numel(), int(cl["active"].sum())
    b = _binary_bound(work, n, n_act, RAY_IN, BIN_CLOSEST_OUT)
    out["closest"] = dict(max_abs_err=float((tk[both] - tp[both]).abs().max())
                          if bool(both.any()) else 0.0, ms=ms[0],
                          ms_range=ms[1:], call_ms=call_ms,
                          plain_ms=plain_ms, share=b["bound_ms"] / ms[0],
                          counts=counts, **b)
    print(f"[binary closest] {card}: {n} rays ({n_act} active), "
          f"{int(hk.sum())} hits; mismatches vs plain {mis}; stats instance:"
          f" counts {counts} vs plain ({work['steps']}, {work['leafs']}), "
          f"{smis} result mismatches; vs persist kernels {vs}; device "
          f"{ms[0]:.4f} ms a launch ({ms[1]:.4f}-{ms[2]:.4f}), one call "
          f"{call_ms:.4f} ms, plain {plain_ms:.1f} ms; {_binary_text(work, b)}"
          f"; {100 * out['closest']['share']:.2f}% of the bound")
    if any(mis.values()) or smis or vs["hit"] or vs["t"] or \
            counts != (work["steps"], work["leafs"]) or not bool(hk.any()):
        raise RuntimeError("binary closest-hit kernel disagrees with its "
                           "plain version or the persist kernel")

    args = (bvh, tris, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
            ah["active"])
    work = T.new_work()
    op, plain_ms = _timed_ms(lambda: T.traverse_anyhit_ref(*args, work=work))
    ok_ = T.traverse_anyhit(*args)
    _, call_ms = _timed_ms(lambda: T.traverse_anyhit(*args))
    so, st = T.traverse_anyhit(*args, with_stats=True)
    counts = (int(st[0]), int(st[1]))
    opp = P.persist_traverse_anyhit(scene.tables, *args[2:])
    torch.cuda.synchronize()
    mis = {"occlusion": int((ok_ != op).sum()),
           "dead": int(bool(ok_[~ah["active"]].any())),
           "stats_results": int((so != ok_).sum()),
           "vs_persist": int((ok_ != opp).sum())}
    ms = _launch_ms(lambda: T.traverse_anyhit(*args))
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _binary_bound(work, n, n_act, RAY_IN + EXCLUDE, 1)
    out["anyhit"] = dict(max_abs_err=float(mis["occlusion"]), ms=ms[0],
                         ms_range=ms[1:], call_ms=call_ms, plain_ms=plain_ms,
                         share=b["bound_ms"] / ms[0], counts=counts, **b)
    print(f"[binary anyhit] {card}: {n} rays ({n_act} active), "
          f"{int(ok_.sum())} occluded; mismatches {mis}; stats instance "
          f"counts {counts} vs plain ({work['steps']}, {work['leafs']}); "
          f"device {ms[0]:.4f} ms a launch ({ms[1]:.4f}-{ms[2]:.4f}), one "
          f"call {call_ms:.4f} ms, plain {plain_ms:.1f} ms; "
          f"{_binary_text(work, b)}; {100 * out['anyhit']['share']:.2f}% of "
          f"the bound")
    if any(mis.values()) or counts != (work["steps"], work["leafs"]) or \
            not bool(ok_.any()):
        raise RuntimeError("binary any-hit kernel disagrees with its plain "
                           "version or the persist kernel")
    return out


# (b) and (c): the headline frame under each mode, and the persist frame it
# is timed beside
SORT_KEYS = ("morton", "prim", "prim_pos", "normal_pos", "adaptive",
             "morton_pos10")
# (d) the wide bundle: one frame above 2^21 pixels, and the two compact
# frames at half its width it is held to
WIDE_SIZE, WIDE_SPP = 2048, 4
HALF_SIZE, HALF_SPP = 1024, 16


def _headline_cfg(**change):
    from rtjax_torch import RenderConfig
    return RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                        max_bounces=BOUNCES, **change)


def _gate(label, fb, floor):
    """Phase 4's noise-floor gate of a headline frame: its MSE (8 bit) to
    the rtjax artifact."""
    import numpy as np
    ref_mse = float(np.mean((_u8_image(fb) - floor["ref"]) ** 2))
    if ref_mse > floor["gate"]:
        raise RuntimeError(f"{label}: image differs from the rtjax render "
                           f"beyond the noise floor ({ref_mse:.3e} > "
                           f"{floor['gate']:.3e})")
    return ref_mse


def phase9_xla_frames(scene, camera, card, floor):
    """(b) The headline frame under traversal="xla" (the binary walk, the
    unsorted engine), seeds 2 and 3, alternated with persist frames of the
    same seeds (xla, persist, persist, xla), counts from zero around each:
    the xla frames launch the two binary kernels once an iteration and
    nothing else; each image at phase 4's gate.  Returns the binary
    kernels' launches over the two xla frames."""
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm
    launches = {"closest": 0, "anyhit": 0}
    secs = {"xla": [], "persist": []}
    for mode, seed in (("xla", 2), ("persist", 2), ("persist", 3),
                       ("xla", 3)):
        cfg = _headline_cfg(traversal="xla") if mode == "xla" \
            else _headline_cfg()
        runs, c = _drive(scene, camera, cfg, (seed,))
        sec, fb, st = runs[0]
        ref_mse = _gate(f"traversal={mode} seed {seed}", fb, floor)
        kset = "binary" if mode == "xla" else "persist"
        print(f"[xla frame {mode} seed {seed}] {card}: {WIDTH}x{HEIGHT} @ "
              f"{SPP} spp: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
              f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; MSE vs the "
              f"artifact {ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
              f"{c[kset]}")
        if not _only_set(c, kset, st["iterations"]):
            raise RuntimeError(f"the traversal={mode} frame did not run "
                               f"the {kset} kernels alone, once an iteration")
        secs[mode].append(sec)
        if mode == "xla":
            for k in launches:
                launches[k] += c["binary"][k]
            write_ppm(_build.BUILD_DIR / f"xla_seed{seed}.ppm",
                      fb.cpu().numpy(), WIDTH, HEIGHT, binary=True)
    print(f"[xla frames] {card}: frame seconds xla {secs['xla']}, persist "
          f"{secs['persist']}")
    return launches, secs


def phase9_sort_keys(scene, camera, card, floor):
    """(c) The headline frame (seed 2) under each sort key but the default
    and once with sort_rays=False, counts from zero: the persist kernels
    alone, once an iteration; each image at phase 4's gate."""
    out = {}
    for name, change in ([(k, dict(sort_key=k)) for k in SORT_KEYS]
                         + [("no_sort", dict(sort_rays=False))]):
        runs, c = _drive(scene, camera, _headline_cfg(**change), (2,))
        sec, fb, st = runs[0]
        ref_mse = _gate(name, fb, floor)
        print(f"[sort mode {name}] {card}: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
              f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; MSE vs the "
              f"artifact {ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
              f"{c['persist']}")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the persist "
                               "kernels alone, once an iteration")
        out[name] = sec
    return out


def phase9_wide_bundle(scene, camera, card):
    """(d) cornell_bunny at WIDE_SIZE^2 @ WIDE_SPP (above 2^21 pixels: the
    wide sort bundle) and at HALF_SIZE^2 @ HALF_SPP (the compact bundle),
    seeds 2 and 3, counts from zero (persist kernels alone, once an
    iteration).  Gate: the wide frame's linear radiance box-downsampled
    2x2 to HALF_SIZE^2 within 2x the seed-to-seed MSE of the two compact
    frames of the seed-2 compact frame."""
    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import wavefront as WF
    import torch
    frames = {}
    for size, spp, seed in ((WIDE_SIZE, WIDE_SPP, 2), (HALF_SIZE, HALF_SPP, 2),
                            (HALF_SIZE, HALF_SPP, 3)):
        cfg = RenderConfig(width=size, height=size, num_samples=spp,
                           max_bounces=BOUNCES)
        compact = WF._compact_bundle_ok(scene, cfg)
        if compact != (size == HALF_SIZE):
            raise RuntimeError(f"{size}x{size}: _compact_bundle_ok is "
                               f"{compact}")
        _zero_counts()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb, st = WF.render_frame_linear(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        c = _read_counts()
        if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
            raise RuntimeError("framebuffer has non-finite or negative "
                               "values")
        print(f"[wide bundle {size}x{size} @ {spp} spp seed {seed}] {card}:"
              f" {'compact' if compact else 'wide'} bundle, pool "
              f"{cfg.pool_size}, {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
              f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; launches "
              f"{c['persist']}")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError("the wide-bundle frames did not run the "
                               "persist kernels alone, once an iteration")
        frames[size, seed] = (fb / spp).cpu().numpy().astype(np.float64) \
            .reshape(size, size, 3)
    w = frames[WIDE_SIZE, 2]
    down = w.reshape(HALF_SIZE, 2, HALF_SIZE, 2, 3).mean(axis=(1, 3))
    c2, c3 = frames[HALF_SIZE, 2], frames[HALF_SIZE, 3]
    seed_mse = float(np.mean((c2 - c3) ** 2))
    wide_mse = float(np.mean((down - c2) ** 2))
    print(f"[wide bundle image] linear radiance: wide {WIDE_SIZE}^2 "
          f"downsampled 2x2 vs compact seed 2 MSE {wide_mse:.4e}, compact "
          f"seed-to-seed MSE {seed_mse:.4e} (gate {2 * seed_mse:.4e}); means"
          f" {down.mean():.5f} {c2.mean():.5f} {c3.mean():.5f}")
    if not 0.0 < wide_mse <= 2.0 * seed_mse:
        raise RuntimeError("the wide-bundle frame differs from the compact "
                           "frames beyond the noise floor")
    return dict(wide_mse=wide_mse, seed_mse=seed_mse)


def phase9_config4_xla(scene, camera, card, c4_floor):
    """(e) Eval config 4 under traversal="xla" (rtjax's per-instance loop
    over the binary walk), seed 2, counts from zero: only the binary
    kernels, 1 + instances launches of each an iteration; the image within
    2x phase 6(a)'s seed-to-seed MSE (plus the 8-bit term) of its seed-2
    frame."""
    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=C4_SPP,
                       max_bounces=C4_BOUNCES, traversal="xla")
    runs, c = _drive(scene, camera, cfg, (2,))
    sec, fb, st = runs[0]
    per = 1 + scene.instances.num
    img = _u8_image(fb)
    mse_ = float(np.mean((img - c4_floor["img_a2"]) ** 2))
    gate = 2.0 * c4_floor["seed_mse"] + c4_floor["quant"]
    write_ppm(_build.BUILD_DIR / "config4_xla.ppm", fb.cpu().numpy(), WIDTH,
              HEIGHT, binary=True)
    print(f"[config4 xla] {card}: {WIDTH}x{HEIGHT} @ {C4_SPP} spp, "
          f"{C4_BOUNCES} bounces: {st['iterations']} iterations, "
          f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
          f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; launches "
          f"{c['binary']} ({per} a kernel an iteration expected); MSE vs "
          f"repass seed 2 {mse_:.3e} (gate {gate:.3e})")
    if not _only(c, "binary") or c["plain"] or any(
            v != per * st["iterations"] for v in c["binary"].values()):
        raise RuntimeError("config 4 under traversal='xla' did not run the "
                           "binary kernels alone, 1 + instances times an "
                           "iteration")
    if mse_ > gate:
        raise RuntimeError("config 4 under traversal='xla' differs from "
                           "repass beyond the noise floor")
    return dict(seconds=sec, mse=mse_)


def _binary_rows(kernels, launches):
    """The kernels line's rows of the two binary-walk kernels."""
    rows = []
    for kind in ("closest", "anyhit"):
        r = kernels[kind]
        rows.append(dict(
            BINARY_KERNELS[kind], route="cuda", source=BINARY_SOURCE,
            launches=launches[kind], max_abs_err=r["max_abs_err"],
            ms=r["ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
            library_ms=None, **{k: r[k] for k in _BOUND_KEYS},
            share=r["share"], timed_launches=REPS,
            note="rtjax's binary-BVH walk (an XLA while_loop, no "
                 "pallas_call); launches over phase 9(b)'s two "
                 "traversal='xla' headline frames"))
    return rows


# --------------------------------------------------------------- phase 10
# detailed_stats under every walker, and multi-GPU rendering
# ptxas registers of the packet, lane and two-level kernels' default
# instances before their stats instances were added (phase 1 of this
# script on the card's toolkit, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
# they must not change
DEFAULT_WALK_REGISTERS = {
    "packet closest, width 8": 72, "packet closest, width 16": 72,
    "packet any-hit, width 8": 60, "packet any-hit, width 16": 62,
    "lane closest, width 8": 95, "lane closest, width 16": 95,
    "lane any-hit, width 8": 79, "lane any-hit, width 16": 80,
    "two-level fetch closest, width 8, records global": 121,
    "two-level fetch closest, width 8, records staged": 123,
    "two-level fetch closest, width 16, records global": 127,
    "two-level fetch closest, width 16, records staged": 125,
    "two-level fetch any-hit, width 8, records global": 114,
    "two-level fetch any-hit, width 8, records staged": 116,
    "two-level fetch any-hit, width 16, records global": 122,
    "two-level fetch any-hit, width 16, records staged": 123}
# (d) and (e): two ranks on the one card; (e) eval config 5 for 16 spp as
# two batches
SHARDED_SPP = SPP
C5_SHARDED_SPP, C5_SHARDED_BATCH = 16, 8
RANK_TIMEOUT = 600


def _walk_stats_ptxas():
    """``({label: registers} of the packet, lane and two-level default
    instances, {label: registers} of their stats instances)``, printed, and
    the default ones held to DEFAULT_WALK_REGISTERS."""
    from rtjax_torch.kernels import _build
    default, stats = {}, {}
    reports = [(_group_label(name), res) for name, res in
               _build.ptxas_report(_build.packet_library())] + \
        [(_kernel_label(name), res) for name, res in
         _build.ptxas_report(_build.wide_inst_library())]
    for label, res in reports:
        if label in DEFAULT_WALK_REGISTERS:
            default[label] = _registers(res)
        elif " stats " in f" {label} ":
            stats[label] = _registers(res)
    print(f"[walk stats ptxas] default instances {default}; stats instances "
          f"{stats}; before the stats instances {DEFAULT_WALK_REGISTERS}")
    if len(stats) != len(DEFAULT_WALK_REGISTERS):
        raise RuntimeError("ptxas did not report a stats instance for every "
                           "default instance")
    if default != DEFAULT_WALK_REGISTERS:
        raise RuntimeError("the packet, lane or two-level default instances'"
                           " registers changed")
    return default, stats


def phase10_stats_kernels(scene, camera, c4_scene, c4_camera, group, card):
    """(a) The packet and lane kernels' stats instances on phase 3's rays
    (their bound the default rows', ``group``), the two-level kernels'
    on phase 5's field rays over config 4 and over MANY_INST instances;
    then the ptxas registers.  Returns ``({(walk, kind): row}, registers)``,
    the rows from the first ray set of each."""
    import torch
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.kernels import wide_inst as WI
    from rtjax_torch.scenes import instanced_bunnies
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    tab = scene.tables
    c_args = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    a_args = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    out = {}
    for walk, size, closest, anyhit in (
            ("packet", WD.PACKET, WD.wide_traverse_closest,
             WD.wide_traverse_anyhit),
            ("lane", L.LANE, L.lane_traverse_closest,
             L.lane_traverse_anyhit)):
        kinds = {
            "closest": (c_args, closest, lambda *a, work, g=size:
                        WD.group_traverse_closest_ref(*a, g, work=work),
                        RAY_IN, CLOSEST_OUT, tab, group[walk, "closest"], 0),
            "anyhit": (a_args, anyhit, lambda *a, work, g=size:
                       WD.group_traverse_anyhit_ref(*a, g, work=work),
                       RAY_IN + EXCLUDE, 1, tab, group[walk, "anyhit"], 0)}
        for kind, r in _check_counting(f"{walk} kernel", kinds, card).items():
            out[walk, kind] = r
    gen = torch.Generator(device="cuda").manual_seed(4321)
    many, many_camera = instanced_bunnies("cuda", n_inst=MANY_INST)
    for label, sc, cam in (("two-level", c4_scene, c4_camera),
                           (f"two-level {MANY_INST} instances", many,
                            many_camera)):
        cl, ah = _field_rays(sc, cam, gen)
        it = sc.inst_tables
        records = it.num_instances * AFF_RECORD
        kinds = {
            "closest": ((it, cl["o"], cl["d"], cl["tmax"], cl["active"]),
                        WI.wide_traverse_closest_inst,
                        WI.wide_traverse_closest_inst_ref, RAY_IN, INST_OUT,
                        it.wide, None, records),
            "anyhit": ((it, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                        ah["active"]), WI.wide_traverse_anyhit_inst,
                       WI.wide_traverse_anyhit_inst_ref, RAY_IN + EXCLUDE, 1,
                       it.wide, None, records)}
        for kind, r in _check_counting(label, kinds, card).items():
            out.setdefault(("two_level", kind), r)
            out["two_level", kind].setdefault("ab", {})[label] = {
                k: r[k] for k in ("stats_device_ms", "default_device_ms",
                                  "cost", "counts")}
    return out, _walk_stats_ptxas()


def _expect_only(counts, want):
    """True when the launches in ``counts`` are exactly ``want`` (``{(set,
    kind): n}``, every other count 0) and no plain version ran."""
    got = {(k, kind): counts[k][kind] for k in _KERNEL_SETS
           for kind in ("closest", "anyhit")}
    expect = {key: want.get(key, 0) for key in got}
    return got == expect and counts["plain"] == 0


def phase10_stats_frames(scene, camera, c4_scene, c4_camera, card, floor,
                         c4_floor):
    """(b) detailed_stats frames, counts from zero around each: the
    headline under walker="packet" (and the packet any hit) and under
    walker="lane" with anyhit_walker="packet", each at phase 4's gate; config
    4 under two_level="kernel", within 2x phase 6(a)'s seed-to-seed MSE
    plus the 8-bit term of its repass frame.  Each frame launches its
    kernels' stats instances alone, once an iteration, and its histogram
    sums to the path rays.  Returns ``{(walk, kind): launches}``."""
    import dataclasses

    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm
    launches = {}
    c4 = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=C4_SPP,
                      max_bounces=C4_BOUNCES)
    for label, sc, cam, cfg, want in (
            ("packet", scene, camera,
             _headline_cfg(walker="packet", anyhit_walker="packet"),
             {("packet_stats", "closest"), ("packet_stats", "anyhit")}),
            ("lane", scene, camera,
             _headline_cfg(walker="lane", anyhit_walker="packet"),
             {("lane_stats", "closest"), ("packet_stats", "anyhit")}),
            ("two-level", c4_scene, c4_camera,
             dataclasses.replace(c4, two_level="kernel"),
             {("two_level_stats", "closest"),
              ("two_level_stats", "anyhit")})):
        runs, c = _drive(sc, cam, dataclasses.replace(
            cfg, detailed_stats=True), (2,))
        secs, fb, st = runs[0]
        its = st["iterations"]
        hist = st["bounce_histogram"]
        if label == "two-level":
            img = _u8_image(fb)
            err = float(np.mean((img - c4_floor["img_a2"]) ** 2))
            gate = 2.0 * c4_floor["seed_mse"] + c4_floor["quant"]
        else:
            err, gate = _gate(f"{label} stats frame", fb, floor), \
                floor["gate"]
        write_ppm(_build.BUILD_DIR / f"stats_{label}.ppm", fb.cpu().numpy(),
                  WIDTH, HEIGHT, binary=True)
        print(f"[stats frame {label}] {card}: {WIDTH}x{HEIGHT} @ "
              f"{cfg.num_samples} spp, detailed_stats, seed 2: {its} "
              f"iterations, {st['rays_traced']:.0f} rays, {secs:.3f} s; "
              f"histogram {hist.tolist()} (sum {int(hist.sum())}); node "
              f"steps {st['node_steps']}, leaf visits {st['leaf_visits']} "
              f"(any hit {st['anyhit_steps']} / {st['anyhit_visits']}); MSE "
              f"{err:.3e} (gate {gate:.3e}); launches "
              f"{ {k: v for k, v in c.items() if k != 'plain'} }")
        if not _expect_only(c, {key: its for key in want}):
            raise RuntimeError(f"the {label} detailed_stats frame did not "
                               "run its stats instances alone, once an "
                               "iteration")
        if err > gate:
            raise RuntimeError(f"the {label} detailed_stats frame differs "
                               "beyond its gate")
        if int(hist[0]) != cfg.num_pixels * cfg.num_samples or min(
                st["node_steps"], st["leaf_visits"], st["anyhit_steps"]) <= 0:
            raise RuntimeError(f"the {label} detailed_stats frame's counts "
                               "are wrong")
        for kset, kind in want:
            walk = {"packet_stats": "packet", "lane_stats": "lane",
                    "two_level_stats": "two_level"}[kset]
            launches[walk, kind] = c[kset][kind]
    launches.setdefault(("lane", "anyhit"), 0)
    return launches


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(job, world):
    """Run ``world`` processes of ``python3 chip_smoke.py --rank-job job``
    (:func:`_rank_job`), all started together and all stopped before it
    returns; their saved results, by rank."""
    import torch
    from rtjax_torch.kernels import _build
    coord = f"127.0.0.1:{_free_port()}"
    outs = [_build.BUILD_DIR / f"rank_{job}_{r}.pt" for r in range(world)]
    for o in outs:
        if o.exists():
            o.unlink()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-job", job,
         str(r), str(world), coord, str(outs[r])], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=RANK_TIMEOUT)
            for line in text.splitlines():
                if line.startswith("[") or "Error" in line:
                    print(f"  rank {r}: {line}")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of the {job} run exited with "
                                   f"{p.returncode}:\n{text[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o) for o in outs]


def _rank_job(job, rank, world, coord, out):
    """One process of phase 10's multi-process runs (``python3
    chip_smoke.py --rank-job JOB RANK WORLD HOST:PORT OUT``), joined by
    ``init_multihost``: "nccl", the default backend at a world of one;
    "gloo", the gloo backend on the card.  Renders the headline frame
    through ``render_frame_linear_sharded`` (seed 2, after a seed-1
    warm-up frame; and, at a world of
    one, the unsharded frame from ``rank_generator(2, 0)``; under gloo,
    rank 0 an unsharded frame of the same spp, timed beside it) and, under
    gloo, eval config 5 through ``render_checkpointed(mesh=)``
    (uninterrupted, then a file one batch short resumed); each frame with
    its launch counts from zero and the rank's own stats; saves them to
    ``out``."""
    import hashlib

    import torch
    import torch.distributed as dist
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.parallel import (init_multihost, make_mesh,
                                      rank_generator,
                                      render_frame_linear_sharded)
    from rtjax_torch.render import wavefront
    from rtjax_torch.render.checkpoint import render_checkpointed
    from rtjax_torch.scenes import cornell_bunny
    dev = init_multihost(coord, world, rank,
                         backend=None if job == "nccl" else "gloo")
    mesh = make_mesh(dev)
    scene, camera = cornell_bunny(device=dev)
    local = []
    orig = wavefront.render_frame_linear

    def keep(*args, **kw):
        fb, st = orig(*args, **kw)
        local.append(st)
        return fb, st

    wavefront.render_frame_linear = keep

    def timed(fn):
        local.clear()
        _zero_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, list(local), _read_counts()

    res = dict(backend=dist.get_backend(), device=str(dev), size=mesh.size,
               rank=mesh.rank)
    cfg = _headline_cfg()
    # a warm-up frame (seed 1): the process's first launches of everything
    timed(lambda: render_frame_linear_sharded(
        scene, camera, cfg, torch.Generator(device=dev).manual_seed(1),
        mesh))
    (fb, st), secs, loc, counts = timed(
        lambda: render_frame_linear_sharded(
            scene, camera, cfg, torch.Generator(device=dev).manual_seed(2),
            mesh))
    res["frame"] = dict(
        stats=st, secs=secs, local=loc, counts=counts,
        sha=hashlib.sha256(fb.cpu().numpy().tobytes()).hexdigest(),
        fb=torch.sqrt(fb / cfg.num_samples).cpu())
    if job == "nccl":
        (_, st1), secs1, _, counts1 = timed(lambda: orig(
            scene, camera, cfg, rank_generator(2, 0, dev)))
        res["unsharded"] = dict(stats=st1, secs=secs1, counts=counts1)
    else:
        def alone():
            if rank == 0:
                return orig(scene, camera, cfg,
                            torch.Generator(device=dev).manual_seed(2))
            return None, None
        (_, st1), secs1, _, counts1 = timed(alone)
        dist.barrier()
        res["unsharded"] = dict(stats=st1, secs=secs1, counts=counts1)

        def c5(spp):
            return RenderConfig(width=C5_WIDTH, height=C5_HEIGHT,
                                num_samples=spp, max_bounces=C5_BOUNCES)
        full_path = str(_build.BUILD_DIR / "config5_sharded.npz")
        short_path = str(_build.BUILD_DIR / "config5_sharded_short.npz")
        if rank == 0:
            for p in (full_path, short_path):
                if os.path.exists(p):
                    os.remove(p)
        kw = dict(batch_spp=C5_SHARDED_BATCH, save_every=1, verbose=False,
                  mesh=mesh)
        full, secs, loc, counts = timed(lambda: render_checkpointed(
            scene, camera, c5(C5_SHARDED_SPP), full_path, **kw))
        res["c5_full"] = dict(secs=secs, local=loc, counts=counts)
        timed(lambda: render_checkpointed(
            scene, camera, c5(C5_SHARDED_SPP - C5_SHARDED_BATCH), short_path,
            **kw))
        resumed, secs, loc, counts = timed(lambda: render_checkpointed(
            scene, camera, c5(C5_SHARDED_SPP), short_path, **kw))
        res["c5_resumed"] = dict(secs=secs, local=loc, counts=counts)
        if rank == 0:
            res["c5_images"] = (full.cpu(), resumed.cpu())
        res["c5_equal_ranks"] = hashlib.sha256(
            resumed.cpu().numpy().tobytes()).hexdigest()
    torch.save(res, out)
    dist.destroy_process_group()


def phase10_multi_gpu(card, floor):
    """(c) NCCL at a world of one, (d) two ranks on the one card over gloo
    with CUDA tensors, (e) a sharded checkpointed render of config 5 over
    the same two ranks, (f) the CLI under ``torchrun``.  Each rank's frame
    runs the persist kernels alone, once an iteration.  Returns the
    numbers the summary prints."""
    import numpy as np
    import torch
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import read_ppm

    def persist_only(counts, its):
        return _expect_only(counts, {("persist", "closest"): its,
                                     ("persist", "anyhit"): its})

    (r,) = _run_ranks("nccl", 1)
    f, u = r["frame"], r["unsharded"]
    err = _gate("nccl world of one", f["fb"], floor)
    print(f"[nccl world of one] {card}: backend {r['backend']}, "
          f"{r['device']}, mesh size {r['size']}; {WIDTH}x{HEIGHT} @ {SPP} "
          f"spp: {f['stats']} in {f['secs']:.3f} s, the unsharded frame "
          f"from rank_generator(2, 0) {u['stats']['iterations']} iterations,"
          f" {u['stats']['rays_traced']:.0f} rays in {u['secs']:.3f} s; MSE "
          f"{err:.3e} (gate {floor['gate']:.3e}); launches "
          f"{f['counts']['persist']}")
    if r["backend"] != "nccl" or r["size"] != 1 or \
            f["stats"]["iterations"] != u["stats"]["iterations"] or \
            f["stats"]["rays_traced"] != u["stats"]["rays_traced"] or \
            not persist_only(f["counts"], f["stats"]["iterations"]):
        raise RuntimeError("the NCCL world of one is not the unsharded "
                           "frame")

    ranks = _run_ranks("gloo", 2)
    fr = [q["frame"] for q in ranks]
    local_rays = [q["local"][0]["rays_traced"] for q in fr]
    local_its = [q["local"][0]["iterations"] for q in fr]
    st = fr[0]["stats"]
    err = _gate("two-rank frame", fr[0]["fb"], floor)
    alone = ranks[0]["unsharded"]
    print(f"[gloo two ranks] {card}: backend {ranks[0]['backend']} on "
          f"{ranks[0]['device']} / {ranks[1]['device']}; {WIDTH}x{HEIGHT} @ "
          f"{SHARDED_SPP} spp, {SHARDED_SPP // 2} a rank: reduced {st}, "
          f"ranks' local rays {local_rays}, iterations {local_its}; "
          f"checksums {fr[0]['sha'][:16]} / {fr[1]['sha'][:16]}; MSE "
          f"{err:.3e} (gate {floor['gate']:.3e}); frame seconds {fr[0]['secs']:.3f} "
          f"/ {fr[1]['secs']:.3f} against {alone['secs']:.3f} for one "
          f"process alone ({alone['stats']['rays_traced']:.0f} rays); "
          f"launches {[q['counts']['persist'] for q in fr]}")
    if ranks[0]["backend"] != "gloo" or fr[0]["sha"] != fr[1]["sha"] or \
            fr[0]["stats"] != fr[1]["stats"] or \
            st["rays_traced"] != sum(local_rays) or \
            st["iterations"] != max(local_its) or not all(
                persist_only(q["counts"], q["local"][0]["iterations"])
                for q in fr):
        raise RuntimeError("the two gloo ranks do not hold the reduced frame")

    full, resumed = ranks[0]["c5_images"]
    c5f = [q["c5_full"] for q in ranks]
    rays = sum(st_["rays_traced"] for q in c5f for st_ in q["local"])
    secs = c5f[0]["secs"]
    n_resumed = [len(q["c5_resumed"]["local"]) for q in ranks]
    close = bool(torch.allclose(resumed, full, rtol=C5_RTOL, atol=C5_ATOL))
    rel = float(((resumed - full).abs() / full.abs().clamp(min=1e-30)).max())
    mrays = rays / secs / 1e6
    print(f"[config5 sharded] {card}: {C5_WIDTH}x{C5_HEIGHT} @ "
          f"{C5_SHARDED_SPP} spp as {C5_SHARDED_SPP // C5_SHARDED_BATCH} "
          f"batches of {C5_SHARDED_BATCH} over two gloo ranks: {secs:.3f} s, "
          f"{rays:.4g} rays, {mrays:.3f} Mrays/s sustained; resumed from a "
          f"file one batch short (batches rendered {n_resumed}): max |d| "
          f"{float((resumed - full).abs().max()):.3e}, max relative "
          f"{rel:.3e}, within rtol {C5_RTOL} / atol {C5_ATOL} {close}; "
          f"ranks' images equal "
          f"{ranks[0]['c5_equal_ranks'] == ranks[1]['c5_equal_ranks']}")
    if not close or n_resumed != [1, 1] or \
            ranks[0]["c5_equal_ranks"] != ranks[1]["c5_equal_ranks"] or \
            not all(_only_set(q[k]["counts"], "persist") for q in ranks
                    for k in ("c5_full", "c5_resumed")):
        raise RuntimeError("the sharded config-5 render did not resume to "
                           "the uninterrupted image")

    out = _build.BUILD_DIR / "sharded.ppm"
    if out.exists():
        out.unlink()
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "rtjax_torch", "render", "--sharded",
           "--width", "256", "--height", "256", "--spp", "8", "-o", str(out)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    cli_secs = time.perf_counter() - t0
    ok = res.returncode == 0 and out.exists() and \
        read_ppm(out).shape == (256, 256, 3) and f"wrote {out}" in res.stdout
    print(f"[torchrun cli] {' '.join(cmd[1:])}: rc {res.returncode}, "
          f"{cli_secs:.3f} s; {res.stdout.strip().splitlines()[-2:]}")
    if not ok:
        raise RuntimeError(f"the CLI under torchrun failed:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    return dict(two_rank_secs=[q["secs"] for q in fr],
                alone_secs=alone["secs"], c5_mrays=mrays, c5_secs=secs,
                nccl_secs=f["secs"], cli_secs=cli_secs,
                img=float(np.mean(_u8_image(fr[0]["fb"]))))


def _walk_stats_rows(stats, launches):
    """The kernels line's rows of the six new stats instances."""
    rows = []
    names = {"packet": (GROUP_KERNELS, GROUP_SOURCES["packet"]),
             "lane": (GROUP_KERNELS, GROUP_SOURCES["lane"]),
             "two_level": (INST_KERNELS, INST_SOURCE)}
    for (walk, kind), r in stats.items():
        table, source = names[walk]
        base = table[kind] if walk == "two_level" else table[walk, kind]
        rows.append(dict(
            name=f"{base['name']} (with_stats)", replaces=base["replaces"],
            route="cuda", source=source, launches=launches[walk, kind],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            library_ms=None, **{k: r[k] for k in _BOUND_KEYS},
            share=r["share"], default_ms=r["default_ms"], cost=r["cost"],
            timed_launches=2 * REPS, counts=r["counts"],
            **({"ab": r["ab"]} if "ab" in r else {}),
            note="the default kernel with its node visits and leaf rows "
                 "counted (detailed_stats); bound as the default row's; "
                 "plain_ms one call of the plain walk counting; launches "
                 "over phase 10(b)'s detailed_stats frame"))
    return rows


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
    inst_launches, inst_captured, c4_floor = phase6_config4(
        c4_scene, baked, c4_camera, card)
    for kind, k in inst.items():
        k["launches"] = inst_launches[kind]
    _record_ab(inst, phase6_in_frame(c4_scene, card, inst_captured),
               "in_frame")
    stamp("phase 6 (config 4 frames)")
    phase8_cli(card)
    stats, stats_launches, ptxas = phase8_stats(scene, camera, card, floor)
    modes = phase8_modes(scene, camera, card, floor)
    c5 = phase8_config5(scene, camera, card)
    stamp("phase 8 (CLI, stats, estimator modes, config 5)")
    binary = phase9_binary_kernels(scene, camera, card)
    binary_launches, xla_secs = phase9_xla_frames(scene, camera, card, floor)
    key_secs = phase9_sort_keys(scene, camera, card, floor)
    wide = phase9_wide_bundle(scene, camera, card)
    c4_xla = phase9_config4_xla(c4_scene, c4_camera, card, c4_floor)
    stamp("phase 9 (binary walk, sort keys, unsorted engine, wide bundle)")
    walk_stats, walk_ptxas = phase10_stats_kernels(
        scene, camera, c4_scene, c4_camera, group, card)
    walk_launches = phase10_stats_frames(scene, camera, c4_scene, c4_camera,
                                         card, floor, c4_floor)
    multi = phase10_multi_gpu(card, floor)
    stamp("phase 10 (stats instances, detailed_stats frames, multi-GPU)")
    frames = phase7_frames(scene, camera, card, c4_scene, c4_camera)
    stamp("phase 7 (frame kernels)")
    for rows_, kernels in ((persist, "persist"), (inst, "two_level")):
        for kind, ms in frames[kernels].items():
            rows_[kind]["frame_ms"] = ms
    for kind, ms in frames["packet"].items():
        group["packet", kind]["frame_ms"] = ms
    group["lane", "closest"]["frame_ms"] = frames["lane"]["closest"]
    stats_rows = _stats_rows(stats, stats_launches)
    rows = [*persist.values(), *stats_rows.values(), *group.values(),
            *inst.values(), *_binary_rows(binary, binary_launches),
            *_walk_stats_rows(walk_stats, walk_launches)]
    for k in rows:
        print(f"[bound] {k['name']}: {k['bound_us']:.3f} us by "
              f"{k['bound_by']}, kernel {k['ms']:.4f} ms device time, "
              f"{100 * k['share']:.2f}% of the bound; launches {k['launches']}")
    print(f"[summary] {card}: config 5 sustained {c5['mrays']:.3f} Mrays/s "
          f"({c5['seconds']:.3f} s for {C5_SUSTAINED_SPP} spp); stats / "
          f"default device time closest "
          f"{stats_rows['closest']['cost']:.3f}, any hit "
          f"{stats_rows['anyhit']['cost']:.3f}; stats instances' registers "
          f"{ptxas['stats']}; parity / default mean {modes['ratio']:.5f}; "
          f"headline frame seconds traversal=xla {xla_secs['xla']} vs "
          f"persist {xla_secs['persist']}; sort modes {key_secs}; wide "
          f"bundle MSE {wide['wide_mse']:.4e} vs seed-to-seed "
          f"{wide['seed_mse']:.4e}; config 4 xla {c4_xla['seconds']:.3f} s; "
          f"stats / default device time "
          + ", ".join(f"{w} {k} {r['cost']:.3f}"
                      for (w, k), r in walk_stats.items())
          + f"; their stats instances' registers {walk_ptxas[1]}; headline "
          f"frame seconds two gloo ranks {multi['two_rank_secs']} vs one "
          f"process {multi['alone_secs']:.3f}, NCCL world of one "
          f"{multi['nccl_secs']:.3f}; config 5 over two ranks "
          f"{multi['c5_mrays']:.3f} Mrays/s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        job, rank, world, coord, out = sys.argv[2:7]
        _rank_job(job, int(rank), int(world), coord, out)
    else:
        main()
