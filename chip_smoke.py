#!/usr/bin/env python3
"""GPU smoke run of rtjax_torch, the PyTorch + CUDA port of rtjax.

Run from the repository root on a machine with one NVIDIA GPU (built for
Hopper, sm_90a):

    python3 chip_smoke.py

Phases (each prints one line of its own numbers; any failure raises and
the script exits non-zero):

0. device: require CUDA; print the card's name and power limit, and the
   torch and CUDA versions;
1. build: the BVH builder and the eight kernel libraries (the persist,
   two-level, packet and lane, binary-walk and direct-path kernels, the
   device loop, the step kernels and the step's key sort) from this
   checkout's sources, into build/rtjax_torch/, all nine compilers
   started together; ptxas's registers, stack frame and spills of the
   persist, two-level, packet and lane kernels (both designs, widths 8
   and 16, the two-level fetch kernels with the instance records staged
   or global), of the step kernels and of the key sort (the binary-walk
   kernels' in phase 9, the direct pair's in phase 12);
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
   persist kernels and the three step kernels must have launched, the
   key sort once an iteration, and no plain version and no stride-design
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
   plain version or stride-design kernel runs; (a) and (d) launch the
   direct kernels once an iteration besides, for the 3-triangle base (as
   rtjax's repass takes its direct loop there).
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
   ``detailed_stats``: only the persist kernels' stats instances and the
   mode's step kernels, once an iteration, the bounce histogram summing to
   the path rays traced, the
   image at the headline gate; the stats instances' node visits and leaf
   rows equal to the plain walk's ``new_work()`` counts and their results
   bit for bit the default instances', on phase 3's rays and on launch
   CAPTURE_AT of that frame, timed in turns with the default instances;
   the default instances' ptxas registers unchanged (DEFAULT_REGISTERS);
   (c) cornell_bunny at MODE_SIZE^2 @ MODE_SPP under
   ``reference_parity`` and the default estimator, each on its mode's
   step kernels once an iteration: the parity mean within
   PARITY_MEAN_TOL of rtjax's parity artifact and the parity / default
   ratio within PARITY_RATIO_TOL of BASELINE's 1.0158; a
   ``one_sample_mis`` headline frame (on its step kernels) at the
   headline gate; (d) eval config
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
   counts and the bound, the ptxas lines of every instance (the default
   instances' registers held to BINARY_REGISTERS), and the first design
   (one thread a ray, ``traverse_*_thread``) bit for bit against the fetch
   design the engine runs, both timed in turns (first, fetch, fetch,
   first), the records' bytes beside the arrays'; (b) the
   headline frame under traversal="xla", seeds 2 and 3, alternated with
   persist frames (xla, persist, persist, xla): only the binary kernels,
   once an iteration, and the unsorted engine's step kernels, each image
   at phase 4's gate, frame seconds; (c) the headline frame under every
   other sort key and with sort_rays=False: only the persist kernels,
   once an iteration, and the mode's step kernels, each at phase 4's
   gate;
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
11. the big-scene tier (run after phase 10, before phase 7's profiles):
   benchmarks/bigscene_proof.py's heightfield at each of BIG_GRIDS
   (3,998,792 and 7,597,202 triangles; the second past 2^20 leaf rows,
   where the node rows' f32 meta mirror is NaN and no walk reads it):
   (a) built on the card, its triangles, binary nodes, depth, node width,
   wide nodes, leaf rows, table MiB (against the card's L2) and the
   seconds of the native BVH build, the collapse and packing, the tables'
   upload and the rest; it must have wide tables and resolve to the
   kernels; (d) bigscene_proof.py's frame (BIG_SIZE^2 @ BIG_SPP, BIG_BOUNCES
   bounces) on the kernels, seeds 1 and 2, counts from zero: the persist
   kernels alone, once an iteration, frame seconds and Mrays/s, the image
   finite, non-negative, mean > 0; then under traversal="xla" (seed 3,
   the binary kernels alone) within 2x the seed-to-seed MSE (plus the
   8-bit term) of the seed-2 kernel frame; (b) phase 3's persist, packet
   and lane checks, timings and bounds on BIG_RAYS camera rays with twice
   as many shadow rays from their hits (half toward the light, half
   along shallow directions that the hills occlude), and again on launch
   BIG_CAPTURE_AT of the seed-1 frame (its shadow rays may all reach the
   light); (c) the persist, packet, lane and binary kernels against the
   all-triangles oracle (kernels/brute.py) on BIG_BRUTE_RAYS camera and
   shadow rays, hit, t and occlusion equal and prim equal but at ties of
   equal t, and the binary kernels' hits, t and occlusion against the
   persist kernels' on every ray of (b); then, at the largest grid, phase
   9 (a)'s checks of the binary kernels, both designs, on (b)'s rays;
12. rtjax's tiny-scene direct path and eval configs 2 and 3 (run after
   phase 11, before phase 7's profiles; launch counts from zero around
   every frame): (c) eval config 2 at full width (cornell_planes, 12
   triangles, C2_SIZE^2 @ C2_SPP spp, C2_BOUNCES bounces, the default pool)
   at the default config, on the direct kernels alone once an iteration,
   and under ``direct_max_tris=0``, on the persist kernels alone,
   alternated after a warm-up frame (direct, persist, persist, direct;
   seeds 2, 2, 3, 3), each pair of one seed within 2x the direct frames'
   seed-to-seed MSE plus the 8-bit term (the two walks keep other triangles
   at ties of equal t, and the sorted pool decorrelates the frames from
   there), frame seconds; the first frame keeps the first closest-hit
   launch (the pool's camera rays) and the second any-hit launch (their 2N
   shadow rays); (a) the direct kernels on those rays and over random soups
   of DIRECT_SOUPS triangles (one shared-memory tile, and several):
   bit for bit against their plain versions, hit, t, prim and occlusion
   equal to the all-triangles oracle's, device time a launch, one call,
   one plain call and the bound (the soups on phase 3's kind of rays at
   the pool's width: the first launch's camera rays see only the image's
   top rows), and any hit's first design (``direct_anyhit_v1``) bit for
   bit too and timed in turns with the engine's; on config 2's rays each
   kernel's SASS counts, each design with every lane inactive and every
   lane active, the SIMT efficiency of the lanes in order and compacted,
   and every design bit for bit under each of DIRECT_MASKS
   (tools/direct_designs.py); (b) the
   persist kernels on config 2's rays: hits, t and occlusion equal (prim
   ties counted) and their device time a launch beside the direct kernels';
   (d) a detailed_stats config-2 frame: the default frame's rays traced, no
   node steps and leaf visits equal to the triangles times the active lanes
   of every launch, and every launch held against the persist kernel on its
   own rays (hits, t and occlusion equal but where the occluder lies at the
   ray's tmax, OCC_RTOL; ties counted); (e) eval config 3 (the glass bunny
   on a mirror floor, 256^2 @ C3_SPP spp, C3_BOUNCES bounces) at seeds 2
   and 3 on the persist kernels and under ``traversal="xla"`` at seed 4,
   within 2x their seed-to-seed MSE plus the 8-bit term; the CLI's
   cornell_bunny_glass at 256^2 @ 64 spp against
   artifacts/cornell_bunny_glass_256_64spp.ppm, printed, not gated; (f)
   captured frames of config 2 and config 4 (a) on any hit's two designs
   in turns, and one profiled frame of each (summed device time of the
   pair, the sort and the step kernels), in a process of its own
   (``tools/direct_designs.py --frames``): each arm launching only its
   design, once an iteration, equal rays, each seed within (c)'s gate;
13. the device-resident frame loop (run after phase 12, before phase 7's
   profiles): on the headline, eval configs 2 and 3, config 4 under
   repass (two_level="auto", arm (a)) and under two_level="kernel" (arm
   (b)), and both arms on the field of C4_MANY instances, with the graph
   cache cleared, a frame that
   captures the step (its seconds and the graph pool's bytes) and an
   eager one, then graph and eager frames alternated (seeds 2, 2, 3, 3,
   4, 4), launch counts from zero around each and their synchronising
   calls counted by torch.cuda's sync debug mode: each pair of one seed
   equal in iterations, rays, occupancy and launches, the framebuffers
   within FB_RTOL, a graph frame's reads at most ceil(iterations /
   STEPS_PER_READ) + 2, each graph frame at its phase's image gate; the
   STEPS_PER_READ A/B over SPR_CHOICES on the headline and config 2;
   repass's passes at 16 and C4_MANY instances, the while nodes the
   engine captures against all G passes captured and masked, in turns
   (tools/repass_designs.py: each frame equal to the eager loop's; busy
   and idle passes a frame, an idle masked pass's device time); the
   device-busy share of a
   graph and an eager frame of each cell, profiled in a process of its
   own (``--busy-job``);
14. the fused wavefront step (run after phase 13, before phase 7's
   profiles; ~90 s): (a) route, shade and resolve (kernels/step.py,
   csrc/step_kernels.cu) against their plain versions on the states of
   STEP_CHECK_ITS of the headline, configs 2 (sorting and sort_every
   skip iterations), 3 (specular) and 4 (instanced), stepped op by op,
   and on a synthetic pool of every lane kind (every material, point and
   area lights, the environment light, dead, dirty and non-finite-beta
   lanes): every output bit for bit, the mismatching lanes printed and
   all 0, the framebuffer within FB_RTOL (its atomic adds' order); (b)
   captured frames through the kernels and under step_kernels=False in
   turns (STEP_ORDER) on the headline, configs 2, 3, 4 (a) and (b) and
   config 5's 4-spp probe: each seed's pair equal in iterations, rays,
   occupancy and traversal launches, the step kernels once an iteration
   in one arm and never in the other, framebuffers within FB_RTOL, each
   kernel frame at its phase's image gate, frame seconds of both arms;
   (c) phase 13's busy job's device events and device ms an iteration of
   both arms (STEP_BUSY); (d) each kernel's device time a launch, the
   sort's and each plain version's, with the bound (bytes a lane moves,
   ROUTE_BYTES ...; operations, ROUTE_OPS ...).  Besides, the step
   kernels' record design (a 40-byte bundle record a lane) against their
   first design (route_v1 / shade_v1, the [9, N] column bundle): (a)
   both designs on every state; (b) the first design's frames too, equal
   to the record design's; (c) its busy profile; (d) in turns, route and
   shade against the first design's (tools/step_designs.py), registers
   and resident warps, one wrapper call of each kernel and index_add_ of
   the flush.  Then the other modes (the unsorted engine,
   reference_parity, the wide bundle, one_sample_mis, detailed_stats):
   the registers of the default instances, the first design and the
   unsorted and parity instances held to STEP_REGISTERS, the camera
   rank's scan against torch.cumsum on five masks (tools/mode_steps.py),
   the modes' kernels bit for bit against their plain versions
   (tools/step_designs.py; the bounce histogram too) on the op-by-op
   states of phase 8(c)'s parity frame, of the headline under parity,
   "xla", sort_rays=False and parity with "xla", of config 3 under
   parity, of the headline under detailed_stats, one_sample_mis (also
   unsorted) and parity with detailed_stats, of phase 9(d)'s wide frame
   and of the headline at 126 bounces (alone and with one_sample_mis and
   detailed_stats), and on synthetic pools with limbo or dirty lanes,
   those cells' frames against step_kernels=False in turns (equal
   iterations, rays, histograms and traversal sums), and each kernel
   timed.  (e) The step's key sort (kernels/sort.py, csrc/key_sort.cu;
   in (a)-(d) too: bit for bit against torch.sort on every checked
   state's route keys, once an iteration in every kernels frame on a
   sorted engine, and timed in turns with torch.sort on each cell's
   route keys of STEP_TIME_IT, and in the other modes on MODE_TIMED's):
   its registers; bit for bit against ``torch.sort(keys,
   stable=True).indices`` on tools/sort_designs.py's key sets at 2^17 -
   2^20 keys, each timed in turns with torch.sort; a skip launch of the
   ``sort_every`` cadence leaving its order untouched, timed; and, in a
   process of its own (``tools/sort_designs.py --frames``), captured
   frames of the headline, config 2, config 4 (b), the parity frame and
   the wide frame with the sort on the kernels and on torch.sort in
   turns, equal in iterations, rays and launches, one profiled frame an
   arm (device ms and events an iteration, the sort's device ms a frame,
   no torch sort kernel on the kernels' arm) and the device tally of the
   launches that sorted and that returned at once;
7. the two persist kernels' device time over one whole headline frame,
   the two packet kernels' over one walker="packet" headline frame, the
   lane closest-hit kernel's over one walker="lane" headline frame (its
   any hit the persist kernel's), then the two two-level kernels' over
   one config-4 two_level="kernel" frame
   (torch.profiler; every launch of the frame must be recorded, or the
   frame is profiled again, once) under each design, first design, new,
   new, first (render/trace.py's names rebound to the first design for its
   frames).

A ``[time]`` line after each phase gives the seconds since the start,
and a ``[frame]`` line after every frame says whether it replayed the
captured step (``stats["graphed"]``).  Frames replay the captured step
where their mode allows it; the frames whose kernel names in
render/trace.py are rebound to keep or check single launches (phases
4, 6(b), 7, 8(b), 11(d) and 12(c)-(d)) run the eager loop through
:func:`_drive_eager` / :func:`_render_eager`, since a replayed graph calls
no Python per launch.

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
instances (rows of their own, ``(with_stats)``), phase 12(c)'s two
default config-2 frames for the direct pair (rows 12-13; with
``config4_launches``, phase 6(a)'s base launches, ``persist_ms``, the
persist kernels' time on the same rays, and ``soups``, (a)'s numbers
over the soups), phase 4's three frames for the step kernels and the
key sort (rows of route, shade and resolve: rtjax's XLA fusions of
``wavefront_step``, which reach no ``pallas_call``; their times phase 14 (d)'s on the
headline's state of iteration STEP_TIME_IT, ``sort_ms`` torch.sort's
there on the route row, ``mismatching_lanes`` phase 14 (a)'s; no
``ab``; the full-record modes' rows, ``step_route_shade_unsorted`` and
the parity kernels: launches from phase 9(b)'s two xla frames, phase
8(c)'s parity frame and phase 14's parity-with-xla frame, times phase
14's on the headline's states; the key sort's row: rtjax's lax.sort,
its time and torch.sort's (``library_ms``) in turns on the headline's
route keys of STEP_TIME_IT, ``cells``, ``sets``, ``skip_ms`` and
``frames`` phase 14 (e)'s).  The persist, packet,
lane and binary-walk rows carry ``bigscene``: phase 11's numbers by grid
(the persist rows' device time, bound and share on (b)'s rays and
in-frame launch, their launches over (d)'s two kernel frames; every
row's mismatches against the oracle).  lane_traverse_anyhit is on no engine path
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
    cuda = tuple(int(v) for v in (torch.version.cuda or "0.0").split(".")[:2])
    if cuda < (12, 4):
        raise RuntimeError(f"CUDA {torch.version.cuda}: the captured step's "
                           "device loops need CUDA-graph while nodes (12.4)")
    return card


def phase1_build():
    from rtjax_torch.kernels import _build
    builds = {"bvh builder": _build.bvh_library,
              "persist kernels": _build.persist_library,
              "two-level kernels": _build.wide_inst_library,
              "packet and lane kernels": _build.packet_library,
              "binary-walk kernels": _build.binary_library,
              "direct-path kernels": _build.direct_library,
              "device loop": _build.loop_library,
              "step kernels": _build.step_library,
              "key sort": _build.key_sort_library}

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
    for name, res in _build.ptxas_report(_build.step_library()):
        print(f"[ptxas] {_step_label(name)}: {res}")
    for name, res in _build.ptxas_report(_build.key_sort_library()):
        kind = "upsweep" if "upsweep_kernel" in name else "pass"
        print(f"[ptxas] key sort {kind}: {res}")


def _step_label(mangled):
    """"step shade" for a step kernel's mangled name: route, route_v1,
    shade, shade_v1, resolve and the full-record modes' kernels
    (route_parity, ...)."""
    import re
    m = re.search(r"((?:route|shade|resolve)(?:_parity)?(?:_unsorted)?"
                  r"(?:_v1)?)_kernel", mangled)
    return mangled if m is None else f"step {m[1]}"


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


def _check_persist(label, tab, cl, ah, card, need_occluded=True,
                   plain_once=False):
    """Hold both persist kernels, in the fetch design and in the first
    (stride) design, against their plain versions on ``tab`` with the
    closest-hit rays ``cl`` and the any-hit rays ``ah``: zero hit/occlusion
    mismatches, equal t/prim/normal and correct dead lanes, or raise.  Time
    the two designs in turns (:func:`_ab_ms`) and the plain version
    (median of REPS), count the plain walk's work and give each kernel its
    bound.  Returns ``{"closest": {...}, "anyhit": {...}}``: max |t diff|,
    the fetch design's ms (mean of its two medians), the stride design's,
    the plain ms, both designs' medians and the bound.  With
    ``need_occluded`` False, any-hit rays none of which is occluded pass
    (a scene lit from above that nothing shadows).  With ``plain_once``
    the plain versions are timed by one call each (CUDA events), where
    they take seconds a call."""
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
    plain_ms = _plain_ms(lambda: P.persist_traverse_closest_ref(*args),
                         plain_once)
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
    plain_ms = _plain_ms(lambda: P.persist_traverse_anyhit_ref(*args),
                         plain_once)
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _bound(work, n, n_act, RAY_IN + EXCLUDE, 1, tab)
    out["anyhit"] = _ab_result(float(mis["fetch"]["occlusion"]), new, old,
                               call_ms, plain_ms, b)
    print(f"[{label} anyhit] {card}: {n} rays ({n_act} active) over "
          f"{tab.width}-wide tables, {occluded} occluded; mismatches vs "
          f"plain (occlusion, dead lanes): fetch {mis['fetch']}, stride "
          f"{mis['stride']}; " + _ab_text(out["anyhit"])
          + f"; {_work_text(work, b)}")
    if any(v for m in mis.values() for v in m.values()) or \
            (need_occluded and occluded == 0):
        raise RuntimeError(f"{label}: any-hit kernel disagrees with its "
                           "plain version")
    return out


def _plain_ms(fn, once):
    """A plain version's time: one call's (CUDA events) when ``once``, else
    the median of REPS (:func:`_median_ms`)."""
    return _timed_ms(fn)[1] if once else _median_ms(fn)


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


def _check_group(label, tab, cl, ah, card, bounds, walks=("packet", "lane"),
                 need_occluded=True):
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
    ``need_occluded`` as in :func:`_check_persist`.  Returns
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
                or (need_occluded and int(ok_.sum()) == 0):
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
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render.film import read_ppm, write_ppm
    from rtjax_torch.render.wavefront import render_frame

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=SPP,
                       max_bounces=BOUNCES)
    for k in P.LAUNCHES:
        P.LAUNCHES[k] = 0
        P.REF_CALLS[k] = 0
        P.STRIDE_LAUNCHES[k] = 0
        P.STATS_LAUNCHES[k] = 0
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = S.REF_CALLS[k] = 0
    SO.LAUNCHES["key_sort"] = SO.REF_CALLS["key_sort"] = 0
    runs = []
    for seed in (1, 2, 3):  # warm-up, then two timed runs
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if seed == 1:
            captured, restore = _capture_launch(CAPTURE_AT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the warm-up keeps launch CAPTURE_AT: the eager loop
        fb, stats = _render_eager(scene, camera, cfg, gen) if seed == 1 \
            else render_frame(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, stats))
        if seed == 1:
            restore()
    # the step kernels' launches ride along as "step route", ...
    launches = dict(P.LAUNCHES) | {f"step {k}": S.LAUNCHES[k]
                                   for k in S.MODE_KERNELS["default"]}
    launches["key_sort"] = SO.LAUNCHES["key_sort"]
    if any(v for k, v in S.LAUNCHES.items()
           if k not in S.MODE_KERNELS["default"]):
        raise RuntimeError("the main path launched another mode's step "
                           "kernels")
    ref_calls = sum(P.REF_CALLS.values()) + sum(P.STRIDE_LAUNCHES.values()) \
        + sum(P.STATS_LAUNCHES.values()) + sum(S.REF_CALLS.values()) \
        + SO.REF_CALLS["key_sort"]

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
        raise RuntimeError("the main path did not run through both "
                           "traversal kernels and the three step kernels")
    if launches["key_sort"] != launches["step route"]:
        raise RuntimeError(f"the key sort launched {launches['key_sort']} "
                           f"times against route's {launches['step route']}"
                           ": not once a sorted iteration")
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
    "anyhit": [...], "iterations": n, "steps": m}``, ``steps`` the frame
    loop's steps (the iterations rounded up to whole chunks of
    ``STEPS_PER_READ``: the steps past the end of the last chunk launch
    on an empty pool, and LAUNCHES does not count them, the profiler
    does), the kernels picked by ``kind_of``
    (a kernel name -> "closest", "anyhit" or None).  ``rebind`` maps
    render/trace.py names to the functions the engine calls for this frame
    (the stride design's); they are put back after it.  The profile's raw
    device events are summed: ``key_averages()`` first builds every
    event's tree, which took most of the phase's time."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rtjax_torch.render import trace
    from rtjax_torch.render import wavefront as WF
    from rtjax_torch.render.wavefront import render_frame
    saved = {k: getattr(trace, k) for k in rebind}
    for k, fn in rebind.items():
        setattr(trace, k, fn)
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the eager loop: ``rebind`` is looked up at every launch
            _, stats = render_frame(scene, camera, cfg, gen, graph=False)
            torch.cuda.synchronize()
    finally:
        for k, fn in saved.items():
            setattr(trace, k, fn)
    its, chunk = stats["iterations"], WF.STEPS_PER_READ
    out = {"closest": [0.0, 0], "anyhit": [0.0, 0], "iterations": its,
           "steps": math.ceil(its / chunk) * chunk}
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
    "packet": ..., "lane": ..., "two_level": ...}``.  A frame whose
    profile holds another number of launches of either kernel than the
    frame loop's steps (:func:`_frame_kernel_ms`) is profiled again, once;
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
                      f"{k['iterations']} iterations in {k['steps']} "
                      f"steps")
                if k["closest"][1] == k["anyhit"][1] == k["steps"]:
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
            runs, c = (_drive_eager if capture else _drive)(
                scene, camera, dataclasses.replace(cfg, **WALKERS[walker]),
                (seed,))
        finally:
            if capture:
                restore()
        secs, fb, st = runs[0]
        its = st["iterations"]
        got = {(kernel, kind): n for kernel in _KERNEL_SETS
               for kind, n in c[kernel].items()}
        expect = dict.fromkeys(got, 0)
        for key in want[walker]:
            expect[key] = its
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
    (grp,) = inst.groups   # config 4: one mesh, its instances in id order
    ent, meets = _repass_setup(grp, rays["o"], rays["d"])
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
                "binary", "binary_stats", "binary_thread", "packet_stats",
                "lane_stats", "two_level_stats", "direct", "direct_v1")


def _counters():
    """``{set: (LAUNCHES, REF_CALLS or None)}`` of every kernel module."""
    from rtjax_torch.kernels import direct as D
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.kernels import step as S
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
            "binary_thread": (T.THREAD_LAUNCHES, None),
            "packet_stats": (WD.STATS_LAUNCHES, None),
            "lane_stats": (L.STATS_LAUNCHES, None),
            "two_level_stats": (WI.STATS_LAUNCHES, None),
            "direct": (D.LAUNCHES, None),
            "direct_v1": (D.V1_LAUNCHES, None),
            # outside _KERNEL_SETS: the covered modes launch them beside
            # every traversal set (the first design only when chosen)
            "step": (S.LAUNCHES, S.REF_CALLS),
            "step_v1": (S.V1_LAUNCHES, None),
            # the step's key sort: once a sorted iteration of the kernels
            "sort": (SO.LAUNCHES, SO.REF_CALLS)}


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


def _drive(scene, camera, cfg, seeds, graph=True):
    """Render one frame per seed with every launch count read from zero:
    ``([(seconds, framebuffer, stats), ...], counts)``; counts hold each
    kernel set's launches and ``plain``, the plain-version calls.  The
    frames replay the captured step where the mode allows it
    (``graph=False``: :func:`_drive_eager`)."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    _zero_counts()
    runs = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb, stats = render_frame(scene, camera, cfg, gen, graph=graph)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, stats))
        if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
            raise RuntimeError("framebuffer has non-finite or negative "
                               "values")
    return runs, _read_counts()


def _drive_eager(scene, camera, cfg, seeds):
    """:func:`_drive` through the eager frame loop (``graph=False``): the
    frames whose kernel names in render/trace.py are rebound to keep or
    check single launches (``_capture_launch``, ``_direct_in_frame``,
    phase 8(b)'s count), which a replayed CUDA graph never calls."""
    return _drive(scene, camera, cfg, seeds, graph=False)


def _render_eager(scene, camera, cfg, gen):
    """``render_frame`` through the eager frame loop, for a frame whose
    kernel names are rebound (see :func:`_drive_eager`)."""
    from rtjax_torch.render.wavefront import render_frame
    return render_frame(scene, camera, cfg, gen, graph=False)


def _only(counts, kernel_set, also=()):
    """True when ``kernel_set`` launched both its kernels and no other set
    launched any (but the sets in ``also``)."""
    return min(counts[kernel_set].values()) > 0 and not any(
        v for name in _KERNEL_SETS if name != kernel_set and name not in also
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
          f"{a['persist']['closest'] / its:.2f}, any-hit "
          f"{a['persist']['anyhit'] / its:.2f} (beyond the base launch, "
          f"which the direct kernels take: {a['direct']})")
    # the 3-triangle base takes the direct kernels once an iteration, as
    # rtjax's repass takes its direct loop there
    require(_only(a, "persist", also=("direct",)) and a["plain"] == 0
            and a["direct"] == {"closest": its, "anyhit": its},
            "repass did not run through the persist kernels and, for its "
            "base, the direct kernels alone")

    captured, restore = _capture_launch(C4_CAPTURE_AT, INST_NAMES)
    try:
        b_runs, b = _drive_eager(
            scene, camera, dataclasses.replace(cfg, two_level="kernel"), (2,))
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
    d_its = d_runs[0][2]["iterations"]
    require(_only(d, "packet", also=("direct",)) and d["plain"] == 0
            and d["direct"] == {"closest": d_its, "anyhit": d_its},
            "repass under walker='packet' did not run through the packet "
            "kernels and, for its base, the direct kernels alone")

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
                                          quant=quant,
                                          direct_launches=a["direct"])


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


def _step_once(counts, mode, iterations):
    """True when each step kernel of ``mode`` (kernels/step.py
    ``MODE_KERNELS``; None: the op-by-op step) launched ``iterations``
    times and no other step kernel launched."""
    from rtjax_torch.kernels import step as S
    mine = () if mode is None else S.MODE_KERNELS[mode]
    return all(v == (iterations if k in mine else 0)
               for k, v in counts["step"].items()) \
        and not any(counts["step_v1"].values())


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
    import importlib

    import numpy as np
    import torch
    from rtjax_torch import cli
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import read_ppm
    frames = []
    # the module, not rtjax_torch.render (the package's render function)
    R = importlib.import_module("rtjax_torch.render")
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
    zero: only the stats instances, once an iteration, and the mode's step
    kernels (the histogram in resolve), once an iteration; the histogram sums
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
        runs, c = _drive_eager(scene, camera, cfg, (2,))
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
    if not _step_once(c, "default_stats", st["iterations"]):
        raise RuntimeError("the detailed_stats frame did not run its step "
                           "kernels once an iteration")
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
    from zero around each (persist kernels alone, once an iteration; the
    mode's step kernels once an iteration, none of the others): the
    parity frame's mean within PARITY_MEAN_TOL of the parity artifact's,
    and its ratio to the default frame's within PARITY_RATIO_TOL of
    PARITY_RATIO; then a ``one_sample_mis`` headline frame (its step
    kernels once an iteration, no plain version) at the headline gate
    against the artifact.  Returns the parity frame's step launches too
    (``launches``)."""
    import dataclasses

    import numpy as np
    from rtjax_torch import RenderConfig
    from rtjax_torch.render.film import read_ppm
    base = RenderConfig(width=MODE_SIZE, height=MODE_SIZE,
                        num_samples=MODE_SPP, max_bounces=BOUNCES)
    means, launches = {}, {}
    for name, cfg in (("parity", dataclasses.replace(
            base, reference_parity=True)), ("default", base)):
        runs, c = _drive(scene, camera, cfg, (1,))
        secs, fb, st = runs[0]
        means[name] = _mean_u8(fb, MODE_SIZE, MODE_SIZE)
        mode = "parity" if name == "parity" else "default"
        print(f"[modes {name}] {card}: {MODE_SIZE}x{MODE_SIZE} @ {MODE_SPP} "
              f"spp, seed 1: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {secs:.3f} s, "
              f"{st['rays_traced'] / secs / 1e6:.3f} Mrays/s; image mean "
              f"{means[name]:.5f}; launches {c['persist']}, step kernels "
              f"{ {k: v for k, v in c['step'].items() if v} }")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the persist "
                               "kernels alone, once an iteration")
        if not _step_once(c, mode, st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the {mode} "
                               "step kernels once an iteration")
        launches[name] = c["step"]
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
          f"{c['persist']}, step kernels "
          f"{ {k: v for k, v in c['step'].items() if v} }")
    if not _only_set(c, "persist", st["iterations"]) or \
            ref_mse > floor["gate"] or \
            not _step_once(c, "default_1s", st["iterations"]):
        raise RuntimeError("the one_sample_mis frame failed its gate")
    return dict(means, artifact=art, ratio=ratio, osm_mse=ref_mse,
                launches=launches["parity"])


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
# ptxas registers of the binary kernels' default instances (the fetch
# design and the first), from this script's build on the card's toolkit
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): they must not change
BINARY_DEFAULT_MANGLED = {"fetch closest": "fetch_kernelILb0ELb0E",
                          "fetch any-hit": "fetch_kernelILb1ELb0E",
                          "first closest": "closest_kernelILb0E",
                          "first any-hit": "anyhit_kernelILb0E"}
BINARY_REGISTERS = {"fetch closest": 58, "fetch any-hit": 55,
                    "first closest": 56, "first any-hit": 48}
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
    return (f"work: {work['steps']} node-pair steps (the longest walk "
            f"{work['rounds']}), {work['leafs']} leaf "
            f"visits, {work['tri_tests']} triangles tested, {b['pairs']} "
            f"node pairs and {b['tris']} triangles read ({b['loads']} B "
            f"loaded, re-reads included); bound {b['bound_us']:.3f} us by "
            f"{b['bound_by']} ({b['bytes']} B at {PEAK_BYTES / 1e12} TB/s, "
            f"{b['ops']} float ops at {PEAK_FLOPS / 1e12} TFLOP/s)")


def _binary_ab(kind, args, got):
    """The first design against the fetch design on the same arguments:
    ``(mismatches, {"new": [ms, ms], "old": [ms, ms]})``, timed in turns
    (:func:`_ab_ms`)."""
    import torch
    from rtjax_torch.kernels import traversal as T
    fetch = getattr(T, f"traverse_{kind}")
    thread = getattr(T, f"traverse_{kind}_thread")
    old = thread(*args)
    torch.cuda.synchronize()
    flat = lambda r: [r] if isinstance(r, torch.Tensor) else \
        [t for v in r for t in flat(v)]
    mis = sum(int((a != b).sum()) for a, b in zip(flat(old), flat(got),
                                                    strict=True))
    new, old_ms = _ab_ms(lambda: fetch(*args), lambda: thread(*args))
    return mis, {"new": new, "old": old_ms, "mismatches": mis}


def _binary_ab_text(label, card, ab, b):
    new, old = statistics.mean(ab["new"]), statistics.mean(ab["old"])
    print(f"[{label} designs] {card}: {ab['mismatches']} "
          f"mismatches; fetch {ab['new'][0]:.4f}, "
          f"{ab['new'][1]:.4f} ms vs first design {ab['old'][0]:.4f}, "
          f"{ab['old'][1]:.4f} ms in turns (old, new, new, old): "
          f"{old / new:.2f}x; shares of the bound "
          f"{100 * b['bound_ms'] / new:.2f}% vs "
          f"{100 * b['bound_ms'] / old:.2f}%")


def _records_text(bvh, tris):
    """The fetch design's records (built here if not yet) beside the
    arrays they are packed from."""
    from rtjax_torch.kernels import traversal as T
    rec = T.binary_records(bvh, tris)
    arrays = sum(a.numel() * a.element_size() for a in (
        bvh.bmin, bvh.bmax, bvh.left_first, bvh.num_prims, tris.p0, tris.e1,
        tris.e2, tris.n))
    return (f"records {rec.pairs.shape[0]} pairs + {rec.tris.shape[0]} "
            f"triangles, {rec.nbytes / 2**20:.1f} MiB beside the arrays' "
            f"{arrays / 2**20:.1f} MiB")


def phase9_binary_kernels(scene, camera, card):
    """(a) Both binary-walk kernels against their plain versions on phase
    3's rays over the headline scene's binary BVH (2^18 closest-hit, 2^19
    any-hit rays): zero mismatches in hit, t, u, v, prim, normal and
    occlusion, correct dead lanes; hits, t and occlusion equal to the
    persist kernels' on the same rays (equal-t ties, where the two walks
    keep another prim, counted); device time per launch, one call, one
    plain call; the plain walk's counts and the bound; the stats
    instances' counts equal to the plain walk's and their results the
    default instances' bit for bit; the ptxas lines of every instance.
    The first design (one thread a ray, ``traverse_*_thread``)
    bit for bit against the fetch design the engine runs, and both timed
    in turns (:func:`_ab_ms`); the records' bytes beside the arrays'."""
    import torch
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import traversal as T
    regs = {}
    for name, res in _build.ptxas_report(_build.binary_library()):
        print(f"[binary ptxas] {name}: {res}")
        for label, mangled in BINARY_DEFAULT_MANGLED.items():
            if mangled in name:
                regs[label] = int(res.split("Used ")[1].split()[0])
    print(f"[binary ptxas] default instances' registers {regs}; recorded "
          f"{BINARY_REGISTERS}")
    if regs != BINARY_REGISTERS:
        raise RuntimeError("the binary kernels' registers differ from the "
                           "recorded ones")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = _test_rays(scene, camera, gen)
    return _check_binary("binary", scene, cl, ah, card)


def _check_binary(label, scene, cl, ah, card):
    """Phase 9 (a)'s checks of the binary kernels over ``scene``'s binary
    BVH on closest-hit rays ``cl`` and any-hit rays ``ah``, printed as
    ``[<label> closest|anyhit ...]``; ``{kind: record}``."""
    import torch
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import traversal as T
    bvh, tris = scene.bvh, scene.tris
    print(f"[{label} scene] {bvh.num_nodes} nodes, depth {bvh.max_depth}, "
          f"stack {T.stack_len(bvh)} entries a ray; "
          f"{_records_text(bvh, tris)}")
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
    first, ab = _binary_ab("closest", args, got)
    n, n_act = cl["tmax"].numel(), int(cl["active"].sum())
    b = _binary_bound(work, n, n_act, RAY_IN, BIN_CLOSEST_OUT)
    out["closest"] = dict(max_abs_err=float((tk[both] - tp[both]).abs().max())
                          if bool(both.any()) else 0.0, ms=ms[0],
                          ms_range=ms[1:], call_ms=call_ms,
                          plain_ms=plain_ms, share=b["bound_ms"] / ms[0],
                          counts=counts, ab=ab, **b)
    print(f"[{label} closest] {card}: {n} rays ({n_act} active), "
          f"{int(hk.sum())} hits; mismatches vs plain {mis}; stats instance:"
          f" counts {counts} vs plain ({work['steps']}, {work['leafs']}), "
          f"{smis} result mismatches; vs persist kernels {vs}; device "
          f"{ms[0]:.4f} ms a launch ({ms[1]:.4f}-{ms[2]:.4f}), one call "
          f"{call_ms:.4f} ms, plain {plain_ms:.1f} ms; {_binary_text(work, b)}"
          f"; {100 * out['closest']['share']:.2f}% of the bound")
    _binary_ab_text(f"{label} closest", card, ab, b)
    if any(mis.values()) or smis or vs["hit"] or vs["t"] or first or \
            counts != (work["steps"], work["leafs"]) or not bool(hk.any()):
        raise RuntimeError(f"{label}: binary closest-hit kernel disagrees "
                           "with its plain version or the persist kernel")

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
    mis["first_design"], ab = _binary_ab("anyhit", args, ok_)
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _binary_bound(work, n, n_act, RAY_IN + EXCLUDE, 1)
    out["anyhit"] = dict(max_abs_err=float(mis["occlusion"]), ms=ms[0],
                         ms_range=ms[1:], call_ms=call_ms, plain_ms=plain_ms,
                         share=b["bound_ms"] / ms[0], counts=counts, ab=ab,
                         **b)
    print(f"[{label} anyhit] {card}: {n} rays ({n_act} active), "
          f"{int(ok_.sum())} occluded; mismatches {mis}; stats instance "
          f"counts {counts} vs plain ({work['steps']}, {work['leafs']}); "
          f"device {ms[0]:.4f} ms a launch ({ms[1]:.4f}-{ms[2]:.4f}), one "
          f"call {call_ms:.4f} ms, plain {plain_ms:.1f} ms; "
          f"{_binary_text(work, b)}; {100 * out['anyhit']['share']:.2f}% of "
          f"the bound")
    _binary_ab_text(f"{label} anyhit", card, ab, b)
    if any(mis.values()) or counts != (work["steps"], work["leafs"]) or \
            not bool(ok_.any()):
        raise RuntimeError(f"{label}: binary any-hit kernel disagrees with "
                           "its plain version or the persist kernel")
    return out


# (b) and (c): the headline frame under each mode, and the persist frame it
# is timed beside
SORT_KEYS = ("morton", "prim", "prim_pos", "normal_pos", "adaptive",
             "morton_pos10")
# (d) the wide bundle: one frame above 2^21 pixels, and the two compact
# frames at half its width it is held to
WIDE_SIZE, WIDE_SPP = 2048, 4
WIDE_BOUNCES = 126     # the least max_bounces beyond the compact bundle
HALF_SIZE, HALF_SPP = 1024, 16


def _headline_cfg(**change):
    from rtjax_torch import RenderConfig
    return RenderConfig(**{**dict(width=WIDTH, height=HEIGHT,
                                  num_samples=SPP, max_bounces=BOUNCES),
                           **change})


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
    the xla frames launch the two binary kernels and the unsorted engine's
    step kernels once an iteration and nothing else; each image at phase
    4's gate.  Returns the binary kernels' launches over the two xla
    frames, the frame seconds and the step kernels' launches there."""
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm
    launches, step_launches = {"closest": 0, "anyhit": 0}, {}
    secs = {"xla": [], "persist": []}
    for mode, seed in (("xla", 2), ("persist", 2), ("persist", 3),
                       ("xla", 3)):
        cfg = _headline_cfg(traversal="xla") if mode == "xla" \
            else _headline_cfg()
        runs, c = _drive(scene, camera, cfg, (seed,))
        sec, fb, st = runs[0]
        ref_mse = _gate(f"traversal={mode} seed {seed}", fb, floor)
        kset = "binary" if mode == "xla" else "persist"
        step_mode = "unsorted" if mode == "xla" else "default"
        print(f"[xla frame {mode} seed {seed}] {card}: {WIDTH}x{HEIGHT} @ "
              f"{SPP} spp: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
              f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; MSE vs the "
              f"artifact {ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
              f"{c[kset]}, step kernels "
              f"{ {k: v for k, v in c['step'].items() if v} }")
        if not _only_set(c, kset, st["iterations"]):
            raise RuntimeError(f"the traversal={mode} frame did not run "
                               f"the {kset} kernels alone, once an iteration")
        if not _step_once(c, step_mode, st["iterations"]):
            raise RuntimeError(f"the traversal={mode} frame did not run the "
                               f"{step_mode} step kernels once an iteration")
        secs[mode].append(sec)
        if mode == "xla":
            for k in launches:
                launches[k] += c["binary"][k]
            for k, v in c["step"].items():
                step_launches[k] = step_launches.get(k, 0) + v
            write_ppm(_build.BUILD_DIR / f"xla_seed{seed}.ppm",
                      fb.cpu().numpy(), WIDTH, HEIGHT, binary=True)
    print(f"[xla frames] {card}: frame seconds xla {secs['xla']}, persist "
          f"{secs['persist']}")
    return launches, secs, step_launches


def phase9_sort_keys(scene, camera, card, floor):
    """(c) The headline frame (seed 2) under each sort key but the default
    and once with sort_rays=False, counts from zero: the persist kernels
    alone, once an iteration, and the step kernels of the mode (the
    unsorted engine's under sort_rays=False) once an iteration; each
    image at phase 4's gate."""
    out = {}
    for name, change in ([(k, dict(sort_key=k)) for k in SORT_KEYS]
                         + [("no_sort", dict(sort_rays=False))]):
        runs, c = _drive(scene, camera, _headline_cfg(**change), (2,))
        sec, fb, st = runs[0]
        ref_mse = _gate(name, fb, floor)
        step_mode = "unsorted" if name == "no_sort" else "default"
        print(f"[sort mode {name}] {card}: {st['iterations']} iterations, "
              f"{st['rays_traced']:.0f} rays, {sec:.3f} s, "
              f"{st['rays_traced'] / sec / 1e6:.3f} Mrays/s; MSE vs the "
              f"artifact {ref_mse:.3e} (gate {floor['gate']:.3e}); launches "
              f"{c['persist']}, step kernels "
              f"{ {k: v for k, v in c['step'].items() if v} }")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the persist "
                               "kernels alone, once an iteration")
        if not _step_once(c, step_mode, st["iterations"]):
            raise RuntimeError(f"the {name} frame did not run the "
                               f"{step_mode} step kernels once an iteration")
        out[name] = sec
    return out


def phase9_wide_bundle(scene, camera, card):
    """(d) cornell_bunny at WIDE_SIZE^2 @ WIDE_SPP (above 2^21 pixels: the
    wide sort bundle) and at HALF_SIZE^2 @ HALF_SPP (the compact bundle),
    seeds 2 and 3, counts from zero (persist kernels alone, once an
    iteration, and the bundle's step kernels, ``"wide"`` or ``"default"``,
    once an iteration).  Gate: the wide frame's linear radiance box-downsampled
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
              f"{c['persist']}, step kernels "
              f"{ {k: v for k, v in c['step'].items() if v} }")
        if not _only_set(c, "persist", st["iterations"]):
            raise RuntimeError("the wide-bundle frames did not run the "
                               "persist kernels alone, once an iteration")
        if not _step_once(c, "default" if compact else "wide",
                          st["iterations"]):
            raise RuntimeError("the wide-bundle frames did not run their "
                               "step kernels once an iteration")
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
            fetch_ab_ms=r["ab"]["new"], first_design_ms=r["ab"]["old"],
            note="rtjax's binary-BVH walk (an XLA while_loop, no "
                 "pallas_call), the fetch design; first_design_ms: the "
                 "first design, one thread a ray, timed in turns with it; "
                 "launches over phase 9(b)'s two traversal='xla' headline "
                 "frames"))
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
    got = {(k, kind): n for k in _KERNEL_SETS
           for kind, n in counts[k].items()}
    expect = {key: want.get(key, 0) for key in got}
    return got == expect and counts["plain"] == 0


def phase10_stats_frames(scene, camera, c4_scene, c4_camera, card, floor,
                         c4_floor):
    """(b) detailed_stats frames, counts from zero around each: the
    headline under walker="packet" (and the packet any hit) and under
    walker="lane" with anyhit_walker="packet", each at phase 4's gate; config
    4 under two_level="kernel", within 2x phase 6(a)'s seed-to-seed MSE
    plus the 8-bit term of its repass frame.  Each frame launches its
    kernels' stats instances alone and the step kernels of
    ``detailed_stats``, once an iteration, and its histogram
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
        if not _expect_only(c, {key: its for key in want}) or \
                not _step_once(c, "default_stats", its):
            raise RuntimeError(f"the {label} detailed_stats frame did not "
                               "run its stats instances alone and its step "
                               "kernels, once an iteration")
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
    orig = wavefront.render_frame_linear = _frame_log(
        wavefront.render_frame_linear)

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


# --------------------------------------------------------------- phase 11
# the big-scene tier: benchmarks/bigscene_proof.py's heightfield (a G x G
# grid, Y = 0.25 sin 3X cos 3Z, two triangles a cell, one matte material,
# its area light and camera) at 3,998,792 and 7,597,202 triangles; the
# second has more than 2^20 leaf rows, past the f32 meta mirror's cap
# (accel/wide.py META_CAP; ROADMAP [C 1])
BIG_GRIDS = (1415, 1950)
BIG_SIZE = 128         # bigscene_proof.py's frame: 128x128 @ 4 spp, 4
BIG_SPP = 4            # bounces
BIG_BOUNCES = 4
BIG_RAYS = 1 << 16     # (b): camera rays, and twice as many shadow rays
BIG_BRUTE_RAYS = 1024  # (c): rays held against every triangle
# (b) keeps the rays of this launch of each persist kernel of the seed-1
# frame: the first bounce's path rays, and the shadow rays of the camera
# rays' hits
BIG_CAPTURE_AT = 2
# the light triangle of the heightfield scene
BIG_LIGHT = ((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (0.0, 3.0, 1.0))


def _heightfield(g):
    """bigscene_proof.py's scene at grid ``g``: ``(builder, camera)``."""
    import numpy as np
    from rtjax_torch import Camera, SceneBuilder
    xs = np.linspace(-2, 2, g, dtype=np.float64)
    x, z = np.meshgrid(xs, xs)
    y = 0.25 * np.sin(3 * x) * np.cos(3 * z)
    v = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    i = np.arange(g - 1)
    ii, jj = np.meshgrid(i, i, indexing="ij")
    a = (ii * g + jj).ravel()
    c = a + g
    f = np.concatenate([np.stack([a, a + 1, c], 1),
                        np.stack([a + 1, c + 1, c], 1)])
    b = SceneBuilder()
    b.add_mesh(v, f, b.make_matte((0.6, 0.6, 0.6)))
    b.add_area_light(*BIG_LIGHT, (12.0, 12.0, 12.0),
                     b.make_matte((0.0, 0.0, 0.0)))
    camera = Camera.make((0, 2.5, 4.5), (0, 0, 0), (0, 1, 0), 45, 1.0,
                         "cuda")
    return b, camera


def _timed_build(builder):
    """``builder.build("cuda")`` with its parts timed: ``(scene, {"total",
    "bvh", "collapse", "upload", "rest"})`` in seconds, ``bvh`` the native
    BVH build, ``collapse`` the wide tables' collapse and packing, and
    ``upload`` their copy to the card (scene/scene.py's names rebound for
    the build); ``rest`` is the leaf-order permutation, the light table
    and the triangles' and binary BVH's copies."""
    import torch
    from rtjax_torch.accel import wide
    from rtjax_torch.scene import scene as scene_mod
    secs = {"bvh": 0.0, "wide": 0.0, "upload": 0.0}
    saved = (scene_mod.build_bvh_best, scene_mod.build_wide_tables,
             wide.WideTables.from_arrays)

    def timing(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            return out
        return run

    scene_mod.build_bvh_best = timing("bvh", saved[0])
    scene_mod.build_wide_tables = timing("wide", saved[1])
    wide.WideTables.from_arrays = staticmethod(timing("upload", saved[2]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene = builder.build("cuda")
        torch.cuda.synchronize()
        secs["total"] = time.perf_counter() - t0
    finally:
        scene_mod.build_bvh_best, scene_mod.build_wide_tables = saved[:2]
        wide.WideTables.from_arrays = staticmethod(saved[2])
    secs["collapse"] = secs.pop("wide") - secs["upload"]
    secs["rest"] = secs["total"] - secs["bvh"] - secs["collapse"] \
        - secs["upload"]
    return scene, secs


def _big_rays(scene, camera, gen):
    """(b)'s ray sets: BIG_RAYS camera rays over the frame, 10% inactive,
    and 2 BIG_RAYS shadow rays from the camera rays' hits (the persist
    kernel's), excluding the hit prim, inactive where the camera ray is
    inactive or missed: the first half toward random points of the light
    (tmax just short of it), the second along random shallow directions
    (elevation below ~17 degrees, tmax infinite), which the hills occlude
    where light from above never is."""
    import torch
    from rtjax_torch.core import vec
    from rtjax_torch.kernels import persist as P
    dev = gen.device
    n = BIG_RAYS
    rnd = lambda m: torch.rand(m, generator=gen, device=dev)
    o, d = camera.get_rays_v3(rnd(n), rnd(n))
    cl = dict(o=tuple(c.contiguous() for c in o), d=d,
              tmax=torch.full((n,), float("inf"), device=dev),
              active=rnd(n) > 0.1)
    hit, t, prim, _ = P.persist_traverse_closest(
        scene.tables, cl["o"], cl["d"], cl["tmax"], cl["active"])
    t = torch.where(hit, t, 0.0)
    rep = lambda a: torch.cat([a, a])
    p = tuple(rep(oc + t * dc) for oc, dc in zip(cl["o"], cl["d"]))
    u, v = rnd(2 * n), rnd(2 * n)
    flip = u + v > 1.0
    u, v = torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)
    l0, l1, l2 = BIG_LIGHT
    target = tuple(l0[k] + u * (l1[k] - l0[k]) + v * (l2[k] - l0[k])
                   for k in range(3))
    to = vec.sub(target, p)
    dist = vec.length(to)
    g = torch.randn(3, 2 * n, generator=gen, device=dev)
    low = vec.normalize((g[0], 0.3 * g[1].abs(), g[2]))
    first = torch.arange(2 * n, device=dev) < n
    ah = dict(o=tuple(c.contiguous() for c in p),
              d=tuple(torch.where(first, a / dist, b).contiguous()
                      for a, b in zip(to, low)),
              tmax=torch.where(first, dist * 0.999, float("inf")),
              exclude=torch.where(rep(hit), rep(prim), -1), active=rep(hit))
    return cl, ah


def _stack3(v3, idx):
    import torch
    return torch.stack([c[idx] for c in v3], 1)


def _ties_ok(tris, o, d, tmax, prim, t):
    """Every ray's ``prim`` hits it at exactly ``t`` (the same test as the
    kernels' and the oracle's): a prim other than the oracle's is then a
    tie at equal t."""
    from rtjax_torch.core.geometry import intersect_triangle_v3
    p = prim.long()
    g = lambda a: tuple(a[p, k] for k in range(3))
    h, tt, _, _ = intersect_triangle_v3(
        tuple(o[:, k] for k in range(3)), tuple(d[:, k] for k in range(3)),
        tmax, g(tris.p0), g(tris.e1), g(tris.e2), g(tris.n))
    return bool(h.all()) and bool((tt == t).all())


def _against_brute(label, scene, cl, ah, card):
    """(c) The persist, packet, lane and binary-walk kernels against the
    all-triangles oracle (kernels/brute.py) on BIG_BRUTE_RAYS camera rays
    and as many shadow rays (half of either kind of (b)'s): hit, t and
    occlusion equal, prim equal but at
    ties of equal t; and the binary walk's hits, t and occlusion against
    the persist kernels' on every ray (prim ties counted).  Returns
    ``{walk: {"closest": {...}, "anyhit": {...}}}``."""
    import torch
    from rtjax_torch.kernels import brute
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import traversal as T
    from rtjax_torch.kernels import wide as WD
    m = BIG_BRUTE_RAYS
    n = cl["tmax"].numel()
    ci = torch.arange(m, device=cl["tmax"].device)
    si = torch.cat([ci[:m // 2], n + ci[:m - m // 2]])
    o, d = _stack3(cl["o"], ci), _stack3(cl["d"], ci)
    tmax, act = cl["tmax"][ci], cl["active"][ci]
    (bh, bt, _, _, bp, _), brute_ms = _timed_ms(
        lambda: brute.closest_brute(scene.tris, o, d, tmax, act))
    so, sd = _stack3(ah["o"], si), _stack3(ah["d"], si)
    stmax, sex, sact = ah["tmax"][si], ah["exclude"][si], ah["active"][si]
    bocc, brute_any_ms = _timed_ms(
        lambda: brute.anyhit_brute(scene.tris, so, sd, stmax, sex, sact))
    tab = scene.tables
    cargs = (cl["o"], cl["d"], cl["tmax"], cl["active"])
    aargs = (ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    runs = {
        "persist": (P.persist_traverse_closest(tab, *cargs),
                    P.persist_traverse_anyhit(tab, *aargs)),
        "packet": (WD.wide_traverse_closest(tab, *cargs),
                   WD.wide_traverse_anyhit(tab, *aargs)),
        "lane": (L.lane_traverse_closest(tab, *cargs),
                 L.lane_traverse_anyhit(tab, *aargs))}
    bk = T.traverse_closest(scene.bvh, scene.tris, *cargs)
    runs["binary"] = ((bk[0], bk[1], bk[4], bk[5]),
                      T.traverse_anyhit(scene.bvh, scene.tris, *aargs))
    torch.cuda.synchronize()
    out, bad = {}, []
    ph, pt, pp, _ = runs["persist"][0]
    for walk, ((h, t, p, _), occ) in runs.items():
        hm, tm, pm = h[:m], t[:m], p[:m]
        both = hm & bh
        diff = both & (pm != bp)
        ties_ok = _ties_ok(scene.tris, o[diff], d[diff], tmax[diff],
                           pm[diff], bt[diff]) if bool(diff.any()) else True
        rec = {"closest": {"hit": int((hm != bh).sum()),
                           "t": int((tm[both] != bt[both]).sum()),
                           "prim_ties": int(diff.sum()),
                           "max_abs_err": float((tm[both] - bt[both]).abs()
                                                .max()) if bool(both.any())
                           else 0.0},
               "anyhit": {"occlusion": int((occ[si] != bocc).sum())}}
        if walk != "persist":
            all_both = h & ph
            rec["vs_persist"] = {
                "hit": int((h != ph).sum()),
                "t": int((t[all_both] != pt[all_both]).sum()),
                "ties": int((p[all_both] != pp[all_both]).sum()),
                "occlusion": int((occ != runs["persist"][1]).sum())}
        out[walk] = rec
        if rec["closest"]["hit"] or rec["closest"]["t"] or not ties_ok \
                or rec["anyhit"]["occlusion"] \
                or any(v for k, v in rec.get("vs_persist", {}).items()
                       if k != "ties"):
            bad.append(walk)
    print(f"[{label} brute] {card}: {m} camera rays ({int(act.sum())} "
          f"active, {int(bh.sum())} hits) and {m} shadow rays "
          f"({int(bocc.sum())} occluded) against all {scene.tris.num} "
          f"triangles (closest {brute_ms:.1f} ms, any hit "
          f"{brute_any_ms:.1f} ms); mismatches by kernel {out}")
    if bad or not bool(bh.any()) or not bool(bocc.any()):
        raise RuntimeError(f"{label}: the {bad} kernels disagree with the "
                           "all-triangles oracle or the persist kernels")
    return out


def _square_u8(fb, size):
    """A square framebuffer of side ``size`` in 8-bit steps, as floats."""
    import numpy as np
    from rtjax_torch.render.film import to_u8
    return to_u8(fb.cpu().numpy(), size, size).astype(np.float64) / 255.0


def _big_frames(label, scene, camera, card, xla):
    """(d) bigscene_proof.py's frame on the kernels, seeds 1 and 2, counts
    from zero: the persist kernels alone, once an iteration; the seed-1
    frame keeps launch BIG_CAPTURE_AT of each persist kernel.  With
    ``xla``, the frame again under traversal="xla" (seed 3: the binary
    kernels alone, once an iteration), within 2x the kernel frames'
    seed-to-seed MSE (8 bit, plus the quantisation term).  Returns
    ``(captured, {"seconds", "mrays", "launches", ...})``."""
    import dataclasses

    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import write_ppm
    from rtjax_torch.render.wavefront import render_frame
    cfg = RenderConfig(width=BIG_SIZE, height=BIG_SIZE, num_samples=BIG_SPP,
                       max_bounces=BIG_BOUNCES)
    _zero_counts()
    captured, restore = _capture_launch(BIG_CAPTURE_AT)
    runs = []
    for seed in (1, 2):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the seed-1 frame keeps launch BIG_CAPTURE_AT: the eager loop
        fb, st = _render_eager(scene, camera, cfg, gen) if seed == 1 \
            else render_frame(scene, camera, cfg, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, fb, st))
        if seed == 1:
            restore()
    counts = _read_counts()
    its = sum(r[2]["iterations"] for r in runs)
    sec, _, st = runs[1]
    out = {"seconds": [r[0] for r in runs], "iterations": its,
           "rays": st["rays_traced"], "mrays": st["rays_traced"] / sec / 1e6,
           "launches": dict(counts["persist"])}
    imgs = [_square_u8(r[1], BIG_SIZE) for r in runs]
    means = [float(r[1].mean()) for r in runs]
    seed_mse = float(np.mean((imgs[0] - imgs[1]) ** 2))
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    for (sec_, fb, _), seed in zip(runs, (1, 2)):
        write_ppm(_build.BUILD_DIR / f"bigscene_{label}_seed{seed}.ppm",
                  fb.cpu().numpy(), BIG_SIZE, BIG_SIZE, binary=True)
    print(f"[{label} frames] {card}: {BIG_SIZE}x{BIG_SIZE} @ {BIG_SPP} spp, "
          f"{BIG_BOUNCES} bounces: seeds 1 and 2 {out['seconds'][0]:.3f} / "
          f"{out['seconds'][1]:.3f} s, {st['iterations']} iterations, "
          f"{st['rays_traced']:.0f} rays, {out['mrays']:.3f} Mrays/s (seed "
          f"2); framebuffer means {means[0]:.4f} / {means[1]:.4f}; "
          f"seed-to-seed MSE {seed_mse:.3e}; launches {counts['persist']} "
          f"over {its} iterations, plain calls {counts['plain']}")
    if not _only_set(counts, "persist") or any(
            v != its for v in counts["persist"].values()) \
            or min(means) <= 0 or set(captured) != {"closest", "anyhit"}:
        raise RuntimeError(f"{label}: the frames did not run the persist "
                           "kernels alone, once an iteration, or are black")
    if xla:
        runs_x, cx = _drive(scene, camera,
                            dataclasses.replace(cfg, traversal="xla"), (3,))
        sec_x, fb_x, st_x = runs_x[0]
        xla_mse = float(np.mean((_square_u8(fb_x, BIG_SIZE) - imgs[1]) ** 2))
        gate = 2.0 * seed_mse + quant
        out.update(xla_seconds=sec_x, xla_mse=xla_mse, seed_mse=seed_mse,
                   xla_mrays=st_x["rays_traced"] / sec_x / 1e6)
        print(f"[{label} xla frame] {card}: seed 3, {sec_x:.3f} s, "
              f"{st_x['iterations']} iterations, {out['xla_mrays']:.3f} "
              f"Mrays/s; MSE vs the seed-2 kernel frame {xla_mse:.3e}, gate "
              f"{gate:.3e}; launches {cx['binary']}")
        if not _only_set(cx, "binary", st_x["iterations"]) \
                or xla_mse > gate or float(fb_x.mean()) <= 0:
            raise RuntimeError(f"{label}: the xla frame did not run the "
                               "binary kernels alone or differs from the "
                               "kernel frames beyond their noise")
    return captured, out


def phase11_bigscene(card):
    """The big-scene tier at each of BIG_GRIDS: (a) the heightfield built
    on the card, its parts timed, with wide tables that resolve to the
    kernels ("pallas"); (d) bigscene_proof.py's frame on the kernels (and
    under traversal="xla"); (b) the persist kernels (both designs) against
    their plain versions bit for bit, timed, with their bound, and the
    packet and lane kernels against the plain group walk and the persist
    kernels, on BIG_RAYS camera rays with their shadow rays and on
    launch BIG_CAPTURE_AT of the seed-1 frame; (c) the kernels against the
    all-triangles oracle and the binary walk, and the binary kernels (both
    designs) against their plain versions on (b)'s rays, timed, with their
    bound (:func:`_check_binary`, at the largest grid).  Returns ``{grid:
    {...}}``, (e) being (b)'s persist numbers at the largest grid."""
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import trace
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    out = {}
    for g in BIG_GRIDS:
        label = f"bigscene {g}"
        builder, camera = _heightfield(g)
        scene, secs = _timed_build(builder)
        del builder
        tab = scene.tables
        mode = trace.resolve_mode(scene, RenderConfig())
        w = tab.width if tab is not None else 0
        mirror = "NaN" if tab is not None and bool(
            torch.isnan(tab.node_bounds[0, 6 * w])) else "exact"
        print(f"[{label} build] {card}: {scene.tris.num} triangles, "
              f"{scene.bvh.num_nodes} binary nodes, depth "
              f"{scene.bvh.max_depth}; "
              + (f"{w}-wide tables, {tab.num_wide_nodes} wide nodes, "
                 f"{tab.num_leaf_rows} leaf rows, "
                 f"{tab.nbytes / 2**20:.1f} MiB ({tab.nbytes / max(l2, 1):.1f}"
                 f"x the card's {l2 / 2**20:.0f} MiB L2), meta mirror "
                 f"{mirror}; " if tab is not None else "no wide tables; ")
              + f"resolves to {mode!r}; built in {secs['total']:.1f} s: "
              f"native BVH {secs['bvh']:.1f} s, collapse and packing "
              f"{secs['collapse']:.1f} s, upload {secs['upload']:.2f} s, "
              f"the rest {secs['rest']:.1f} s")
        if tab is None or mode != "pallas":
            raise RuntimeError(f"{label}: the scene has no wide tables or "
                               "does not resolve to the kernels")
        rec = dict(triangles=scene.tris.num, depth=scene.bvh.max_depth,
                   width=w, wide_nodes=tab.num_wide_nodes,
                   leaf_rows=tab.num_leaf_rows, table_mib=tab.nbytes / 2**20,
                   mirror=mirror, build_s=secs)
        captured, rec["frames"] = _big_frames(label, scene, camera, card,
                                              xla=True)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        cl, ah = _big_rays(scene, camera, gen)
        rec["persist"] = _check_persist(label, tab, cl, ah, card,
                                        plain_once=True)
        rec["group"] = _check_group(label, tab, cl, ah, card,
                                    rec["persist"])
        tab_c, icl = captured["closest"]
        tab_a, iah = captured["anyhit"]
        if tab_c is not tab or tab_a is not tab:
            raise RuntimeError(f"{label}: the captured launches used other "
                               "tables")
        in_frame = f"{label} in-frame launch {BIG_CAPTURE_AT}"
        # the heightfield's hills shadow no light from above: the frame's
        # shadow rays may all reach the light
        rec["persist_in_frame"] = _check_persist(in_frame, tab, icl, iah,
                                                 card, need_occluded=False,
                                                 plain_once=True)
        rec["group_in_frame"] = _check_group(in_frame, tab, icl, iah, card,
                                             rec["persist_in_frame"],
                                             need_occluded=False)
        rec["brute"] = _against_brute(label, scene, cl, ah, card)
        if g == BIG_GRIDS[-1]:
            rec["binary"] = _check_binary(f"{label} binary", scene, cl, ah,
                                          card)
        out[g] = rec
        del scene, tab, captured, cl, ah, icl, iah
        torch.cuda.empty_cache()
    return out


def _big_record(r, kind):
    """A persist kernel's big-scene numbers at one grid, for its row."""
    return {k: r[kind][k] for k in ("ms", "stride_ms", "call_ms", "plain_ms",
                                    "bound_us", "bound_by", "share",
                                    "max_abs_err")}


def _big_rows(big):
    """``{row name: {grid: record}}``: phase 11's numbers for the rows of
    the persist, packet, lane and binary-walk kernels.  A persist row's
    record holds (b)'s device time, bound and share on the camera and
    shadow rays and on the in-frame launch ((e) at the largest grid), its
    launches over (d)'s two kernel frames, and (c)'s mismatches against
    the oracle."""
    rows = {}
    for g, rec in big.items():
        for kind in ("closest", "anyhit"):
            rows.setdefault(KERNELS[kind]["name"], {})[g] = dict(
                _big_record(rec["persist"], kind),
                in_frame=_big_record(rec["persist_in_frame"], kind),
                launches=rec["frames"]["launches"][kind],
                brute=rec["brute"]["persist"][kind])
            for walk in ("packet", "lane"):
                r, ri = rec["group"][walk, kind], rec["group_in_frame"][
                    walk, kind]
                pick = lambda x: {k: x[k] for k in (
                    "ms", "call_ms", "plain_ms", "err", "share",
                    "group_share")}
                rows.setdefault(GROUP_KERNELS[walk, kind]["name"], {})[g] = \
                    dict(pick(r), in_frame=pick(ri),
                         brute=rec["brute"][walk][kind],
                         vs_persist=rec["brute"][walk]["vs_persist"])
            rb = rec.get("binary", {}).get(kind, {})
            rows.setdefault(BINARY_KERNELS[kind]["name"], {})[g] = dict(
                brute=rec["brute"]["binary"][kind],
                vs_persist=rec["brute"]["binary"]["vs_persist"],
                **{k: rb[k] for k in ("ms", "call_ms", "plain_ms", "bound_us",
                                      "bound_by", "share", "ab") if k in rb})
    return rows


# --------------------------------------------------------------- phase 12
# rtjax's tiny-scene direct path, eval configs 2 and 3

DIRECT_KERNELS = {
    "closest": dict(name="direct_closest",
                    replaces="rtjax/render/trace.py:98"),
    "anyhit": dict(name="direct_anyhit",
                   replaces="rtjax/render/trace.py:137"),
}
DIRECT_SOURCE = "rtjax_torch/csrc/direct_traverse.cu"
DIRECT_NAMES = {"closest": "direct_closest", "anyhit": "direct_anyhit"}
# config 2 (benchmarks/run_configs.py:182-187): Cornell planes, 512^2 @ 64
# spp, 10 bounces, the default pool
C2_SIZE, C2_SPP, C2_BOUNCES = 512, 64, 10
# config 3 (benchmarks/run_configs.py:189-196): the glass bunny on a mirror
# floor, 256^2 @ 16 spp, 8 bounces
C3_SPP, C3_BOUNCES = 16, 8
# the CLI scene cornell_bunny_glass at 256^2 @ 64 spp, against rtjax's
# render in artifacts/ (its render settings are not recorded)
C3_ARTIFACT = os.path.join(ROOT, "artifacts",
                           "cornell_bunny_glass_256_64spp.ppm")
# (a) the direct kernels also over soups of these many triangles (one
# 64-triangle tile, and several) on config 2's rays
DIRECT_SOUPS = (64, 300)


def _direct_bound(n, n_active, n_tris, in_bytes, out_bytes, tests):
    """The least time of a direct launch over ``n`` rays (``n_active``
    active) and ``n_tris`` triangles that needs ``tests`` triangle tests:
    each ray's flag and results and an active ray's inputs, and each
    triangle (48 B) once, over 3.35 TB/s; one Moeller-Trumbore test
    (OPS_TRI) a test over 67 TFLOP/s."""
    nbytes = n * (RAY_FLAGS + out_bytes) + n_active * in_bytes \
        + n_tris * TRI_BYTES
    ops = OPS_TRI * tests
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_us=max(t_ops, t_bytes)
                * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, bytes=nbytes, tests=tests)


def _anyhit_tests(tris, ah):
    """Triangle tests the any-hit rays ``ah`` need: every active ray tests
    the triangles in order up to its first occluder (all of them when none
    occludes it)."""
    import torch
    from rtjax_torch.core.geometry import intersect_triangle_v3
    live = ah["active"].clone()
    tests = torch.zeros((), dtype=torch.int64, device=live.device)
    for k in range(tris.num):
        tests += live.sum()
        row = lambda a: (a[k, 0], a[k, 1], a[k, 2])
        h, _, _, _ = intersect_triangle_v3(ah["o"], ah["d"], ah["tmax"],
                                           row(tris.p0), row(tris.e1),
                                           row(tris.e2), row(tris.n))
        live &= ~(h & (ah["exclude"] != k))
    return int(tests)


def _check_direct(label, tris, cl, ah, card):
    """Both direct kernels on the closest-hit rays ``cl`` and any-hit rays
    ``ah`` over ``tris``: bit for bit against their plain versions (hit,
    t, prim, normal and occlusion on every lane) and against the
    all-triangles oracle (hit, t, prim and occlusion: both keep the first
    triangle of least t); device time a launch, one call, one plain call,
    and the bound; any hit's first design bit for bit too and timed in
    turns with the engine's (``ab``, ``v1_ms``).  Returns ``{"closest":
    {...}, "anyhit": {...}}``."""
    import torch
    from rtjax_torch.kernels import brute
    from rtjax_torch.kernels import direct as D
    out = {}
    cargs = (tris, cl["o"], cl["d"], cl["tmax"], cl["active"])
    ref, plain_ms = _timed_ms(lambda: D.direct_closest_ref(*cargs))
    got = D.direct_closest(*cargs)
    _, call_ms = _timed_ms(lambda: D.direct_closest(*cargs))
    hk, tk, pk, nk = got
    mis = {k: int((a != b).sum()) for k, a, b in
           zip(("hit", "t", "prim"), got[:3], ref[:3])}
    mis["normal"] = int(sum((a != b).sum() for a, b in zip(nk, ref[3])))
    o3, d3 = (torch.stack(cl[k], 1) for k in ("o", "d"))
    bh, bt, _, _, bp, _ = brute.closest_brute(tris, o3, d3, cl["tmax"],
                                              cl["active"])
    vs = {"hit": int((hk != bh).sum()), "t": int((tk[hk] != bt[hk]).sum()),
          "prim": int((pk[hk] != bp[hk]).sum())}
    ms = _launch_ms(lambda: D.direct_closest(*cargs))
    n, n_act = cl["tmax"].numel(), int(cl["active"].sum())
    b = _direct_bound(n, n_act, tris.num, RAY_IN, CLOSEST_OUT,
                      n_act * tris.num)
    out["closest"] = dict(max_abs_err=float((tk - ref[1]).abs().max()),
                          ms=ms[0], ms_range=ms[1:], call_ms=call_ms,
                          plain_ms=plain_ms, share=b["bound_ms"] / ms[0],
                          hits=int(hk.sum()), **b)
    print(f"[{label} direct closest] {card}: {n} rays ({n_act} active) x "
          f"{tris.num} triangles, {int(hk.sum())} hits; mismatches vs plain "
          f"{mis}, vs the oracle {vs}; device {ms[0]:.4f} ms a launch "
          f"({ms[1]:.4f}-{ms[2]:.4f}), one call {call_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms; bound {b['bound_us']:.3f} us by "
          f"{b['bound_by']} ({b['bytes']} B, {b['ops']} float ops); "
          f"{100 * out['closest']['share']:.2f}% of the bound")
    if any(mis.values()) or any(vs.values()) or not bool(hk.any()):
        raise RuntimeError(f"{label}: the direct closest-hit kernel "
                           "disagrees with its plain version or the oracle")

    aargs = (tris, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
             ah["active"])
    occ_ref, plain_ms = _timed_ms(lambda: D.direct_anyhit_ref(*aargs))
    occ = D.direct_anyhit(*aargs)
    _, call_ms = _timed_ms(lambda: D.direct_anyhit(*aargs))
    so3, sd3 = (torch.stack(ah[k], 1) for k in ("o", "d"))
    bocc = brute.anyhit_brute(tris, so3, sd3, ah["tmax"], ah["exclude"],
                              ah["active"])
    mis = {"occlusion": int((occ != occ_ref).sum()),
           "vs_oracle": int((occ != bocc).sum()),
           "v1": int((D.direct_anyhit_v1(*aargs) != occ_ref).sum())}
    ms = _launch_ms(lambda: D.direct_anyhit(*aargs))
    ab = _ab_ms(lambda: D.direct_anyhit(*aargs),
                lambda: D.direct_anyhit_v1(*aargs))
    n, n_act = ah["tmax"].numel(), int(ah["active"].sum())
    b = _direct_bound(n, n_act, tris.num, RAY_IN + EXCLUDE, 1,
                      _anyhit_tests(tris, ah))
    out["anyhit"] = dict(max_abs_err=float(mis["occlusion"]), ms=ms[0],
                         ms_range=ms[1:], call_ms=call_ms, plain_ms=plain_ms,
                         share=b["bound_ms"] / ms[0],
                         occluded=int(occ.sum()), ab=ab,
                         v1_ms=statistics.mean(ab[1]), **b)
    print(f"[{label} direct anyhit] {card}: {n} rays ({n_act} active) x "
          f"{tris.num} triangles, {int(occ.sum())} occluded; mismatches "
          f"{mis}; device {ms[0]:.4f} ms a launch ({ms[1]:.4f}-"
          f"{ms[2]:.4f}), one call {call_ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms; bound {b['bound_us']:.3f} us by {b['bound_by']} "
          f"({b['bytes']} B, {b['tests']} tests, {b['ops']} float ops); "
          f"{100 * out['anyhit']['share']:.2f}% of the bound; in turns "
          f"v1, engine, engine, v1: engine {ab[0]} ms, first design "
          f"{ab[1]} ms ({100 * b['bound_ms'] / out['anyhit']['v1_ms']:.2f}"
          f"%)")
    if any(mis.values()):
        raise RuntimeError(f"{label}: a direct any-hit kernel disagrees "
                           "with its plain version or the oracle")
    return out


# (a) the activity masks every design is held on, over config 2's rays
DIRECT_MASKS = ("all", "none", "scattered", "one_a_warp", "prefix")
# (f) captured frames of any hit's two designs, in a process of its own
DIRECT_FRAMES_TIMEOUT = 300


def _direct_mask(kind, n):
    """``[n]`` bool on the card: every lane, none, 28% scattered, lane 5
    of each warp of 32, or the first 40% of the lanes."""
    import torch
    i = torch.arange(n, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(28)
    return {"all": i >= 0, "none": i < 0,
            "scattered": torch.rand(n, generator=g, device="cuda") < 0.28,
            "one_a_warp": i % 32 == 5, "prefix": i < (2 * n) // 5}[kind]


def _direct_designs(tris, cl, ah, card):
    """(a) on config 2's launches, the measurements the designs were
    chosen by (tools/direct_designs.py): each kernel's SASS counts
    (instructions, LDS and LDC a test), each design's device ms on the
    rays as they are, with every lane inactive (the floor) and every lane
    active (any hit's two designs in turns), the SIMT efficiency of the
    lanes in order and compacted; and every design bit for bit against
    the plain versions under DIRECT_MASKS."""
    import torch
    from rtjax_torch.kernels import _build
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import direct_designs as DD
    sass = DD.sass(_build.direct_library())
    for name, r in sass.items():
        print(f"[direct sass] {card}: {name}: {DD.sass_text(name, r)}")
    out = dict(sass=sass, rays={
        kind: DD.check_rays("config2", kind, tris, rays, card)
        for kind, rays in (("closest", cl), ("anyhit", ah))})
    bad = {k: r["mismatches"] for k, r in out["rays"].items()
           if any(r["mismatches"].values())}
    masks = {}
    for kind in DIRECT_MASKS:
        c = dict(cl, active=_direct_mask(kind, cl["active"].numel()))
        a = dict(ah, active=_direct_mask(kind, ah["active"].numel()))
        masks[kind] = {f"{k} {arm}": v
                       for k, r in (("closest", c), ("anyhit", a))
                       for arm, v in DD.equal_plain(k, tris, r).items()}
    torch.cuda.synchronize()
    print(f"[config2 direct masks] {card}: mismatching lanes against the "
          f"plain versions under each activity mask {masks}")
    if bad or any(v for m in masks.values() for v in m.values()):
        raise RuntimeError(f"config 2: a direct design disagrees with its "
                           f"plain version: {bad} {masks}")
    out["masks"] = masks
    return out


def _direct_frames(card):
    """(f) captured frames of config 2 and config 4 (a) on any hit's two
    designs in turns, and one profiled frame of each
    (tools/direct_designs.py ``--frames``, in a process of its own):
    closest hit once an iteration in both arms, any hit's engine design
    or its first design once an iteration and the other never, equal rays
    traced, each seed's pair within phase (c)'s image gate.  Returns the
    tool's numbers."""
    import torch
    from rtjax_torch.kernels import _build
    out = _build.BUILD_DIR / "direct_frames.pt"
    if out.exists():
        out.unlink()
    p = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "direct_designs.py"),
                        "--frames", "--out", str(out)], cwd=ROOT,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=DIRECT_FRAMES_TIMEOUT)
    for line in p.stdout.splitlines():
        if line.startswith("[direct") or "Error" in line:
            print(f"  direct frames: {line}")
    if p.returncode != 0:
        raise RuntimeError(f"the direct frames job exited with "
                           f"{p.returncode}:\n{p.stdout[-4000:]}")
    res = torch.load(out)
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    for name, r in res.items():
        its = r["iterations"]
        want = {"engine": ({"closest": its, "anyhit": its},
                           {"anyhit": 0}),
                "v1": ({"closest": its, "anyhit": 0}, {"anyhit": its})}
        same_rays = all(r["rays"]["engine", s] == r["rays"]["v1", s]
                        for s in (2, 3))
        recorded = all(p["groups"][g][1] >= its for p in
                       r["profile"].values()
                       for g in ("direct closest", "direct anyhit"))
        if r["launches"] != want or not same_rays or not recorded or \
                max(r["arm_mse"]) > 2.0 * r["seed_mse"] + quant:
            raise RuntimeError(f"{name}: the direct designs' frames differ "
                               f"in launches, rays or image: {r}")
    return res


def _direct_soup(scene, t_n):
    """(a) ``t_n`` random triangles, each about a tenth of the box of
    ``scene``'s triangles in size, spread over that box."""
    import numpy as np
    import torch
    from rtjax_torch.core.geometry import Triangles
    tri = scene.tris
    verts = torch.cat([tri.p0, tri.p0 - tri.e1, tri.p0 + tri.e2]).cpu()
    lo, hi = verts.amin(0).numpy(), verts.amax(0).numpy()
    g = np.random.default_rng(t_n)
    p0 = lo + (hi - lo) * g.random((t_n, 3))
    e = lambda: 0.2 * (hi - lo) * (g.random((t_n, 3)) - 0.5)
    return Triangles.from_vertices(p0, p0 + e(), p0 + e(), "cuda")


def _direct_soup_rays(scene, camera, n):
    """(a) The soups' rays: phase 3's kind at ``n`` camera rays (over the
    whole image and random in the box) and 2n shadow rays."""
    import torch
    return _test_rays(scene, camera,
                      torch.Generator(device="cuda").manual_seed(1234), n=n)


def _direct_vs_persist(scene, cl, ah, direct_out, card):
    """(b) The persist kernels on config 2's own rays over its tables:
    hits, t and occlusion equal to the direct kernels', prim equal but at
    ties of equal t (counted); device time a launch beside the direct
    kernels'."""
    import torch
    from rtjax_torch.kernels import direct as D
    from rtjax_torch.kernels import persist as P
    tables = scene.tables
    cargs = (cl["o"], cl["d"], cl["tmax"], cl["active"])
    aargs = (ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    hp, tp, pp, _ = P.persist_traverse_closest(tables, *cargs)
    hd, td, pd, _ = D.direct_closest(scene.tris, *cargs)
    occ_p = P.persist_traverse_anyhit(tables, *aargs)
    occ_d = D.direct_anyhit(scene.tris, *aargs)
    torch.cuda.synchronize()
    both = hp & hd
    vs = {"hit": int((hp != hd).sum()), "t": int((tp[both] != td[both])
                                                  .sum()),
          "ties": int((pp[both] != pd[both]).sum()),
          "occlusion": int((occ_p != occ_d).sum())}
    ms = {"closest": _launch_ms(lambda: P.persist_traverse_closest(
        tables, *cargs))[0],
          "anyhit": _launch_ms(lambda: P.persist_traverse_anyhit(
              tables, *aargs))[0]}
    print(f"[config2 persist vs direct] {card}: on config 2's rays, "
          f"mismatches {vs}; device time a launch persist closest "
          f"{ms['closest']:.4f} ms vs direct "
          f"{direct_out['closest']['ms']:.4f} ms, persist any hit "
          f"{ms['anyhit']:.4f} ms vs direct "
          f"{direct_out['anyhit']['ms']:.4f} ms")
    if vs["hit"] or vs["t"] or vs["occlusion"]:
        raise RuntimeError("config 2: the persist and direct kernels find "
                           "other hits")
    return dict(persist_ms=ms, vs_persist=vs)


# a shadow ray's occlusion may differ between the direct loop and a BVH
# walk only where its occluder lies at its tmax: the walk culls a box
# whose slab entry rounds above tmax (a wall's flat box, the light's other
# triangle) where the triangle's own t does not; this is the relative gap
# allowed between that t and tmax
OCC_RTOL = 1e-5


def _occluder_gap(tris, o, d, tmax, exclude, lanes):
    """``|tmax - t| / tmax`` of the nearest occluding triangle (not the
    lane's ``exclude``) of each ray of ``lanes`` (inf where none)."""
    import torch
    from rtjax_torch.core.geometry import intersect_triangle_v3
    idx = lanes.nonzero().squeeze(1)
    pick = lambda v: tuple(c[idx] for c in v)
    best = torch.full((idx.numel(),), float("inf"), device=tmax.device)
    for k in range(tris.num):
        row = lambda a: (a[k, 0], a[k, 1], a[k, 2])
        h, t, _, _ = intersect_triangle_v3(pick(o), pick(d), tmax[idx],
                                           row(tris.p0), row(tris.e1),
                                           row(tris.e2), row(tris.n))
        h &= exclude[idx] != k
        best = torch.where(h, torch.minimum(best, t), best)
    return (tmax[idx] - best).abs() / tmax[idx].abs()


def _direct_in_frame(tables):
    """Rebind render/trace.py's direct wrappers so that every launch of a
    frame also runs the persist kernel over ``tables`` on the same rays:
    ``(tally, restore)``; ``tally`` gathers, by kind, each launch's active
    lanes and its mismatches against the persist kernel (hit, t at hits,
    and prim at hits: the ties of equal t; occlusion, those the persist
    kernel found occluded and the direct one not, and those whose
    occluder is not at the ray's tmax, OCC_RTOL), and ``gap`` the largest
    gap of a mismatch's occluder, as device tensors."""
    import torch
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.render import trace
    tally = {k: [] for k in (*DIRECT_NAMES, "gap")}
    examples = tally["examples"] = []
    saved = {name: getattr(trace, name) for name in DIRECT_NAMES.values()}

    def closest(tris, o, d, tmax, active, **kw):
        out = saved["direct_closest"](tris, o, d, tmax, active, **kw)
        hp, tp, pp, _ = P.persist_traverse_closest(tables, o, d, tmax,
                                                   active)
        h, t, p = out[:3]
        both = h & hp
        tally["closest"].append(torch.stack([
            active.sum(), (h != hp).sum(), (both & (t != tp)).sum(),
            (both & (p != pp)).sum()]))
        return out

    def anyhit(tris, o, d, tmax, exclude, active, **kw):
        out = saved["direct_anyhit"](tris, o, d, tmax, exclude, active, **kw)
        occ = out[0] if isinstance(out, tuple) else out
        occ_p = P.persist_traverse_anyhit(tables, o, d, tmax, exclude,
                                          active)
        diff = occ != occ_p
        gap = _occluder_gap(tris, o, d, tmax, exclude, diff)
        if len(examples) < 4 and bool(diff.any()):
            i = int(diff.nonzero()[0])
            examples.append(dict(
                o=[float(c[i]) for c in o], d=[float(c[i]) for c in d],
                tmax=float(tmax[i]), exclude=int(exclude[i]),
                gap=float(gap[0]), direct=bool(occ[i])))
        tally["anyhit"].append(torch.stack([
            active.sum(), diff.sum(), (diff & occ_p).sum(),
            (gap > OCC_RTOL).sum()]))
        tally["gap"].append(gap.max() if gap.numel() else
                            torch.zeros((), device=gap.device))
        return out

    trace.direct_closest, trace.direct_anyhit = closest, anyhit

    def restore():
        for name, fn in saved.items():
            setattr(trace, name, fn)

    return tally, restore


def phase12_direct(card):
    """rtjax's tiny-scene direct path and eval configs 2 and 3: (c) config
    2 at full width (512^2 @ 64 spp, 10 bounces, the default pool) on the
    direct kernels and under ``direct_max_tris=0`` on the persist kernels,
    alternated (direct, persist, persist, direct; seeds 2, 2, 3, 3), the
    first frame keeping the camera rays at pool width and their 2N shadow
    rays; (a) the direct kernels on those
    rays and over DIRECT_SOUPS soups, against their plain versions and the
    oracle; (b) the persist kernels on config 2's rays; (d) a
    detailed_stats config-2 frame; (e) config 3 and the CLI's
    cornell_bunny_glass.  Returns the rows' numbers."""
    import dataclasses

    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.render.film import read_ppm, write_ppm
    from rtjax_torch.scenes import cornell_bunny, cornell_planes
    for name, res in _build.ptxas_report(_build.direct_library()):
        print(f"[direct ptxas] {name}: {res}")
    scene, camera = cornell_planes("cuda")
    cfg = RenderConfig(width=C2_SIZE, height=C2_SIZE, num_samples=C2_SPP,
                       max_bounces=C2_BOUNCES)
    off = dataclasses.replace(cfg, direct_max_tris=0)
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0

    # (c) frames, alternated; the first keeps the first iteration's
    # closest-hit launch (the pool's camera rays) and the second
    # iteration's any-hit launch (their shadow rays; the first has none)
    _drive(scene, camera, cfg, (1,))       # warm-up: the pool's buffers
    frames, counts = [], []
    for arm, seed in (("direct", 2), ("persist", 2), ("persist", 3),
                      ("direct", 3)):
        if not frames:
            captured, restore_c = _capture_launch(
                1, {"closest": DIRECT_NAMES["closest"]})
            shadow, restore_a = _capture_launch(
                2, {"anyhit": DIRECT_NAMES["anyhit"]})
        try:
            # the first frame keeps two launches: the eager loop
            runs, c = (_drive if frames else _drive_eager)(
                scene, camera, cfg if arm == "direct" else off, (seed,))
        finally:
            if not frames:
                restore_c()
                restore_a()
                captured.update(shadow)
        secs, fb, st = runs[0]
        frames.append((arm, seed, secs, fb, st))
        counts.append(c)
        if not _only_set(c, arm, st["iterations"]):
            raise RuntimeError(f"config 2 ({arm} arm) did not launch the "
                               f"{arm} kernels alone, once an iteration: "
                               f"{c}")
        print(f"[config2 frame {arm} seed {seed}] {card}: {C2_SIZE}x"
              f"{C2_SIZE} @ {C2_SPP} spp, {C2_BOUNCES} bounces, pool "
              f"{cfg.pool_size}, {scene.tris.num} triangles: "
              f"{st['iterations']} iterations, {st['rays_traced']:.0f} rays, "
              f"{secs:.3f} s, {st['rays_traced'] / secs / 1e6:.3f} Mrays/s; "
              f"launches {c[arm]}")
    if set(captured) != {"closest", "anyhit"}:
        raise RuntimeError("config 2: the direct kernels' first launches "
                           "were not captured")
    img = {(a, s): _square_u8(fb, C2_SIZE) for a, s, _, fb, _ in frames}
    seed_mse = float(np.mean((img["direct", 2] - img["direct", 3]) ** 2))
    arm_mse = [float(np.mean((img["direct", s] - img["persist", s]) ** 2))
               for s in (2, 3)]
    for a, s, _, fb, _ in frames:
        write_ppm(_build.BUILD_DIR / f"config2_{a}_seed{s}.ppm",
                  fb.cpu().numpy(), C2_SIZE, C2_SIZE, binary=True)
    secs = {arm: [f[2] for f in frames if f[0] == arm]
            for arm in ("direct", "persist")}
    # the two walks keep different triangles at ties of equal t (a wall's
    # diagonal), and one path that differs reorders the sorted pool's
    # random words for many others: the frames decorrelate, so they are
    # held as independent frames (2x, plus the 8-bit term), and (d) holds
    # every launch of a frame to the persist kernel's hits
    gate = 2.0 * seed_mse + quant
    print(f"[config2 image] seed-to-seed MSE {seed_mse:.3e}; direct vs "
          f"persist at seeds 2 / 3 {arm_mse[0]:.3e} / {arm_mse[1]:.3e} "
          f"(gate {gate:.3e}); frame seconds direct "
          f"{secs['direct']}, persist {secs['persist']}; means "
          f"{img['direct', 2].mean():.4f} {img['persist', 2].mean():.4f}")
    if not 0 < seed_mse or max(arm_mse) > gate or \
            min(float(f[3].mean()) for f in frames) <= 0:
        raise RuntimeError("config 2: the direct and persist frames differ "
                           "beyond ties, or an image is black")
    direct_launches = dict(counts[0]["direct"])
    for k, v in counts[3]["direct"].items():
        direct_launches[k] += v

    # (a) the kernels on the captured rays, and over the soups
    tris_c, cl = captured["closest"]
    tris_a, ah = captured["anyhit"]
    if tris_c is not scene.tris or tris_a is not scene.tris:
        raise RuntimeError("config 2: the captured launches used other "
                           "triangles")
    out = {"config2": _check_direct("config2", scene.tris, cl, ah, card)}
    designs = _direct_designs(scene.tris, cl, ah, card)
    # the soups fill the box with triangles of about a tenth of it; the
    # first launch's camera rays see only the image's top rows, so the
    # soups take phase 3's kind of rays at the pool's width: camera rays
    # over the whole image and random rays in the box, and twice as many
    # shadow rays between random points of the box
    scl, sah = _direct_soup_rays(scene, camera, cfg.pool_size)
    for t_n in DIRECT_SOUPS:
        out[t_n] = _check_direct(f"soup {t_n}", _direct_soup(scene, t_n),
                                 scl, sah, card)

    # (b) the persist kernels on the same rays: S 1 per launch
    s1 = _direct_vs_persist(scene, cl, ah, out["config2"], card)

    # (d) a detailed_stats frame, every launch also held against the
    # persist kernel on its rays; counts exactly rtjax's direct loop's
    tally, restore = _direct_in_frame(scene.tables)
    try:
        runs, c = _drive_eager(scene, camera,
                               dataclasses.replace(cfg, detailed_stats=True),
                               (2,))
    finally:
        restore()
    _, _, st = runs[0]
    its = st["iterations"]
    gap = float(torch.stack(tally.pop("gap")).max())
    examples = tally.pop("examples")
    sums = {k: [int(x) for x in torch.stack(v).sum(0)]
            for k, v in tally.items()}
    active = {k: v[0] for k, v in sums.items()}
    t_n = scene.tris.num
    want = dict(node_steps=0, anyhit_steps=0,
                leaf_visits=t_n * (active["closest"] + active["anyhit"]),
                anyhit_visits=t_n * active["anyhit"])
    got = {k: st[k] for k in want}
    in_frame = dict(hit=sums["closest"][1], t=sums["closest"][2],
                    ties=sums["closest"][3],
                    occlusion_at_tmax=sums["anyhit"][1],
                    occluded_by_persist_only=sums["anyhit"][2],
                    occlusion_off_tmax=sums["anyhit"][3],
                    largest_gap=gap)
    print(f"[config2 stats frame] {card}: rays traced {st['rays_traced']:.0f}"
          f" vs {frames[0][4]['rays_traced']:.0f} (default seed 2); counts "
          f"{got}, active lanes x {t_n} {want}; histogram sum "
          f"{int(st['bounce_histogram'].sum())}; launches direct "
          f"{c['direct']}, persist (the check's) {c['persist']}; every "
          f"launch against the persist kernel on its rays: "
          f"{active['closest']} + {active['anyhit']} active rays, "
          f"mismatches {in_frame} (occlusion may differ only where the "
          f"occluder lies at the ray's tmax, within {OCC_RTOL:g} of it); "
          f"first occlusion mismatches {examples}")
    if got != want or st["rays_traced"] != frames[0][4]["rays_traced"] \
            or not _only(c, "direct", also=("persist",)) or c["plain"] \
            or any(c[k] != {"closest": its, "anyhit": its}
                   for k in ("direct", "persist")) \
            or in_frame["hit"] or in_frame["t"] \
            or in_frame["occluded_by_persist_only"] \
            or in_frame["occlusion_off_tmax"]:
        raise RuntimeError("config 2: the detailed_stats frame's counts or "
                           "rays differ from the direct loop's, or a launch "
                           "found other hits than the persist kernel")

    # (e) config 3, and the CLI's glass bunny against rtjax's render
    c3, c3_cam = cornell_bunny("cuda", bunny_material="glass", floor="mirror")
    cfg3 = RenderConfig(width=WIDTH, height=HEIGHT, num_samples=C3_SPP,
                        max_bounces=C3_BOUNCES)
    runs3, c = _drive(c3, c3_cam, cfg3, (2, 3))
    its = sum(r[2]["iterations"] for r in runs3)
    if not _only_set(c, "persist", its):
        raise RuntimeError(f"config 3 did not run the persist kernels "
                           f"alone: {c}")
    runs_x, cx = _drive(c3, c3_cam, dataclasses.replace(cfg3,
                                                       traversal="xla"), (4,))
    if not _only_set(cx, "binary", runs_x[0][2]["iterations"]):
        raise RuntimeError(f"config 3 under traversal='xla' did not run the "
                           f"binary kernels alone: {cx}")
    i2, i3, ix = (_u8_image(r[1]) for r in (*runs3, *runs_x))
    seed3 = float(np.mean((i2 - i3) ** 2))
    xla3 = float(np.mean((i2 - ix) ** 2))
    for name, r in (("seed2", runs3[0]), ("seed3", runs3[1]),
                    ("xla_seed4", runs_x[0])):
        write_ppm(_build.BUILD_DIR / f"config3_{name}.ppm",
                  r[1].cpu().numpy(), WIDTH, HEIGHT, binary=True)
    glass, glass_cam = cornell_bunny("cuda", bunny_material="glass")
    runs_g, cg = _drive(glass, glass_cam, RenderConfig(
        width=WIDTH, height=HEIGHT, num_samples=SPP, max_bounces=BOUNCES),
        (1,))
    art = read_ppm(C3_ARTIFACT).astype(np.float64) / 255.0
    art_mse = float(np.mean((_u8_image(runs_g[0][1]) - art) ** 2))
    print(f"[cornell_bunny_glass vs artifact] {card}: {WIDTH}x{HEIGHT} @ "
          f"{SPP} spp, {BOUNCES} bounces, seed 1, {runs_g[0][0]:.3f} s: MSE "
          f"{art_mse:.3e} vs {os.path.relpath(C3_ARTIFACT, ROOT)} (not a "
          f"gate: the artifact's render settings are not recorded); means "
          f"{_u8_image(runs_g[0][1]).mean():.4f} vs {art.mean():.4f}")
    gate3 = 2.0 * seed3 + quant
    print(f"[config3] {card}: glass bunny, mirror floor, {WIDTH}x{HEIGHT} @ "
          f"{C3_SPP} spp, {C3_BOUNCES} bounces: seeds 2 / 3 "
          f"{runs3[0][0]:.3f} / {runs3[1][0]:.3f} s, "
          f"{runs3[0][2]['rays_traced'] / runs3[0][0] / 1e6:.3f} Mrays/s, "
          f"xla seed 4 {runs_x[0][0]:.3f} s; seed-to-seed MSE {seed3:.3e}, "
          f"xla vs seed 2 {xla3:.3e} (gate {gate3:.3e}); means "
          f"{i2.mean():.4f} {i3.mean():.4f} {ix.mean():.4f}")
    if not 0 < seed3 or xla3 > gate3 or min(i2.mean(), ix.mean()) <= 0:
        raise RuntimeError("config 3: the kernel and xla frames differ "
                           "beyond the noise floor, or an image is black")
    s1["in_frame"] = in_frame
    # (f) the two designs' captured frames and profiles
    designs["frames"] = _direct_frames(card)
    return dict(kernels=out, launches=direct_launches, s1=s1,
                designs=designs,
                secs=secs, seed_mse=seed_mse, arm_mse=arm_mse,
                c3=dict(secs=[r[0] for r in runs3], xla_secs=runs_x[0][0],
                        seed_mse=seed3, xla_mse=xla3, artifact_mse=art_mse))


def _direct_rows(d12, c4_launches):
    """The kernels line's rows of the direct pair: config 2's rays, the
    soups and config 4's base launches beside them."""
    rows = []
    frames = d12["designs"]["frames"]
    for kind in ("closest", "anyhit"):
        r = d12["kernels"]["config2"][kind]
        rays = d12["designs"]["rays"][kind]
        group = f"direct {kind}"
        in_frame = {cell: {arm: f["profile"][arm]["groups"][group]
                           for arm in f["profile"]}
                    for cell, f in frames.items()}
        rows.append(dict(
            DIRECT_KERNELS[kind], route="cuda", source=DIRECT_SOURCE,
            launches=d12["launches"][kind], max_abs_err=max(
                d12["kernels"][k][kind]["max_abs_err"]
                for k in d12["kernels"]), ms=r["ms"], call_ms=r["call_ms"],
            plain_ms=r["plain_ms"], library_ms=None,
            **{k: r[k] for k in _BOUND_KEYS}, share=r["share"],
            timed_launches=REPS,
            **({} if kind == "closest" else dict(
                v1_ms=r["v1_ms"], ab_ms=dict(engine=r["ab"][0],
                                             v1=r["ab"][1]),
                v1_share=r["bound_ms"] / r["v1_ms"])),
            floor_ms=rays["mean"]["floor"], all_active_ms=rays["mean"]["all"],
            simt=rays["simt"],
            in_frame_ms_launches=in_frame,
            persist_ms=d12["s1"]["persist_ms"][kind],
            soups={t: {k: d12["kernels"][t][kind][k] for k in (
                "ms", "plain_ms", "bound_us", "bound_by", "share")}
                for t in DIRECT_SOUPS},
            config4_launches=c4_launches[kind],
            note="rtjax's fused-XLA all-triangles loop, no pallas_call; "
                 "launches over phase 12(c)'s two default config-2 frames; "
                 "config4_launches: phase 6(a)'s three repass frames' base "
                 "launches; closest hit runs its first design; any "
                 "hit's v1_ms / ab_ms: its first design in turns on the "
                 "same rays; in_frame_ms_launches: summed device ms and "
                 "launches of a profiled captured frame per any-hit "
                 "design (phase 12(f))"))
    return rows


# ---------------------------------------------------------------- phase 13

# each cell's timed frames, alternated: (path, seed)
GRAPH_ORDER = (("graph", 2), ("eager", 2), ("eager", 3), ("graph", 3),
               ("graph", 4), ("eager", 4))
SPR_CHOICES = (1, 4, 8, 16)      # the STEPS_PER_READ A/B
C4_MANY = 64                     # config 4's field at this many instances
FB_RTOL, FB_ATOL = 1e-5, 1e-7    # graph vs eager framebuffers, one seed
BUSY_TIMEOUT = 600


def _frame_log(render_frame_linear):
    """Wrap ``wavefront.render_frame_linear`` so that every frame prints
    one ``[frame]`` line: whether it replayed the captured graph, its
    iterations, its blocking reads and the seconds it spent capturing."""
    def logged(scene, camera, cfg, *args, **kw):
        fb, st = render_frame_linear(scene, camera, cfg, *args, **kw)
        print(f"[frame] {cfg.width}x{cfg.height} @ {cfg.num_samples} spp: "
              f"graphed {st['graphed']}, {st['iterations']} iterations, "
              f"{st['host_reads']} host reads"
              + (f", capture {st['capture_s']:.3f} s" if st["graphed"]
                 else ""))
        return fb, st
    return logged


def _counted_reads(fn):
    """``(fn(), reads)``: the synchronising device calls ``fn`` made (the
    blocking device-to-host reads among them), counted by torch.cuda's
    sync debug mode, which warns on each."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in seen)


def _graph_cells(scene, camera, c4_scene, c4_camera):
    """Phase 13's cells: ``{name: (scene, camera, cfg, size)}``, the
    headline, eval configs 2 and 3, config 4 under repass (arm (a), the
    default) and under ``two_level="kernel"`` (arm (b)), and both arms on
    the same field of 64 instances (C4_MANY)."""
    from rtjax_torch import RenderConfig
    from rtjax_torch.scenes import (cornell_bunny, cornell_planes,
                                    instanced_bunnies)
    planes, planes_cam = cornell_planes("cuda")
    c3, c3_cam = cornell_bunny("cuda", bunny_material="glass",
                               floor="mirror")
    many, many_cam = instanced_bunnies("cuda", n_inst=C4_MANY)
    c4 = lambda **kw: RenderConfig(width=WIDTH, height=HEIGHT,
                                   num_samples=C4_SPP,
                                   max_bounces=C4_BOUNCES, **kw)
    return {
        "headline": (scene, camera, _headline_cfg(), WIDTH),
        "config2": (planes, planes_cam, RenderConfig(
            width=C2_SIZE, height=C2_SIZE, num_samples=C2_SPP,
            max_bounces=C2_BOUNCES), C2_SIZE),
        "config3": (c3, c3_cam, RenderConfig(
            width=WIDTH, height=HEIGHT, num_samples=C3_SPP,
            max_bounces=C3_BOUNCES), WIDTH),
        "config4a": (c4_scene, c4_camera, c4(), WIDTH),
        "config4b": (c4_scene, c4_camera, c4(two_level="kernel"), WIDTH),
        f"config4a_{C4_MANY}": (many, many_cam, c4(), WIDTH),
        f"config4b_{C4_MANY}": (many, many_cam, c4(two_level="kernel"),
                                WIDTH)}


def _launches_match(name, graph, eager):
    """A graph frame's launch counts against the eager frame's of its
    seed: equal, but under repass (the config4a cells), where the graph's
    while nodes skip the passes with no pending ray that the eager loop
    launches masked: there every count at most the eager one, the pass
    walker's fewer, every other equal."""
    if not name.startswith("config4a"):
        return graph == eager
    fewer = [k for k in graph if graph[k] != eager[k]]
    return fewer == ["persist"] and all(
        0 < graph["persist"][c] < eager["persist"][c]
        for c in ("closest", "anyhit"))


def _pass_text(graph, eager):
    if graph == eager:
        return ""
    return (f" (persist kernels {graph['persist']} against the eager "
            f"loop's {eager['persist']})")


def _repass_designs(card):
    """The A/B of repass's passes inside the captured step
    (tools/repass_designs.py): the while nodes the engine runs against all
    G passes captured and masked, in turns, on config 4's field at 16 and
    C4_MANY instances, each frame equal to the eager loop's; the busy and
    idle passes a frame and an idle masked pass's device time."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import repass_designs
    out = repass_designs.run((16, C4_MANY), reps=1,
                             log=lambda line: print(
                                 line.replace("] ", f"] {card}: ", 1)))
    for n, rec in out.items():
        med = rec["medians"]
        if med["while"] > med["masked"]:
            print(f"[repass designs {n} instances] {card}: the while nodes "
                  f"were slower ({med['while']:.4f} s against "
                  f"{med['masked']:.4f} s)")
    return out


def _graph_frame(sc, cam, cfg, seed, path):
    """One frame through ``path`` ("graph" or "eager"), launch counts from
    zero: ``(seconds, framebuffer, stats, reads, counts)``."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (fb, st), reads = _counted_reads(lambda: render_frame(
        sc, cam, cfg, gen, graph=path == "graph"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
        raise RuntimeError("framebuffer has non-finite or negative values")
    return secs, fb, st, reads, _read_counts()


def _set_design(design):
    """Make the step kernels' ``design`` ("record" or "v1") the one frames
    run (the graph cache is keyed on it)."""
    from rtjax_torch.kernels import step as S
    S.DESIGN = design


def _union_ms(spans):
    """The time (ms) covered by at least one of ``spans`` (``(start, end,
    ...)`` ns)."""
    total, end = 0, None
    for a, b, *_ in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def _profiled_frame(sc, cam, cfg, seed, **kw):
    """One frame (``render_frame(..., **kw)``, seed ``seed``) under
    torch.profiler with CUDA activity alone: ``{wall, device_ms,
    summed_ms, events, iterations, graphed, events_per_it,
    device_ms_per_it, kernels, spans}``: ``device_ms`` the time at least
    one device event (kernels, copies, fills) ran, ``summed_ms`` their
    durations summed (more than ``device_ms`` where events overlap: the
    key sort's passes launch as programmatic dependents and wait inside
    the kernel), ``kernels`` ``{event name: [ms, events]}``, ``spans``
    each event's ``(start, end, name)`` (ns)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rtjax_torch.render.wavefront import render_frame
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = render_frame(sc, cam, cfg, gen, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            k = kernels.setdefault(e.name(), [0.0, 0])
            k[0] += e.duration_ns() / 1e6
            k[1] += 1
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          e.name()))
    events = len(spans)
    dev_ms = _union_ms(spans)
    its = max(st["iterations"], 1)
    return dict(wall=wall, device_ms=dev_ms,
                summed_ms=sum(k[0] for k in kernels.values()),
                events=events, iterations=st["iterations"],
                graphed=st["graphed"], events_per_it=events / its,
                device_ms_per_it=dev_ms / its, kernels=kernels, spans=spans)


def _busy_job(out):
    """Phase 13's device-busy shares, in a process of its own (``python3
    chip_smoke.py --busy-job OUT``; torch.profiler in a long process had
    dropped kernel records, phase 7): for each cell, a warm-up frame
    through each path (seed 1), then one graph and one eager frame (seed
    5) profiled (:func:`_profiled_frame`); for the cells of STEP_BUSY also
    a graph frame under ``step_kernels=False`` ("graph_op") and one
    through the step kernels' first design ("graph_v1", phase 14 (c));
    saved to ``out``."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    from rtjax_torch.scenes import cornell_bunny, instanced_bunnies
    scene, camera = cornell_bunny(device="cuda")
    c4, c4_cam = instanced_bunnies("cuda")
    res = {}
    for name, (sc, cam, cfg, _) in _graph_cells(scene, camera, c4,
                                                c4_cam).items():
        res[name] = {}
        # "graph_op": the captured step with step_kernels=False (phase 14)
        paths = ("graph", "eager") + (("graph_op", "graph_v1")
                                      if name in STEP_BUSY else ())
        kw = lambda path: dict(graph=path != "eager",
                               step_kernels=path != "graph_op")
        for path in paths:
            _set_design("v1" if path == "graph_v1" else "record")
            render_frame(sc, cam, cfg, torch.Generator(
                device="cuda").manual_seed(1), **kw(path))
        for path in paths:
            _set_design("v1" if path == "graph_v1" else "record")
            r = res[name][path] = _profiled_frame(sc, cam, cfg, 5, **kw(path))
            del r["spans"]
            print(f"[graph busy {name} {path}] {r['wall']:.3f} s, device "
                  f"{r['device_ms']:.3f} ms in {r['events']} events, "
                  f"{r['iterations']} iterations")
    torch.save(res, out)


def _run_busy_job():
    """Run :func:`_busy_job` in a subprocess and return its results."""
    import torch
    from rtjax_torch.kernels import _build
    out = _build.BUILD_DIR / "graph_busy.pt"
    if out.exists():
        out.unlink()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--busy-job", str(out)], cwd=ROOT,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=BUSY_TIMEOUT)
    for line in p.stdout.splitlines():
        if line.startswith("[") or "Error" in line:
            print(f"  busy job: {line}")
    if p.returncode != 0:
        raise RuntimeError(f"the busy job exited with {p.returncode}:\n"
                           f"{p.stdout[-4000:]}")
    return torch.load(out)


def phase13_graph(scene, camera, card, floor, c4_scene, c4_camera,
                  c4_floor):
    """The device-resident frame loop: for each cell (:func:`_graph_cells`)
    the graph cache is cleared, a graph frame (seed 1; the capture: its
    seconds and the graph pool's bytes) and an eager one run, then graph
    and eager frames alternate (GRAPH_ORDER), each with its launch counts
    from zero and its synchronising calls counted (:func:`_counted_reads`).
    Gates: every graph frame graphed, every eager one not; the pair of a
    seed equal in iterations, rays and occupancy, its framebuffers within
    FB_RTOL / FB_ATOL and its launch counts equal; a graph frame's reads
    at most ceil(iterations / STEPS_PER_READ) + 2; each graph frame at its
    phase's image gate (the headline phase 4's against the artifact,
    configs 2 and 3 within 2x the eager frames' seed-to-seed MSE plus the
    8-bit term, config 4 (a) and (b) phase 6's 0.1x of repass's
    seed-to-seed MSE against the seed-2 repass frame).  Then the
    STEPS_PER_READ A/B (SPR_CHOICES, forward and back, seed 2) on the
    headline and config 2, repass's two designs
    (:func:`_repass_designs`),
    and the device-busy shares from :func:`_run_busy_job`."""
    import math
    import statistics

    import numpy as np
    import torch
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import graph as G
    from rtjax_torch.render import wavefront as WF
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    out = {}
    for name, (sc, cam, cfg, size) in _graph_cells(
            scene, camera, c4_scene, c4_camera).items():
        G.clear_graphs()
        warm = {path: _graph_frame(sc, cam, cfg, 1, path)
                for path in ("graph", "eager")}
        st_c = warm["graph"][2]
        if not st_c["graphed"] or st_c["capture_s"] <= 0:
            raise RuntimeError(f"{name}: the first graph frame did not "
                               "capture the step")
        frames = {}
        for path, seed in GRAPH_ORDER:
            frames[path, seed] = _graph_frame(sc, cam, cfg, seed, path)
        imgs = {k: _square_u8(f[1], size) for k, f in frames.items()}
        seed_mse = float(np.mean((imgs["eager", 2] - imgs["eager", 3])
                                 ** 2))
        rec = dict(capture_s=st_c["capture_s"],
                   pool_bytes=st_c["graph_pool_bytes"],
                   secs={p: [f[0] for (q, _), f in frames.items() if q == p]
                         for p in ("graph", "eager")},
                   reads={p: [f[3] for (q, _), f in frames.items() if q == p]
                          for p in ("graph", "eager")},
                   iterations=frames["graph", 2][2]["iterations"],
                   rays=frames["graph", 2][2]["rays_traced"],
                   seed_mse=seed_mse)
        for seed in (1, 2, 3, 4):
            g, e = (warm[p] if seed == 1 else frames[p, seed]
                    for p in ("graph", "eager"))
            its = g[2]["iterations"]
            bound = math.ceil(its / WF.STEPS_PER_READ) + 2
            same = all(g[2][k] == e[2][k] for k in
                       ("iterations", "rays_traced", "avg_occupancy"))
            close = torch.allclose(g[1], e[1], rtol=FB_RTOL, atol=FB_ATOL)
            max_rel = float(((g[1] - e[1]).abs()
                             / e[1].abs().clamp(min=1e-30)).max())
            if name == "headline":
                gate, img_mse = floor["gate"], float(np.mean(
                    (_square_u8(g[1], size) - floor["ref"]) ** 2))
            elif name in ("config4a", "config4b"):
                gate, img_mse = 0.1 * c4_floor["seed_mse"], float(np.mean(
                    (_square_u8(g[1], size) - c4_floor["img_a2"]) ** 2))
            else:
                gate, img_mse = 2.0 * seed_mse + quant, float(np.mean(
                    (_square_u8(g[1], size) - _square_u8(e[1], size))
                    ** 2))
            print(f"[graph {name} seed {seed}] {card}: {its} iterations, "
                  f"{g[2]['rays_traced']:.0f} rays; graph {g[0]:.3f} s "
                  f"({g[3]} synchronising calls, bound {bound}), eager "
                  f"{e[0]:.3f} s ({e[3]}); equal iterations, rays, "
                  f"occupancy {same}; framebuffers within rtol {FB_RTOL} "
                  f"{close} (largest relative gap {max_rel:.3e}); launches "
                  f"{'equal' if g[4] == e[4] else 'as the loops ran'} "
                  f"{_launches_match(name, g[4], e[4])}"
                  f"{_pass_text(g[4], e[4])}; image MSE {img_mse:.3e} (gate "
                  f"{gate:.3e})")
            if not g[2]["graphed"] or e[2]["graphed"]:
                raise RuntimeError(f"{name} seed {seed}: a frame took the "
                                   "other path")
            if not same or not close or not _launches_match(name, g[4],
                                                             e[4]):
                raise RuntimeError(f"{name} seed {seed}: the graph and "
                                   "eager frames differ")
            if seed > 1 and g[3] > bound:
                raise RuntimeError(f"{name} seed {seed}: {g[3]} blocking "
                                   f"reads, more than {bound}")
            if name in ("config4a", "config4b") and seed != 2:
                continue
            if img_mse > gate:
                raise RuntimeError(f"{name} seed {seed}: the graph frame "
                                   "differs beyond its gate")
        print(f"[graph {name}] {card}: capture {rec['capture_s']:.3f} s, "
              f"graph pool {rec['pool_bytes']} bytes; frame seconds graph "
              f"{rec['secs']['graph']} vs eager {rec['secs']['eager']}; "
              f"synchronising calls a frame graph {rec['reads']['graph']}, "
              f"eager {rec['reads']['eager']}; median ratio eager / graph "
              f"{statistics.median(rec['secs']['eager']) / statistics.median(rec['secs']['graph']):.3f}")
        out[name] = rec
        if name in ("headline", "config2"):
            ab = {s: [] for s in SPR_CHOICES}
            saved = WF.STEPS_PER_READ
            try:
                for s in (*SPR_CHOICES, *reversed(SPR_CHOICES)):
                    WF.STEPS_PER_READ = s
                    f = _graph_frame(sc, cam, cfg, 2, "graph")
                    if f[2]["iterations"] != rec["iterations"]:
                        raise RuntimeError(f"{name}: STEPS_PER_READ {s} "
                                           "changed the iterations")
                    ab[s].append((f[0], f[3]))
            finally:
                WF.STEPS_PER_READ = saved
            rec["spr"] = {s: [v[0] for v in r] for s, r in ab.items()}
            print(f"[graph {name} STEPS_PER_READ] {card}: "
                  + "; ".join(f"{s}: {[round(v[0], 4) for v in r]} s, "
                              f"{r[0][1]} synchronising calls"
                              for s, r in ab.items()))
    G.clear_graphs()
    out["repass_designs"] = _repass_designs(card)
    busy = _run_busy_job()
    for name, r in busy.items():
        for path in ("graph", "eager"):
            b = r[path]
            med = statistics.median(out[name]["secs"][path])
            b["share_of_median"] = b["device_ms"] / 1e3 / med
            print(f"[graph busy {name} {path}] {card}: device "
                  f"{b['device_ms']:.3f} ms in {b['events']} events over a "
                  f"profiled {b['wall']:.3f} s frame "
                  f"({100 * b['device_ms'] / 1e3 / b['wall']:.1f}% busy), "
                  f"{100 * b['share_of_median']:.1f}% of the unprofiled "
                  f"median {med:.3f} s; graphed {b['graphed']}")
        out[name]["busy"] = r
    G.clear_graphs()
    return out


# ---------------------------------------------------------------- phase 14

STEP_KERNELS = {
    "route": dict(name="step_route",
                  replaces="rtjax/render/wavefront.py:212"),
    "shade": dict(name="step_shade",
                  replaces="rtjax/render/wavefront.py:437"),
    "resolve": dict(name="step_resolve",
                    replaces="rtjax/render/wavefront.py:748"),
}
STEP_SOURCE = "rtjax_torch/csrc/step_kernels.cu"
# the cells whose busy-job profile also takes step_kernels=False
STEP_BUSY = ("headline", "config2", "config3", "config4a", "config4b")
# (a): the iterations whose state each cell's kernels are checked on, and
# the one whose headline state (d) times
STEP_CHECK_ITS = (0, 1, 2, 5, 12)
STEP_TIME_IT = 12
# the full-record modes' checked iterations and timed iteration (the
# headline's unsorted pool runs in 16-row bands: its early states are all
# hits or all misses)
MODE_CHECK_ITS = (0, 1, 2, 5, 12, 30)
MODE_TIME_IT = 30
# (b): each cell's frames, in turns: a frame of seed 1 captures its arm's
# graph (the cache holds one), then the arm's timed frames; "v1" the
# step kernels' first design
STEP_ORDER = (("kernels", 1), ("kernels", 2), ("kernels", 3), ("v1", 1),
              ("v1", 2), ("v1", 3), ("op", 1), ("op", 2), ("op", 3),
              ("op", 4), ("v1", 1), ("v1", 4), ("kernels", 1),
              ("kernels", 4))
# the full-record modes' frames, in turns, as STEP_ORDER's but with no
# first design
MODE_ORDER = (("kernels", 1), ("kernels", 2), ("op", 1), ("op", 2),
              ("op", 3), ("kernels", 1), ("kernels", 3))
# bytes a lane moves, each input read once and each output written once:
# route reads the state (81 B) and its word (8 B) and writes its key and
# bundle (40 B); shade reads the bundle (36 B), five words (40 B) and, on
# a sorting iteration, its order (8 B), and writes the state (56 B) and
# the traced flag (1 B), with lights two shadow rays (66 B) and their
# radiance (24 B), and a flushing lane's pixel is read and written (24
# B); resolve reads the radiance, both channels' radiance, masks and
# occlusion (40 B) and writes the radiance (12 B); the sort reads a key
# and writes a key and an index (16 B)
ROUTE_BYTES = 81 + 8 + 40
SHADE_BYTES, SHADE_ORDER, SHADE_LIGHTS, SHADE_FLUSH = 36 + 40 + 57, 8, 90, 24
RESOLVE_BYTES, SORT_BYTES = 52, 16
# float operations a lane does, counted from csrc/step_math.cuh (the two
# BSDF samples, light sample, pdf and ray-triangle test, camera ray and
# codecs of shade; the codecs, key and roulette of route)
ROUTE_OPS, SHADE_OPS, RESOLVE_OPS = 140, 600, 14


def _step_bound(nbytes, ops):
    ms_b, ms_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return dict(bound_ms=max(ms_b, ms_o), bound_us=max(ms_b, ms_o) * 1e3,
                bound_by="bytes" if ms_b >= ms_o else "operations",
                bytes=nbytes, ops=ops)


def _step_scene():
    """A synthetic scene with matte, mirror and glass triangles, two point
    lights, an area light and an environment light."""
    import numpy as np
    from rtjax_torch.scene.scene import SceneBuilder
    b = SceneBuilder()
    mats = (b.make_matte((0.7, 0.6, 0.5)), b.make_mirror((0.9, 0.8, 0.9)),
            b.make_glass(1.5))
    rng = np.random.default_rng(3)
    for m in mats + mats:
        p0 = rng.uniform(-1, 1, (8, 3))
        b.add_triangles(p0, p0 + rng.uniform(-0.6, 0.6, (8, 3)),
                        p0 + rng.uniform(-0.6, 0.6, (8, 3)), m)
    for q in range(2):
        b.add_point_light((0.3 * q, 1.5, 0.3), (5.0, 4.0, 3.0))
    b.add_area_light([-0.3, 1.2, -0.3], [0.3, 1.2, -0.3], [0.0, 1.2, 0.3],
                     (8, 8, 8), mats[0])
    b.set_environment((0.2, 0.3, 0.4))
    return b.build("cuda")


def _synthetic_state(scene, cfg, gen):
    """Random lanes of every kind: hits and misses, dead and dirty dead
    lanes, camera-ray hits on the light, lanes past max_bounces, inf and
    NaN throughput."""
    import torch
    from rtjax_torch.constants import DEAD_BOUNCES
    from rtjax_torch.render.wavefront import PathState
    n = cfg.pool_size
    u = lambda: torch.rand(n, generator=gen, device="cuda")
    ri = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen,
                                      device="cuda", dtype=torch.int32)
    d = torch.randn(3, n, generator=gen, device="cuda")
    d = d / d.norm(dim=0)
    beta = [u() * 1.5 for _ in range(3)]
    beta[0] = torch.where(u() < 0.02, float("inf"), beta[0])
    beta[1] = torch.where(u() < 0.02, float("nan"), beta[1])
    return PathState(
        pixel=ri(0, cfg.num_pixels),
        ray_o=tuple(u() * 2 - 1 for _ in range(3)),
        ray_d=tuple(d[k].contiguous() for k in range(3)),
        hit=u() < 0.7, t=u() * 3,
        normal=tuple(torch.randn(n, generator=gen, device="cuda")
                     for _ in range(3)),
        prim=ri(-1, scene.tris.num), src=ri(0, 1),
        bounces=torch.where(u() < 0.15, DEAD_BOUNCES,
                            ri(0, cfg.max_bounces + 2)),
        beta=tuple(beta),
        acc=tuple(torch.where(u() < 0.5, 0.0, u()) for _ in range(3)))


def _lanes_differ(a, b):
    """Lanes of two outputs that are not equal bit for bit (every NaN
    equal to every NaN)."""
    import torch
    if a.dtype == torch.float32:
        same = (a.view(torch.int32) == b.view(torch.int32)) | (
            torch.isnan(a) & torch.isnan(b))
    elif a.dtype == torch.float64:
        same = (a.view(torch.int64) == b.view(torch.int64)) | (
            torch.isnan(a) & torch.isnan(b))
    else:
        same = a == b
    return int((~same).sum())


def _flat_out(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [c for v in x for c in _flat_out(v)]
    return [x]


def _synthetic_checks(camera, card, modes, its, seed):
    """The step kernels of each mode of ``modes`` (``{label: change of
    the RenderConfig}``) on synthetic pools of every lane kind
    (:func:`_synthetic_state` over :func:`_step_scene`, a random
    framebuffer), one pool an iteration of ``its``, against their plain
    versions (tools/step_designs.py ``check_state``): ``({kernel:
    mismatching lanes}, framebuffer gap)``."""
    import torch
    import step_designs as SD
    from rtjax_torch import RenderConfig
    syn = _step_scene()
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst, gap = {}, 0.0
    for label, change in modes.items():
        cfg = RenderConfig(**{**dict(width=WIDTH, height=HEIGHT,
                                     num_samples=4, max_bounces=BOUNCES),
                              **change})
        for it in its:
            words = torch.randint(0, 1 << 32, (5, cfg.pool_size),
                                  generator=g, device="cuda",
                                  dtype=torch.int64)
            fb = torch.rand(cfg.num_pixels, 3, generator=g, device="cuda")
            bad, err, c = SD.check_state(
                syn, camera, cfg, _synthetic_state(syn, cfg, g), words, fb,
                torch.tensor(it, device="cuda"),
                torch.tensor(it * 99991, device="cuda"))
            gap = max(gap, err)
            total = {k: sum(v.values()) for k, v in bad.items()}
            kind = "in limbo" if c["mode"].startswith("parity") \
                else "dirty"
            print(f"[step kernels synthetic {label} {it}] {card}: "
                  f"{int(c['counts'][4])} lanes {kind}; mismatching lanes "
                  + ", ".join(f"{k} {v}" for k, v in total.items()))
            for k, v in bad.items():
                worst[k] = worst.get(k, 0) + total[k]
                if total[k]:
                    print(f"  {k} mismatches by field: "
                          f"{ {f: m for f, m in v.items() if m} }")
    return worst, gap


def _step_timings(t, card):
    """(d): prints the headline's timings (tools/step_designs.py
    ``time_state`` on its state of STEP_TIME_IT: in turns, each kernel's
    device time a launch and its bound, route against route_v1 and shade
    against shade_v1; one wrapper call and one plain version call of each
    (CUDA events, median of REPS); torch.sort and ``index_add_`` of the
    flush) and every step kernel's registers and resident warps; returns
    ``t`` with the latter."""
    import step_designs as SD
    t["registers"] = SD.kernel_table()
    t["card"] = card
    for name, r in t["kernels"].items():
        print(f"[step time {name}] {card}: {r['mean_ms']:.4f} ms a launch "
              f"(mean of {REPS} queued, in turns: {r['ms']}), bound "
              f"{r['bound_us']:.3f} us by {r['bound_by']} ({r['bytes']:.0f} "
              f"bytes), {100 * r['share']:.2f}% of the bound")
    for name, r in t["registers"].items():
        print(f"[step occupancy {name}] {card}: {r['registers']} registers, "
              f"{r['local_bytes']} local bytes, {r['block']} threads a "
              f"block, {r['warps_per_sm']} resident warps an SM")
    one = {k: r["one_call_ms"] for k, r in t["kernels"].items()
           if "one_call_ms" in r}
    plain = {k: r["plain_ms"] for k, r in t["kernels"].items()
             if "plain_ms" in r}
    print(f"[step time one call] {card}: {one} ms (a wrapper call, host "
          f"launch included); plain versions {plain} ms; flush atomics a "
          f"shade launch {t['flush_atomics']}; index_add_ "
          f"{t['index_add_ms']:.4f} ms; torch.sort {t['sort_ms']:.4f} ms")
    print(_sort_time_text(f"headline it {STEP_TIME_IT}", t["key_sort"], card))
    return t


def _step_frame(sc, cam, cfg, seed, arm):
    """One captured frame through ``arm`` ("kernels", "v1": the step
    kernels' first design, or "op": ``step_kernels=False``), launch counts
    from zero: ``(seconds, framebuffer, stats, counts)``."""
    import torch
    from rtjax_torch.render.wavefront import render_frame
    _set_design("v1" if arm == "v1" else "record")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb, st = render_frame(sc, cam, cfg, gen, step_kernels=arm != "op")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(fb).all()) or bool((fb < 0).any()):
        raise RuntimeError("framebuffer has non-finite or negative values")
    return secs, fb, st, _read_counts()


def _frames_in_turns(sc, cam, cfg, order):
    """Captured frames of ``order`` (``(arm, seed)`` pairs,
    :func:`_step_frame`) from an empty graph cache: ``{(arm, seed):
    (seconds, framebuffer, stats, counts)}`` of the seeds but 1 (a frame
    of seed 1 captures its arm's graph; the cache holds one)."""
    from rtjax_torch.render import graph as G
    G.clear_graphs()
    frames = {}
    for arm, seed in order:
        f = _step_frame(sc, cam, cfg, seed, arm)
        if seed != 1:
            frames[arm, seed] = f
    _set_design("record")
    return frames


# detailed_stats' traversal sums (render/wavefront.py render_frame_linear)
STATS_SUMS = ("node_steps", "leaf_visits", "anyhit_steps", "anyhit_visits")


def _arms_agree(kf, of, mode):
    """A kernels-arm frame against the ``step_kernels=False`` frame of its
    seed (each from :func:`_step_frame`): ``{"same": equal iterations,
    rays and occupancy (under ``detailed_stats`` equal bounce histograms
    and traversal sums too), "walks": equal traversal launches, "steps":
    ``mode``'s step kernels once an iteration, on a sorted engine the key
    sort too, and no plain version in the one, no step kernel and no key
    sort in the other, "close": framebuffers within FB_RTOL}``."""
    import torch
    from rtjax_torch.kernels import step as S
    its = kf[2]["iterations"]
    stats = "bounce_histogram" in kf[2]
    sorts = S.engine_of(mode) in ("default", "wide", "parity")
    return dict(
        same=all(kf[2][k] == of[2][k] for k in
                 ("iterations", "rays_traced", "avg_occupancy")
                 + STATS_SUMS * stats)
        and (not stats or torch.equal(kf[2]["bounce_histogram"],
                                      of[2]["bounce_histogram"])),
        walks={k: v for k, v in kf[3].items() if k not in ("step", "sort")}
        == {k: v for k, v in of[3].items() if k not in ("step", "sort")},
        steps=(_step_once(kf[3], mode, its) and not kf[3]["plain"]
               and kf[3]["sort"]["key_sort"] == its * sorts
               and _step_once(of[3], None, 0)
               and of[3]["sort"]["key_sort"] == 0),
        close=torch.allclose(kf[1], of[1], rtol=FB_RTOL, atol=FB_ATOL))


def _sort_time_text(label, t, card):
    """A ``[sort time ...]`` line of tools/sort_designs.py ``time_sort``'s
    numbers (``t``), with the route keys' lanes and a skip launch's
    time where there is one."""
    import sort_designs as SDs
    line = SDs.time_text(label, t, card)
    if "skip_ms" in t:
        line += f"; a skip launch {t['skip_ms']:.4f} ms"
    return line + f" ({t['lanes']} route keys)" if "lanes" in t else line


# (e) the key sort's set sizes, its frames' process's time limit, and the
# profiler's names of torch's sort kernels (tools/sort_designs.py THEIRS)
SORT_LOG2 = (17, 18, 19, 20)
SORT_FRAMES_TIMEOUT = 400
SORT_SOURCE = "rtjax_torch/csrc/key_sort.cu"


def phase14_key_sort(card):
    """(e) the step's key sort (kernels/sort.py, csrc/key_sort.cu): its
    kernels' registers; bit for bit against ``torch.sort(keys,
    stable=True).indices`` on tools/sort_designs.py's key sets at
    SORT_LOG2 sizes, each timed in turns with torch.sort; a skip launch
    leaving its order untouched; then, in a process of its own
    (``tools/sort_designs.py --frames``), captured frames of the
    headline, config 2, config 4 (b), the parity frame and the wide frame
    with the sort on the kernels and on torch.sort in turns, equal in
    iterations, rays, occupancy and launches, and a profiled frame an arm:
    no torch sort kernel on the kernels' arm.  Returns the numbers."""
    import torch
    import sort_designs as SDs
    from rtjax_torch.kernels import _build
    registers = SDs.kernel_table()
    print(f"[sort registers] {card}: " + ", ".join(
        f"{k} {r['registers']} registers, {r['local_bytes']} local bytes, "
        f"{r['warps_per_sm']} resident warps an SM"
        for k, r in registers.items()))
    sets, skips = SDs.check_sets(SORT_LOG2, card)
    bad = {f"{k[0]} 2^{k[1]}": v["bad"] for k, v in sets.items()
           if v["bad"]}
    if bad or not SDs.skips_ok(skips):
        raise RuntimeError(f"the key sort differs from torch.sort: {bad}; "
                           f"skip launches {skips}")
    out = _build.BUILD_DIR / "sort_frames.pt"
    if out.exists():
        out.unlink()
    p = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "sort_designs.py"),
                        "--frames", "--log2", "", "--out", str(out)],
                       cwd=ROOT, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True,
                       timeout=SORT_FRAMES_TIMEOUT)
    for line in p.stdout.splitlines():
        if line.startswith("[sort frame") or "Error" in line:
            print(line)
    if p.returncode != 0:
        raise RuntimeError(f"the sort's frames exited with {p.returncode}:\n"
                           f"{p.stdout[-4000:]}")
    frames = torch.load(out)
    if any(f["theirs"] or f["launches"] != f["iterations"]
           for f in frames.values()):
        raise RuntimeError("a profiled kernels' frame ran a torch sort "
                           "kernel, or the key sort did not run once an "
                           "iteration")
    return dict(registers=registers, sets=sets, skips=skips, frames=frames)


def phase14_step_kernels(scene, camera, card, floor, c4_scene, c4_camera,
                         c4_floor, g13):
    """The fused wavefront step (kernels/step.py, csrc/step_kernels.cu):
    (a) route, shade and resolve against their plain versions on the
    states of STEP_CHECK_ITS of the headline, eval configs 2 (sorting and
    sort_every skip iterations), 3 (specular) and 4 (instanced), stepped
    op by op, and on a synthetic pool of every lane kind: every output
    bit for bit (mismatching lanes printed, all 0), the framebuffer
    within FB_RTOL (tools/step_designs.py ``check_and_time``); (b)
    captured frames through the kernels and under ``step_kernels=False``
    in turns (STEP_ORDER) on the headline, configs 2, 3, 4 (a) and (b)
    and config 5's 4-spp probe: each seed's pair agreeing
    (:func:`_arms_agree`), each kernel frame at its phase's image gate;
    (c) phase 13's busy job's device events and device ms an iteration,
    both arms, and the first design's; (d) :func:`_step_timings` of the
    headline's state of STEP_TIME_IT.  (a) also holds route_v1 / shade_v1
    (the first design) against the same plain versions and shade against
    shade_v1; (b) also renders the first design's frames in turns, equal
    to the kernels' in iterations, rays, occupancy and launches.  Returns
    the rows' numbers."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import step_designs as SD
    from rtjax_torch import RenderConfig
    from rtjax_torch.render import graph as G
    from rtjax_torch.render import wavefront as WF
    quant = 2.0 * (1.0 / 255.0) ** 2 / 12.0
    cells = _graph_cells(scene, camera, c4_scene, c4_camera)
    cells = {k: cells[k] for k in STEP_BUSY}
    # (a)
    worst = {name: 0 for name in (*STEP_KERNELS, "route_v1", "shade_v1",
                                  "key_sort")}
    fb_err = 0.0
    timed = None
    sort_cells = {}
    for name, (sc, cam, cfg, _) in cells.items():
        assert WF.step_kernels_cover(sc, cfg), name
        sort_cells[name] = {}
        bad, err, t = SD.check_and_time(
            sc, cam, cfg, STEP_CHECK_ITS,
            STEP_TIME_IT if name == "headline" else None, label=name,
            card=card, sort_it=STEP_TIME_IT, sort_out=sort_cells[name])
        fb_err = max(fb_err, err)
        timed = t or timed
        for k, v in bad.items():
            worst[k] += v
        print(_sort_time_text(f"{name} it {STEP_TIME_IT}", sort_cells[name],
                              card))
    bad, err = _synthetic_checks(camera, card, {"pool": {}}, (0, 1, 3), 11)
    fb_err = max(fb_err, err)
    for k, v in bad.items():
        worst[k] += v
    if any(worst.values()):
        raise RuntimeError(f"the step kernels differ from their plain "
                           f"versions: {worst}")
    # (b)
    c5 = RenderConfig(width=C5_WIDTH, height=C5_HEIGHT, num_samples=4,
                      max_bounces=C5_BOUNCES)
    cells["config5"] = (scene, camera, c5, None)
    secs = {}
    for name, (sc, cam, cfg, size) in cells.items():
        frames = _frames_in_turns(sc, cam, cfg, STEP_ORDER)
        secs[name] = {arm: [f[0] for (a, _), f in frames.items() if a == arm]
                      for arm in ("kernels", "v1", "op")}
        if size is not None:
            img = lambda f: _square_u8(f[1], size)
            seed_mse = float(np.mean((img(frames["op", 2])
                                      - img(frames["op", 3])) ** 2))
        for seed in (2, 3, 4):
            kf, of = frames["kernels", seed], frames["op", seed]
            its = kf[2]["iterations"]
            ok = _arms_agree(kf, of, "default")
            if name == "headline":
                gate, mse = floor["gate"], float(np.mean(
                    (_square_u8(kf[1], size) - floor["ref"]) ** 2))
            elif name in ("config4a", "config4b"):
                gate, mse = 0.1 * c4_floor["seed_mse"], float(np.mean(
                    (_square_u8(kf[1], size) - c4_floor["img_a2"]) ** 2))
            elif size is not None:
                gate, mse = 2.0 * seed_mse + quant, float(np.mean(
                    (_square_u8(kf[1], size) - _square_u8(of[1], size))
                    ** 2))
            else:
                gate = mse = 0.0   # config 5: finite and non-negative
            print(f"[step frame {name} seed {seed}] {card}: {its} "
                  f"iterations, {kf[2]['rays_traced']:.0f} rays; kernels "
                  f"{kf[0]:.3f} s, step_kernels=False {of[0]:.3f} s; equal "
                  f"iterations, rays, occupancy {ok['same']}; traversal "
                  f"launches equal {ok['walks']}; step kernels once an "
                  f"iteration, no plain version {ok['steps']} "
                  f"({kf[3]['step']}); framebuffers within rtol {FB_RTOL} "
                  f"{ok['close']}; image MSE {mse:.3e} (gate {gate:.3e})")
            if not all(ok.values()):
                raise RuntimeError(f"{name} seed {seed}: the step kernels' "
                                   "frame differs from the op-by-op step's")
            # the first design's frame of the seed against the kernels'
            vf = frames["v1", seed]
            v_same = all(kf[2][k] == vf[2][k] for k in
                         ("iterations", "rays_traced", "avg_occupancy"))
            v_close = torch.allclose(kf[1], vf[1], rtol=FB_RTOL,
                                     atol=FB_ATOL)
            v_walks = {k: v for k, v in kf[3].items() if k not in
                       ("step", "step_v1")} == \
                {k: v for k, v in vf[3].items() if k not in
                 ("step", "step_v1")}
            v_steps = (vf[3]["step_v1"] == {"route": its, "shade": its}
                       and vf[3]["step"]["resolve"] == its
                       and vf[3]["step"]["route"] == 0
                       and vf[3]["step"]["shade"] == 0
                       and not any(kf[3]["step_v1"].values()))
            v_mse = mse if size is None else float(np.mean(
                (_square_u8(vf[1], size) - _square_u8(kf[1], size)) ** 2))
            print(f"[step frame {name} seed {seed} v1] {card}: first design"
                  f" {vf[0]:.3f} s against the record design's {kf[0]:.3f} "
                  f"s; equal iterations, rays, occupancy {v_same}; traversal"
                  f" launches equal {v_walks}; route_v1 / shade_v1 once an "
                  f"iteration {v_steps} ({vf[3]['step_v1']}); framebuffers "
                  f"within rtol {FB_RTOL} {v_close}; image MSE between the "
                  f"designs {v_mse:.3e}")
            if not (v_same and v_close and v_walks and v_steps):
                raise RuntimeError(f"{name} seed {seed}: the first design's "
                                   "frame differs from the record design's")
            if name in ("config4a", "config4b") and seed != 2:
                continue
            if mse > gate:
                raise RuntimeError(f"{name} seed {seed}: the kernels' frame "
                                   "differs beyond its gate")
        print(f"[step frame {name}] {card}: frame seconds kernels "
              f"{secs[name]['kernels']} vs first design {secs[name]['v1']} "
              f"vs step_kernels=False {secs[name]['op']}; median ratio "
              f"op / kernels "
              f"{np.median(secs[name]['op']) / np.median(secs[name]['kernels']):.3f},"
              f" v1 / kernels "
              f"{np.median(secs[name]['v1']) / np.median(secs[name]['kernels']):.4f}")
    G.clear_graphs()
    # (c)
    busy = {}
    for name in STEP_BUSY:
        r = g13[name]["busy"]
        busy[name] = {}
        for arm, path in (("kernels", "graph"), ("op", "graph_op"),
                          ("v1", "graph_v1")):
            b = r[path]
            its = max(b["iterations"], 1)
            busy[name][arm] = dict(events_per_it=b["events"] / its,
                                   device_ms_per_it=b["device_ms"] / its,
                                   device_ms=b["device_ms"], wall=b["wall"])
        k_, o_, v_ = (busy[name][a] for a in ("kernels", "op", "v1"))
        print(f"[step busy {name}] {card}: device events an iteration "
              f"kernels {k_['events_per_it']:.1f} vs step_kernels=False "
              f"{o_['events_per_it']:.1f} vs first design "
              f"{v_['events_per_it']:.1f}; device ms an iteration "
              f"{k_['device_ms_per_it']:.5f} vs {o_['device_ms_per_it']:.5f}"
              f" vs {v_['device_ms_per_it']:.5f}; profiled frames "
              f"{k_['wall']:.3f} vs {o_['wall']:.3f} vs {v_['wall']:.3f} s")
    # (d)
    t = _step_timings(timed, card)
    # (e)
    sort = phase14_key_sort(card)
    sort["cells"] = sort_cells
    return dict(mismatches=worst, fb_err=fb_err, secs=secs, busy=busy,
                times=t, sort=sort)


# the modes beside the default one (the unsorted engine, reference_parity,
# the wide bundle, one-sample MIS, detailed_stats): the kernels line's
# rows, each timed on its mode's cell of MODE_TIMED
MODE_STEP_KERNELS = {
    "route_shade_unsorted": ("unsorted", "rtjax/render/wavefront.py:212"),
    "route_parity": ("parity", "rtjax/render/wavefront.py:212"),
    "shade_parity": ("parity", "rtjax/render/wavefront.py:437"),
    "resolve_parity": ("parity", "rtjax/render/wavefront.py:748"),
    "route_parity_unsorted": ("parity_unsorted",
                              "rtjax/render/wavefront.py:212"),
    "shade_parity_unsorted": ("parity_unsorted",
                              "rtjax/render/wavefront.py:437"),
    "resolve_stats": ("default_stats", "rtjax/render/wavefront.py:809"),
    "shade_1s": ("default_1s", "rtjax/render/wavefront.py:486"),
    "resolve_1s": ("default_1s", "rtjax/render/wavefront.py:758"),
    "route_shade_unsorted_1s": ("unsorted_1s",
                                "rtjax/render/wavefront.py:486"),
    "resolve_parity_stats": ("parity_stats",
                             "rtjax/render/wavefront.py:809"),
    "route_wide": ("wide", "rtjax/render/wavefront.py:418"),
    "shade_wide": ("wide", "rtjax/render/wavefront.py:437"),
    "shade_wide_1s": ("wide_1s_stats", "rtjax/render/wavefront.py:486"),
    "resolve_1s_stats": ("wide_1s_stats", "rtjax/render/wavefront.py:758")}
MODE_TIMED = {"unsorted": "headline xla", "parity": "parity frame",
              "parity_unsorted": "headline parity xla",
              "default_stats": "headline stats",
              "default_1s": "headline one_sample",
              "unsorted_1s": "headline one_sample no_sort",
              "parity_stats": "headline parity stats",
              "wide": "wide frame",
              "wide_1s_stats": "headline 126 bounces one_sample stats"}
# the ptxas registers of the default instances, of the first design and of
# the unsorted engine's and parity's instances: they must not change (the
# first design's shade takes the shadow rays' shared helper at 96,
# resident warps as at 95: 16)
STEP_REGISTERS = {"route": 40, "shade": 85, "resolve": 26, "route_v1": 40,
                  "shade_v1": 96, "route_shade_unsorted": 103,
                  "route_parity": 40, "shade_parity": 104,
                  "resolve_parity": 28, "route_parity_unsorted": 40,
                  "shade_parity_unsorted": 104}


def _mode_cells(scene, camera):
    """Phase 14's cells of the modes beside the default one: ``{name:
    (scene, camera, cfg)}``: phase 8(c)'s parity frame (MODE_SIZE^2 @
    MODE_SPP, a pool of 2^19 lanes), the headline under parity, ``"xla"``,
    ``sort_rays=False`` and parity with ``"xla"``, eval config 3 under
    parity (the specular branches); the headline under
    ``detailed_stats``, ``one_sample_mis`` (also with ``sort_rays=False``)
    and parity with ``detailed_stats``; the wide bundle on phase 9(d)'s
    WIDE_SIZE^2 @ WIDE_SPP frame and on the headline at 126 bounces, alone
    and with ``one_sample_mis`` and ``detailed_stats``."""
    from rtjax_torch import RenderConfig
    from rtjax_torch.scenes import cornell_bunny
    c3, c3_cam = cornell_bunny("cuda", bunny_material="glass",
                               floor="mirror")
    return {
        "parity frame": (scene, camera, RenderConfig(
            width=MODE_SIZE, height=MODE_SIZE, num_samples=MODE_SPP,
            max_bounces=BOUNCES, reference_parity=True)),
        "headline parity": (scene, camera,
                            _headline_cfg(reference_parity=True)),
        "headline xla": (scene, camera, _headline_cfg(traversal="xla")),
        "headline no_sort": (scene, camera, _headline_cfg(sort_rays=False)),
        "headline parity xla": (scene, camera, _headline_cfg(
            reference_parity=True, traversal="xla")),
        "config3 parity": (c3, c3_cam, _c3_cfg(reference_parity=True)),
        "headline stats": (scene, camera, _headline_cfg(detailed_stats=True)),
        "headline one_sample": (scene, camera,
                                _headline_cfg(one_sample_mis=True)),
        "headline one_sample no_sort": (scene, camera, _headline_cfg(
            one_sample_mis=True, sort_rays=False)),
        "headline parity stats": (scene, camera, _headline_cfg(
            reference_parity=True, detailed_stats=True)),
        "wide frame": (scene, camera, RenderConfig(
            width=WIDE_SIZE, height=WIDE_SIZE, num_samples=WIDE_SPP,
            max_bounces=BOUNCES)),
        "headline 126 bounces": (scene, camera,
                                 _headline_cfg(max_bounces=WIDE_BOUNCES)),
        "headline 126 bounces one_sample stats": (scene, camera,
                                                  _headline_cfg(
            max_bounces=WIDE_BOUNCES, one_sample_mis=True,
            detailed_stats=True))}


def _c3_cfg(**change):
    from rtjax_torch import RenderConfig
    return RenderConfig(width=WIDTH, height=HEIGHT, num_samples=C3_SPP,
                        max_bounces=C3_BOUNCES, **change)


def _mode_frames(name, sc, cam, cfg, card, profile=False, log=print):
    """Captured frames of a full-record mode's cell through the step
    kernels and under ``step_kernels=False``, in turns (MODE_ORDER): each
    seed's pair must agree (:func:`_arms_agree`).  With ``profile`` also
    one profiled frame an arm (seed 5, after a seed-1 warm-up,
    :func:`_profiled_frame`).  Returns ``{secs, busy, launches}``,
    ``launches`` the step kernels' of the kernels arm's seed-2 frame."""
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import graph as G
    from rtjax_torch.render import wavefront as WF
    if not WF.step_kernels_cover(sc, cfg):
        raise RuntimeError(f"{name}: the step kernels do not cover it")
    mode = S.step_mode(sc, cfg)
    got = _frames_in_turns(sc, cam, cfg, MODE_ORDER)
    secs = {arm: [f[0] for (a, _), f in got.items() if a == arm]
            for arm in ("kernels", "op")}
    for seed in (2, 3):
        kf, of = got["kernels", seed], got["op", seed]
        ok = _arms_agree(kf, of, mode)
        log(f"[mode frame {name} seed {seed}] {card}: {kf[2]['iterations']}"
            f" iterations, {kf[2]['rays_traced']:.0f} rays; kernels "
            f"{kf[0]:.4f} s, step_kernels=False {of[0]:.4f} s; equal "
            f"iterations, rays, occupancy {ok['same']}; traversal launches "
            f"equal {ok['walks']}; the mode's step kernels once an "
            f"iteration, no plain version {ok['steps']} ({kf[3]['step']}); "
            f"framebuffers within rtol {FB_RTOL} {ok['close']}")
        if not all(ok.values()):
            raise RuntimeError(f"{name} seed {seed}: the kernels' frame "
                               "differs from the op-by-op step's")
    busy = {}
    for arm in ("kernels", "op") if profile else ():
        G.clear_graphs()
        _step_frame(sc, cam, cfg, 1, arm)
        busy[arm] = _profiled_frame(sc, cam, cfg, 5,
                                    step_kernels=arm == "kernels")
        del busy[arm]["spans"]
    if profile:
        k_, o_ = busy["kernels"], busy["op"]
        log(f"[mode busy {name}] {card}: device events an iteration kernels"
            f" {k_['events_per_it']:.1f} vs step_kernels=False "
            f"{o_['events_per_it']:.1f}; device ms an iteration "
            f"{k_['device_ms_per_it']:.5f} vs {o_['device_ms_per_it']:.5f};"
            f" profiled frames {k_['wall']:.4f} vs {o_['wall']:.4f} s "
            f"({k_['iterations']} iterations)")
    log(f"[mode frames {name}] {card}: frame seconds kernels "
        f"{secs['kernels']} vs step_kernels=False {secs['op']}; median "
        f"ratio op / kernels "
        f"{statistics.median(secs['op']) / statistics.median(secs['kernels']):.3f}")
    G.clear_graphs()
    return dict(secs=secs, busy=busy, launches=got["kernels", 2][3]["step"])


def _mode_time_text(t, card):
    """The ``[mode time ...]`` lines of one mode's timings
    (tools/step_designs.py ``time_state``)."""
    lines = [f"[mode time {k}] {card}: {r['mean_ms']:.4f} ms a launch (in "
             f"turns {r['ms']}), bound {r['bound_us']:.3f} us by "
             f"{r['bound_by']} ({r['bytes']:.0f} bytes), "
             f"{100 * r['share']:.2f}% of the bound; one call "
             f"{r['one_call_ms']:.4f} ms, plain version {r['plain_ms']:.4f} "
             f"ms; {r['registers']} registers, {r['warps_per_sm']} resident "
             "warps an SM" for k, r in t["kernels"].items()]
    sort = "none" if t["sort_ms"] is None else f"{t['sort_ms']:.4f} ms"
    work = (f"{t['flushing']} lanes flush, {t['limbo']} in limbo"
            if "flushing" in t else
            f"{t['flush_atomics']['lanes']} lanes flush by "
            f"{t['flush_atomics']['record']} atomics")
    if t["key_sort"] is not None:
        lines.append(_sort_time_text(f"{'+'.join(t['kernels'])}",
                                     t["key_sort"], card))
    return lines + [f"[mode time {'+'.join(t['kernels'])}] {card}: "
                    f"{t['lanes']} lanes, torch.sort {sort}; {work}"]


def phase14_mode_kernels(scene, camera, card):
    """(a)-(d) for the modes beside the default one (kernels/step.py
    ``route_full`` / ``shade_full`` / ``resolve_full``, the unsorted
    engine's ``route_shade_unsorted``, the wide bundle, the one-sample and
    ``detailed_stats`` instances): the registers of the default instances,
    the first design and the unsorted and parity instances held to
    STEP_REGISTERS, every other step kernel's printed; the camera rank's
    scan against
    ``torch.cumsum`` on five masks (tools/mode_steps.py ``check_ranks``);
    each mode's kernels against their plain versions on the op-by-op
    states of MODE_CHECK_ITS of each cell of :func:`_mode_cells` and on
    synthetic pools of every lane kind with limbo or dirty lanes
    (tools/step_designs.py): every output bit for bit (the bounce
    histogram too), the framebuffer within FB_RTOL; each cell's captured
    frames through the kernels and under ``step_kernels=False`` in turns
    (:func:`_mode_frames`); each kernel's timing on its MODE_TIMED cell's
    state of MODE_TIME_IT.  Returns the rows' numbers."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import mode_steps as M
    import step_designs as SD
    from rtjax_torch.kernels import step as S
    regs = {k: S.kernel_info(k)["registers"] for k in S.KERNEL_IDS}
    print(f"[step registers] {card}: {regs} (held to {STEP_REGISTERS})")
    if {k: regs[k] for k in STEP_REGISTERS} != STEP_REGISTERS:
        raise RuntimeError("the step kernels' registers changed")
    ranks = M.check_ranks(scene, camera, card)
    worst = {f"rank {k}": v for k, v in ranks.items() if v}
    fb_gap, times = 0.0, {}
    timed = {v: k for k, v in MODE_TIMED.items()}
    cells = _mode_cells(scene, camera)
    for name, (sc, cam, cfg) in cells.items():
        bad, gap, t = SD.check_and_time(
            sc, cam, cfg, MODE_CHECK_ITS,
            MODE_TIME_IT if name in timed else None, label=name, card=card)
        worst.update({f"{name} {k}": v for k, v in bad.items() if v})
        fb_gap = max(fb_gap, gap)
        if name in timed:
            times[timed[name]] = t
    parity = dict(reference_parity=True, rr_start=0)
    wide = dict(max_bounces=WIDE_BOUNCES)
    bad, gap = _synthetic_checks(camera, card, {
        "unsorted": dict(sort_rays=False), "parity": parity,
        "parity_unsorted": dict(parity, sort_rays=False),
        "stats": dict(detailed_stats=True),
        "parity stats": dict(parity, detailed_stats=True),
        "one_sample": dict(one_sample_mis=True),
        "one_sample no_sort": dict(one_sample_mis=True, sort_rays=False),
        "wide": wide,
        "wide one_sample stats": dict(wide, one_sample_mis=True,
                                      detailed_stats=True)}, (0, 1), 13)
    worst.update({f"synthetic {k}": v for k, v in bad.items() if v})
    fb_gap = max(fb_gap, gap)
    if worst:
        raise RuntimeError(f"the full-record step kernels differ from their "
                           f"plain versions: {worst}")
    frames = {name: _mode_frames(name, sc, cam, cfg, card)
              for name, (sc, cam, cfg) in cells.items()}
    for t in times.values():
        for line in _mode_time_text(t, card):
            print(line)
    return dict(fb_gap=fb_gap, times=times, frames=frames, ranks=ranks)


def _mode_rows(p14m, launches):
    """The kernels line's rows of the instances of the modes beside the
    default one (launches: phase 8(c)'s parity frame for the parity
    kernels, phase 9(b)'s two xla frames for the unsorted engine's, and
    for every other the seed-2 kernel frame of its MODE_TIMED cell in
    phase 14)."""
    rows = []
    for name, (mode, replaces) in MODE_STEP_KERNELS.items():
        r = p14m["times"][mode]["kernels"][name]
        rows.append(dict(
            name=f"step_{name}", route="cuda", source=STEP_SOURCE,
            replaces=replaces, launches=launches[name],
            max_abs_err=p14m["fb_gap"] if name.startswith("shade") else 0.0,
            ms=r["mean_ms"], timed_ms=r["ms"], timed_launches=REPS,
            one_call_ms=r["one_call_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=r["bound_us"],
            bound_by=r["bound_by"], share=r["share"], library_ms=None,
            registers=r["registers"], warps_per_sm=r["warps_per_sm"],
            note=f"no pallas_call: rtjax's XLA fusions of wavefront_step, "
                 f"mode {mode}, timed on {MODE_TIMED[mode]}'s state"))
    return rows


def _step_rows(p14, launches):
    """The kernels line's rows of the step kernels (launches: phase 4's
    three headline frames)."""
    t = p14["times"]
    k = t["kernels"]
    rows = []
    for name, meta in STEP_KERNELS.items():
        r = k[name]
        rows.append(dict(
            name=meta["name"], route="cuda", source=STEP_SOURCE,
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=p14["fb_err"] if name == "shade" else 0.0,
            ms=r["mean_ms"], timed_ms=r["ms"], timed_launches=REPS,
            one_call_ms=r["one_call_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=r["bound_us"],
            bound_by=r["bound_by"], share=r["share"], library_ms=None,
            registers=r["registers"], warps_per_sm=r["warps_per_sm"],
            mismatching_lanes=p14["mismatches"][name],
            note="no pallas_call: rtjax's XLA fusions of wavefront_step"))
    rows[0]["first_design_ms"] = k["route_v1"]["mean_ms"]
    rows[1]["first_design_ms"] = k["shade_v1"]["mean_ms"]
    rows[1]["flush_atomics"] = t["flush_atomics"]
    rows[0]["sort_ms"] = t["sort_ms"]
    rows[0]["sort_bound_ms"] = _step_bound(t["lanes"] * SORT_BYTES,
                                           0)["bound_ms"]
    return rows


def _sort_row(p14, p14m, launches):
    """The kernels line's row of the step's key sort (launches: phase 4's
    three headline frames; its time phase 14 (d)'s on the headline's
    route keys of iteration STEP_TIME_IT, in turns with torch.sort, the
    library call; ``cells`` the same on the other cells' route keys,
    ``sets`` on the synthetic key sets, ``frames`` (e)'s frames)."""
    t = p14["times"]["key_sort"]
    sort = p14["sort"]
    cells = {k: v for k, v in sort["cells"].items() if k != "headline"}
    for mode, name in (("parity", "parity frame"), ("wide", "wide frame")):
        cells[name] = p14m["times"][mode]["key_sort"]
    brief = lambda r: dict(lanes=r.get("lanes"), ms=r["mean"]["kernels"],
                           library_ms=r["mean"]["torch"],
                           bound_ms=r["bound"]["bound_ms"],
                           **({"skip_ms": r["skip_ms"]} if "skip_ms" in r
                              else {}))
    return dict(
        name="key_sort", route="cuda", source=SORT_SOURCE,
        replaces="rtjax/render/sorting.py:126", launches=launches,
        max_abs_err=0.0, mismatching_lanes=p14["mismatches"]["key_sort"],
        ms=t["mean"]["kernels"], timed_ms=t["kernels"], timed_launches=REPS,
        one_call_ms=t["one_call_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound"]["bound_ms"], bound_us=t["bound"]["bound_us"],
        bound_by=t["bound"]["bound_by"],
        share=t["bound"]["bound_ms"] / t["mean"]["kernels"],
        library_ms=t["mean"]["torch"], library_timed_ms=t["torch"],
        registers={k: r["registers"] for k, r in sort["registers"].items()},
        kernels="a memset node, upsweep_kernel, pass_kernel x 4",
        cells={k: brief(r) for k, r in cells.items()},
        sets={f"{k[0]} 2^{k[1]}": dict(ms=v["time"]["mean"]["kernels"],
                                       library_ms=v["time"]["mean"]["torch"],
                                       bad=v["bad"])
              for k, v in sort["sets"].items()},
        skip_ms={f"2^{k}": v["skip_ms"] for k, v in sort["skips"].items()},
        frames={k: dict(secs=f["secs"], sort_ms=f["sort_ms"],
                        tally=f["tally"], iterations=f["iterations"],
                        device_ms_per_it={a: b["device_ms_per_it"]
                                          for a, b in f["busy"].items()},
                        events_per_it={a: b["events_per_it"]
                                       for a, b in f["busy"].items()})
                for k, f in sort["frames"].items()},
        note="no pallas_call: XLA's lax.sort; library_ms is torch.sort("
             "keys, stable=True), the plain version, timed in turns")


def main():
    t0 = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t0:.1f} s")

    card = phase0_device()
    import torch
    from rtjax_torch.render import wavefront
    wavefront.render_frame_linear = _frame_log(wavefront.render_frame_linear)
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
    binary_launches, xla_secs, xla_steps = phase9_xla_frames(scene, camera,
                                                             card, floor)
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
    big = phase11_bigscene(card)
    stamp("phase 11 (big-scene tier)")
    d12 = phase12_direct(card)
    stamp("phase 12 (direct path, configs 2 and 3)")
    g13 = phase13_graph(scene, camera, card, floor, c4_scene, c4_camera,
                        c4_floor)
    stamp("phase 13 (the captured frame loop)")
    p14 = phase14_step_kernels(scene, camera, card, floor, c4_scene,
                               c4_camera, c4_floor, g13)
    p14m = phase14_mode_kernels(scene, camera, card)
    stamp("phase 14 (the step kernels)")
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
            *_walk_stats_rows(walk_stats, walk_launches),
            *_direct_rows(d12, c4_floor["direct_launches"]),
            *_step_rows(p14, {k: launches[f"step {k}"]
                              for k in STEP_KERNELS}),
            _sort_row(p14, p14m, launches["key_sort"]),
            *_mode_rows(p14m, {
                k: {"unsorted": xla_steps, "parity": modes["launches"]}.get(
                    m, p14m["frames"][MODE_TIMED[m]]["launches"])[k]
                for k, (m, _) in MODE_STEP_KERNELS.items()})]
    for k, rec in _big_rows(big).items():
        next(r for r in rows if r["name"] == k)["bigscene"] = rec
    for k in rows:
        print(f"[bound] {k['name']}: {k['bound_us']:.3f} us by "
              f"{k['bound_by']}, kernel {k['ms']:.4f} ms device time, "
              f"{100 * k['share']:.2f}% of the bound; launches {k['launches']}")
    c2_prof = d12["designs"]["frames"]["config2"]["profile"]
    c2_its = " / ".join(f"{c2_prof[a]['ms_per_iteration']:.4f}"
                        for a in ("engine", "v1"))
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
          f"{multi['c5_mrays']:.3f} Mrays/s; big scenes "
          + "; ".join(
              f"{r['triangles']} triangles built in "
              f"{r['build_s']['total']:.1f} s, frame "
              f"{r['frames']['seconds'][1]:.3f} s at "
              f"{r['frames']['mrays']:.3f} Mrays/s (xla "
              f"{r['frames']['xla_seconds']:.3f} s), persist share of the "
              f"bound closest {100 * r['persist']['closest']['share']:.2f}%,"
              f" any hit {100 * r['persist']['anyhit']['share']:.2f}%"
              for r in big.values())
          + f"; config 2 frame seconds direct {d12['secs']['direct']} vs "
          f"direct_max_tris=0 {d12['secs']['persist']}, device time a "
          f"launch direct closest "
          f"{d12['kernels']['config2']['closest']['ms']:.4f} ms vs persist "
          f"{d12['s1']['persist_ms']['closest']:.4f} ms, any hit "
          f"{d12['kernels']['config2']['anyhit']['ms']:.4f} ms vs "
          f"{d12['s1']['persist_ms']['anyhit']:.4f} ms (any hit's first "
          f"design {d12['kernels']['config2']['anyhit']['v1_ms']:.4f} ms); "
          f"config 2 device ms an iteration, any hit's engine / first "
          f"design {c2_its}; config 3 "
          f"{d12['c3']['secs']} s (xla {d12['c3']['xla_secs']:.3f} s); "
          "captured step vs eager loop, median frame seconds "
          + ", ".join(
              f"{name} {statistics.median(r['secs']['graph']):.3f} vs "
              f"{statistics.median(r['secs']['eager']):.3f} (capture "
              f"{r['capture_s']:.3f} s, busy "
              f"{100 * r['busy']['graph']['share_of_median']:.1f}% vs "
              f"{100 * r['busy']['eager']['share_of_median']:.1f}%)"
              for name, r in g13.items() if name != "repass_designs")
          + "; repass in the captured step, median frame seconds "
          + ", ".join(
              f"{n} instances while nodes {r['medians']['while']:.4f} vs "
              f"all passes masked {r['medians']['masked']:.4f}"
              for n, r in g13["repass_designs"].items()))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        job, rank, world, coord, out = sys.argv[2:7]
        _rank_job(job, int(rank), int(world), coord, out)
    elif sys.argv[1:2] == ["--busy-job"]:
        _busy_job(sys.argv[2])
    else:
        main()
