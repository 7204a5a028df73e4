#!/usr/bin/env python3
"""The wavefront step under its modes beside the default one (the
unsorted engine, ``reference_parity``, the wide bundle, ``one_sample_mis``,
``detailed_stats``) on one CUDA card.

    python3 tools/mode_steps.py [--cells "parity frame,headline xla"]
                                [--time-it 30] [--check] [--split-ab]

It prints every step kernel's registers and resident warps, checks the
camera rank's scan against ``torch.cumsum`` (:func:`check_ranks`), and on
each cell of ``chip_smoke.py``'s ``_mode_cells`` named in ``--cells``
(default: phase 8(c)'s parity frame, the headline under
``traversal="xla"`` and under ``sort_rays=False``; the cells of the
wide bundle, ``one_sample_mis`` and ``detailed_stats`` by name, e.g.
``"headline stats,wide frame"``):

1. steps a pool op by op and, on the states of ``MODE_CHECK_ITS``, holds
   the mode's kernels bit for bit against their plain versions, and on
   the state of ``--time-it`` times each kernel in turns with its byte
   bound and share, one wrapper call and one plain call
   (tools/step_designs.py ``check_and_time``);
2. renders frames through the step kernels and under
   ``step_kernels=False`` in turns, captured, each seed's pair agreeing,
   and profiles one captured frame of each arm: device events and device
   ms an iteration (``chip_smoke._mode_frames``); on the cells of
   ``chip_smoke.DESIGN_CELLS`` (the parity frames, the headline under
   ``"xla"`` and under ``one_sample_mis`` without the sort) also the
   mode's kernels against their first design in turns, each arm
   profiled: busy ms and events an iteration, route's and shade's ms a
   frame (``chip_smoke._designs``).

``--check`` stops after step 1.  ``--split-ab`` instead times the
unsorted engine's route-and-shade kernel against route and shade as two
kernels (a patched copy of the library's first design,
:func:`split_library`) on the headline's state under ``traversal="xla"``,
in turns.  ``chip_smoke.py``'s
phase 14 runs :func:`check_ranks` and steps 1-2 without the profile on
every cell.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# the rank's masks (check_ranks): the pool is RANK_BLOCKS shade blocks and
# a ragged tail
RANK_BLOCKS, RANK_TAIL = 37, 5
CELLS = ("parity frame", "headline xla", "headline no_sort")


def check_ranks(scene, camera, card, log=print, dev="cuda"):
    """The camera rank against ``torch.cumsum`` on the masks of lanes that
    take a camera ray: all, none, alternating, one a shade block, and the
    first and last lane of every block, over RANK_BLOCKS blocks and a
    ragged tail.  The unsorted engine's route and shade (one kernel; its
    look-back after the shading, and the first design's scan before it,
    key ``"<mask> v1"``) run on a pool whose continuing lanes are the
    mask's complement (every slot at bounce 0, roulette off, one sample a
    pixel in scanline order): each lane with a camera ray takes pixel
    ``cam_start`` + its rank.  Returns the mismatching lanes by mask (all
    0)."""
    import torch
    from step_designs import _copy
    from rtjax_torch import RenderConfig
    from rtjax_torch.constants import DEAD_BOUNCES
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render.wavefront import PathState
    blk = S.SCAN_BLOCK
    n = RANK_BLOCKS * blk + RANK_TAIL
    side = 1 << 8
    cfg = RenderConfig(width=side, height=side, num_samples=1,
                       max_bounces=5, num_working_paths=n,
                       sort_rays=False, camera_order="scanline",
                       rr_start=1 << 20)
    idx = torch.arange(n, device=dev)
    masks = {"all": idx >= 0, "none": idx < 0, "alternating": idx % 2 == 0,
             "one a block": idx % blk == 37 % blk,
             "block edges": (idx % blk == 0) | (idx % blk == blk - 1)}
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for (name, gen), v1 in ((m, v1) for v1 in (False, True)
                            for m in masks.items()):
        f = lambda v: torch.full((n,), v, device=dev)
        state = PathState(
            pixel=torch.zeros(n, dtype=torch.int32, device=dev),
            ray_o=(f(0.0), f(0.0), f(0.0)), ray_d=(f(0.0), f(0.0), f(1.0)),
            hit=~gen, t=f(1.0), normal=(f(0.0), f(1.0), f(0.0)),
            prim=torch.zeros(n, dtype=torch.int32, device=dev),
            src=torch.zeros(n, dtype=torch.int32, device=dev),
            bounces=torch.where(gen, DEAD_BOUNCES, 0).to(torch.int32),
            beta=(f(1.0), f(1.0), f(1.0)), acc=(f(0.0), f(0.0), f(0.0)))
        words = torch.randint(0, 1 << 32, (5, n), generator=g,
                              device=dev, dtype=torch.int64)
        cam_start = torch.tensor(11, device=dev)
        step = S.route_shade_unsorted_v1 if v1 else S.route_shade_unsorted
        sh = step(scene, camera, cfg, _copy(state),
                  torch.zeros(cfg.num_pixels, 3, device=dev), words,
                  cam_start)
        rank = torch.cumsum(gen, 0) - gen.long()
        want = torch.where(gen, (11 + rank).to(torch.int32), 0)
        got = torch.where(gen, sh.pixel, 0)
        name += " v1" * v1
        out[name] = int((got != want).sum()) + int((~sh.trace_mask).sum())
        log(f"[mode rank {name}] {card}: {int(gen.sum())} of {n} lanes take"
            f" a camera ray; mismatching ranks {out[name]}")
    return out


# --split-ab: the unsorted engine's route and shade as two kernels again,
# in a patched copy of the library: route writes the record (a route
# instance of the unsorted engine added), the first design's shade
# (route_shade_unsorted_v1) gathers it
SPLIT_MERGED = ("    if constexpr (kMode == rtjax_step::kUnsorted) {\n"
                "      int2 w")
SPLIT_COUNT = ("  if constexpr (kMode == rtjax_step::kUnsorted) "
               "count(a.counts, r.mat);\n")
SPLIT_ROUTE = """
namespace {
__global__ void __launch_bounds__(kBlock)
    route_unsorted_kernel(const StepArgs a) {
  route_full<rtjax_step::kUnsorted>(a);
}
}  // namespace

extern "C" int rtjax_step_route_unsorted(const StepArgs* a, void* stream) {
  return launch(route_unsorted_kernel, kBlock, a, stream);
}
"""


def split_source(src):
    """``src`` (csrc/step_kernels.cu) patched so that the unsorted
    engine's shade gathers the record and route writes it."""
    for old in (SPLIT_MERGED, SPLIT_COUNT):
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/step_kernels.cu has no single {old!r}")
    src = src.replace(SPLIT_MERGED, SPLIT_MERGED.replace(
        "kMode == rtjax_step::kUnsorted", "false"))
    return src.replace(SPLIT_COUNT, "") + SPLIT_ROUTE


def split_library():
    """A copy of the step library under ``build/`` whose unsorted engine's
    first design runs route and shade as two kernels
    (``rtjax_step_route_unsorted`` writes the record,
    ``rtjax_step_route_shade_unsorted_v1`` gathers it): ``(path, ptxas's
    lines of the two)``."""
    import step_designs as SD
    from rtjax_torch.kernels import _build
    lib = SD.patched_library("split", {
        "step_kernels.cu": split_source(_build.STEP_SOURCE.read_text()),
        "step_math.cuh": _build.STEP_HEADER.read_text()})
    lines = [res for name, res in _build.ptxas_report(lib)
             if "route_unsorted_kernel" in name
             or "route_shade_unsorted_v1_kernel" in name]
    return lib, lines


def split_ab(scene, camera, cfg, time_it, card, reps=5, log=print):
    """``--split-ab`` on one unsorted cell's state of ``time_it`` (stepped
    op by op): the split copy bit for bit against the plain version, then
    in turns (merged, two kernels, two kernels, merged) the library's
    route-and-shade kernel against route + shade of the split copy, each
    launch that writes the next state on its own copy of the state.  The
    split's shade is the first design's, which ranks by its scan."""
    import ctypes

    import chip_smoke as C
    import torch
    from step_designs import _copy
    from rtjax_torch.kernels import step as S
    from rtjax_torch.render import wavefront as WF
    mode = S.step_mode(scene, cfg)
    if mode != "unsorted":
        raise ValueError(f"--split-ab takes the unsorted engine, not {mode}")
    n = cfg.pool_size
    g = torch.Generator(device="cuda").manual_seed(7)
    carry = WF.initial_carry(cfg, "cuda")
    carry = carry[:3] + (torch.zeros((), dtype=torch.int64,
                                     device="cuda"),) + carry[4:]
    for it in range(time_it + 1):
        words = torch.randint(0, 1 << 32, (5, n), generator=g,
                              device="cuda", dtype=torch.int64)
        if it < time_it:
            carry = WF.wavefront_step(scene, camera, cfg, words, carry,
                                      step_kernels=False)
    state, fb, cam_start = carry[0], carry[1], carry[2]
    path, lines = split_library()
    for line in lines:
        log(f"[mode split ptxas] {card}: {line}")
    split = S.bind(ctypes.CDLL(str(path)))
    split.rtjax_step_route_unsorted.argtypes = [ctypes.POINTER(S.StepArgs),
                                                ctypes.c_void_p]
    lib = S._kernels()
    stream = torch.cuda.current_stream().cuda_stream
    zero = lambda: torch.zeros(S.NUM_COUNTS, dtype=torch.int64,
                               device="cuda")

    def route_block():
        """A route block of the split copy: the record allocated."""
        a, (_, record, counts) = S.route_args(scene, cfg, state, words,
                                              mode=mode)
        return a, record, counts

    def shade_block(st, record, counts):
        a = S.shade_args(scene, camera, cfg, st, fb.clone(), words, None,
                         None, counts, 0, cam_start, 1, v1=True,
                         mode=mode)[0]
        a.bundle = record.data_ptr()
        a.held += (record,)
        return a

    fb0 = fb.clone()
    sh0 = S.route_shade_unsorted_ref(scene, camera, cfg, state, fb0, words,
                                     cam_start)
    a_r, record, counts = route_block()
    split.rtjax_step_route_unsorted(ctypes.byref(a_r), stream)
    st1 = _copy(state)
    a_s = shade_block(st1, record, counts)
    split.rtjax_step_route_shade_unsorted_v1(ctypes.byref(a_s), stream)
    torch.cuda.synchronize()
    bad = {}
    got = dict(pixel=st1.pixel, ray_o=st1.ray_o, ray_d=st1.ray_d,
               beta=st1.beta, bounces=st1.bounces, acc=st1.acc)
    for f, v in got.items():
        for j, (x, y) in enumerate(zip(C._flat_out(v),
                                       C._flat_out(getattr(sh0, f)))):
            if C._lanes_differ(x, y):
                bad[f"{f}[{j}]"] = C._lanes_differ(x, y)
    if C._lanes_differ(counts[:4], sh0.counts[:4]) and not bad:
        bad["counts"] = 1
    launches = 6 * (reps + 1)
    merged = iter([S.shade_args(scene, camera, cfg, st, fb.clone(), words,
                                None, None, zero(), 0, cam_start, 1,
                                mode=mode)[0]
                   for st in (_copy(state) for _ in range(launches))])
    routes = iter([route_block()[0]] * launches)
    shades = iter([shade_block(st, record, zero())
                   for st in (_copy(state) for _ in range(launches))])
    call = lambda entry, blocks: (lambda: entry(ctypes.byref(next(blocks)),
                                                stream))
    ms = {"merged": [], "two kernels": []}
    for arm in ("merged", "two kernels", "two kernels", "merged"):
        if arm == "merged":
            ms[arm].append(C._launch_ms(call(
                lib.rtjax_step_route_shade_unsorted, merged), reps)[0])
        else:
            ms[arm].append(
                C._launch_ms(call(split.rtjax_step_route_unsorted, routes),
                             reps)[0]
                + C._launch_ms(call(
                    split.rtjax_step_route_shade_unsorted_v1, shades),
                    reps)[0])
    log(f"[mode split] {card}: mismatching lanes {bad or 0}; route and "
        f"shade merged {ms['merged']} ms against two kernels "
        f"{ms['two kernels']} ms a step (in turns)")
    if bad:
        raise RuntimeError(f"the split kernels differ from the plain "
                           f"version: {bad}")
    return dict(ms=ms, ptxas=lines)


def run(names, time_it, card, check_only=False, log=print):
    """Every step kernel's registers, :func:`check_ranks`, and on each
    cell of ``names`` step 1 (timed on ``time_it``) and, unless
    ``check_only``, step 2: ``{"registers", "ranks", cell: {...}}``."""
    import chip_smoke as C
    import step_designs as SD
    from rtjax_torch.kernels import step as S
    scene, camera = C.phase2_scene()
    out = {"registers": {k: S.kernel_info(k) for k in S.KERNEL_IDS}}
    for k, r in out["registers"].items():
        log(f"[mode registers {k}] {card}: {r['registers']} registers, "
            f"{r['local_bytes']} local bytes, {r['block']} threads a "
            f"block, {r['warps_per_sm']} resident warps an SM")
    out["ranks"] = check_ranks(scene, camera, card, log)
    bad = {k: v for k, v in out["ranks"].items() if v}
    cells = C._mode_cells(scene, camera)
    for name in names:
        sc, cam, cfg = cells[name]
        worst, gap, timed = SD.check_and_time(sc, cam, cfg, C.MODE_CHECK_ITS,
                                              time_it, label=name, card=card,
                                              log=log)
        bad.update({f"{name} {k}": v for k, v in worst.items() if v})
        out[name] = dict(mismatches=worst, fb_gap=gap, times=timed)
        for line in C._mode_time_text(timed, card):
            log(line)
        if not check_only:
            out[name].update(C._mode_frames(name, sc, cam, cfg, card,
                                            profile=True, log=log))
            if name in C.DESIGN_CELLS:
                out[name]["designs"] = C._designs(name, sc, cam, cfg, card,
                                                  log=log)
    if bad:
        raise RuntimeError(f"the step kernels differ from their plain "
                           f"versions: {bad}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--time-it", type=int, default=30)
    ap.add_argument("--check", action="store_true",
                    help="registers, ranks and the kernels on frame states "
                    "only (no frames)")
    ap.add_argument("--split-ab", action="store_true",
                    help="the unsorted engine's route-and-shade kernel "
                    "against the two as kernels of their own, on the "
                    "headline under traversal='xla'")
    ap.add_argument("--out")
    args = ap.parse_args()
    import chip_smoke as C
    card = C.phase0_device()
    print(f"[card] {card}")
    C.phase1_build()
    if args.split_ab:
        scene, camera = C.phase2_scene()
        out = split_ab(scene, camera, C._headline_cfg(traversal="xla"),
                       args.time_it, card)
    else:
        out = run(args.cells.split(","), args.time_it, card, args.check)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)


if __name__ == "__main__":
    main()
