#!/usr/bin/env python3
"""The step's stable key sort (kernels/sort.py, csrc/key_sort.cu) on one
CUDA card.

    python3 tools/sort_designs.py [--log2 17,18,19,20] [--frames [--out F]]
    python3 tools/sort_designs.py --variants [--log2 18,19]

1. prints each sort kernel's registers, spill bytes and resident warps an
   SM;
2. holds :func:`kernels.sort.stable_order` bit for bit against
   ``torch.sort(keys, stable=True).indices`` on every synthetic set of
   :data:`SETS` at each size ``2^--log2``, and checks that a
   launch on a ``sort_every`` skip iteration leaves its order untouched
   (and counts itself in the device tally as one that returned at once);
3. times, in turns, ``torch.sort`` against the kernels on each set
   (:func:`time_sort`: ``chip_smoke._launch_ms``, CUDA events between
   calls queued behind a spin kernel), with the bound; ``--variants``
   instead times copies of the library built with other sizes, or with
   a part taken out, against the engine's in turns;
4. ``--frames``: captured frames of the headline, config 2, config 4 (b),
   the parity frame and the wide 2048^2 frame with the step's sort on the
   kernels and on ``torch.sort`` (the name ``kernels.sort.stable_order``
   rebound, a graph captured for each arm), in turns (:func:`frames`):
   equal iterations, rays and occupancy, framebuffers within rtol 1e-5;
   frame seconds; a profiled captured frame an arm with device events and
   ms an iteration and the sort's device ms a frame (and, on the kernels'
   arm, that no CUB or torch sort kernel ran); the device tally of the
   kernels' launches that sorted and that returned at once.

``chip_smoke.py`` phase 14 runs 2-4 through these functions;
tools/step_designs.py holds and times the sort on every cell's route keys
beside the step kernels.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DIRTY_KEY, INACTIVE_KEY, MAX_LIVE_KEY = 0x7FFFFFFE, 0x7FFFFFFF, 0x7FFFFFFD
# the synthetic key sets: constant keys, the dead classes alone, sorted and
# reversed keys, random 31-bit keys (the key functions' range), random
# int32 keys with negatives, the int32 extremes, two distinct keys, and a
# late iteration's pool (most lanes dead or dirty, the rest live)
SETS = ("all_equal", "all_dead", "dead_pair", "sorted", "reversed",
        "random31", "random_int32", "extremes", "two_keys", "mostly_dead")
FB_RTOL, FB_ATOL = 1e-5, 1e-7
# bytes the sort must move a key: its key read (4 B) and its order index
# written (8 B)
SORT_KEY_BYTES = 12
# the kernels the profiler names: the sort's own, and the sorts of torch
# (CUB's radix sort, torch's small-segment sorts)
OURS = re.compile(r"upsweep_kernel|pass_kernel")
THEIRS = re.compile(r"RadixSort|radix_sort|sortKeyValue|bitonic|segmented",
                    re.I)


def synthetic_keys(name: str, n: int, seed: int = 0) -> np.ndarray:
    """``n`` int32 keys of the set ``name`` (:data:`SETS`), from
    ``seed``."""
    rng = np.random.default_rng(seed)
    live = lambda m: rng.integers(0, MAX_LIVE_KEY + 1, m)
    if name == "all_equal":
        k = np.full(n, int(live(1)[0]))
    elif name == "all_dead":
        k = np.full(n, INACTIVE_KEY)
    elif name == "dead_pair":
        k = rng.choice([DIRTY_KEY, INACTIVE_KEY], n)
    elif name == "sorted":
        k = np.sort(live(n))
    elif name == "reversed":
        k = np.sort(live(n))[::-1]
    elif name == "random31":
        k = rng.integers(0, 1 << 31, n)
    elif name == "random_int32":
        k = rng.integers(-(1 << 31), 1 << 31, n)
    elif name == "extremes":
        k = rng.choice([-(1 << 31), -(1 << 31) + 1, -1, 0, 1,
                        (1 << 31) - 2, (1 << 31) - 1], n)
    elif name == "two_keys":
        k = rng.choice(live(2), n)
    elif name == "mostly_dead":
        u = rng.uniform(size=n)
        k = np.where(u < 0.6, INACTIVE_KEY,
                     np.where(u < 0.85, DIRTY_KEY, live(n)))
    else:
        raise ValueError(f"no key set {name!r}")
    return np.ascontiguousarray(k.astype(np.int32))


def kernel_table():
    """``{name: sort.kernel_info(name)}`` of every sort kernel."""
    from rtjax_torch.kernels import sort as SO
    return {name: SO.kernel_info(name) for name in SO.KERNEL_IDS}


def sort_bound(n: int) -> dict:
    """The least time of a sort of ``n`` keys: its bytes over the memory
    rate (the comparisons it needs are no float or tensor-core work, and
    at 2^17-2^20 keys they take less time than the bytes)."""
    import chip_smoke as C
    return C._step_bound(n * SORT_KEY_BYTES, 0)


def check(keys) -> int:
    """Lanes of the kernels' order that differ from
    ``torch.sort(keys, stable=True).indices``."""
    import torch
    from rtjax_torch.kernels import sort as SO
    want = torch.sort(keys, stable=True).indices
    return int((SO.stable_order(keys) != want).sum())


def check_skip(n: int) -> dict:
    """A launch on a ``sort_every`` skip iteration (``counts[0]`` all the
    lanes, ``it`` 1, ``sort_every`` 2; ``it`` as a tensor and as an int)
    and one on a sorting iteration (``it`` 2): ``{untouched: the skips
    left the order's words as they were, sorts: the other sorted, tally:
    [sorted, returned at once] of the three launches, skip_ms: the device
    ms of a skip launch}``."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    keys = torch.randint(0, 1 << 31, (n,), device="cuda", dtype=torch.int32)
    counts = torch.tensor([n, 0, 0, 0, 0], device="cuda")
    before = SO.tally("cuda").clone()
    untouched = True
    for it in (torch.tensor(1, device="cuda"), 1):
        out = torch.full((n,), -7, dtype=torch.int64, device="cuda")
        got = SO.sort_into(keys, out, (counts, it, 2))
        untouched &= bool((got == -7).all())
    want = torch.sort(keys, stable=True).indices
    sorts = bool((SO.stable_order(keys, (counts, 2, 2)) == want).all())
    torch.cuda.synchronize()
    tally = (SO.tally("cuda") - before).tolist()
    skip_ms = C._launch_ms(lambda: SO.stable_order(keys, (counts, 1, 2)))[0]
    return dict(untouched=untouched, sorts=sorts, tally=tally,
                skip_ms=skip_ms)


def time_sort(keys, reps=5) -> dict:
    """In turns (torch.sort, kernels, kernels, torch.sort), each the device
    ms of a call (``chip_smoke._launch_ms``, the mean of ``reps`` calls
    queued behind a spin): ``{"torch": [ms, ms], "kernels": [ms, ms],
    "mean": {...}, "one_call_ms": a wrapper call in CUDA events (host
    launch included), "plain_ms": a plain-version call likewise, "bound":
    sort_bound}``."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    fns = {"torch": lambda: torch.sort(keys, stable=True),
           "kernels": lambda: SO.stable_order(keys)}
    out = {k: [] for k in fns}
    for k in ("torch", "kernels", "kernels", "torch"):
        out[k].append(C._launch_ms(fns[k], reps)[0])
    out["mean"] = {k: statistics.mean(v) for k, v in list(out.items())}
    out["one_call_ms"] = C._median_ms(lambda: SO.stable_order(keys))
    out["plain_ms"] = C._median_ms(lambda: SO.stable_order_ref(keys))
    out["bound"] = sort_bound(keys.shape[0])
    return out


def time_text(label, t, card) -> str:
    m, b = t["mean"], t["bound"]
    return (f"[sort time {label}] {card}: kernels {m['kernels']:.4f} ms, "
            f"torch.sort {m['torch']:.4f} ms a call (in turns "
            f"{t['kernels']} / {t['torch']}); bound {b['bound_us']:.3f} us "
            f"({100 * b['bound_ms'] / m['kernels']:.2f}% of it); one call "
            f"{t['one_call_ms']:.4f} ms, plain version {t['plain_ms']:.4f} ms")


def check_sets(log2s=(17, 18, 19, 20), card="", seed=0, log=print):
    """Steps 2-3 on every set of :data:`SETS` at each size: ``({(set,
    log2): {"bad": check(), "time": time_sort()}}, {log2:
    check_skip()})``."""
    import torch
    res, skips = {}, {}
    for lg in log2s:
        n = 1 << lg
        for name in SETS:
            keys = torch.from_numpy(synthetic_keys(name, n, seed)).cuda()
            res[name, lg] = dict(bad=check(keys), time=time_sort(keys))
            log(f"[sort check {name} 2^{lg}] {card}: mismatching lanes "
                f"{res[name, lg]['bad']}")
            log(time_text(f"{name} 2^{lg}", res[name, lg]["time"], card))
        skips[lg] = check_skip(n)
        log(f"[sort skip 2^{lg}] {card}: {skips[lg]}")
    return res, skips


def skips_ok(skips) -> bool:
    return all(s["untouched"] and s["sorts"] and s["tally"] == [1, 2]
               for s in skips.values())


# --variants: copies of the library built with other settings
# (csrc/key_sort.cuh's macros) or with a part taken out for timing only
# (source patches, ``(old, new)`` each; such a copy's order is wrong, and
# the engine's time less its time is what the part costs): keys a thread
# ranks in a pass (the tile: 256 threads x items) and reads in the
# upsweep, the status words a look-back step reads, the passes in plain
# stream order, the peers by one
# __match_any_sync; taken out: the look-back, the ballots (each key its
# own peer group), the upsweep's work, every pass, the upsweep and every
# pass, all passes but the first, every pass's work after its ticket and
# its wait
VARIANTS = {
    "items4": dict(defines={"RTJAX_SORT_ITEMS": 4}),
    "items16": dict(defines={"RTJAX_SORT_ITEMS": 16}),
    "up4": dict(defines={"RTJAX_SORT_UP_ITEMS": 4}),
    "no_pdl": dict(defines={"RTJAX_SORT_PDL": 0}),
    "look8": dict(defines={"RTJAX_SORT_LOOK": 8}),
    "look16": dict(defines={"RTJAX_SORT_LOOK": 16}),
    "match_any": dict(patches=[(
        "    peers[k] = peers_of(digit(key[k], pass),\n"
        "                        first + item_offset(warp, k, lane) < a.n, "
        "full);",
        "    peers[k] = __match_any_sync(0xFFFFFFFFu, first + "
        "item_offset(warp, k, lane) < a.n ? digit(key[k], pass) : 0x100u);")]),
    "no_lookback": dict(patches=[("  if (tile > 0) {\n    for (int j",
                                  "  if (false) {\n    for (int j")]),
    "no_ballots": dict(patches=[(
        "    peers[k] = peers_of(digit(key[k], pass),\n"
        "                        first + item_offset(warp, k, lane) < a.n, "
        "full);",
        "    peers[k] = 1u << lane;")]),
    "no_upsweep_work": dict(patches=[(
        "  if (!full) return;\n  launch_dependents();\n  __shared__",
        "  if (true) return;\n  launch_dependents();\n  __shared__")]),
    "upsweep_only": dict(patches=[("p < kPasses; ++p) {\n    const",
                                   "p < 0; ++p) {\n    const")]),
    "memset_only": dict(patches=[
        ("p < kPasses; ++p) {\n    const", "p < 0; ++p) {\n    const"),
        ("  upsweep_kernel<<<upsweep_blocks(n), kBlock, 0, s>>>(a);\n", "")]),
    "one_pass": dict(patches=[("p < kPasses; ++p) {\n    const",
                               "p < 1; ++p) {\n    const")]),
    "empty_passes": dict(patches=[(
        "  __syncthreads();\n  const int tile = tile_s;",
        "  __syncthreads();\n  if (total != ~0u) return;\n"
        "  const int tile = tile_s;")])}


def variant_library(name):
    """The library built with ``VARIANTS[name]`` under
    ``build/rtjax_torch/variants/``, bound."""
    import ctypes
    import shutil

    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import sort as SO
    v = VARIANTS[name]
    src = _build.SORT_SOURCE
    d = _build.BUILD_DIR / "variants"
    d.mkdir(parents=True, exist_ok=True)
    if "patches" in v:
        text = src.read_text()
        for old, new in v["patches"]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: a patch does not apply "
                                   "once to csrc/key_sort.cu")
            text = text.replace(old, new)
        src = d / f"key_sort_{name}.cu"
        src.write_text(text)
        shutil.copy(_build.SORT_HEADER, d / _build.SORT_HEADER.name)
    path = _build._build(
        d / f"libkey_sort_{name}.so", [src],
        [_build.nvcc_path()] + _build.NVCC_FLAGS
        + [f"-D{k}={val}" for k, val in v.get("defines", {}).items()],
        (_build.SORT_HEADER,))
    return SO.bind(ctypes.CDLL(str(path)))


def time_variants(keys, names, reps=5) -> dict:
    """The engine's library against each variant of ``names`` on ``keys``
    in turns (engine, variants..., variants reversed, engine): ``{name:
    {"ms": [ms, ms], "bad": mismatching lanes}}``."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    libs = {"engine": SO._kernels(),
            **{v: variant_library(v) for v in names}}
    want = torch.sort(keys, stable=True).indices
    out = {k: dict(ms=[]) for k in libs}
    try:
        for k in ("engine", *names, *names[::-1], "engine"):
            SO._lib = libs[k]
            out[k]["bad"] = int((SO.stable_order(keys) != want).sum())
            out[k]["ms"].append(C._launch_ms(lambda: SO.stable_order(keys),
                                             reps)[0])
    finally:
        SO._lib = libs["engine"]
    return out


def _torch_order(keys, cadence=None):
    """The A/B arm's sort: ``torch.sort`` in the step's place (rebound as
    ``kernels.sort.stable_order``)."""
    import torch
    return torch.sort(keys, stable=True).indices


def _frame(sc, cam, cfg, seed):
    import time

    import chip_smoke as C
    import torch
    from rtjax_torch.render.wavefront import render_frame
    gen = torch.Generator(device="cuda").manual_seed(seed)
    C._zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb, st = render_frame(sc, cam, cfg, gen)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, fb, st, C._read_counts()


def profiled_frame(sc, cam, cfg, seed) -> dict:
    """One captured frame (seed ``seed``) under torch.profiler
    (``chip_smoke._profiled_frame``, its ``device_ms`` the time at least
    one device event ran) and besides: ``sort_ms`` the time one of the
    sort's own events ran (its kernels and memset nodes), ``theirs`` the
    events of torch's sort kernels, ``theirs_ms`` their durations summed,
    ``sum_ms_per_it`` the events' durations summed an iteration."""
    import chip_smoke as C
    p = C._profiled_frame(sc, cam, cfg, seed)
    spans = p.pop("spans")
    p.pop("kernels")
    theirs = [(a, b) for a, b, n in spans if THEIRS.search(n)]
    return dict(p, sort_ms=C._union_ms(
        [s for s in spans if OURS.search(s[2]) or "emset" in s[2]]),
        theirs=len(theirs), theirs_ms=sum(b - a for a, b in theirs) / 1e6,
        sum_ms_per_it=p["summed_ms"] / max(p["iterations"], 1))


def frames(sc, cam, cfg, order=(("kernels", 2), ("torch", 2), ("torch", 3),
                                ("kernels", 3), ("kernels", 4), ("torch", 4),
                                ("torch", 5), ("kernels", 5)),
           profile=True):
    """Captured frames with the step's sort on the kernels and on
    ``torch.sort`` in turns (``order``; each arm's graph captured by a
    seed-1 frame when the arm changes), then one profiled captured frame
    an arm (seed 6, :func:`profiled_frame`): ``{"secs": {arm: [s]},
    "frames": {(arm, seed): (s, fb, stats, counts)}, "busy": {arm:
    profile}, "sort_ms": {arm: the sort's device ms in the profiled frame
    (the kernels': the time its own events ran; torch.sort's: its CUB
    kernels' durations, not its index fill)}, "theirs": the kernels arm's
    events of torch's sorts, "tally": [sorted, returned at once] over the
    kernels arm's timed frames (with the steps a chunk runs past a
    frame's end)}``."""
    import torch
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.render import graph as G
    real = SO.stable_order
    got, arm_now = {}, None
    tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    try:
        for arm, seed in order:
            SO.stable_order = real if arm == "kernels" else _torch_order
            if arm != arm_now:
                G.clear_graphs()
                _frame(sc, cam, cfg, 1)
                arm_now = arm
            before = SO.tally("cuda").clone()
            got[arm, seed] = _frame(sc, cam, cfg, seed)
            if arm == "kernels":
                tally += SO.tally("cuda") - before
        busy, sort_ms, theirs = {}, {}, 0
        for arm in ("kernels", "torch") if profile else ():
            SO.stable_order = real if arm == "kernels" else _torch_order
            G.clear_graphs()
            _frame(sc, cam, cfg, 1)
            b = busy[arm] = profiled_frame(sc, cam, cfg, 6)
            sort_ms[arm] = b["sort_ms"] if arm == "kernels" else \
                b["theirs_ms"]
            if arm == "kernels":
                theirs = b["theirs"]
    finally:
        SO.stable_order = real
        G.clear_graphs()
    secs = {arm: [f[0] for (a, _), f in got.items() if a == arm]
            for arm in ("kernels", "torch")}
    return dict(secs=secs, frames=got, busy=busy, sort_ms=sort_ms,
                theirs=theirs, tally=tally.tolist())


def frames_agree(r) -> dict:
    """Each seed's pair of :func:`frames`: equal iterations, rays and
    occupancy, equal launches but the sort's, the kernels' sort once an
    iteration in one arm and never in the other, framebuffers within
    FB_RTOL."""
    import torch
    out = {}
    for (arm, seed), kf in r["frames"].items():
        if arm != "kernels":
            continue
        tf = r["frames"]["torch", seed]
        its = kf[2]["iterations"]
        out[seed] = dict(
            same=all(kf[2][k] == tf[2][k] for k in
                     ("iterations", "rays_traced", "avg_occupancy")),
            launches={k: v for k, v in kf[3].items() if k != "sort"} ==
            {k: v for k, v in tf[3].items() if k != "sort"},
            sort=kf[3]["sort"]["key_sort"] == its
            and tf[3]["sort"]["key_sort"] == 0,
            close=torch.allclose(kf[1], tf[1], rtol=FB_RTOL, atol=FB_ATOL))
    return out


def frame_cells(scene, camera, c4_scene, c4_camera):
    """``{name: (scene, camera, cfg)}`` of the frames' cells: the
    headline, config 2, config 4 (b), the parity frame (1024^2 @ 16 spp)
    and the wide 2048^2 @ 4 spp frame."""
    import chip_smoke as C
    from rtjax_torch import RenderConfig
    cells = C._graph_cells(scene, camera, c4_scene, c4_camera)
    modes = C._mode_cells(scene, camera)
    out = {k: cells[k][:3] for k in ("headline", "config2", "config4b")}
    out["parity frame"] = modes["parity frame"]
    out["wide frame"] = modes["wide frame"]
    assert isinstance(out["wide frame"][2], RenderConfig)
    return out


def frames_text(name, r, card) -> list:
    lines = []
    for seed, ok in frames_agree(r).items():
        kf = r["frames"]["kernels", seed]
        tf = r["frames"]["torch", seed]
        lines.append(f"[sort frame {name} seed {seed}] {card}: "
                     f"{kf[2]['iterations']} iterations; kernels "
                     f"{kf[0]:.4f} s, torch.sort {tf[0]:.4f} s; agree {ok}")
    line = (f"[sort frames {name}] {card}: frame seconds kernels "
            f"{r['secs']['kernels']} vs torch.sort {r['secs']['torch']}")
    if r["busy"]:
        k_, t_ = r["busy"]["kernels"], r["busy"]["torch"]
        line += (f"; device ms an iteration (busy) "
                 f"{k_['device_ms_per_it']:.5f} vs "
                 f"{t_['device_ms_per_it']:.5f} (events summed "
                 f"{k_['sum_ms_per_it']:.5f} vs {t_['sum_ms_per_it']:.5f}), "
                 f"events an iteration "
                 f"{k_['events_per_it']:.1f} vs {t_['events_per_it']:.1f}; "
                 f"the sort's device ms a frame {r['sort_ms']['kernels']:.4f}"
                 f" vs {r['sort_ms']['torch']:.4f} ({k_['iterations']} "
                 f"iterations); torch sort events on the kernels' arm "
                 f"{r['theirs']}")
    lines.append(line + f"; kernel launches sorted / returned at once "
                 f"{r['tally']}")
    return lines


def run_frames(card="", log=print) -> dict:
    """Step 4 on every cell of :func:`frame_cells`: ``{cell: summary}``
    (frame seconds, each seed's agreement, the profiled frames' device ms
    and events an iteration, the sort's device ms a frame, torch's sort
    events on the kernels' arm, the device tally); raises where the arms'
    frames differ."""
    from rtjax_torch.scenes import cornell_bunny, instanced_bunnies
    scene, camera = cornell_bunny(device="cuda")
    c4, c4_cam = instanced_bunnies("cuda")
    out = {}
    for name, (sc, cam, cfg) in frame_cells(scene, camera, c4,
                                            c4_cam).items():
        r = frames(sc, cam, cfg)
        for line in frames_text(name, r, card):
            log(line)
        agree = frames_agree(r)
        keep = ("wall", "device_ms", "summed_ms", "events", "iterations",
                "events_per_it", "device_ms_per_it", "sum_ms_per_it")
        out[name] = dict(
            secs=r["secs"], agree=agree, sort_ms=r["sort_ms"],
            theirs=r["theirs"], tally=r["tally"],
            iterations=r["frames"]["kernels", 2][2]["iterations"],
            launches=r["frames"]["kernels", 2][3]["sort"]["key_sort"],
            busy={arm: {k: b[k] for k in keep}
                  for arm, b in r["busy"].items()})
        if not all(all(v.values()) for v in agree.values()):
            raise RuntimeError(f"{name}: the arms' frames differ")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", default="17,18,19,20",
                    help="sizes of the key sets (empty: none)")
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--out", help="where --frames saves its summary "
                    "(torch.save)")
    ap.add_argument("--variants", action="store_true",
                    help="only the variants against the engine's library")
    args = ap.parse_args()
    import subprocess

    import torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    for name, r in kernel_table().items():
        print(f"[sort kernel {name}] {card}: {r['registers']} registers, "
              f"{r['local_bytes']} local bytes, {r['block']} threads a "
              f"block, {r['warps_per_sm']} resident warps an SM")
    log2s = tuple(int(x) for x in args.log2.split(",") if x)
    if args.variants:
        for lg in log2s:
            for name in ("random31", "mostly_dead"):
                keys = torch.from_numpy(synthetic_keys(name, 1 << lg)).cuda()
                print(f"[sort variants {name} 2^{lg}] {card}: "
                      f"{time_variants(keys, tuple(VARIANTS))}")
        return
    res, skips = check_sets(log2s, card)
    bad = {k: v["bad"] for k, v in res.items() if v["bad"]}
    if bad or not skips_ok(skips):
        raise RuntimeError(f"the sort differs from torch.sort: {bad}, skip "
                           f"launches {skips}")
    if args.frames:
        summary = run_frames(card)
        if args.out:
            torch.save(summary, args.out)


if __name__ == "__main__":
    main()
