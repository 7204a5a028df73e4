#!/usr/bin/env python3
"""The step's stable key sort (kernels/sort.py, csrc/key_sort.cu) on one
CUDA card: the engine's design, the first design (``stable_order_v1``) and
``torch.sort``.

    python3 tools/sort_designs.py [--log2 17,18,19,20] [--frames [--out F]]
    python3 tools/sort_designs.py --variants [--log2 18,19]

1. prints each sort kernel's registers, spill bytes and resident warps an
   SM (the engine's upsweep, pass and if-node condition, the first
   design's upsweep and pass);
2. holds :func:`kernels.sort.stable_order` and ``stable_order_v1`` bit
   for bit against ``torch.sort(keys, stable=True).indices`` on every
   synthetic set of :data:`SETS` at each size ``2^--log2``, the engine's
   launches in turns with another size's on their persistent scratches,
   and checks that a launch on a ``sort_every`` skip iteration leaves its
   order untouched (and counts itself in the device tally as one that
   skipped);
3. times, in turns, ``torch.sort``, the engine's kernels and the first
   design's on each set (:func:`time_sort`: ``chip_smoke._launch_ms``,
   CUDA events between calls queued behind a spin kernel), with the
   bound;
   ``--variants`` instead times copies of the library built with other
   sizes, or with a part taken out, against the engine's and the first
   design's in turns;
4. ``--frames``: captured frames of the headline, config 2, config 4 (b),
   the parity frame and the wide 2048^2 frame with the step's sort on the
   engine's kernels, on the first design's and on ``torch.sort`` (the name
   ``kernels.sort.stable_order`` rebound, a graph captured for each arm),
   in turns (:func:`frames`): equal iterations, rays and occupancy,
   framebuffers within rtol 1e-5, each seed's device tally of sorting and
   skipping launches equal in both kernel arms (the if node's against the
   cadence the first design's kernels evaluate); frame seconds; a
   profiled captured frame an arm with device events and ms an iteration,
   the sort's device ms a frame, the sort kernels, condition kernels and
   memset nodes it ran against the tally of its launches (no pass and no
   memset on a skip under the if node), and no CUB or torch sort kernel
   on the kernel arms.

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
# the kernels the profiler names: the engine's sorting kernels and its if
# node's condition, the first design's kernels, and the sorts of torch
# (CUB's radix sort, torch's small-segment sorts)
PASSES = re.compile(r"sort_upsweep|sort_pass")
CONDITION = re.compile(r"cadence_condition")
PASSES_V1 = re.compile(r"upsweep_kernel|pass_kernel")
OURS = re.compile(r"sort_upsweep|sort_pass|cadence_condition|"
                  r"upsweep_kernel|pass_kernel")
THEIRS = re.compile(r"RadixSort|radix_sort|sortKeyValue|bitonic|segmented",
                    re.I)
# the frames' arms: the step's sort as ``kernels.sort.stable_order`` on the
# engine's kernels, the first design's and torch.sort
ARMS = ("kernels", "v1", "torch")


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


def check(keys) -> dict:
    """Lanes of each design's order that differ from ``torch.sort(keys,
    stable=True).indices``: ``{"kernels": n, "v1": n}``."""
    import torch
    from rtjax_torch.kernels import sort as SO
    want = torch.sort(keys, stable=True).indices
    return dict(kernels=int((SO.stable_order(keys) != want).sum()),
                v1=int((SO.stable_order_v1(keys) != want).sum()))


def check_interleaved(log2s, seed=0) -> int:
    """The engine's launches at two sizes in turns, each on its persistent
    scratch, three rounds of new keys: lanes that differ from torch.sort
    over all of them."""
    import torch
    from rtjax_torch.kernels import sort as SO
    bad = 0
    for r, name in enumerate(("random_int32", "mostly_dead", "two_keys")):
        for lg in log2s:
            keys = torch.from_numpy(synthetic_keys(name, 1 << lg,
                                                   seed + r)).cuda()
            bad += int((SO.stable_order(keys) !=
                        torch.sort(keys, stable=True).indices).sum())
    return bad


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
    """In turns (torch.sort, kernels, v1, v1, kernels, torch.sort), each
    the device ms of a call (``chip_smoke._launch_ms``, the mean of
    ``reps`` calls queued behind a spin): ``{"torch": [ms, ms], "kernels":
    [ms, ms], "v1": [ms, ms], "mean": {...}, "one_call_ms": a wrapper call
    in CUDA events (host launch included), "plain_ms": a plain-version
    call likewise, "bound": sort_bound}``."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    fns = {"torch": lambda: torch.sort(keys, stable=True),
           "kernels": lambda: SO.stable_order(keys),
           "v1": lambda: SO.stable_order_v1(keys)}
    out = {k: [] for k in fns}
    for k in ("torch", "kernels", "v1", "v1", "kernels", "torch"):
        out[k].append(C._launch_ms(fns[k], reps)[0])
    out["mean"] = {k: statistics.mean(v) for k, v in list(out.items())}
    out["one_call_ms"] = C._median_ms(lambda: SO.stable_order(keys))
    out["plain_ms"] = C._median_ms(lambda: SO.stable_order_ref(keys))
    out["bound"] = sort_bound(keys.shape[0])
    return out


def time_text(label, t, card) -> str:
    m, b = t["mean"], t["bound"]
    return (f"[sort time {label}] {card}: kernels {m['kernels']:.4f} ms, "
            f"the first design's {m['v1']:.4f} ms, torch.sort "
            f"{m['torch']:.4f} ms a call"
            f" (in turns {t['kernels']} / {t['v1']} / {t['torch']}); bound "
            f"{b['bound_us']:.3f} us "
            f"({100 * b['bound_ms'] / m['kernels']:.2f}% of it); one call "
            f"{t['one_call_ms']:.4f} ms, plain version {t['plain_ms']:.4f} ms")


def check_sets(log2s=(17, 18, 19, 20), card="", seed=0, log=print):
    """Steps 2-3 on every set of :data:`SETS` at each size: ``({(set,
    log2): {"bad": check(), "time": time_sort()}}, {log2:
    check_skip()})``; the sets' ``("interleaved", 0)`` entry holds
    :func:`check_interleaved`'s mismatches over the sizes."""
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
    if log2s:
        bad = check_interleaved(log2s[:2], seed)
        res["interleaved", 0] = dict(bad=dict(kernels=bad, v1=0))
        log(f"[sort interleaved 2^{log2s[:2]}] {card}: mismatching lanes "
            f"{bad}")
    return res, skips


def sets_bad(res) -> dict:
    """The mismatching lanes of :func:`check_sets`' entries that have
    any."""
    return {f"{k[0]} 2^{k[1]}": v["bad"] for k, v in res.items()
            if any(v["bad"].values())}


def skips_ok(skips) -> bool:
    return all(s["untouched"] and s["sorts"] and s["tally"] == [1, 2]
               for s in skips.values())


# --variants: copies of the library built with other settings
# (csrc/key_sort.cuh's macros) or with a part taken out for timing only
# (source patches, ``(old, new)`` each, applied to the first occurrence,
# which is the engine's kernel; such a copy's order is wrong, and the
# engine's time less its time is what the part costs): 4 or 8 keys a
# thread in the upsweep; the passes in plain stream order; taken out: the
# look-back, the ballots (each key its own peer group, the scatter's
# writes held inside the arrays), every pass (the upsweep alone), all
# passes but the first, every pass's work after its ticket and its wait
_IN_BOUNDS = (
    "    const long long dst = base[digit(v.x, pass)] + j;\n    if (last)",
    "    long long dst = base[digit(v.x, pass)] + j;\n"
    "    dst = dst < 0 ? 0 : (dst < a.n ? dst : a.n - 1);\n    if (last)")
VARIANTS = {
    "up4": dict(defines={"RTJAX_SORT_UP_ITEMS": 4}),
    "up8": dict(defines={"RTJAX_SORT_UP_ITEMS": 8}),
    "no_pdl": dict(defines={"RTJAX_SORT_PDL": 0}),
    "no_lookback": dict(patches=[("  if (tile > 0) {\n    for (int j",
                                  "  if (false) {\n    for (int j")]),
    "no_ballots": dict(patches=[(
        "    peers[k] = peers_of(digit(key[k], pass),\n"
        "                        first + item_offset(warp, k, lane) < a.n, "
        "full);",
        "    peers[k] = 1u << lane;"), _IN_BOUNDS]),
    "upsweep_only": dict(patches=[(
        "  e = launch_passes(sort_pass, a, num_tiles(n), s);",
        "  e = cudaSuccess;")]),
    "one_pass": dict(patches=[("p < kPasses; ++p) {\n    const",
                               "p < 1; ++p) {\n    const")]),
    "empty_passes": dict(patches=[(
        "  if (pass > 0) wait_for_previous();\n  const unsigned parity",
        "  if (pass > 0) wait_for_previous();\n  if (a.n > 0) return;\n"
        "  const unsigned parity")])}


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
            if old not in text:
                raise RuntimeError(f"variant {name}: a patch does not apply "
                                   "to csrc/key_sort.cu")
            text = text.replace(old, new, 1)
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
    """The engine's library and the first design against each variant of
    ``names`` on ``keys`` in turns (engine, v1, variants..., variants
    reversed, v1, engine), each library on persistent scratches of its own
    (a layout and tickets of its own): ``{name: {"ms": [ms, ms], "bad":
    mismatching lanes}}``."""
    import chip_smoke as C
    import torch
    from rtjax_torch.kernels import sort as SO
    libs = {"engine": SO._kernels(),
            **{v: variant_library(v) for v in names}}
    spaces = {k: {} for k in libs}
    engine_spaces = SO._scratches
    spaces["engine"] = engine_spaces
    want = torch.sort(keys, stable=True).indices
    out = {k: dict(ms=[]) for k in (*libs, "v1")}
    try:
        for k in ("engine", "v1", *names, *names[::-1], "v1", "engine"):
            SO._lib = libs.get(k, libs["engine"])
            SO._scratches = spaces.get(k, engine_spaces)
            fn = (lambda: SO.stable_order_v1(keys)) if k == "v1" else \
                (lambda: SO.stable_order(keys))
            out[k]["bad"] = int((fn() != want).sum())
            out[k]["ms"].append(C._launch_ms(fn, reps)[0])
    finally:
        SO._lib, SO._scratches = libs["engine"], engine_spaces
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


def profiled_frame(sc, cam, cfg, seed, arm="kernels") -> dict:
    """One captured frame (seed ``seed``) under torch.profiler
    (``chip_smoke._profiled_frame``, its ``device_ms`` the time at least
    one device event ran) and besides: ``sort_ms`` the time one of the
    sort's own events ran (its kernels, and on the ``v1`` arm its memset
    nodes), ``theirs`` the events of torch's sort kernels, ``theirs_ms``
    their durations summed, ``sum_ms_per_it`` the events' durations summed
    an iteration; ``tally`` the device tally's [sorted, skipped] over the
    frame, ``passes`` / ``passes_v1`` the events of the engine's / the
    first design's upsweep and pass kernels, ``conditions`` those of the
    if node's condition kernel, ``memsets`` the memset events."""
    import chip_smoke as C
    from rtjax_torch.kernels import sort as SO
    before = SO.tally("cuda").clone()
    p = C._profiled_frame(sc, cam, cfg, seed)
    tally = (SO.tally("cuda") - before).tolist()
    spans = p.pop("spans")
    p.pop("kernels")
    theirs = [(a, b) for a, b, n in spans if THEIRS.search(n)]
    count = lambda rx: sum(1 for *_, n in spans if rx.search(n))
    memset = lambda n: "emset" in n
    return dict(p, sort_ms=C._union_ms(
        [s for s in spans if OURS.search(s[2])
         or (arm == "v1" and memset(s[2]))]),
        theirs=len(theirs), theirs_ms=sum(b - a for a, b in theirs) / 1e6,
        sum_ms_per_it=p["summed_ms"] / max(p["iterations"], 1),
        tally=tally, passes=count(PASSES), passes_v1=count(PASSES_V1),
        conditions=count(CONDITION),
        memsets=sum(1 for *_, n in spans if memset(n)))


FRAME_ORDER = (("kernels", 2), ("v1", 2), ("torch", 2), ("torch", 3),
               ("v1", 3), ("kernels", 3))


def frames(sc, cam, cfg, order=FRAME_ORDER, profile=True):
    """Captured frames with the step's sort on the engine's kernels, PR
    20's and ``torch.sort`` in turns (``order``; each arm's graph
    captured by a seed-1 frame when the arm changes), then one profiled
    captured frame an arm (seed 6, :func:`profiled_frame`): ``{"secs":
    {arm: [s]}, "frames": {(arm, seed): (s, fb, stats, counts)},
    "tallies": {(arm, seed): the device tally's [sorted, skipped] over the
    frame (with the steps a chunk runs past its end)}, "busy": {arm:
    profile}, "sort_ms": {arm: the sort's device ms in the profiled frame
    (torch.sort's: its CUB kernels' durations, not its index fill)},
    "cadence": sort_every above 1}``."""
    import torch
    from rtjax_torch.kernels import sort as SO
    from rtjax_torch.render import graph as G
    from rtjax_torch.render import wavefront as WF
    real = {"kernels": SO.stable_order, "v1": SO.stable_order_v1,
            "torch": _torch_order}
    got, tallies, arm_now = {}, {}, None
    try:
        for arm, seed in order:
            SO.stable_order = real[arm]
            if arm != arm_now:
                G.clear_graphs()
                _frame(sc, cam, cfg, 1)
                arm_now = arm
            before = SO.tally("cuda").clone()
            got[arm, seed] = _frame(sc, cam, cfg, seed)
            tallies[arm, seed] = (SO.tally("cuda") - before).tolist()
        busy = {}
        for arm in ARMS if profile else ():
            SO.stable_order = real[arm]
            G.clear_graphs()
            _frame(sc, cam, cfg, 1)
            busy[arm] = profiled_frame(sc, cam, cfg, 6, arm)
    finally:
        SO.stable_order = real["kernels"]
        G.clear_graphs()
    arms = dict.fromkeys(a for a, _ in order)
    secs = {arm: [f[0] for (a, _), f in got.items() if a == arm]
            for arm in arms}
    sort_ms = {arm: b["theirs_ms"] if arm == "torch" else b["sort_ms"]
               for arm, b in busy.items()}
    return dict(secs=secs, frames=got, tallies=tallies, busy=busy,
                sort_ms=sort_ms,
                cadence=WF.resolve_sort_every(sc, cfg) > 1)


def if_node_check(r) -> dict:
    """The profiled frames' sort events against their tallies: on the
    engine's arm five kernels (upsweep and passes) a sorting launch and
    none on a skip, one condition kernel a launch under a cadence (none
    without), no memset node of the sort (its memsets the first design's
    arm's less one a launch of it), none of the first design's kernels;
    the first design's five kernels on every launch of its arm, skips too;
    no torch sort kernel on either kernel arm."""
    k, v = r["busy"]["kernels"], r["busy"]["v1"]
    launches_v1 = sum(v["tally"])
    return dict(
        passes=k["passes"] == 5 * k["tally"][0] and k["passes_v1"] == 0,
        conditions=k["conditions"] == (sum(k["tally"]) if r["cadence"]
                                       else 0),
        memsets=k["memsets"] == v["memsets"] - launches_v1,
        v1=v["passes_v1"] == 5 * launches_v1 and v["passes"] == 0,
        theirs=k["theirs"] == 0 and v["theirs"] == 0)


def frames_agree(r) -> dict:
    """Each seed's frames of :func:`frames`, each kernel arm against the
    torch.sort arm's: equal iterations, rays and occupancy, equal
    launches but the sort's, the arm's sort once an iteration and the
    other design never (none on torch.sort's arm), framebuffers within
    FB_RTOL; on the engine's arm the tally of sorting and skipping
    launches equal to the first design's arm's, whose kernels evaluate the
    cadence themselves."""
    import torch
    out = {}
    for (arm, seed), kf in r["frames"].items():
        if arm == "torch":
            continue
        tf = r["frames"]["torch", seed]
        its = kf[2]["iterations"]
        mine, other = ("key_sort", "key_sort_v1") if arm == "kernels" \
            else ("key_sort_v1", "key_sort")
        out[arm, seed] = dict(
            same=all(kf[2][k] == tf[2][k] for k in
                     ("iterations", "rays_traced", "avg_occupancy")),
            launches={k: v for k, v in kf[3].items() if k != "sort"} ==
            {k: v for k, v in tf[3].items() if k != "sort"},
            sort=kf[3]["sort"][mine] == its and kf[3]["sort"][other] == 0
            and not any(tf[3]["sort"].values()),
            close=torch.allclose(kf[1], tf[1], rtol=FB_RTOL, atol=FB_ATOL))
        if arm == "kernels" and ("v1", seed) in r["tallies"]:
            out[arm, seed]["tally"] = (r["tallies"]["kernels", seed]
                                       == r["tallies"]["v1", seed])
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
    for (arm, seed), ok in frames_agree(r).items():
        kf = r["frames"][arm, seed]
        tf = r["frames"]["torch", seed]
        lines.append(f"[sort frame {name} {arm} seed {seed}] {card}: "
                     f"{kf[2]['iterations']} iterations; {arm} "
                     f"{kf[0]:.4f} s, torch.sort {tf[0]:.4f} s; tally "
                     f"{r['tallies'][arm, seed]}; agree {ok}")
    line = (f"[sort frames {name}] {card}: frame seconds " + ", ".join(
        f"{arm} {v}" for arm, v in r["secs"].items()))
    if r["busy"]:
        b = r["busy"]
        line += ("; device ms an iteration (busy) " + " / ".join(
            f"{arm} {b[arm]['device_ms_per_it']:.5f}" for arm in b)
            + " (events summed " + " / ".join(
                f"{b[arm]['sum_ms_per_it']:.5f}" for arm in b)
            + "), events an iteration " + " / ".join(
                f"{b[arm]['events_per_it']:.1f}" for arm in b)
            + "; the sort's device ms a frame " + " / ".join(
                f"{arm} {r['sort_ms'][arm]:.4f}" for arm in b)
            + f" ({b['kernels']['iterations']} iterations); profiled "
            "tallies " + " / ".join(f"{b[arm]['tally']}" for arm in b)
            + "; engine's sort kernels / conditions / memsets "
            f"{b['kernels']['passes']} / {b['kernels']['conditions']} / "
            f"{b['kernels']['memsets']}, the first design's kernels / memsets "
            f"{b['v1']['passes_v1']} / {b['v1']['memsets']}; "
            f"checks {if_node_check(r)}")
    lines.append(line)
    return lines


def run_frames(card="", log=print) -> dict:
    """Step 4 on every cell of :func:`frame_cells`: ``{cell: summary}``
    (frame seconds, each seed's agreement, the profiled frames' device ms
    and events an iteration, the sort's device ms a frame, the tallies and
    the if node's checks); raises where the arms' frames differ or a
    check fails."""
    from rtjax_torch.scenes import cornell_bunny, instanced_bunnies
    scene, camera = cornell_bunny(device="cuda")
    c4, c4_cam = instanced_bunnies("cuda")
    out = {}
    for name, (sc, cam, cfg) in frame_cells(scene, camera, c4,
                                            c4_cam).items():
        r = frames(sc, cam, cfg)
        for line in frames_text(name, r, card):
            log(line)
        agree, checks = frames_agree(r), if_node_check(r)
        keep = ("wall", "device_ms", "summed_ms", "events", "iterations",
                "events_per_it", "device_ms_per_it", "sum_ms_per_it",
                "tally", "passes", "passes_v1", "conditions", "memsets")
        first = r["frames"][FRAME_ORDER[0]]
        out[name] = dict(
            secs=r["secs"], agree=agree, checks=checks,
            sort_ms=r["sort_ms"], cadence=r["cadence"],
            tallies={f"{a} {s}": t for (a, s), t in r["tallies"].items()},
            iterations=first[2]["iterations"],
            launches=first[3]["sort"]["key_sort"],
            busy={arm: {k: b[k] for k in keep}
                  for arm, b in r["busy"].items()})
        if not all(all(v.values()) for v in agree.values()) or \
                not all(checks.values()):
            raise RuntimeError(f"{name}: the arms' frames differ, or the "
                               f"sort's events do not match its tally: "
                               f"{agree} {checks}")
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
    bad = sets_bad(res)
    if bad or not skips_ok(skips):
        raise RuntimeError(f"the sort differs from torch.sort: {bad}, skip "
                           f"launches {skips}")
    if args.frames:
        summary = run_frames(card)
        if args.out:
            torch.save(summary, args.out)


if __name__ == "__main__":
    main()
