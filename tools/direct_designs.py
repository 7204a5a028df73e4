#!/usr/bin/env python3
"""The direct pair's designs on one CUDA card.

    python3 tools/direct_designs.py [--variants [NAME,NAME]]
    python3 tools/direct_designs.py --frames [--out FILE]

The direct kernels (kernels/direct.py, csrc/direct_traverse.cu): closest
hit runs one design, the first (one thread a ray, the triangles staged in
shared memory 64 at a time, every test in full); any hit runs in two arms:

- ``engine``, the engine's: each block compacts the live lanes of a window
  of ``kPerThread * kBlock`` lanes and runs the triangle loop over the
  dense list, over 48-byte triangle records in shared memory, rejecting on
  t first;
- ``v1``: its first design (closest hit's structure, with an early exit).

On eval config 2 (``cornell_planes``, 12 triangles, 512^2 @ 64 spp, 10
bounces, pool 2^19) it

1. prints ptxas's line and the SASS counts of each kernel (:func:`sass`:
   ``cuobjdump -sass``; instructions, shared-memory, constant-bank and
   local loads, and the instructions and loads a test);
2. keeps an eager frame's first closest-hit launch and second any-hit
   launch (:func:`config2_rays`), holds every design bit for bit against
   the plain versions on them and times them, any hit's two arms in turns
   (:func:`time_rays`: the launch as it is, with every lane inactive --
   the fixed floor -- and with every lane active), with the SIMT
   efficiency of the lanes in order and compacted (:func:`simt`);
3. with ``--variants``, builds copies of the library with a part of any
   hit's design undone (``VARIANTS``, all builds together), holds each
   bit for bit and times it against the engine's in turns on step 2's
   any-hit launch and on chip_smoke's 64-triangle soup's shadow rays,
   then profiles a captured frame on each, forward and back
   (:func:`variants`);
4. with ``--frames``, renders captured frames of config 2 and config 4 (a)
   (``instanced_bunnies``, repass over its 3-triangle base) in turns,
   engine, v1, v1, engine (:func:`use` rebinds the any-hit launcher and
   clears the graph cache), then profiles one captured frame an arm
   (torch.profiler, CUDA activity): device ms an iteration and the summed
   device time of the direct pair, ``torch.sort``, the step kernels and
   the rest (:func:`frames`).  ``--out`` saves its numbers
   (``torch.save``).

``chip_smoke.py``'s phase 12 calls steps 1-2 in process and step 4 as
``python3 tools/direct_designs.py --frames --out ...`` in a process of its
own (torch.profiler in a long process has dropped kernel records).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# captured frames of each cell in turns: (arm, seed)
FRAME_ORDER = (("engine", 2), ("v1", 2), ("v1", 3), ("engine", 3))
PROFILE_SEED = 5
# the profiled frames' kernel groups, by a pattern of the kernel's name
GROUPS = (("direct closest",
           r"closest_kernel(\((\(anonymous namespace\)::)?|ENS_4)Tris"),
          ("direct anyhit",
           r"anyhit_kernel(_v1)?(\((\(anonymous namespace\)::)?|ENS_4)Tris"),
          ("sort", r"(?i)sort"),
          ("route", r"route(_v1)?_kernel"),
          ("shade", r"shade(_v1)?_kernel"),
          ("resolve", r"resolve_kernel"))
# any hit's arms
ARMS = ("engine", "v1")


def arms():
    """``{arm: any-hit launcher}`` of kernels/direct.py (the engine's
    saved at the first call)."""
    from rtjax_torch.kernels import direct as D
    global _ARMS
    if "_ARMS" not in globals():
        _ARMS = {"engine": D._anyhit_cuda, "v1": D._anyhit_cuda_v1}
    return _ARMS


def use(arm):
    """Make ``arm`` the any-hit design the wrapper launches, and drop the
    cached step graph (it holds the other design's launches)."""
    from rtjax_torch.kernels import direct as D
    from rtjax_torch.render import graph
    D._anyhit_cuda = arms()[arm]
    graph.clear_graphs()


# ------------------------------------------------------------- 1. the SASS

def _functions(text):
    """``{mangled name: [(address, instruction text)]}`` of cuobjdump's
    ``-sass`` listing."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m[1], [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            cur.append((int(m[1], 16), m[2].strip()))
    return out


def _opcode(ins):
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def sass(lib):
    """Per kernel of the library: ``{"instructions", "lds", "ldc", "ldl",
    "stl", "float_ops", "rcp", "per_test", "lds_per_test",
    "ldc_per_test"}``.  A test is counted by its reciprocal (one
    ``MUFU.RCP`` a test, outside the division's slow-path subroutine,
    which starts at the lowest ``CALL`` target): where a loop (the
    shortest backward branch around reciprocals) holds the tests, its
    length over the reciprocals in it; in straight-line code, the median
    gap between consecutive reciprocals."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    report = {}
    for name, code in _functions(text).items():
        ops = [_opcode(i) for _, i in code if _opcode(i) != "NOP"]
        calls = [int(m[1], 16) for _, i in code
                 for m in [re.search(r"CALL\.\S+\s+0x([0-9a-f]+)", i)] if m]
        end = min(calls, default=code[-1][0] + 16 if code else 0)
        rcp = [a for a, i in code if "MUFU.RCP" in i and a < end]
        count = lambda pre: sum(o.startswith(pre) for o in ops)
        rec = dict(instructions=len(ops), lds=count("LDS"), ldc=count("LDC")
                   + count("ULDC"), ldl=count("LDL"), stl=count("STL"),
                   float_ops=sum(o.split(".")[0] in ("FADD", "FMUL", "FFMA",
                                                     "FSETP") for o in ops),
                   rcp=len(rcp))
        loops = []
        for a, i in code:
            m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", i)
            if m and int(m[1], 16) < a and any(
                    int(m[1], 16) <= r <= a for r in rcp):
                loops.append((int(m[1], 16), a))
        if loops:
            lo, hi = min(loops, key=lambda ta: ta[1] - ta[0])
            tests = sum(lo <= r <= hi for r in rcp)
            rec["per_test"] = ((hi - lo) // 16 + 1) / tests
        elif len(rcp) > 2:
            lo, hi = rcp[0], rcp[-1] - 16
            tests = len(rcp) - 1
            rec["per_test"] = statistics.median(
                (b - a) // 16 for a, b in zip(rcp, rcp[1:]))
        else:
            lo, hi, tests = 0, -1, 1
            rec["per_test"] = None
        inside = [_opcode(i) for a, i in code if lo <= a <= hi]
        rec["lds_per_test"] = sum(o.startswith("LDS") for o in inside) / tests
        rec["ldc_per_test"] = sum(o.startswith(("LDC", "ULDC"))
                                  for o in inside) / tests
        report[name] = rec
    return report


def sass_text(name, r):
    return (f"{r['instructions']} instructions, {r['lds']} LDS, {r['ldc']} "
            f"LDC/ULDC, {r['ldl']} LDL, {r['stl']} STL, {r['float_ops']} "
            f"FADD/FMUL/FFMA/FSETP, {r['rcp']} reciprocals; ~"
            f"{r['per_test']} instructions a test, "
            f"{r['lds_per_test']:.1f} LDS and {r['ldc_per_test']:.1f} "
            f"LDC/ULDC a test")


# ------------------------------------------------------ 2. config 2's rays

def config2():
    """Eval config 2's scene, camera and config."""
    import chip_smoke as C
    from rtjax_torch import RenderConfig
    from rtjax_torch.scenes import cornell_planes
    scene, camera = cornell_planes("cuda")
    return scene, camera, RenderConfig(
        width=C.C2_SIZE, height=C.C2_SIZE, num_samples=C.C2_SPP,
        max_bounces=C.C2_BOUNCES)


def config2_rays(scene, camera, cfg, seed=2):
    """An eager config-2 frame's first closest-hit launch (the pool's
    camera rays) and second any-hit launch (their shadow rays):
    ``(closest rays, any-hit rays)`` as chip_smoke's ``_capture_launch``
    keeps them."""
    import chip_smoke as C
    captured, restore_c = C._capture_launch(
        1, {"closest": C.DIRECT_NAMES["closest"]})
    shadow, restore_a = C._capture_launch(
        2, {"anyhit": C.DIRECT_NAMES["anyhit"]})
    try:
        C._drive_eager(scene, camera, cfg, (seed,))
    finally:
        restore_c()
        restore_a()
    return captured["closest"][1], shadow["anyhit"][1]


def tests_per_lane(tris, rays, kind):
    """The triangle tests each lane needs: every triangle for an active
    closest-hit lane; for an any-hit lane the triangles up to its first
    occluder (all when none occludes it); 0 for an inactive lane."""
    import torch
    from rtjax_torch.core.geometry import intersect_triangle_v3
    active = rays["active"]
    if kind == "closest":
        return active.to(torch.int32) * tris.num
    live = active.clone()
    tests = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    for k in range(tris.num):
        tests += live.to(torch.int32)
        row = lambda a: (a[k, 0], a[k, 1], a[k, 2])
        h, _, _, _ = intersect_triangle_v3(rays["o"], rays["d"], rays["tmax"],
                                           row(tris.p0), row(tris.e1),
                                           row(tris.e2), row(tris.n))
        live &= ~(h & (rays["exclude"] != k))
    return tests


def window_lanes():
    """The any-hit kernel's window, ``kPerThread * kBlock`` of
    csrc/direct_traverse.cu."""
    from rtjax_torch.kernels import _build
    src = _build.DIRECT_SOURCE.read_text()
    per, block = (int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
                  for k in ("kPerThread", "kBlock"))
    return per * block


def simt(tests, active, window=None):
    """``{"in_order", "compacted"}``: the tests the lanes need over 32 x
    the sum, over warps, of the most tests a lane of that warp needs.  In
    order (closest hit, any hit's first design): warps of 32 consecutive
    lanes.  Compacted (any hit): each window's live lanes in order, a warp
    taking 32 consecutive of them (a thread takes dense indices tid, tid +
    kBlock, ...: warp w of round r the 32 from r * kBlock + 32 w)."""
    import torch
    window = window or window_lanes()
    n = tests.numel()
    need = float(tests.sum())
    if need == 0:
        return dict(in_order=None, compacted=None)
    lane = torch.arange(n, device=tests.device)
    warps = torch.zeros((n + 31) // 32, dtype=torch.int32,
                        device=tests.device)
    warps.scatter_reduce_(0, lane // 32, tests, "amax")
    a = active.to(torch.int64)
    win = lane // window
    first = torch.zeros(int(win.max()) + 2, dtype=torch.int64,
                        device=tests.device)
    first.index_add_(0, win + 1, a)
    rank = torch.cumsum(a, 0) - 1 - torch.cumsum(first, 0)[win]
    chunk = win * (window // 32) + rank.clamp(min=0) // 32
    dense = torch.zeros(int(chunk.max()) + 1, dtype=torch.int32,
                        device=tests.device)
    dense.scatter_reduce_(0, chunk[active], tests[active], "amax")
    return dict(in_order=need / (32 * float(warps.sum())),
                compacted=need / (32 * float(dense.sum())))


def arms_of(kind):
    """The designs timed for ``kind``: closest hit has one."""
    return ("engine",) if kind == "closest" else ARMS


def _call(kind, arm, tris, rays):
    from rtjax_torch.kernels import direct as D
    if kind == "closest":
        return D.direct_closest(tris, rays["o"], rays["d"], rays["tmax"],
                                rays["active"])
    fn = D.direct_anyhit if arm == "engine" else D.direct_anyhit_v1
    return fn(tris, rays["o"], rays["d"], rays["tmax"], rays["exclude"],
              rays["active"])


def _bits(out):
    import torch
    if not isinstance(out, tuple):
        return out.to(torch.int32)[None]
    return torch.stack([c.view(torch.int32) if c.is_floating_point()
                        else c.to(torch.int32) for c in (*out[:3], *out[3])])


def equal_plain(kind, tris, rays):
    """Lanes of each design of ``kind`` whose outputs differ from the
    plain version's in any bit: ``{arm: n}``."""
    from rtjax_torch.kernels import direct as D
    if kind == "closest":
        want = D.direct_closest_ref(tris, rays["o"], rays["d"], rays["tmax"],
                                    rays["active"])
    else:
        want = D.direct_anyhit_ref(tris, rays["o"], rays["d"], rays["tmax"],
                                   rays["exclude"], rays["active"])
    want = _bits(want)
    return {arm: int((_bits(_call(kind, arm, tris, rays)) != want).any(0)
                     .sum()) for arm in arms_of(kind)}


def time_rays(kind, tris, rays):
    """Device ms a launch of each design of ``kind`` (chip_smoke
    ``_launch_ms``; any hit's arms in turns engine, v1, v1, engine) on
    ``rays`` as they are (``as_is``), with every lane inactive (``floor``)
    and every lane active (``all``): ``{mask: {arm: [ms, ms]}}``."""
    import torch
    import chip_smoke as C
    order = ("engine", "engine") if kind == "closest" else \
        ("engine", "v1", "v1", "engine")
    out = {}
    for mask in ("as_is", "floor", "all"):
        r = dict(rays)
        if mask != "as_is":
            r["active"] = torch.full_like(rays["active"], mask == "all")
        out[mask] = {arm: [] for arm in arms_of(kind)}
        for arm in order:
            out[mask][arm].append(C._launch_ms(
                lambda: _call(kind, arm, tris, r))[0])
    return out


def check_rays(label, kind, tris, rays, card=""):
    """Step 2's line for one launch: mismatches, times, SIMT efficiency;
    returns the numbers."""
    mis = equal_plain(kind, tris, rays)
    tests = tests_per_lane(tris, rays, kind)
    eff = simt(tests, rays["active"])
    ms = time_rays(kind, tris, rays)
    n, n_act = rays["active"].numel(), int(rays["active"].sum())
    mean = {m: {a: statistics.mean(v) for a, v in by.items()}
            for m, by in ms.items()}
    times = "; ".join(f"{m} " + ", ".join(f"{a} {v}" for a, v in by.items())
                      for m, by in ms.items())
    print(f"[{label} direct {kind} designs] {card}: {n} rays ({n_act} "
          f"active) x {tris.num} triangles, {int(tests.sum())} tests; "
          f"mismatching lanes vs plain {mis}; device ms a launch: {times}; "
          f"SIMT efficiency lanes in order {_pct(eff['in_order'])}, "
          f"compacted {_pct(eff['compacted'])}")
    return dict(mismatches=mis, ms=ms, mean=mean, simt=eff,
                tests=int(tests.sum()), n=n, n_active=n_act)


def _pct(x):
    return "n/a" if x is None else f"{100 * x:.2f}%"


# -------------------------------------------------------------- 3. frames

def _group(name):
    for label, pat in GROUPS:
        if re.search(pat, name):
            return label
    return "other"


def _profiled(sc, cam, cfg):
    """One captured frame (seed PROFILE_SEED) under torch.profiler
    (``chip_smoke._profiled_frame``): ``{"wall", "device_ms", "events",
    "iterations", "groups": {label: [ms, launches]}}``."""
    import chip_smoke as C
    p = C._profiled_frame(sc, cam, cfg, PROFILE_SEED)
    del p["spans"]
    groups = {label: [0.0, 0] for label, _ in GROUPS + (("other", ""),)}
    for name, (ms, count) in p.pop("kernels").items():
        g = groups[_group(name)]
        g[0] += ms
        g[1] += count
    return dict(p, groups=groups, ms_per_iteration=p["device_ms_per_it"])


def frames(cells, card=""):
    """Step 4 over ``cells`` (``{name: (scene, camera, cfg, size)}``):
    per cell and arm the frame seconds in FRAME_ORDER, rays traced, the
    launches, the image gap to the other arm's frame of the same seed,
    and the profiled frame."""
    import numpy as np
    import chip_smoke as C
    res = {}
    for name, (sc, cam, cfg, size) in cells.items():
        for arm in ARMS:                        # capture each arm's graph
            use(arm)
            C._graph_frame(sc, cam, cfg, 1, "graph")
        runs = {}
        for arm, seed in FRAME_ORDER:
            use(arm)
            secs, fb, st, _, counts = C._graph_frame(sc, cam, cfg, seed,
                                                     "graph")
            runs[arm, seed] = (secs, C._square_u8(fb, size), st, counts)
        img = lambda a, s: runs[a, s][1]
        seed_mse = float(np.mean((img("engine", 2) - img("engine", 3))
                                 ** 2))
        arm_mse = [float(np.mean((img("engine", s) - img("v1", s)) ** 2))
                   for s in (2, 3)]
        rays = {k: runs[k][2]["rays_traced"] for k in runs}
        prof = {}
        for arm in ARMS:
            use(arm)
            prof[arm] = _profiled(sc, cam, cfg)
        use("engine")
        res[name] = dict(
            secs={a: [runs[a, s][0] for a2, s in FRAME_ORDER if a2 == a]
                  for a in ARMS},
            rays=rays, seed_mse=seed_mse, arm_mse=arm_mse,
            launches={a: (runs[a, 2][3]["direct"], runs[a, 2][3]
                          ["direct_v1"]) for a in ARMS},
            iterations=runs["engine", 2][2]["iterations"], profile=prof)
        r = res[name]
        print(f"[direct frames {name}] {card}: {r['iterations']} iterations;"
              f" frame seconds engine {r['secs']['engine']}, any hit's first"
              f" design {r['secs']['v1']}; rays traced "
              f"{sorted(set(rays.values()))}; launches (direct, direct_v1) "
              f"{r['launches']}; image MSE engine vs v1 at seeds 2 / 3 "
              f"{arm_mse[0]:.3e} / {arm_mse[1]:.3e}, seed-to-seed "
              f"{seed_mse:.3e}")
        for arm, p in prof.items():
            pair = sum(p["groups"][g][0] for g in ("direct closest",
                                                   "direct anyhit"))
            print(f"[direct profile {name} {arm}] {card}: {p['wall']:.4f} s,"
                  f" device {p['device_ms']:.3f} ms in {p['events']} events,"
                  f" {p['ms_per_iteration']:.4f} ms an iteration; the pair "
                  f"{pair:.3f} ms ({100 * pair / p['device_ms']:.2f}%); "
                  + ", ".join(f"{g} {v[0]:.3f} ms / {v[1]}"
                              for g, v in p["groups"].items()))
    return res


def frame_cells():
    """Config 2 and config 4 (a) as chip_smoke's phase 13 renders them."""
    import chip_smoke as C
    from rtjax_torch import RenderConfig
    from rtjax_torch.scenes import instanced_bunnies
    planes, planes_cam, cfg2 = config2()
    c4, c4_cam = instanced_bunnies("cuda")
    return {"config2": (planes, planes_cam, cfg2, C.C2_SIZE),
            "config4a": (c4, c4_cam, RenderConfig(
                width=C.WIDTH, height=C.HEIGHT, num_samples=C.C4_SPP,
                max_bounces=C.C4_BOUNCES), C.WIDTH)}


# ------------------------------------------------------------ 3. variants

_T_FIRST = """  if (!((t > 0.0f) & (t <= r.tmax))) return false;
"""
_NO_COMPACTION = ("""  const int total = compact(w, rays.active, n, blockIdx.x * kWindow,
                            [&](int i) { occ_out[i] = 0; });
  for (int round = 0; round * kBlock < total; ++round) {
    const int idx = round * kBlock + threadIdx.x;
    const bool live = idx < total;
    const int i = live ? w.list[idx] : 0;""", """  for (int round = 0; round < kPerThread; ++round) {
    const int i = blockIdx.x * kWindow + round * kBlock + threadIdx.x;
    const bool live = i < n && rays.active[i] != 0;
    if (i < n && !live) occ_out[i] = 0;""")


def _lanes(n):
    return [("kPerThread = 2;", f"kPerThread = {n};")]


# name -> [(text of direct_traverse.cu or direct_math.cuh, replacement)]:
# the any-hit kernel with a part of its design undone; each text must
# occur exactly once in the two files (names hold no commas: --variants
# splits on them)
VARIANTS = {
    "engine": [],
    "full test": [(_T_FIRST, ""), (
        "  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);\n}",
        "  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &"
        "\n         (t <= r.tmax);\n}")],
    "full test + no compaction": [(_T_FIRST, ""), (
        "  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);\n}",
        "  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f) & (t > 0.0f) &"
        "\n         (t <= r.tmax);\n}"), _NO_COMPACTION],
    "no compaction": [_NO_COMPACTION],
    "1 lane a thread": _lanes(1),
    "4 lanes a thread": _lanes(4),
}
VARIANTS["full test + no compaction + 1 lane a thread"] = \
    VARIANTS["full test + no compaction"] + _lanes(1)
# the t test as a warp-uniform branch: u and v for the whole warp when
# any of its lanes passes t
_UNIFORM_T = [(_T_FIRST, """  const bool t_in = (t > 0.0f) & (t <= r.tmax);
  if (!__any_sync(__activemask(), t_in)) return false;
"""), ("  return (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);\n}",
       "  return t_in & (u >= 0.0f) & (v >= 0.0f) & (u + v <= 1.0f);\n}")]
VARIANTS["uniform t branch"] = _UNIFORM_T
VARIANTS["uniform t branch + 1 lane a thread"] = _UNIFORM_T + _lanes(1)


def build_variant(name, edits):
    """A copy of the direct library with ``edits`` made, built into
    ``build/rtjax_torch/variants/direct_<name>/lib.so``."""
    from rtjax_torch.kernels import _build
    files = {f.name: f.read_text() for f in (_build.DIRECT_SOURCE,
                                             _build.DIRECT_HEADER)}
    for old, new in edits:
        where = [f for f, text in files.items() if text.count(old) == 1]
        if len(where) != 1 or sum(t.count(old) for t in files.values()) != 1:
            raise RuntimeError(f"{name}: the text to replace does not occur "
                               f"exactly once: {old!r}")
        files[where[0]] = files[where[0]].replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    out_dir = _build.BUILD_DIR / "variants" / f"direct_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for fname, text in files.items():
        (out_dir / fname).write_text(text)
    out = out_dir / "lib.so"
    cmd = [_build.nvcc_path()] + _build.NVCC_FLAGS + [
        "-o", str(out), str(out_dir / _build.DIRECT_SOURCE.name)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: {' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    return out


def variants(sets, names, card="", rounds=1, frame=None):
    """Every variant of ``names`` built (all builds together), held bit
    for bit against the plain version on each any-hit ray set of ``sets``
    (``{label: (triangles, rays)}``) and timed against the engine's kernel
    in turns (engine, variant, variant, engine), on the rays as they are
    and with every lane inactive: ``{name: {(label, mask): [variant ms,
    engine ms]}}``; with ``frame``
    (``(scene, camera, cfg)``), also the summed device ms and launches of
    the any-hit kernel in a profiled captured frame on each variant and on
    the first design, forward and back (``"frame"``: two records)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    import chip_smoke as C
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import direct as D
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(
            lambda n: build_variant(n, VARIANTS[n]), names)))
    print(f"[direct variants] {card}: {len(libs)} builds together in "
          f"{time.perf_counter() - t0:.1f} s")
    bound = {n: D.bind(ctypes.CDLL(str(lib))) for n, lib in libs.items()}
    for n, lib in libs.items():
        for kernel, res in _build.ptxas_report(lib):
            if "anyhit_kernel" in kernel and "_v1" not in kernel:
                print(f"[direct variant ptxas] {n}: {res}")
    base = D._kernels()
    out = {}
    try:
        for n, lib in bound.items():
            D._lib = lib
            mis = sum(equal_plain("anyhit", tris, ah)["engine"]
                      for tris, ah in sets.values())
            out[n] = {}
            for label, (tris, ah) in sets.items():
                for mask in ("as_is", "floor"):
                    r = dict(ah)
                    if mask == "floor":
                        r["active"] = ah["active"] & False
                    ms = {base: [], lib: []}
                    for _ in range(rounds):
                        for which in (base, lib, lib, base):
                            D._lib = which
                            ms[which].append(C._launch_ms(
                                lambda: _call("anyhit", "engine", tris,
                                              r))[0])
                    out[n][label, mask] = [statistics.mean(ms[lib]),
                                           statistics.mean(ms[base])]
            print(f"[direct variant {n}] {card}: mismatching lanes {mis}; "
                  f"any-hit device ms a launch, variant / engine in turns: "
                  + "; ".join(f"{lb} {m} {v[0]:.4f} / {v[1]:.4f}"
                              for (lb, m), v in out[n].items()))
            if mis:
                raise RuntimeError(f"variant {n} disagrees with the plain "
                                   f"version on {mis} lanes")
        if frame is not None:
            order = [("first design", base), *bound.items()]
            for n, lib in order + order[::-1]:
                D._lib = lib
                use("v1" if n == "first design" else "engine")
                C._graph_frame(*frame, 1, "graph")       # the capture
                p = _profiled(*frame)
                rec = p["groups"]["direct anyhit"]
                out.setdefault(n, {}).setdefault("frame", []).append(rec)
                print(f"[direct variant {n} frame] {card}: "
                      f"{p['ms_per_iteration']:.4f} ms an iteration; any hit"
                      f" {rec[0]:.3f} ms / {rec[1]}")
    finally:
        D._lib = base
        use("engine")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS),
                    help="step 3: the variants named (comma-separated; "
                         "all by default)")
    ap.add_argument("--frames", action="store_true",
                    help="step 4 alone: frames in turns and profiled")
    ap.add_argument("--out", help="save step 4's numbers here")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from rtjax_torch.kernels import _build
    card = C.phase0_device()
    lib = _build.direct_library()
    if args.frames:
        res = frames(frame_cells(), card)
        if args.out:
            torch.save(res, args.out)
        return
    for name, r in _build.ptxas_report(lib):
        print(f"[direct ptxas] {name}: {r}")
    for name, r in sass(lib).items():
        print(f"[direct sass] {name}: {sass_text(name, r)}")
    scene, camera, cfg = config2()
    cl, ah = config2_rays(scene, camera, cfg)
    check_rays("config2", "closest", scene.tris, cl, card)
    check_rays("config2", "anyhit", scene.tris, ah, card)
    if args.variants:
        soup = C._direct_soup(scene, 64)
        _, soup_ah = C._direct_soup_rays(scene, camera, cfg.pool_size)
        variants({"config2": (scene.tris, ah), "soup 64": (soup, soup_ah)},
                 args.variants.split(","), card, frame=(scene, camera, cfg))


if __name__ == "__main__":
    main()
