#!/usr/bin/env python3
"""The binary walk's fetch design (``csrc/binary_traverse.cu``) against
each part of it undone or changed, on one CUDA card.

    python3 tools/binary_variants.py [--only NAME,NAME] [--rounds R]

Each variant is a copy of ``csrc/binary_traverse.cu`` with a few lines
replaced (``VARIANTS``; each replaced text must occur exactly once, or the
tool stops), built beside copies of the headers it includes into
``build/rtjax_torch/variants/binary_<n>/``, all builds started together;
ptxas's registers, stack frame and spills of its fetch kernels are
printed.  On ``chip_smoke.py``'s phase-3 rays over the headline scene's
binary BVH (2^18 closest-hit, 2^19 any-hit rays) every variant is held
bit for bit against the plain versions and timed (``chip_smoke._launch_ms``:
the mean device time of ``chip_smoke.REPS`` launches), the shipped
library and every variant in turns, ``--rounds`` rounds, with the first
design (``traverse_*_thread``) beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_BOUNDS = "__launch_bounds__(kBlock)\nfetch_kernel("
_GRID = """  const int grid = rtjax::fetch_grid<fetch_kernel<ANY, STATS>>(n, smem,
                                                                kBlock);"""
_ALL_BLOCKS = """  const int grid = (n + kBlock - 1) / kBlock;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fetch_kernel<ANY, STATS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);"""
_PHASE = "    if (4 * n_wait >= 3 * n_live) {"
_REFILL = "constexpr int kRefill = 16;"
_WORDS = "  const int c_l = w.x, np_l = w.y, c_r = w.z, np_r = w.w;\n"


def _prefetch(level):
    """Prefetch an internal child's pair record, which the next step may
    read."""
    return "".join(
        f"  if ({n} == 0) asm volatile(\"prefetch.global.{level} [%0];\" "
        f":: \"l\"(pairs + (long long){c} * 4));\n"
        for c, n in (("c_l", "np_l"), ("c_r", "np_r")))


VARIANTS = {
    "shipped": [],
    "no refill: a block a 128 rays": [
        (_GRID, _ALL_BLOCKS),
        ("      more = base + k < (unsigned)n;", "      more = false;")],
    "refill at every empty lane": [(_REFILL, "constexpr int kRefill = 1;")],
    "leaves tested after every step": [(_PHASE, "    if (n_wait > 0) {")],
    "leaf phase at half the lanes": [(_PHASE,
                                      "    if (2 * n_wait >= n_live) {")],
    "leaf phase at a quarter of the lanes": [
        (_PHASE, "    if (4 * n_wait >= n_live) {")],
    "leaves after every step and refill at every lane": [
        (_PHASE, "    if (n_wait > 0) {"),
        (_REFILL, "constexpr int kRefill = 1;")],
    "12 blocks an SM": [(_BOUNDS, "__launch_bounds__(kBlock, 12)\n"
                                  "fetch_kernel(")],
    "children prefetched to L2": [(_WORDS, _WORDS + _prefetch("L2"))],
}


def build(index, name, edits):
    """Build one variant; ``(name, library path, ptxas lines)``."""
    from rtjax_torch.kernels import _build
    src = (_build.CSRC_DIR / "binary_traverse.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {old[:40]!r} occurs "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "variants" / f"binary_{index}"
    out.mkdir(parents=True, exist_ok=True)
    for h in (_build.WALK_HEADER, _build.FETCH_HEADER):
        shutil.copy(h, out / h.name)
    (out / "binary_traverse.cu").write_text(src)
    lib = out / "libbinary_traverse.so"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(lib), str(out / "binary_traverse.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"variant {name!r} failed to build:\n{res.stderr}")
    (out / "libbinary_traverse.log").write_text(res.stdout + res.stderr)
    ptx = [f"{k.split('fetch_kernel')[1][:10]}: {v}" for k, v in
           _build.ptxas_report(lib) if "fetch_kernel" in k]
    return name, lib, ptx


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("binary_variants: needs a CUDA device")
    import chip_smoke as C
    from rtjax_torch.kernels import traversal as T
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    names = [n for n in VARIANTS if not args.only or n == "shipped"
             or n in args.only.split(",")]
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(lambda a: build(*a), [
            (i, n, VARIANTS[n]) for i, n in enumerate(names)]))
    libs = {}
    for name, lib, ptx in built:
        print(f"[binary variant {name}] " + "; ".join(ptx))
        libs[name] = T.bind(ctypes.CDLL(str(lib)))
    scene, camera = C.phase2_scene()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cl, ah = C._test_rays(scene, camera, gen)
    bvh, tris = scene.bvh, scene.tris
    work = {"closest": T.new_work(), "anyhit": T.new_work()}
    calls = {
        "closest": (lambda: T.traverse_closest(
            bvh, tris, cl["o"], cl["d"], cl["tmax"], cl["active"]),
            T.traverse_closest_ref(bvh, tris, cl["o"], cl["d"], cl["tmax"],
                                   cl["active"], work=work["closest"])),
        "anyhit": (lambda: T.traverse_anyhit(
            bvh, tris, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
            ah["active"]),
            T.traverse_anyhit_ref(bvh, tris, ah["o"], ah["d"], ah["tmax"],
                                  ah["exclude"], ah["active"],
                                  work=work["anyhit"]))}
    for kind, w in work.items():
        print(f"[binary walk {kind}] {w['steps']} node-pair steps, "
              f"{w['tri_tests']} triangle tests; the longest walk "
              f"{w['rounds']} steps")
    first = {"closest": lambda: T.traverse_closest_thread(
        bvh, tris, cl["o"], cl["d"], cl["tmax"], cl["active"]),
        "anyhit": lambda: T.traverse_anyhit_thread(
            bvh, tris, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
            ah["active"])}
    flat = lambda r: [r] if isinstance(r, torch.Tensor) else \
        [t for v in r for t in flat(v)]
    shipped = T._kernels()
    try:
        for name, lib in libs.items():
            T._lib = lib
            for kind, (fn, ref) in calls.items():
                got = fn()
                torch.cuda.synchronize()
                bad = sum(int((a != b).sum()) for a, b in
                          zip(flat(got), flat(ref), strict=True))
                if bad:
                    raise SystemExit(f"variant {name!r} {kind}: {bad} "
                                     "mismatches against the plain version")
        times = {(n, k): [] for n in [*libs, "first design"] for k in calls}
        order = [*libs, "first design"]
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                T._lib = libs.get(name, shipped)
                for kind, (fn, _) in calls.items():
                    f = first[kind] if name == "first design" else fn
                    times[name, kind].append(C._launch_ms(f)[0])
    finally:
        T._lib = shipped
    base = {k: statistics.mean(times["shipped", k]) for k in calls}
    for (name, kind), ms in times.items():
        m = statistics.mean(ms)
        print(f"[binary variant {name} {kind}] "
              + ", ".join(f"{v:.4f}" for v in ms)
              + f" ms; mean {m:.4f} ms, {base[kind] / m:.3f}x the shipped "
              "design's speed")


if __name__ == "__main__":
    main()
