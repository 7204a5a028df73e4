#!/usr/bin/env python3
"""The persistent-walker fetch kernels against each part of their design
undone, on one CUDA card.

    python3 tools/persist_variants.py [--only NAME,NAME] [--config4]
                                      [--rounds R]

Each variant is a copy of ``csrc/persist_traverse.cu`` with a few lines
replaced (``VARIANTS``: each replaced text must occur exactly once in the
source, or the tool stops), built into ``build/rtjax_torch/variants/``,
all builds started together; ptxas's registers, stack frame and spills of
its fetch kernels are printed.  Then it renders one headline frame with
the shipped kernels and keeps the rays of launch ``chip_smoke.CAPTURE_AT``
of each, and on those and on ``chip_smoke.py``'s phase-3 rays (2^18
closest-hit, 2^19 any-hit rays over the headline scene) -- with
``--config4`` also on its phase-5 rays over config 4's baked tables and
its BLAS -- holds every variant bit for bit against the plain versions
and times it: device time per launch (``chip_smoke._launch_ms``: mean,
least and most of ``chip_smoke.REPS`` launches), every variant and the
stride design in turns, ``--rounds`` rounds.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_FETCH_BOUNDS = "__launch_bounds__(kFetchBlock)\nfetch_kernel"
_SHARED_STACK = """  extern __shared__ int stack[];
  int* st_node = stack + threadIdx.x;
  unsigned* st_mask =
      reinterpret_cast<unsigned*>(stack + stack_len * kFetchBlock) +
      threadIdx.x;"""


def _cap(min_blocks):
    return [(_FETCH_BOUNDS, f"__launch_bounds__(kFetchBlock, {min_blocks})"
                            "\nfetch_kernel")]


# name -> [(text of the source, its replacement)]
VARIANTS = {
    "design": [],
    "leaf chunk 1": [("kLeafChunk = 4;", "kLeafChunk = 1;")],
    "leaf chunk 2": [("kLeafChunk = 4;", "kLeafChunk = 2;")],
    "leaf chunk 8": [("kLeafChunk = 4;", "kLeafChunk = 8;")],
    "block 256": [("kFetchBlock = 128;", "kFetchBlock = 256;")],
    "block 64": [("kFetchBlock = 128;", "kFetchBlock = 64;")],
    "<= 80 registers": _cap(6),
    "<= 64 registers": _cap(8),
    "<= 40 registers": _cap(12),
    "refill at 8 empty lanes": [("if (want == 0u) break;",
                                 "if (__popc(want) < 8) break;")],
    "no dynamic fetch (refill at 32)": [("if (want == 0u) break;",
                                         "if (__popc(want) < 32) break;")],
    "scalar loads": [
        ("leaf_any_v<kLeafChunk>(", "rtjax::leaf_any("),
        ("leaf_closest_v<kLeafChunk>(", "rtjax::leaf_closest("),
        ("slab_hits_v<W>(", "rtjax::slab_hits<W>(")],
    "local-memory stack": [
        (_SHARED_STACK, "  int st_node[kStack];\n  unsigned st_mask[kStack];"),
        ("st_node[s.sp * kFetchBlock]", "st_node[s.sp]"),
        ("st_mask[s.sp * kFetchBlock]", "st_mask[s.sp]"),
        ("top = (s.sp - 1) * kFetchBlock;", "top = s.sp - 1;"),
        ("smem = 2 * 4 * stack_len * kFetchBlock;", "smem = 0;")],
}


def patched(source: str, edits) -> str:
    """``source`` with each ``(old, new)`` of ``edits`` replaced; raises
    unless each ``old`` occurs exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"{old!r} occurs {source.count(old)} times in "
                             "the persist kernel source, not once")
        source = source.replace(old, new)
    return source


def build(name, edits):
    from rtjax_torch.kernels import _build
    tag = "".join(c if c.isalnum() else "_" for c in name)
    out = _build.BUILD_DIR / "variants" / f"libpersist_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(patched(_build.PERSIST_SOURCE.read_text(), edits))
    cmd = [_build.nvcc_path()] + _build.NVCC_FLAGS + [
        "-I", str(_build.CSRC_DIR), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: {' '.join(cmd)}\n{res.stdout}"
                           f"{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--config4", action="store_true",
                    help="also time config 4's baked tables and BLAS")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    names = [v for v in args.only.split(",") if v] or list(VARIANTS)

    import torch

    import chip_smoke as cs
    from rtjax_torch import RenderConfig
    from rtjax_torch.kernels import _build
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.render.wavefront import render_frame

    card = cs.phase0_device()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda n: build(n, VARIANTS[n]), names)))
    for name, lib in libs.items():
        for kernel, res in _build.ptxas_report(lib):
            if "fetch_kernel" in kernel:
                print(f"[ptxas {name}] {cs._kernel_label(kernel)}: {res}")

    scene, camera = cs.phase2_scene()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    sets = {"phase 3": cs._test_rays(scene, camera, gen)}
    captured, restore = cs._capture_launch(cs.CAPTURE_AT)
    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                       num_samples=cs.SPP, max_bounces=cs.BOUNCES)
    render_frame(scene, camera, cfg,
                 torch.Generator(device="cuda").manual_seed(1))
    restore()
    sets["in-frame"] = (captured["closest"][1], captured["anyhit"][1])
    tables = dict.fromkeys(sets, scene.tables)
    if args.config4:
        c4, baked, c4_camera = cs.phase5_scene()
        gen = torch.Generator(device="cuda").manual_seed(5678)
        sets["config4 baked"] = cs._field_rays(baked, c4_camera, gen)
        tables["config4 baked"] = baked.tables
        cl, ah = cs._field_rays(c4, c4_camera, gen)
        sets["config4 blas"] = (cs._instance_frame(c4.instances, cl),
                                cs._instance_frame(c4.instances, ah))
        tables["config4 blas"] = c4.blas[0].tables

    calls = {}
    for label, (cl, ah) in sets.items():
        tab = tables[label]
        cargs = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
        aargs = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"],
                 ah["active"])
        calls[label] = (cargs, aargs, P.persist_traverse_closest_ref(*cargs),
                        P.persist_traverse_anyhit_ref(*aargs))

    bound = {n: P.bind(ctypes.CDLL(str(lib))) for n, lib in libs.items()}
    for name, lib in bound.items():
        P._lib = lib
        for label, (cargs, aargs, want_c, want_a) in calls.items():
            got = P.persist_traverse_closest(*cargs)
            occ = P.persist_traverse_anyhit(*aargs)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip(got[:3] + got[3], want_c[:3] + want_c[3]))
            if not same or not torch.equal(occ, want_a):
                raise RuntimeError(f"{name} disagrees with the plain "
                                   f"versions on the {label} rays")
    print(f"[variants] every variant bit-identical to the plain versions "
          f"on {', '.join(calls)}")

    rows = [*bound, "stride design"]
    times = {(n, label, kind): [] for n in rows for label in calls
             for kind in ("closest", "anyhit")}
    for _ in range(args.rounds):
        for name in rows:
            stride = name == "stride design"
            if not stride:
                P._lib = bound[name]
            closest = P.persist_traverse_closest_stride if stride \
                else P.persist_traverse_closest
            anyhit = P.persist_traverse_anyhit_stride if stride \
                else P.persist_traverse_anyhit
            for label, (cargs, aargs, _, _) in calls.items():
                times[name, label, "closest"].append(
                    cs._launch_ms(lambda: closest(*cargs)))
                times[name, label, "anyhit"].append(
                    cs._launch_ms(lambda: anyhit(*aargs)))
    for name in rows:
        print(f"[variants] {card}: {name}: " + "; ".join(
            f"{label} {kind} " + " / ".join(
                f"{m:.4f} ({lo:.4f}-{hi:.4f})"
                for m, lo, hi in times[name, label, kind]) + " ms"
            for label in calls for kind in ("closest", "anyhit"))
            + f" (device time per launch: mean (least-most) of {cs.REPS} "
            f"launches, {args.rounds} rounds in turns)")


if __name__ == "__main__":
    main()
