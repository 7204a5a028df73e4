#!/usr/bin/env python3
"""Where the time of an eval-config-4 frame goes, on one CUDA card.

    python3 tools/prof_config4.py [--out DIR]

Builds config 4 (``scenes.instanced_bunnies``) and its baked control
(``instanced_bunnies_baked``), renders each of three arms once as a
warm-up — (a) repass (``two_level="auto"``), (b) the two-level kernels
(``two_level="kernel"``), (c) the baked single-level scene — then four
unprofiled frames of each, alternated, and prints their seconds.  Then one
``torch.profiler`` frame per arm: its iterations and rays, the self-CUDA
total of the ``key_averages`` table (the device-busy figure; summing
``self_device_time_total`` over the rows counts aten ops and their kernels
twice), the ``cudaLaunchKernel`` calls and the host reads
(``aten::_local_scalar_dense``).  Each arm's table goes to
``DIR/<arm>_table.txt`` (default ``build/rtjax_torch/prof``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "rtjax_torch",
                                                  "prof"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rtjax_torch import RenderConfig
    from rtjax_torch.render.wavefront import render_frame
    from rtjax_torch.scenes import instanced_bunnies, instanced_bunnies_baked

    if not torch.cuda.is_available():
        sys.exit("prof_config4: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    scene, cam = instanced_bunnies("cuda")
    baked, _ = instanced_bunnies_baked("cuda")
    cfg = RenderConfig(width=256, height=256, num_samples=8, max_bounces=5)
    arms = {"repass": (scene, cfg),
            "kernel": (scene, RenderConfig(width=256, height=256,
                                           num_samples=8, max_bounces=5,
                                           two_level="kernel")),
            "baked": (baked, cfg)}

    def frame(sc, c, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = render_frame(sc, cam, c, g)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, st

    for sc, c in arms.values():
        frame(sc, c, 1)
    times = {k: [] for k in arms}
    for rep in range(4):
        for name, (sc, c) in arms.items():
            times[name].append(frame(sc, c, 2 + rep)[0])
    for name, ts in times.items():
        print(f"[timing] {name}: " + ", ".join(f"{t:.3f}" for t in ts)
              + f" s; median {sorted(ts)[len(ts) // 2]:.3f} s")

    os.makedirs(args.out, exist_ok=True)
    for name, (sc, c) in arms.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s, st = frame(sc, c, 9)
        ka = prof.key_averages()
        table = ka.table(sort_by="self_device_time_total", row_limit=18,
                         max_name_column_width=60)
        busy = [ln.strip() for ln in table.splitlines()
                if ln.startswith("Self CUDA time total")]
        counted = ("cudaLaunchKernel", "aten::_local_scalar_dense",
                   "cudaStreamSynchronize", "cudaMemcpyAsync")
        print(f"[profile {name}] frame {s:.3f} s (profiled), "
              f"{st['iterations']} iterations, {st['rays_traced']:.0f} rays; "
              + "; ".join(busy) + "; "
              + ", ".join(f"{e.key} {e.count} calls "
                          f"{e.cpu_time_total / 1e3:.1f} ms"
                          for e in ka if e.key in counted))
        with open(os.path.join(args.out, f"{name}_table.txt"), "w") as f:
            f.write(table)
        print("\n".join(table.splitlines()[:22]))


if __name__ == "__main__":
    main()
