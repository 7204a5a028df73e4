#!/usr/bin/env python3
"""The seed-to-seed spread of the estimator frames that ``chip_smoke.py``
phase 8(c) gates, on one CUDA card.

    python3 tools/mode_bands.py [--seeds N] [--size S] [--spp P]

Renders the headline scene (``scenes.cornell_bunny``) at S x S @ P spp, 10
bounces, under ``reference_parity`` and under the default estimator, for
seeds 1..N (default 4, at chip_smoke's 1024 x 1024 @ 16 spp), and prints
each frame's 8-bit image mean, the parity means' difference from
``artifacts/parity_reference_1024_1024spp.ppm``'s mean, the parity /
default ratio of each seed, and their means and standard deviations: the
numbers chip_smoke's PARITY_MEAN_TOL and PARITY_RATIO_TOL are set from
(each: the largest offset seen plus four standard deviations).  Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--spp", type=int, default=16)
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    import chip_smoke
    from rtjax_torch import RenderConfig
    from rtjax_torch.render.film import read_ppm
    from rtjax_torch.render.wavefront import render_frame
    from rtjax_torch.scenes import cornell_bunny

    if not torch.cuda.is_available():
        sys.exit("mode_bands: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    scene, camera = cornell_bunny("cuda")
    base = RenderConfig(width=args.size, height=args.size,
                        num_samples=args.spp, max_bounces=10)
    art = float(read_ppm(chip_smoke.PARITY_ARTIFACT).astype(np.float64)
                .mean() / 255.0)
    means = {"parity": [], "default": []}
    for seed in range(1, args.seeds + 1):
        for name, cfg in (("parity", dataclasses.replace(
                base, reference_parity=True)), ("default", base)):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fb, st = render_frame(scene, camera, cfg, gen)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            m = chip_smoke._mean_u8(fb, args.size, args.size)
            means[name].append(m)
            print(f"[{name} seed {seed}] {args.size}x{args.size} @ "
                  f"{args.spp} spp: mean {m:.6f}, {st['iterations']} "
                  f"iterations, {st['rays_traced']:.0f} rays, {secs:.3f} s")
    ratios = [a / b for a, b in zip(means["parity"], means["default"])]
    off = [m - art for m in means["parity"]]
    roff = [r - chip_smoke.PARITY_RATIO for r in ratios]
    sd = lambda v: statistics.stdev(v) if len(v) > 1 else 0.0
    print(f"[artifact] {os.path.relpath(chip_smoke.PARITY_ARTIFACT, ROOT)} "
          f"mean {art:.6f}")
    print(f"[parity vs artifact] offsets {[f'{v:+.6f}' for v in off]}, mean "
          f"{statistics.mean(off):+.6f}, sd {sd(off):.6f}; band "
          f"{max(map(abs, off)) + 4 * sd(off):.6f}")
    print(f"[parity / default] ratios {[f'{v:.6f}' for v in ratios]}, mean "
          f"{statistics.mean(ratios):.6f} (BASELINE "
          f"{chip_smoke.PARITY_RATIO}), sd {sd(ratios):.6f}; band "
          f"{max(map(abs, roff)) + 4 * sd(ratios):.6f}")


if __name__ == "__main__":
    main()
