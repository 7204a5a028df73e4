#!/usr/bin/env python3
"""The group walk's work at one warp's rays (lane.LANE) under the two
any-hit rules, beside the persist walk's, on the headline scene's phase-3
rays (``chip_smoke._test_rays``): the counts of the plain walks
(``persist.new_work``), which run on any device.

    python3 tools/lane_work.py [--device cpu|cuda] [--log2-rays 18]

Counts only, no times: node visits, slab tests, leaf rows and triangle
slots of each walk, and what the lane rule (``decide_first`` False) saves
against deciding first.  On the CPU, take a reduced ray count (14 gives
2^14 closest-hit and 2^15 any-hit rays, a few minutes).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("node_visits", "slab_tests", "leaf_rows", "tri_slots")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--log2-rays", type=int, default=18)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from rtjax_torch.kernels import lane as L
    from rtjax_torch.kernels import persist as P
    from rtjax_torch.kernels import wide as WD
    from rtjax_torch.scenes import cornell_bunny

    scene, camera = cornell_bunny(device=args.device)
    tab = scene.tables
    gen = torch.Generator(device=args.device).manual_seed(1234)
    cl, ah = cs._test_rays(scene, camera, gen, 1 << args.log2_rays)
    cargs = (tab, cl["o"], cl["d"], cl["tmax"], cl["active"])
    aargs = (tab, ah["o"], ah["d"], ah["tmax"], ah["exclude"], ah["active"])
    counts = {}

    def count(label, fn, *a, **kw):
        work = P.new_work()
        out = fn(*a, work=work, **kw)
        counts[label] = work
        print(f"[lane work] {label}: " + ", ".join(
            f"{k} {work[k]}" for k in KEYS))
        return out

    count("persist closest", P.persist_traverse_closest_ref, *cargs)
    count("lane closest", WD.group_traverse_closest_ref, *cargs, L.LANE)
    occ = {}
    occ["persist"] = count("persist anyhit", P.persist_traverse_anyhit_ref,
                           *aargs)
    for first in (False, True):
        occ[first] = count(f"lane anyhit, decide_first {first}",
                           WD.group_traverse_anyhit_ref, *aargs, L.LANE,
                           decide_first=first)
    same = all(torch.equal(occ[k], occ["persist"]) for k in (False, True))
    ratio = {k: counts[f"lane anyhit, decide_first {True}"][k]
             / max(counts[f"lane anyhit, decide_first {False}"][k], 1)
             for k in KEYS}
    print(f"[lane work] {tab.width}-wide tables, depth {tab.depth}; "
          f"{cl['tmax'].numel()} closest-hit and {ah['tmax'].numel()} "
          f"any-hit rays on {args.device}; lane closest / persist closest "
          f"node visits {counts['lane closest']['node_visits'] / counts['persist closest']['node_visits']:.2f}x;"
          f" any hit, deciding first / the lane rule: "
          + ", ".join(f"{k} {v:.3f}x" for k, v in ratio.items())
          + f"; occlusion equal under both rules and to persist's: {same}")
    if not same:
        raise SystemExit("the any-hit rules disagree")


if __name__ == "__main__":
    main()
