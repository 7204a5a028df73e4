"""Scene tracing for the wavefront engine (port of rtjax.render.trace for
single-level scenes).

Every scene goes through the persistent-walker traversal
(kernels/persist.py), which launches the CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors.  rtjax's direct all-triangles loop
for tiny scenes (``direct_max_tris``) computes the same hits and is not
ported yet (ROADMAP Queue S 1); nor are the packet, lane and two-level
kernels (Queue B 3-8).
"""

from __future__ import annotations

import torch

from ..core import vec
from ..kernels.persist import (persist_traverse_anyhit,
                               persist_traverse_closest)


def check_config(scene, cfg) -> None:
    """Raise NotImplementedError for configurations outside the port."""
    if cfg.traversal != "auto":
        raise NotImplementedError(
            f"traversal={cfg.traversal!r}: the port has one traversal "
            "backend (the persistent walkers); see ROADMAP Queue B")
    if cfg.walker not in ("auto", "persist"):
        raise NotImplementedError(
            f"walker={cfg.walker!r}: the packet and lane kernels are not "
            "ported yet (ROADMAP Queue B 3, 7)")
    if cfg.anyhit_walker not in ("auto", "persist"):
        raise NotImplementedError(
            f"anyhit_walker={cfg.anyhit_walker!r}: the packet any-hit "
            "kernel is not ported yet (ROADMAP Queue B 4)")
    if scene.tables is None:
        raise NotImplementedError(
            "scenes built with max_leaf_size > 8 have no wide tables; their "
            "traversal is not ported yet (ROADMAP Queue B 3)")


def trace_closest(scene, o, d, tmax, active):
    """Closest hit: ``(hit, t, prim, src, normal)``; t is ``tmax`` on a
    miss, ``src`` is 0 (base scene) and ``normal`` the unnormalised
    ``cross(e1, e2)`` of the hit triangle."""
    hit, t, prim, normal = persist_traverse_closest(scene.tables, o, d, tmax,
                                                    active)
    t = torch.where(hit, t, tmax)
    return hit, t, prim, torch.zeros_like(prim), normal


def trace_anyhit(scene, o, d, tmax, exclude, active):
    """Occlusion with a per-lane excluded (leaf-order) prim."""
    return persist_traverse_anyhit(scene.tables, o, d, tmax, exclude, active)


def _hit_material_index(scene, src, prim):
    runs = scene.mat_runs
    if runs is not None:
        # the prim -> material map as a run-compare chain; prim < 0 (miss
        # lanes) lands in run 0, like the gather's clamp
        mat_idx = torch.full_like(prim, runs[0][1])
        for s, m in runs[1:]:
            mat_idx = torch.where(prim >= s, m, mat_idx)
        return mat_idx
    return vec.take_rows(scene.prim_material, prim)


def gather_hit_materials_v3(scene, src, prim):
    """Material parameters of the hit prims: ``(mtype, albedo, ior)``."""
    return scene.materials.gather_v3(_hit_material_index(scene, src, prim))
