"""Scene tracing for the wavefront engine: the single-level path and the
two-level (instanced) merge (port of rtjax.render.trace).

A hit is identified by ``(src, prim)``: src 0 is the base scene, src k
instance k - 1, and prim the leaf-order triangle within that mesh.  Every
single-level launch (a single-level scene, and each launch of repass)
picks its kernels by walker with :func:`_backend`, as rtjax's ``_backend``
does: the persistent walkers (kernels/persist.py), the packet kernels
(kernels/wide.py) or the lane kernels (kernels/lane.py).  An instanced
scene takes one of rtjax's two strategies, chosen by
``RenderConfig.two_level`` (``two_level_anyhit`` follows it on "auto"):

- "repass" (what "auto" resolves to): one launch over the base scene,
  then, per mesh, passes in which every ray walks its nearest
  not-yet-walked candidate instance (world-box entry closer than its
  current t) in its local frame, all rays of a pass in one launch over the
  shared BLAS.  rtjax's ``lax.while_loop`` over passes is a Python loop
  reading one device value per pass;
- "kernel": one launch of the two-level kernels (kernels/wide_inst.py).

``with_stats=True`` (``RenderConfig.detailed_stats``) appends the walks'
``(node_steps, leaf_visits)``, summed over every launch of the call
(repass: the base launch and every pass).  Only the persist kernels count
(their stats instances); a launch that would take the packet, lane or
two-level kernels raises NotImplementedError naming ROADMAP Queue S 3.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain version for CPU tensors.  rtjax's direct all-triangles loop for
tiny scenes (``direct_max_tris``) computes the same hits and is not ported
yet (ROADMAP Queue S 1); nor is rtjax's binary-BVH traversal
(``traversal="xla"`` and scenes without wide tables, Queue A 18).
"""

from __future__ import annotations

import warnings
from functools import partial

import torch

from ..accel.instancing import apply_affine_point, apply_affine_vector
from ..core import vec
from ..kernels import lane, persist
from ..kernels.lane import lane_traverse_closest
from ..kernels.persist import (persist_traverse_anyhit,
                               persist_traverse_closest, slab, slab_pre)
from ..kernels.wide import wide_traverse_anyhit, wide_traverse_closest
from ..kernels.wide_inst import (wide_traverse_anyhit_inst,
                                 wide_traverse_closest_inst)

_REPASS_BIG = 3.0e38   # rtjax's "no candidate" entry distance


WALKERS = ("auto", "persist", "packet", "lane")
ANYHIT_WALKERS = ("auto", "persist", "packet")
_BINARY = ("rtjax's binary-BVH traversal (kernels/traversal.py) is not "
           "ported yet (ROADMAP Queue A 18)")
_NO_STATS = ("detailed_stats counts traversal work in the persist kernels "
             "only; the {} kernels' counters are not ported yet (ROADMAP "
             "Queue S 3)")


def check_config(scene, cfg) -> None:
    """Raise ValueError for walker values rtjax does not name and
    NotImplementedError for configurations outside the port."""
    if cfg.walker not in WALKERS:
        raise ValueError(f"walker must be one of {WALKERS}, got "
                         f"{cfg.walker!r}")
    if cfg.anyhit_walker not in ANYHIT_WALKERS:
        raise ValueError(f"anyhit_walker must be one of {ANYHIT_WALKERS}, "
                         f"got {cfg.anyhit_walker!r}")
    if cfg.traversal != "auto":
        raise NotImplementedError(
            f"traversal={cfg.traversal!r}: the port traverses with its "
            f"kernels on \"auto\"; {_BINARY}")
    if scene.tables is None:
        raise NotImplementedError(
            f"scenes built with max_leaf_size > 8 have no wide tables; "
            f"{_BINARY}")
    if cfg.detailed_stats:
        if cfg.walker in ("packet", "lane"):
            raise NotImplementedError(_NO_STATS.format(cfg.walker))
        if cfg.anyhit_walker == "packet":
            raise NotImplementedError(_NO_STATS.format("packet"))
        if scene.instances is not None and "kernel" in (
                _resolve_two_level(cfg), _anyhit_two_level(cfg)):
            raise NotImplementedError(_NO_STATS.format("two-level"))


def _backend(tables, cfg, with_stats=False):
    """The ``(closest, anyhit)`` traversal functions for one set of wide
    tables, by walker, as rtjax's ``_backend`` (trace.py:172-234) picks
    them; with ``with_stats`` they return the walk's counts too (persist
    kernels only).  The persistent walkers take trees whose stack fits
    ``persist.STACK``: "auto" takes them there and the packet kernels
    beyond, and "persist" on a deeper tree warns once and takes the packet
    kernels.  "lane" takes its kernels where a warp's stack fits a block
    (``lane.fits``) and beyond warns once and takes the packet kernels.
    "packet" takes its kernels at any depth.  The any-hit kernel follows
    ``anyhit_walker`` alone ("auto" as "persist").  A warning shows once per
    call site under Python's default filter."""
    fits = tables.depth + 1 <= persist.STACK
    walker = cfg.walker
    if walker == "auto":
        walker = "persist" if fits else "packet"
    elif walker == "persist" and not fits:
        warnings.warn(f"walker='persist' requested but the tree (depth "
                      f"{tables.depth}) exceeds the persistent walkers' "
                      f"{persist.STACK}-entry stack; using the packet walker",
                      stacklevel=3)
        walker = "packet"
    elif walker == "lane" and not lane.fits(tables):
        warnings.warn(f"walker='lane' requested but the tree (depth "
                      f"{tables.depth}) needs a lane-kernel warp's stack "
                      f"beyond a block's shared memory; using the packet "
                      f"walker", stacklevel=3)
        walker = "packet"
    closest = {"persist": persist_traverse_closest,
               "packet": wide_traverse_closest,
               "lane": lane_traverse_closest}[walker]
    anyhit = persist_traverse_anyhit \
        if cfg.anyhit_walker != "packet" and fits else wide_traverse_anyhit
    if with_stats:
        if closest is not persist_traverse_closest or \
                anyhit is not persist_traverse_anyhit:
            raise NotImplementedError(_NO_STATS.format(
                f"packet and lane (a tree of depth {tables.depth})"))
        return (partial(closest, tables, with_stats=True),
                partial(anyhit, tables, with_stats=True))
    return partial(closest, tables), partial(anyhit, tables)


def _anyhit_two_level(cfg) -> str:
    """``two_level_anyhit``, "auto" following ``two_level``."""
    tl = cfg.two_level_anyhit
    return _resolve_two_level(cfg) if tl == "auto" else tl


def _resolve_two_level(cfg) -> str:
    """"auto" is the multi-pass re-dispatch, rtjax's choice.  On the H100
    the two-level kernels were faster on config 4; ROADMAP Queue S 13
    holds repass as a removal candidate until a many-instance scene is
    measured."""
    return "repass" if cfg.two_level == "auto" else cfg.two_level


def _strategy(scene, tl: str) -> str:
    """``tl`` itself: the builder makes ``inst_tables`` exactly when the
    base scene and every BLAS have wide tables, which both strategies
    need."""
    if scene.inst_tables is None:
        raise NotImplementedError(
            "instanced scenes whose meshes have no wide tables (max_leaf_size"
            f" > 8) traverse their BLAS one instance at a time; {_BINARY}")
    return tl


def _mesh_groups(inst) -> dict:
    """Instance ids by mesh: ``{mesh_id: [k, ...]}``."""
    groups: dict[int, list[int]] = {}
    for k, m in enumerate(inst.mesh_id):
        groups.setdefault(int(m), []).append(k)
    return groups


def _repass_setup(inst, ks, o, d):
    """Entry distances ``ent [G, N]`` (0 for origins inside the box) and
    the hit-the-box mask ``ok [G, N]`` of one mesh group's world boxes."""
    boxes = torch.cat([inst.aabb_lo[ks], inst.aabb_hi[ks]], 1)[:, None]
    entry, exit_ = slab(boxes, *slab_pre(o, d))
    return torch.clamp(entry, min=0.0), (entry <= exit_) & (exit_ >= 0.0)


def _repass_passes(scene, o, d, active, blocked):
    """Yield, per mesh and pass, ``(blas tables, pend, src_k, o_l, d_l)``:
    the rays whose nearest unwalked candidate instance is still admitted by
    ``blocked() -> [G, N] bool`` (False = candidate), and their rays in that
    instance's frame.  One device read per pass decides whether another
    pass is needed."""
    inst = scene.instances
    for mesh_id, ks in _mesh_groups(inst).items():
        ent, ok = _repass_setup(inst, ks, o, d)
        inv = inst.inv[ks]
        src_of = torch.tensor([k + 1 for k in ks], dtype=torch.int32,
                              device=ent.device)
        g_iota = torch.arange(len(ks), device=ent.device)[:, None]
        walked = torch.zeros_like(ok)
        while True:
            cand = ok & ~walked & active[None] & ~blocked(ent)
            pend = cand.any(0)
            if not bool(pend.any()):
                break
            pick = torch.argmin(torch.where(cand, ent, _REPASS_BIG), dim=0)
            walked |= (g_iota == pick[None]) & pend[None]
            rows = inv[pick]
            o_l = apply_affine_point(rows, o)
            d_l = apply_affine_vector(rows, d)
            yield (scene.blas[mesh_id].tables, pend, src_of[pick],
                   tuple(c.contiguous() for c in o_l),
                   tuple(c.contiguous() for c in d_l))


def _add(st, more):
    """Sum two ``(node_steps, leaf_visits)`` pairs (None: no counts)."""
    return None if st is None else (st[0] + more[0], st[1] + more[1])


def _repass_closest(scene, cfg, o, d, tmax, active, with_stats=False):
    """Two-level closest hit by multi-pass re-dispatch; the normal is
    LOCAL.  Every launch takes the kernel ``cfg.walker`` picks for its
    tables.  Returns ``(hit, t, prim, src, n_l, counts)``, counts summed
    over the launches (None without ``with_stats``)."""
    hit, t, prim, n_l, *st = _backend(scene.tables, cfg, with_stats)[0](
        o, d, tmax, active)
    st = st[0] if with_stats else None
    t = torch.where(hit, t, tmax)
    src = torch.zeros_like(prim)
    for tables, pend, src_k, o_l, d_l in _repass_passes(
            scene, o, d, active, lambda ent: ~(ent < t[None])):
        h2, t2, p2, nl2, *st2 = _backend(tables, cfg, with_stats)[0](
            o_l, d_l, t, pend)
        if with_stats:
            st = _add(st, st2[0])
        closer = h2 & (t2 < t)
        t = torch.where(closer, t2, t)
        prim = torch.where(closer, p2, prim)
        src = torch.where(closer, src_k, src)
        n_l = vec.where(closer, nl2, n_l)
        hit = hit | closer
    return hit, t, prim, src, n_l, st


def _repass_anyhit(scene, cfg, o, d, tmax, exclude, active,
                   with_stats=False):
    """Two-level occlusion by multi-pass re-dispatch; the exclusion applies
    in the base scene only, and occluded rays drop out of later passes.
    Every launch takes the kernel ``cfg.anyhit_walker`` picks.  Returns
    ``(occluded, counts)``, counts as in :func:`_repass_closest`."""
    occ = _backend(scene.tables, cfg, with_stats)[1](o, d, tmax, exclude,
                                                     active)
    st = None
    if with_stats:
        occ, st = occ
    no_excl = torch.full_like(exclude, -1)
    for tables, pend, _, o_l, d_l in _repass_passes(
            scene, o, d, active,
            lambda ent: ~(ent < tmax[None]) | occ[None]):
        occ_k = _backend(tables, cfg, with_stats)[1](o_l, d_l, tmax, no_excl,
                                                     pend)
        if with_stats:
            occ_k, st2 = occ_k
            st = _add(st, st2)
        occ = occ | occ_k
    return occ, st


def _world_normal(inst, src, n_l):
    """Local normals to world space by the hit instance's cofactor (base
    hits are already world)."""
    n_w = apply_affine_vector(inst.nrm[torch.clamp(src - 1, min=0).long()],
                              n_l)
    return vec.where(src > 0, n_w, n_l)


def trace_closest(scene, cfg, o, d, tmax, active, with_stats=False):
    """Closest hit over the base scene and every instance: ``(hit, t,
    prim, src, normal)``; t is ``tmax`` on a miss and ``normal`` the world
    unnormalised ``cross(e1, e2)`` of the hit triangle.  ``o`` / ``d`` are
    component triples.  ``with_stats`` appends ``(node_steps,
    leaf_visits)``, summed over the call's launches."""
    if scene.instances is None:
        hit, t, prim, normal, *st = _backend(scene.tables, cfg, with_stats)[
            0](o, d, tmax, active)
        t = torch.where(hit, t, tmax)
        return (hit, t, prim, torch.zeros_like(prim), normal, *st)
    if _strategy(scene, _resolve_two_level(cfg)) == "repass":
        hit, t, prim, src, n_l, st = _repass_closest(scene, cfg, o, d, tmax,
                                                     active, with_stats)
    else:
        if with_stats:
            raise NotImplementedError(_NO_STATS.format("two-level"))
        hit, t, prim, src, n_l = wide_traverse_closest_inst(
            scene.inst_tables, o, d, tmax, active)
        t = torch.where(hit, t, tmax)
    out = (hit, t, prim, src, _world_normal(scene.instances, src, n_l))
    return out + ((st,) if with_stats else ())


def trace_anyhit(scene, cfg, o, d, tmax, exclude, active, with_stats=False):
    """Occlusion with a per-lane excluded base-scene (leaf-order) prim;
    ``with_stats`` returns ``(occluded, (node_steps, leaf_visits))``."""
    if scene.instances is None:
        return _backend(scene.tables, cfg, with_stats)[1](o, d, tmax,
                                                          exclude, active)
    if _strategy(scene, _anyhit_two_level(cfg)) == "repass":
        occ, st = _repass_anyhit(scene, cfg, o, d, tmax, exclude, active,
                                 with_stats)
        return (occ, st) if with_stats else occ
    if with_stats:
        raise NotImplementedError(_NO_STATS.format("two-level"))
    return wide_traverse_anyhit_inst(scene.inst_tables, o, d, tmax, exclude,
                                     active)


def _hit_material_index(scene, src, prim):
    runs = scene.mat_runs
    if runs is not None:
        # the prim -> material map as a run-compare chain; prim < 0 (miss
        # lanes) lands in run 0, like the gather's clamp
        mat_idx = torch.full_like(prim, runs[0][1])
        for s, m in runs[1:]:
            mat_idx = torch.where(prim >= s, m, mat_idx)
    else:
        mat_idx = vec.take_rows(scene.prim_material, prim)
    inst = scene.instances
    if inst is not None:
        # an instanced hit takes its instance's material
        mat_idx = torch.where(
            src > 0, inst.material[torch.clamp(src - 1, min=0).long()],
            mat_idx)
    return mat_idx


def gather_hit_materials_v3(scene, src, prim):
    """Material parameters of the hit prims: ``(mtype, albedo, ior)``."""
    return scene.materials.gather_v3(_hit_material_index(scene, src, prim))
