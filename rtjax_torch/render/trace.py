"""Scene tracing for the wavefront engine: the single-level path and the
two-level (instanced) merge (port of rtjax.render.trace).

A hit is identified by ``(src, prim)``: src 0 is the base scene, src k
instance k - 1, and prim the leaf-order triangle within that mesh.

``RenderConfig.traversal`` picks the traversal (:func:`resolve_mode`):
"pallas" the kernels over the wide tables, "xla" rtjax's binary-BVH walk
(kernels/traversal.py), and "auto" the kernels where the scene has wide
tables and the binary walk where it has none (rtjax's "auto" takes the
binary walk on every backend but a TPU; the kernels are the port's fast
path on the card, as Pallas is rtjax's on the TPU).  On the kernel path
every single-level launch (a single-level scene, each launch of repass,
and the base and every instance of the per-instance loop) picks its
kernels with :func:`_backend`, as rtjax's ``_backend`` does: a mesh of at
most ``RenderConfig.direct_max_tris`` triangles (default 64; 0 disables)
takes the direct all-triangles kernels (kernels/direct.py), any other mesh
its walker's: the persistent walkers (kernels/persist.py), the packet
kernels (kernels/wide.py) or the lane kernels (kernels/lane.py).  The
binary walk ("xla") and the two-level kernels never take the direct path,
as in rtjax.  An
instanced scene with two-level tables takes one of rtjax's two strategies,
chosen by ``RenderConfig.two_level`` (``two_level_anyhit`` follows it on
"auto"):

- "repass" (what "auto" resolves to): one launch over the base scene,
  then, per mesh, passes in which every ray walks its nearest
  not-yet-walked candidate instance (world-box entry closer than its
  current t) in its local frame, all rays of a pass in one launch over the
  shared BLAS.  rtjax's ``lax.while_loop`` over passes is a device loop
  (render/device_loop.py): inside the captured step a CUDA-graph while
  node on the device condition, op by op G passes for a mesh of G
  instances (rtjax's bound), each masked on the device; the step reads
  nothing from the host and is captured like every other mode's;
- "kernel": one launch of the two-level kernels (kernels/wide_inst.py).

An instanced scene under "xla", or one without two-level tables (a mesh
built with ``max_leaf_size > 8`` has no wide tables), takes rtjax's
per-instance loop: the base scene, then every instance in turn over the
rays that meet its world box, in its local frame; a mesh with wide tables
keeps the kernels there, one without takes the binary walk.

``with_stats=True`` (``RenderConfig.detailed_stats``) appends the walks'
``(node_steps, leaf_visits)``, summed over every launch of the call
(repass and the per-instance loop: the base launch and every pass or
instance).  Every wide-table kernel (the persist, packet, lane and
two-level kernels, through their stats instances) counts node visits and
leaf rows, the binary walk rtjax's node-pair steps and leaf visits, the
direct path rtjax's ``(0, active rays x triangles)``.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain version for CPU tensors.
"""

from __future__ import annotations

import warnings
from functools import partial

import torch

from ..accel.instancing import apply_affine_point, apply_affine_vector
from ..core import vec
from ..core.geometry import FLT_EPSILON
from ..kernels import lane, persist
from ..kernels.direct import direct_anyhit, direct_closest
from ..kernels.lane import lane_traverse_closest
from ..kernels.persist import (persist_traverse_anyhit,
                               persist_traverse_closest, slab, slab_pre)
from ..kernels.traversal import traverse_anyhit, traverse_closest
from ..kernels.wide import wide_traverse_anyhit, wide_traverse_closest
from ..kernels.wide_inst import (wide_traverse_anyhit_inst,
                                 wide_traverse_closest_inst)
from . import device_loop

_REPASS_BIG = 3.0e38   # rtjax's "no candidate" entry distance


WALKERS = ("auto", "persist", "packet", "lane")
ANYHIT_WALKERS = ("auto", "persist", "packet")


def check_config(scene, cfg) -> None:
    """Raise ValueError for walker values rtjax does not name, and for a
    traversal the scene cannot take (:func:`resolve_mode`)."""
    if cfg.walker not in WALKERS:
        raise ValueError(f"walker must be one of {WALKERS}, got "
                         f"{cfg.walker!r}")
    if cfg.anyhit_walker not in ANYHIT_WALKERS:
        raise ValueError(f"anyhit_walker must be one of {ANYHIT_WALKERS}, "
                         f"got {cfg.anyhit_walker!r}")
    resolve_mode(scene, cfg)


def resolve_mode(scene, cfg) -> str:
    """"pallas" (the wide-table kernels) or "xla" (the binary walk):
    ``cfg.traversal``, "auto" taking the kernels where the scene has wide
    tables.  "pallas" on a scene without them raises ValueError, as
    rtjax's assertion does."""
    mode = cfg.traversal
    if mode == "auto":
        return "pallas" if scene.tables is not None else "xla"
    if mode == "pallas" and scene.tables is None:
        raise ValueError("traversal='pallas' needs wide tables: build the "
                         "scene with max_leaf_size <= 8")
    return mode


def _backend(mesh, cfg, with_stats=False):
    """The ``(closest, anyhit)`` traversal functions of one mesh (the
    scene or a BLAS, with wide tables) on the kernel path, as rtjax's
    ``_backend`` (trace.py:172-234) picks them; with ``with_stats`` they
    return the walk's counts too.  A mesh of at most ``cfg.direct_max_tris``
    triangles takes the direct kernels.  Otherwise the walker decides over
    the mesh's tables.  The persistent walkers take trees whose stack fits
    ``persist.STACK``: "auto" takes them there and the packet kernels
    beyond, and "persist" on a deeper tree warns once and takes the packet
    kernels.  "lane" takes its kernels where a warp's stack fits a block
    (``lane.fits``) and beyond warns once and takes the packet kernels.
    "packet" takes its kernels at any depth.  The any-hit kernel follows
    ``anyhit_walker`` alone ("auto" as "persist").  A warning shows once per
    call site under Python's default filter."""
    kw = _stats_kw(with_stats)
    if mesh.tris.num <= cfg.direct_max_tris:
        return (partial(direct_closest, mesh.tris, **kw),
                partial(direct_anyhit, mesh.tris, **kw))
    tables = mesh.tables
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
    return partial(closest, tables, **kw), partial(anyhit, tables, **kw)


def _stats_kw(with_stats):
    """The wrappers' keyword for counting: none without ``with_stats``,
    so that a wrapper without the argument (a first design rebound in
    these names to time it) takes the default path."""
    return {"with_stats": True} if with_stats else {}


def _binary(mesh, cfg, with_stats=False):
    """The ``(closest, anyhit)`` functions of rtjax's binary walk over a
    mesh's BVH (``mesh.bvh``, ``mesh.tris``: the scene or a BLAS), with
    the kernel path's signatures: closest hit drops u and v, as rtjax's
    ``_backend`` does.  The stack holds ``max(cfg.stack_size, depth +
    1)`` entries."""
    def closest(o, d, tmax, active):
        hit, t, _, _, prim, normal, *st = traverse_closest(
            mesh.bvh, mesh.tris, o, d, tmax, active, cfg.stack_size,
            with_stats)
        return (hit, t, prim, normal, *st)

    return closest, partial(traverse_anyhit, mesh.bvh, mesh.tris,
                            stack_size=cfg.stack_size, with_stats=with_stats)


def _single(mesh, mode, cfg, with_stats=False):
    """The single-level ``(closest, anyhit)`` functions of a mesh (the
    scene or a BLAS) under ``mode``: :func:`_backend` (the direct or the
    walker kernels) where the mode is "pallas" and the mesh has wide tables
    (rtjax's ``mode_k``), else the binary walk."""
    if mode == "pallas" and mesh.tables is not None:
        return _backend(mesh, cfg, with_stats)
    return _binary(mesh, cfg, with_stats)


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


def _repass_setup(grp, o, d):
    """Entry distances ``ent [G, N]`` (0 for origins inside the box) and
    the hit-the-box mask ``ok [G, N]`` of one mesh group's world boxes."""
    entry, exit_ = slab(grp.boxes, *slab_pre(o, d))
    return torch.clamp(entry, min=0.0), (entry <= exit_) & (exit_ >= 0.0)


def _repass_passes(scene, o, d, active, blocked, body):
    """rtjax's repass loop over every mesh group: passes while a ray is
    pending, at most ``G`` for a group of ``G`` instances (rtjax's bound:
    each pass walks one candidate of every pending ray), through
    render/device_loop.py: on the CPU rtjax's loop (stop when no ray is
    pending), on the card ``G`` passes masked outside a capture and a
    while node inside one.  ``pend`` holds the rays whose
    nearest unwalked candidate instance is still admitted by ``blocked()
    -> [G, N] bool`` (False = candidate).  A pass calls ``body(blas,
    pend, src_k, o_l, d_l)`` with the rays in their picked instance's
    frame; the body updates its state in place, and a pass with no
    pending ray leaves it bitwise as it was.  No pass reads the device
    from the host."""
    for grp in scene.instances.groups:
        ent, ok = _repass_setup(grp, o, d)
        walked = torch.zeros_like(ok)
        cand = ok & active[None] & ~blocked(ent)
        pend = cand.any(0)
        blas = scene.blas[grp.mesh_id]
        for _ in device_loop.passes(pend, grp.size):
            pick = torch.argmin(torch.where(cand, ent, _REPASS_BIG), dim=0)
            # pick is 0 where no candidate is left: keep it masked
            walked |= (grp.g_iota == pick[None]) & pend[None]
            rows = grp.inv[pick]
            body(blas, pend, grp.src_of[pick],
                 tuple(c.contiguous() for c in apply_affine_point(rows, o)),
                 tuple(c.contiguous() for c in apply_affine_vector(rows, d)))
            torch.logical_and(ok & ~walked & active[None], ~blocked(ent),
                              out=cand)
            torch.any(cand, 0, out=pend)


def _add(st, more):
    """Sum two ``(node_steps, leaf_visits)`` pairs (None: no counts)."""
    return None if st is None else (st[0] + more[0], st[1] + more[1])


def _repass_closest(scene, cfg, o, d, tmax, active, with_stats=False):
    """Two-level closest hit by multi-pass re-dispatch; the normal is
    LOCAL.  Every launch takes the kernel :func:`_backend` picks for its
    mesh.  Returns ``(hit, t, prim, src, n_l, counts)``, counts summed
    over the launches (None without ``with_stats``).  The passes update
    the base launch's results in place."""
    hit, t, prim, n_l, *st = _backend(scene, cfg, with_stats)[0](
        o, d, tmax, active)
    st = tuple(c.clone() for c in st[0]) if with_stats else None
    t = torch.where(hit, t, tmax)
    hit, prim = hit.clone(), prim.clone()
    n_l = tuple(c.clone() for c in n_l)
    src = torch.zeros_like(prim)

    def merge(blas, pend, src_k, o_l, d_l):
        h2, t2, p2, nl2, *st2 = _backend(blas, cfg, with_stats)[0](
            o_l, d_l, t, pend)
        if with_stats:
            for a, b in zip(st, st2[0]):
                a += b
        closer = h2 & (t2 < t)
        torch.where(closer, t2, t, out=t)
        torch.where(closer, p2, prim, out=prim)
        torch.where(closer, src_k, src, out=src)
        for a, b in zip(n_l, nl2):
            torch.where(closer, b, a, out=a)
        hit.logical_or_(closer)

    _repass_passes(scene, o, d, active, lambda ent: ~(ent < t[None]), merge)
    return hit, t, prim, src, n_l, st


def _repass_anyhit(scene, cfg, o, d, tmax, exclude, active,
                   with_stats=False):
    """Two-level occlusion by multi-pass re-dispatch; the exclusion applies
    in the base scene only, and occluded rays drop out of later passes.
    Every launch takes the kernel :func:`_backend` picks for its mesh.
    Returns ``(occluded, counts)``, counts as in :func:`_repass_closest`."""
    occ = _backend(scene, cfg, with_stats)[1](o, d, tmax, exclude, active)
    st = None
    if with_stats:
        occ, st = occ
        st = tuple(c.clone() for c in st)
    occ = occ.clone()
    no_excl = torch.full_like(exclude, -1)

    def merge(blas, pend, _, o_l, d_l):
        occ_k = _backend(blas, cfg, with_stats)[1](o_l, d_l, tmax, no_excl,
                                                   pend)
        if with_stats:
            occ_k, st2 = occ_k
            for a, b in zip(st, st2):
                a += b
        occ.logical_or_(occ_k)

    _repass_passes(scene, o, d, active,
                   lambda ent: ~(ent < tmax[None]) | occ[None], merge)
    return occ, st


def _world_normal(inst, src, n_l):
    """Local normals to world space by the hit instance's cofactor (base
    hits are already world)."""
    n_w = apply_affine_vector(inst.nrm[torch.clamp(src - 1, min=0).long()],
                              n_l)
    return vec.where(src > 0, n_w, n_l)


def _instance_mask(inst, k, o, d):
    """Which rays meet instance ``k``'s world box: rtjax's slab test, in
    its operation order (``(lo - o) * (1 / d)`` per axis)."""
    lo, hi = inst.aabb_lo[k], inst.aabb_hi[k]
    entry = exit_ = None
    for c in range(3):
        safe = torch.where(torch.abs(d[c]) < FLT_EPSILON,
                           torch.copysign(torch.full_like(d[c],
                                                          FLT_EPSILON), d[c]),
                           d[c])
        inv = 1.0 / safe
        e0 = (lo[c] - o[c]) * inv
        e1 = (hi[c] - o[c]) * inv
        near, far = torch.minimum(e0, e1), torch.maximum(e0, e1)
        entry = near if entry is None else torch.maximum(entry, near)
        exit_ = far if exit_ is None else torch.minimum(exit_, far)
    return entry <= exit_


def _local_rays(inst, k, o, d):
    """Rays in instance ``k``'s local frame (the direction not
    renormalised, so t stays in world units)."""
    rows = inst.inv[k]
    return (tuple(c.contiguous() for c in apply_affine_point(rows, o)),
            tuple(c.contiguous() for c in apply_affine_vector(rows, d)))


def _loop_closest(scene, cfg, mode, o, d, tmax, active, with_stats):
    """rtjax's per-instance loop, closest hit: the base scene, then each
    instance over the rays that meet its world box, each launch pruned by
    the best t so far.  Returns ``(hit, t, prim, src, world normal,
    counts)``."""
    inst = scene.instances
    hit, t, prim, n_w, *st = _single(scene, mode, cfg, with_stats)[0](
        o, d, tmax, active)
    st = st[0] if with_stats else None
    t = torch.where(hit, t, tmax)
    src = torch.zeros_like(prim)
    for k in range(inst.num):
        closest = _single(scene.blas[inst.mesh_id[k]], mode, cfg,
                          with_stats)[0]
        m = active & _instance_mask(inst, k, o, d)
        h2, t2, p2, n2, *st2 = closest(*_local_rays(inst, k, o, d), t, m)
        if with_stats:
            st = _add(st, st2[0])
        closer = h2 & (t2 < t)
        t = torch.where(closer, t2, t)
        prim = torch.where(closer, p2, prim)
        src = torch.where(closer, k + 1, src)
        n_w = vec.where(closer, apply_affine_vector(inst.nrm[k], n2), n_w)
        hit = hit | closer
    return hit, t, prim, src, n_w, st


def _loop_anyhit(scene, cfg, mode, o, d, tmax, exclude, active, with_stats):
    """rtjax's per-instance loop, any hit: the base scene with the
    exclusion, then each instance over the unoccluded rays that meet its
    world box.  Returns ``(occluded, counts)``."""
    inst = scene.instances
    occ = _single(scene, mode, cfg, with_stats)[1](o, d, tmax, exclude,
                                                   active)
    st = None
    if with_stats:
        occ, st = occ
    no_excl = torch.full_like(exclude, -1)
    for k in range(inst.num):
        anyhit = _single(scene.blas[inst.mesh_id[k]], mode, cfg,
                         with_stats)[1]
        m = active & ~occ & _instance_mask(inst, k, o, d)
        occ_k = anyhit(*_local_rays(inst, k, o, d), tmax, no_excl, m)
        if with_stats:
            occ_k, st2 = occ_k
            st = _add(st, st2)
        occ = occ | occ_k
    return occ, st


def _two_level_tables(scene, mode) -> bool:
    """Whether the instanced scene takes repass or the two-level kernels
    (the kernel path and two-level tables) rather than the per-instance
    loop."""
    return mode == "pallas" and scene.inst_tables is not None


def trace_closest(scene, cfg, o, d, tmax, active, with_stats=False):
    """Closest hit over the base scene and every instance: ``(hit, t,
    prim, src, normal)``; t is ``tmax`` on a miss and ``normal`` the world
    unnormalised ``cross(e1, e2)`` of the hit triangle.  ``o`` / ``d`` are
    component triples.  ``with_stats`` appends ``(node_steps,
    leaf_visits)``, summed over the call's launches."""
    mode = resolve_mode(scene, cfg)
    if scene.instances is None:
        hit, t, prim, normal, *st = _single(scene, mode, cfg, with_stats)[
            0](o, d, tmax, active)
        t = torch.where(hit, t, tmax)
        return (hit, t, prim, torch.zeros_like(prim), normal, *st)
    if not _two_level_tables(scene, mode):
        *out, st = _loop_closest(scene, cfg, mode, o, d, tmax, active,
                                 with_stats)
        return tuple(out) + ((st,) if with_stats else ())
    if _resolve_two_level(cfg) == "repass":
        hit, t, prim, src, n_l, st = _repass_closest(scene, cfg, o, d, tmax,
                                                     active, with_stats)
    else:
        hit, t, prim, src, n_l, *st = wide_traverse_closest_inst(
            scene.inst_tables, o, d, tmax, active, **_stats_kw(with_stats))
        st = st[0] if with_stats else None
        t = torch.where(hit, t, tmax)
    out = (hit, t, prim, src, _world_normal(scene.instances, src, n_l))
    return out + ((st,) if with_stats else ())


def trace_anyhit(scene, cfg, o, d, tmax, exclude, active, with_stats=False):
    """Occlusion with a per-lane excluded base-scene (leaf-order) prim;
    ``with_stats`` returns ``(occluded, (node_steps, leaf_visits))``."""
    mode = resolve_mode(scene, cfg)
    if scene.instances is None:
        return _single(scene, mode, cfg, with_stats)[1](o, d, tmax, exclude,
                                                        active)
    if not _two_level_tables(scene, mode):
        occ, st = _loop_anyhit(scene, cfg, mode, o, d, tmax, exclude, active,
                               with_stats)
        return (occ, st) if with_stats else occ
    if _anyhit_two_level(cfg) == "repass":
        occ, st = _repass_anyhit(scene, cfg, o, d, tmax, exclude, active,
                                 with_stats)
        return (occ, st) if with_stats else occ
    return wide_traverse_anyhit_inst(scene.inst_tables, o, d, tmax, exclude,
                                     active, **_stats_kw(with_stats))


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


def gather_hit_materials(scene, src, prim):
    """Material parameters of hits, ``(mtype, albedo [..., 3], ior)``."""
    return scene.materials.gather(_hit_material_index(scene, src, prim))


def gather_hit_materials_v3(scene, src, prim):
    """Material parameters of the hit prims: ``(mtype, albedo, ior)``."""
    return scene.materials.gather_v3(_hit_material_index(scene, src, prim))
