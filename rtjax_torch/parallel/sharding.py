"""Multi-device rendering: sample-space sharding over a process group
(port of rtjax.parallel.sharding).

rtjax splits the sample space over a device mesh: each device renders
``num_samples / D`` spp of the whole image from a random stream folded
with its index, against a replicated scene and camera, and the devices'
linear framebuffers are combined by one ``psum``, the frame's only
collective.  The port keeps the design with one process per device and a
``torch.distributed`` process group as the mesh: each rank renders its
share through the single-device engine (render/wavefront.py), then one
``all_reduce(SUM)`` combines the framebuffers, beside the sum of
``rays_traced`` and the maximum of ``iterations`` (the slowest rank's).
All three reductions run on the rank's device, once a frame.

Rank r draws its random words from :func:`rank_generator`: rank 0 from the
caller's generator's seed itself, so a world of one renders exactly what
the unsharded call renders; rank r > 0 from a generator seeded by
``numpy.random.SeedSequence([seed, r])``, as render/checkpoint.py seeds
its batches.  The ranks' samples are independent, and the reduced frame
is a Monte Carlo estimate of the same image; parity with rtjax, whose
devices fold their index into a JAX key, is statistical.

``cfg.num_working_paths`` stays the per-rank pool, as in rtjax.

The collectives take the group's backend as it was chosen
(parallel/multihost.py): NCCL for CUDA tensors, gloo for CPU tensors or
for CUDA tensors in a group the caller started on gloo.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..render.checkpoint import batch_generator


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The port's 1-D mesh: a process group (None for a world of one with
    no group), its size, this process's rank in it and the device it
    renders on."""
    group: object
    size: int
    rank: int
    device: torch.device


def _device(device) -> torch.device:
    """``device`` (default ``cuda``; a bare ``cuda`` is the current card),
    refusing CUDA without a card."""
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: torch.cuda.is_available() "
                               "is False; pass device='cpu' to render on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of ``group``, or of the default process group when one is
    initialised; without one, a world of one.  ``device`` is where this
    process renders (default ``cuda``)."""
    device = _device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 1, 0, device)
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group),
                device)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The random generator of rank ``rank`` in a frame seeded ``seed``:
    ``seed`` itself for rank 0, beyond it ``SeedSequence([seed, rank])``
    (``batch_generator``'s rule)."""
    if rank:
        return batch_generator(seed, rank, device)
    return torch.Generator(device=device).manual_seed(seed)


def render_frame_linear_sharded(scene, camera, cfg: RenderConfig,
                                generator: torch.Generator,
                                mesh: Mesh | None = None):
    """Render one frame data-parallel across ``mesh`` (default
    :func:`make_mesh` on the scene's device): ``(fb_sum [H*W, 3],
    {"iterations", "rays_traced"})``, the all-reduced LINEAR sample-sum
    framebuffer on every rank (not normalised, no gamma).
    ``cfg.num_samples`` is the total spp and must divide by the mesh size;
    ``cfg.num_working_paths`` is the per-rank pool.  Only ``generator``'s
    seed (``initial_seed()``) is read: each rank draws from
    :func:`rank_generator`.  With a group (of any size, one included) the
    reductions run through it; with none they are skipped."""
    from ..render.wavefront import render_frame_linear

    if mesh is None:
        mesh = make_mesh(scene.device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if cfg.num_samples % mesh.size:
        raise ValueError(f"num_samples={cfg.num_samples} must divide by the "
                         f"mesh size {mesh.size}")
    if torch.device(mesh.device) != scene.device:
        raise ValueError(f"the mesh renders on {mesh.device}, the scene is "
                         f"on {scene.device}")
    local = dataclasses.replace(cfg, num_samples=cfg.num_samples // mesh.size)
    gen = rank_generator(generator.initial_seed(), mesh.rank, scene.device)
    fb, stats = render_frame_linear(scene, camera, local, gen)
    if mesh.group is None:
        return fb, {"iterations": stats["iterations"],
                    "rays_traced": stats["rays_traced"]}
    rays = torch.tensor(stats["rays_traced"], dtype=torch.float64,
                        device=fb.device)
    iters = torch.tensor(stats["iterations"], dtype=torch.int64,
                         device=fb.device)
    dist.all_reduce(fb, dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(rays, dist.ReduceOp.SUM, group=mesh.group)
    dist.all_reduce(iters, dist.ReduceOp.MAX, group=mesh.group)
    return fb, {"iterations": int(iters), "rays_traced": float(rays)}


def render_frame_sharded(scene, camera, cfg: RenderConfig,
                         generator: torch.Generator,
                         mesh: Mesh | None = None):
    """Render one frame data-parallel across ``mesh``: the reduced
    framebuffer after the sqrt(mean) gamma-2 post-process, applied once
    over the total spp, and stats; see
    :func:`render_frame_linear_sharded`."""
    fb_sum, stats = render_frame_linear_sharded(scene, camera, cfg,
                                                generator, mesh)
    return torch.sqrt(fb_sum / cfg.num_samples), stats
