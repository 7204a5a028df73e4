"""Checkpoint and resume for long renders (port of
rtjax.render.checkpoint).

A long render runs as a sequence of spp batches; between batches its whole
state is the linear framebuffer and the number of batches done, kept in an
``.npz`` file (keys ``fb``, ``batches_done``, ``seed``, ``batch_spp``,
``fingerprint``, as rtjax writes them), so a killed job resumes from its
last saved batch.  Batches also keep each frame's camera-ray ids within
int32: eval config 5 (1920x1080 @ 1024 spp, 2.1e9 camera rays) renders
only this way.

The fingerprint hashes the image and path-tracing parameters and the bytes
of every scene and camera tensor, so a file from another scene, camera or
configuration is not resumed.  It hashes bytes, not float sums as rtjax
does, so that it is the same on the CPU and on the card and a checkpoint
written on one resumes on the other.  Batch ``b`` draws its random words
from a generator seeded by ``numpy.random.SeedSequence([seed, b])``: the
batches are deterministic and independent, as rtjax's ``fold_in(key, b)``
makes them; parity with rtjax is statistical.

With ``mesh`` (parallel/sharding.py) each batch renders data-parallel over
the mesh's ranks from batch ``b``'s seed, rank 0 alone writes the file, and
every rank returns the same frame.  The file's format does not depend on
the mesh, so a render resumes on another number of ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..utils.log import logger


def _hash_leaves(h, obj, path: str) -> None:
    """Feed every tensor (its dtype, shape and bytes) and every other value
    (its repr) of a nest of dataclasses and tuples to ``h``."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        h.update(repr((path, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.numpy().tobytes())
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _hash_leaves(h, getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            _hash_leaves(h, x, f"{path}[{i}]")
    else:
        h.update(repr((path, obj)).encode())


def render_fingerprint(scene, camera, cfg: RenderConfig) -> str:
    """Hash of everything that must match for sample batches to add up in
    one framebuffer: the image size, the path-tracing parameters and
    estimator, and the scene and camera tensors' contents."""
    h = hashlib.sha256()
    h.update(repr((cfg.width, cfg.height, cfg.max_bounces, cfg.seed,
                   cfg.rr_start, cfg.rr_threshold, cfg.reference_parity,
                   cfg.one_sample_mis)).encode())
    _hash_leaves(h, scene, "scene")
    _hash_leaves(h, camera, "camera")
    return h.hexdigest()


def batch_generator(seed: int, batch: int, device) -> torch.Generator:
    """The random generator of batch ``batch`` of a render seeded
    ``seed``."""
    s = np.random.SeedSequence([seed, batch]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]))


def render_checkpointed(scene, camera, cfg: RenderConfig, path,
                        batch_spp: int | None = None, verbose: bool = True,
                        save_every: int = 4, mesh=None):
    """Render ``cfg.num_samples`` spp in batches of ``batch_spp`` (default
    ``min(num_samples, 64)``), resuming from ``path`` when it holds a
    matching checkpoint and saving there every ``save_every`` batches and
    after the last (``path`` None: no file).  The framebuffer accumulates
    on the scene's device and is read to the host only to be saved; a
    save writes ``path + ".tmp"`` and renames it.  Returns the finished
    gamma-corrected framebuffer ``[H*W, 3]`` on the scene's device.

    With ``mesh`` (a ``parallel.Mesh``) each batch renders through
    ``render_frame_linear_sharded`` (``batch_spp`` must divide by the mesh
    size); rank 0 writes the file, and a barrier after each save holds the
    other ranks until it is in place.

    Only the batch configuration's sizes are read, so a configuration whose
    full ray count overflows int32 renders when its batches fit."""
    from .wavefront import render_frame_linear

    batch_spp = batch_spp or max(1, min(cfg.num_samples, 64))
    if cfg.num_samples % batch_spp:
        raise ValueError(f"batch_spp {batch_spp} does not divide "
                         f"num_samples {cfg.num_samples}")
    step = partial(render_frame_linear, scene, camera)
    writer = True
    if mesh is not None:
        from ..parallel.sharding import Mesh, render_frame_linear_sharded
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        if batch_spp % mesh.size:
            raise ValueError(f"batch_spp {batch_spp} does not divide by the "
                             f"mesh size {mesh.size}")
        step = partial(render_frame_linear_sharded, scene, camera,
                       mesh=mesh)
        writer = mesh.rank == 0
    n_batches = cfg.num_samples // batch_spp
    batch_cfg = dataclasses.replace(cfg, num_samples=batch_spp)
    fp = render_fingerprint(scene, camera, cfg)
    dev = scene.device

    fb = np.zeros((cfg.num_pixels, 3), np.float32)
    start = 0
    if path and os.path.exists(path):
        with np.load(path) as ck:
            if ("fingerprint" in ck and str(ck["fingerprint"]) == fp
                    and int(ck["batch_spp"]) == batch_spp
                    and ck["fb"].shape == fb.shape):
                fb = ck["fb"]
                start = int(ck["batches_done"])
                if verbose:
                    logger.info(f"resuming from {path}: {start}/{n_batches} "
                                "batches")
            elif verbose:
                logger.warning(f"checkpoint {path} does not match this "
                               "render (different scene/camera/config); "
                               "starting fresh")

    fb_dev = torch.tensor(fb, device=dev)
    for b in range(start, n_batches):
        fb_b, stats = step(batch_cfg, batch_generator(cfg.seed, b, dev))
        fb_dev += fb_b
        if path and ((b + 1) % save_every == 0 or b + 1 == n_batches):
            if writer:
                tmp = f"{path}.tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, fb=fb_dev.cpu().numpy(), batches_done=b + 1,
                             seed=cfg.seed, batch_spp=batch_spp,
                             fingerprint=fp)
                os.replace(tmp, path)
            if mesh is not None and mesh.group is not None:
                dist.barrier(group=mesh.group)
        if verbose:
            logger.info(f"batch {b + 1}/{n_batches} done "
                        f"({stats['rays_traced']:.3g} rays)")
    return torch.sqrt(fb_dev / cfg.num_samples)
