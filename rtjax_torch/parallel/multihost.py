"""Multi-process start-up (port of rtjax.parallel.multihost).

rtjax joins one process per host into JAX's distributed runtime, so that
one mesh spans every host's chips.  The port runs one process per GPU and
joins them into a ``torch.distributed`` process group; the sample-space
sharding (parallel/sharding.py) then spans the group, and the frame's
one collective, the framebuffer's all-reduce, runs over NVLink within a
host and the network across hosts.  Nothing in the render path knows about
hosts.

Usage (one call per process, before the scene is built)::

    from rtjax_torch.parallel import init_multihost, make_mesh
    from rtjax_torch.parallel import render_frame_sharded
    device = init_multihost("host0:29500", num_processes=N, process_id=r)
    mesh = make_mesh(device)
    fb, stats = render_frame_sharded(scene, cam, cfg, generator, mesh)

or, under ``torchrun`` (``python -m torch.distributed.run``), which sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, :func:`init_from_env`.  Every process returns the same
reduced framebuffer, so any one of them can write the image.

The backend is chosen, never switched: NCCL for CUDA devices, gloo for the
CPU, or the one the caller names.  A backend that fails to start raises;
nothing retries with another.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """The process group's backend for ``device``: "nccl" for a CUDA
    device, "gloo" for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type {kind!r}")


def _join(device, backend, **kw) -> torch.device:
    """``init_process_group`` on ``backend`` (default
    :func:`default_backend` of ``device``); an NCCL group is bound to
    ``device``.  Returns ``device``."""
    backend = backend or default_backend(device)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, **kw)
    return device


def _bind(device, process_id: int) -> torch.device:
    """The device this process renders on: ``cuda:<local rank>`` for CUDA
    (local rank = ``LOCAL_RANK`` when set, else ``process_id`` modulo the
    visible cards), made the current device; the CPU as given."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; pass device='cpu' to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK",
                               process_id % torch.cuda.device_count()))
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str | None = None,
                   device=None) -> torch.device:
    """Join this process to a process group of ``num_processes`` as rank
    ``process_id``, meeting the others at ``coordinator``
    (``"host:port"``, a TCP rendezvous).  ``device`` defaults to ``cuda``
    and ``backend`` to :func:`default_backend` of it.  Returns the device
    this process renders on (:func:`_bind`)."""
    return _join(_bind(device or "cuda", process_id), backend,
                 init_method=f"tcp://{coordinator}",
                 world_size=num_processes, rank=process_id)


def init_from_env(device=None, backend: str | None = None) -> torch.device:
    """Join the process group that ``torchrun``'s variables describe
    (``init_method="env://"``): ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT`` and, for CUDA, ``LOCAL_RANK``.  Returns the device this
    process renders on."""
    return _join(_bind(device or "cuda", int(os.environ["RANK"])), backend,
                 init_method="env://")


def process_info():
    """``(rank, world size, local device count)`` after start-up: the
    CUDA devices this process sees, 1 without any."""
    return (dist.get_rank(), dist.get_world_size(),
            torch.cuda.device_count() or 1)
