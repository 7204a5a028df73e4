"""Render engine: the wavefront integrator, tracing, film and
checkpointed renders."""

import torch

from ..config import RenderConfig
from .checkpoint import render_checkpointed  # noqa: F401
from .film import read_ppm, to_u8, write_ppm  # noqa: F401
from .graph import clear_graphs  # noqa: F401
from .wavefront import (PathState, render_frame, render_frame_linear,  # noqa: F401
                        wavefront_step)


def render(width, height, num_samples, max_bounces, camera, scene,
           seed: int = 1, **config_kwargs):
    """The reference's entry point (render.cuh:366-367): the ``[height *
    width, 3]`` float32 framebuffer, gamma-2 corrected, on the scene's
    device.  Extra keyword arguments go to RenderConfig.  Samples are drawn
    from a ``torch.Generator`` on that device seeded ``seed``: the same
    image as rtjax's ``render`` in distribution, not in its bits."""
    cfg = RenderConfig(width=width, height=height, num_samples=num_samples,
                       max_bounces=max_bounces, seed=seed, **config_kwargs)
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    fb, _ = render_frame(scene, camera, cfg, gen)
    return fb
