"""rtjax_torch — the PyTorch + CUDA port of rtjax, a wavefront path tracer.

The port runs rtjax's main path (scene build, wide BVH tables, the
wavefront engine with NEE + MIS + Russian roulette) in PyTorch, with the
BVH traversal in hand-written CUDA kernels for Hopper (sm_90a).  It
imports torch and never JAX; rtjax stays the reference it is tested
against.
"""

from . import constants  # noqa: F401
from .config import RenderConfig  # noqa: F401
from .render import render_frame, write_ppm  # noqa: F401
from .scene import (Camera, Mesh, Scene, SceneBuilder, Transform,  # noqa: F401
                    load_ply, rotate, scale, translate)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "Camera", "Mesh", "Scene", "SceneBuilder", "Transform",
    "load_ply", "rotate", "scale", "translate", "render_frame", "write_ppm",
    "constants",
]
