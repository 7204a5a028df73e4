"""Render engine: the wavefront integrator, tracing and film."""

from .film import read_ppm, to_u8, write_ppm  # noqa: F401
from .wavefront import (PathState, render_frame, render_frame_linear,  # noqa: F401
                        wavefront_step)
