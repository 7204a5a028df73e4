"""Cross-cutting utilities: logging, the phase profiler and image
comparison metrics (port of rtjax.utils)."""

from .profiler import Profiler, profiler  # noqa: F401
