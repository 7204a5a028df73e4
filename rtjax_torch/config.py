"""Render configuration: the same fields, defaults and derived sizes as
:class:`rtjax.config.RenderConfig`.

The fields that select TPU-specific behaviour are kept so that one
configuration means the same workload in both packages.
``direct_max_tris`` is rtjax's gate for tiny meshes: on the kernel path a
single-level launch over a mesh of at most that many triangles takes the
direct all-triangles kernels (kernels/direct.py) instead of a BVH walk; 0
disables it (render/trace.py).  A value that names no mode of
rtjax's (``traversal``, ``sort_key``, ``two_level``, ``two_level_anyhit``)
raises ValueError here; the engine (render/wavefront.py) raises ValueError
for combinations that exclude each other.
"""

from __future__ import annotations

import dataclasses

from . import constants


# "pallas": the traversal kernels over the wide tables; "xla": rtjax's
# binary-BVH walk; "auto": the kernels where the scene has wide tables
TRAVERSALS = ("auto", "pallas", "xla")
# rtjax's seven sort keys (render/sorting.py)
SORT_KEYS = ("morton", "morton_pos", "morton_pos10", "prim", "prim_pos",
             "normal_pos", "adaptive")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 600
    height: int = 600
    num_samples: int = 10
    max_bounces: int = 10
    # pool size; None adapts to the workload (see pool_size)
    num_working_paths: int | None = None
    rr_start: int = constants.RR_START
    rr_threshold: float = constants.RR_THRESHOLD
    seed: int = constants.RAND_SEED
    stack_size: int = constants.BVH_MAX_DEPTH
    traversal: str = "auto"
    walker: str = "auto"
    anyhit_walker: str = "auto"
    direct_max_tris: int = 64
    sort_rays: bool = True
    # 0 = auto: every 2nd iteration on scenes of <= 1024 triangles, else 1
    sort_every: int = 0
    two_level: str = "auto"
    two_level_anyhit: str = "auto"
    sort_key: str = "morton_pos"
    # "auto" = blocked 16x16 screen order at <= 8 spp, scanline above
    camera_order: str = "auto"
    max_iterations: int | None = None
    shade_chunks: int | str = "auto"
    one_sample_mis: bool = False
    detailed_stats: bool = False
    reference_parity: bool = False

    def __post_init__(self):
        for name, names in (("traversal", TRAVERSALS),
                            ("sort_key", SORT_KEYS)):
            if getattr(self, name) not in names:
                raise ValueError(f"{name} must be one of {names}, got "
                                 f"{getattr(self, name)!r}")
        if self.sort_every < 0:
            raise ValueError(
                f"sort_every must be >= 0 (0 = auto), got {self.sort_every}")
        for name in ("two_level", "two_level_anyhit"):
            if getattr(self, name) not in ("auto", "kernel", "repass"):
                raise ValueError(f"{name} must be 'auto', 'kernel' or "
                                 f"'repass', got {getattr(self, name)!r}")

    @property
    def shade_chunks_effective(self) -> int:
        if self.shade_chunks == "auto":
            return 1 if self.total_camera_rays >= 16 * self.pool_size else 8
        return self.shade_chunks

    @property
    def pool_size(self) -> int:
        """Explicit ``num_working_paths`` wins; otherwise the largest power
        of two with at least ~16 pool refills, clamped to [2^17, 2^19]."""
        if self.num_working_paths is not None:
            return self.num_working_paths
        n = 1 << 17
        while n < (1 << 19) and n * 16 < self.total_camera_rays:
            n <<= 1
        return n

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def total_camera_rays(self) -> int:
        n = self.num_pixels * self.num_samples
        # camera-ray ids are int32 on the device
        if n >= 2 ** 31:
            raise ValueError(
                f"{n} camera rays overflow int32 ray ids; render fewer "
                "samples per frame")
        return n
