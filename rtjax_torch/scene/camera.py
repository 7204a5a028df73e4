"""Pinhole camera (port of rtjax.scene.camera).

The precompute is done in float32 NumPy exactly as rtjax does it, including
the negated ``vertical`` so that image-space y grows downward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import vec


@dataclasses.dataclass(frozen=True)
class Camera:
    lookfrom: torch.Tensor    # [3] float32
    upper_left: torch.Tensor  # [3]
    horizontal: torch.Tensor  # [3]
    vertical: torch.Tensor    # [3]

    @staticmethod
    def make(lookfrom, lookat, up, vfov_deg: float, aspect_ratio: float,
             device) -> "Camera":
        lookfrom = np.asarray(lookfrom, np.float32)
        lookat = np.asarray(lookat, np.float32)
        up = np.asarray(up, np.float32)

        viewport_height = 2.0 * math.tan(math.radians(float(vfov_deg)) * 0.5)
        viewport_width = viewport_height * float(aspect_ratio)

        w = lookfrom - lookat
        w = w / np.linalg.norm(w)
        v = up - np.dot(up, w) * w
        v = v / np.linalg.norm(v)
        u = np.cross(v, w)

        horizontal = np.float32(viewport_width) * u
        vertical = np.float32(-viewport_height) * v  # y grows downward
        upper_left = lookfrom - w - 0.5 * horizontal - 0.5 * vertical
        return Camera.from_arrays(dict(
            lookfrom=lookfrom, upper_left=upper_left, horizontal=horizontal,
            vertical=vertical), device)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "Camera":
        """Camera from its four ``[3]`` vectors (e.g. an rtjax camera's
        fields as numpy arrays)."""
        t = lambda k: torch.tensor(np.asarray(arrays[k], np.float32),
                                   device=device)
        return Camera(lookfrom=t("lookfrom"), upper_left=t("upper_left"),
                      horizontal=t("horizontal"), vertical=t("vertical"))

    def get_rays_v3(self, x, y):
        """Rays through normalized image coordinates ``x, y`` in [0, 1):
        ``(origin, unit_dir)`` as component triples."""
        d = tuple(self.upper_left[k] + x * self.horizontal[k]
                  + y * self.vertical[k] - self.lookfrom[k]
                  for k in range(3))
        d = vec.normalize(d)
        origin = tuple(self.lookfrom[k].expand(d[0].shape) for k in range(3))
        return origin, d
