"""4x4 affine transforms for scene construction (host-side, NumPy).

Port of rtjax.scene.transform: ``Transform.apply`` is one batched
``M @ [v, 1]`` over an ``[N, 3]`` vertex array, in float64.
"""

from __future__ import annotations

import numpy as np


def translate(dx: float, dy: float, dz: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = (dx, dy, dz)
    return m


def scale(sx: float, sy: float, sz: float) -> np.ndarray:
    return np.diag([sx, sy, sz, 1.0]).astype(np.float64)


def rotate(axis, angle_rad: float) -> np.ndarray:
    """Axis-angle rotation (Rodrigues' formula)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    r3 = np.eye(3) + s * k + (1.0 - c) * (k @ k)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r3
    return m


class Transform:
    """Mutable composite transform; ``composite(other)`` applies ``other``
    after the existing chain (``matrix = other @ matrix``)."""

    def __init__(self, matrix: np.ndarray | None = None):
        self.matrix = np.eye(4, dtype=np.float64) if matrix is None \
            else np.asarray(matrix, np.float64)

    def composite(self, other: np.ndarray) -> "Transform":
        self.matrix = np.asarray(other, np.float64) @ self.matrix
        return self

    def apply(self, vertices: np.ndarray) -> np.ndarray:
        v = np.asarray(vertices, np.float64)
        return v @ self.matrix[:3, :3].T + self.matrix[:3, 3]
