"""Film: framebuffer -> 8-bit image and PPM files (port of
rtjax.render.film).  Quantisation is the reference's exact rule
``clamp(int(256 * c), 0, 255)``."""

from __future__ import annotations

import numpy as np


def to_u8(framebuffer, width: int, height: int) -> np.ndarray:
    """Quantize a ``[H*W, 3]`` (or ``[H, W, 3]``) float framebuffer."""
    fb = np.asarray(framebuffer, np.float32).reshape(height, width, 3)
    return np.clip((256.0 * fb).astype(np.int32), 0, 255).astype(np.uint8)


def write_ppm(path, framebuffer, width: int, height: int,
              binary: bool = False) -> None:
    """Row-major, top-to-bottom PPM: ASCII P3 by default, P6 with
    ``binary=True``."""
    img = to_u8(framebuffer, width, height)
    if binary:
        with open(path, "wb") as f:
            f.write(f"P6\n{width} {height}\n255\n".encode())
            f.write(img.tobytes())
        return
    with open(path, "w") as f:
        f.write(f"P3\n{width} {height}\n255\n")
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in img.reshape(-1, 3)))
        f.write("\n")


def read_ppm(path) -> np.ndarray:
    """Read a P3 or P6 PPM into a ``[H, W, 3]`` uint8 array."""
    with open(path, "rb") as f:
        if f.read(2) == b"P6":
            header = []
            while len(header) < 3:
                line = f.readline()
                if not line.startswith(b"#"):
                    header.extend(line.split())
            w, h, maxv = (int(x) for x in header)
            if maxv != 255:
                raise ValueError(f"unsupported PPM max value {maxv}")
            data = np.frombuffer(f.read(w * h * 3), np.uint8)
            return data.reshape(h, w, 3).copy()
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError("not a P3 or P6 PPM file")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxv != 255:
        raise ValueError(f"unsupported PPM max value {maxv}")
    data = np.array(tokens[4:4 + w * h * 3], np.int32)
    return data.reshape(h, w, 3).astype(np.uint8)
