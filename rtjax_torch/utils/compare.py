"""Image comparison metrics: MSE, PSNR and SSIM (a copy of the NumPy code
of rtjax.utils.compare; the port keeps its own so that it never imports
rtjax).  SSIM is Wang et al. 2004 with a uniform window, on luma for RGB
inputs."""

from __future__ import annotations

import numpy as np


def mse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a, b, peak: float = 1.0) -> float:
    m = mse(a, b)
    return float("inf") if m == 0 else float(10 * np.log10(peak * peak / m))


def _uniform_filter(x, w):
    """Mean filter via cumulative sums (valid region only)."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w]
    return s / (w * w)


def ssim(a, b, peak: float = 1.0, window: int = 7) -> float:
    """Mean SSIM over the valid region; RGB inputs are converted to luma."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        lw = np.array([0.299, 0.587, 0.114])
        a = a @ lw
        b = b @ lw
    w = min(window, a.shape[0], a.shape[1])
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _uniform_filter(a, w)
    mu_b = _uniform_filter(b, w)
    var_a = _uniform_filter(a * a, w) - mu_a ** 2
    var_b = _uniform_filter(b * b, w) - mu_b ** 2
    cov = _uniform_filter(a * b, w) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2) /
         ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(np.mean(s))
