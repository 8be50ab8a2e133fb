"""Fidelity metrics: MSE, PSNR, SSIM.  Port of `localdiffusion_tpu/utils/metrics.py`.

Images are NHWC.  SSIM uses an 11×11 gaussian window (σ = 1.5), K1 = 0.01,
K2 = 0.03, over the valid region.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(a, b):
    return torch.mean((a.float() - b.float()) ** 2)


def psnr(a, b, data_range: float = 2.0):
    return 10.0 * torch.log10((data_range**2) / mse(a, b).clamp_min(1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(xs**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a, b, data_range: float = 2.0, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over the batch; NaN for an image smaller than the window
    (no valid position), as in the JAX package."""
    a = a.float()
    b = b.float()
    if a.ndim == 3:
        a, b = a[None], b[None]
    if min(a.shape[1], a.shape[2]) < window_size:
        return torch.tensor(float("nan"), device=a.device)
    a = a.permute(0, 3, 1, 2)
    b = b.permute(0, 3, 1, 2)
    c = a.shape[1]
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=a.device)
    kern = win[None, None].repeat(c, 1, 1, 1)  # depthwise, one window per channel

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    va = filt(a * a) - mu_a**2
    vb = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return (num / den).mean(dim=(1, 2, 3)).mean()
