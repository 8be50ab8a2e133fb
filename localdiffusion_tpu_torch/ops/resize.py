"""Image resize / crop / blur primitives.  Port of
`localdiffusion_tpu/ops/resize.py`.

Images are NHWC (or HWC) at every function's boundary, as in the JAX
package.  `jax.image.resize` samples at half-pixel centres, which is
`F.interpolate(..., align_corners=False)`; on a shrink it also antialiases
(a triangle filter stretched by the scale, its weights renormalised over the
pixels inside the image), which is `antialias=True`.  Nearest-neighbour
resizing takes source pixel floor((i + 0.5)·in/out), computed in float32
as the JAX function computes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images to `size` = (H, W)."""
    single = x.ndim == 3
    if single:
        x = x[None]
    size = (int(size[0]), int(size[1]))
    shrink = size[0] < x.shape[1] or size[1] < x.shape[2]
    out = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=False, antialias=shrink).permute(0, 2, 3, 1)
    return out[0] if single else out


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC (or HWC) images to `size`."""
    off = 1 if x.ndim == 4 else 0
    for axis, n in ((off, int(size[0])), (off + 1, int(size[1]))):
        m = x.shape[axis]
        if m == n:
            continue
        # XLA folds JAX's `(i + 0.5) * m / n` into one float32 factor,
        # m·(1/n), and so does this (the same index for every m, n)
        step = np.float32(m) * (np.float32(1) / np.float32(n))
        src = np.floor((np.arange(n, dtype=np.float32) + np.float32(0.5)) * step)
        src = src.astype(np.int64)
        x = x.index_select(axis, torch.as_tensor(src, device=x.device))
    return x


def center_crop(x: torch.Tensor, size) -> torch.Tensor:
    """Center crop NHWC (or HWC) to (H, W), zero-padding if smaller
    (torchvision CenterCrop semantics)."""
    off = 1 if x.ndim == 4 else 0
    h, w = x.shape[off], x.shape[off + 1]
    th, tw = size
    pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
    if pad_h or pad_w:
        # F.pad lists the last dimension first: C, then W, then H
        x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        h, w = x.shape[off], x.shape[off + 1]
    # torchvision rounds the crop origin like round((h - th) / 2)
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return x.narrow(off, i, th).narrow(off + 1, j, tw)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, radius: int) -> np.ndarray:
    """Source index of each of n + 2·radius reflect-padded positions
    (numpy's 'reflect': the edge is not repeated; any radius)."""
    i = np.arange(-radius, n + radius)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


def gaussian_blur(x: torch.Tensor, sigma: float, kernel_size: int | None = None):
    """Separable gaussian blur over NHWC (or HWC) images, reflect padding,
    float32 out.  kernel_size defaults to 2·ceil(4σ)+1 (kornia convention);
    the radius is kernel_size // 2.

    Each axis sums its taps one at a time in tap order, as the JAX package
    does: elementwise float32 products and sums, so the result is the same
    on every device and TF32 never enters."""
    radius = int(math.ceil(4.0 * sigma)) if kernel_size is None else kernel_size // 2
    k = gaussian_kernel1d(sigma, radius)
    off = 1 if x.ndim == 4 else 0
    out = x.float()
    for axis in (off, off + 1):
        n = out.shape[axis]
        idx = torch.as_tensor(_reflect_index(n, radius), device=out.device)
        padded = out.index_select(axis, idx)
        acc = torch.zeros_like(out)
        for i in range(2 * radius + 1):
            acc = acc + float(k[i]) * padded.narrow(axis, i, n)
        out = acc
    return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """transforms.Normalize(ImageNet mean/std) on NHWC RGB in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
