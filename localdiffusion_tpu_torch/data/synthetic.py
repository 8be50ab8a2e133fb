"""Synthetic datasets for tests and for environments without the real data.

A copy of `localdiffusion_tpu/data/synthetic.py` (numpy only), kept here
because the port imports nothing of the JAX package: MNIST-like digit blobs,
BRATS-like brain slices with optional "tumour" (locally-OOD) insertions, and
texture tiles with defects.  The 256px Stage A builds its calibration bank
from normal brains and is checked on tumour brains.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def synthetic_digits(
    n: int = 64, size: int = 28, seed: int = 0, digit: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Blobby digit-like images in [0, 255] uint8 + labels."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, size, size), np.float32)
    labels = np.zeros((n,), np.int64)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        d = digit if digit is not None else int(rng.integers(0, 10))
        labels[i] = d
        # deterministic per-digit stroke pattern: a ring + d radial spokes
        cy, cx = size / 2 + rng.normal(0, 1), size / 2 + rng.normal(0, 1)
        r = size / 3.2 + rng.normal(0, 0.5)
        dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        ring = np.exp(-((dist - r) ** 2) / 4.0)
        ang = np.arctan2(yy - cy, xx - cx)
        spokes = np.maximum(0.0, np.cos((d + 1) * ang)) ** 8 * np.exp(
            -(dist**2) / (2 * r**2)
        )
        img = np.clip(ring + spokes, 0, 1)
        imgs[i] = img * 255.0
    return imgs.astype(np.uint8), labels


def synthetic_brain_pair(
    n: int = 8,
    size: int = 64,
    seed: int = 0,
    tumor: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t1, flair, seg) NHWC float32 triplets mimicking BRATS slices.

    t1 and flair are smooth elliptical 'brains' with different contrast
    curves; `tumor=True` adds a bright localized lesion to t1 only (the
    locally-OOD content) and marks it in seg.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    t1s, flairs, segs = [], [], []
    for i in range(n):
        cy, cx = size / 2 + rng.normal(0, 2), size / 2 + rng.normal(0, 2)
        ry, rx = size / 2.6 + rng.normal(0, 1), size / 3.0 + rng.normal(0, 1)
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        brain = np.clip(1.0 - d, 0, 1)
        texture = 0.15 * np.sin(yy / 3 + i) * np.sin(xx / 4)
        t1 = (brain**0.7 + texture * brain) * 1000.0
        flair = (brain**1.6 - texture * brain) * 800.0
        seg = np.zeros((size, size), np.float32)
        if tumor:
            ty = int(rng.integers(size // 4, 3 * size // 4))
            tx = int(rng.integers(size // 4, 3 * size // 4))
            tr = size / 10
            td = np.sqrt((yy - ty) ** 2 + (xx - tx) ** 2)
            lesion = np.exp(-(td**2) / (2 * tr**2))
            t1 = t1 + lesion * 1500.0
            seg = (lesion > 0.3).astype(np.float32)
        t1s.append(t1[..., None])
        flairs.append(flair[..., None])
        segs.append(seg[..., None])
    return (
        np.stack(t1s).astype(np.float32),
        np.stack(flairs).astype(np.float32),
        np.stack(segs).astype(np.float32),
    )


def synthetic_brain_translation(
    n: int,
    size: int,
    tumor: bool,
    seed: int,
    mean_t1: float = 300.0,
    std_t1: float = 350.0,
    mean_flair: float = 250.0,
    std_flair: float = 280.0,
    translate_zero: bool = True,
):
    """(hr=flair, lr_cond=t1, seg) normalized like the BRATS pipeline
    (z-score per modality + translate_zero shift, data.py:400-410)."""
    t1, flair, seg = synthetic_brain_pair(n, size=size, seed=seed, tumor=tumor)

    def norm(img, mean, std):
        out = (img - mean) / std
        if translate_zero:
            out = out + np.abs(out.min(axis=(1, 2, 3), keepdims=True))
        return out.astype(np.float32)

    return norm(flair, mean_flair, std_flair), norm(t1, mean_t1, std_t1), seg


def synthetic_textures(
    n: int = 64,
    size: int = 64,
    seed: int = 0,
    defect: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB texture tiles (stripes+grid like MVTec 'grid'/'carpet') in [0, 1],
    with optional localized defects (the OOD content), plus defect masks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.zeros((n, size, size, 3), np.float32)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi)
        freq = rng.uniform(0.5, 0.9)
        base = 0.5 + 0.25 * np.sin(freq * xx + phase) + 0.15 * np.sin(
            freq * 0.8 * yy - phase
        )
        tex = np.stack([base, base * 0.9 + 0.05, base * 0.8 + 0.1], axis=-1)
        tex += rng.normal(0, 0.02, tex.shape)
        if defect:
            dy = int(rng.integers(size // 5, 4 * size // 5))
            dx = int(rng.integers(size // 5, 4 * size // 5))
            r = size // 10
            dd = (yy - dy) ** 2 + (xx - dx) ** 2 < r * r
            tex[dd] = rng.uniform(0.0, 0.15)  # dark blotch defect
            masks[i, dd, 0] = 1.0
        imgs[i] = np.clip(tex, 0, 1)
    return imgs, masks
