"""MVTec-AD super-resolution / denoising datasets.

A copy of `localdiffusion_tpu/data/mvtec.py` (numpy; PIL imported where an
image is decoded), kept here because the port imports nothing of the JAX
package.  Equivalent of reference data.py:202-325 (MvtecDatasetSR and variants):
RGB images resized to 112 (or 224), value-scaled ×2 into [0, 2]; the
conditioning image is either the SR degradation (nearest ×0.5 down then
bilinear up, data.py:296-301) or salt-and-pepper noise (data.py:248-277).
Returns (img, img_down, label, defect_name) like the reference.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from localdiffusion_tpu_torch.data.mnist import _bilinear_resize


def _load_rgb(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0  # HWC in [0,1]


def sr_degrade(img: np.ndarray) -> np.ndarray:
    """Nearest ×0.5 downsample then bilinear upsample (data.py:296-301).

    Pure-numpy host path (the input pipeline never touches the accelerator).
    """
    h, w, c = img.shape
    down = img[::2, ::2]  # nearest with aligned grid
    up = np.stack(
        [_bilinear_resize(down[..., k], (h, w)) for k in range(c)], axis=-1
    )
    return up.astype(np.float32)


def salt_and_pepper(
    img: np.ndarray, amount: float = 0.02, ratio: float = 0.5, seed: int = 0
) -> np.ndarray:
    """Salt-and-pepper noise on an HWC RGB image (data.py:248-277)."""
    rng = np.random.default_rng(seed)
    out = img.copy()
    hw = img.shape[0] * img.shape[1]
    num = int(amount * hw)
    num_salt = int(round(num * ratio))
    flat = out.reshape(-1, img.shape[2])
    salt_idx = rng.permutation(hw)[:num_salt]
    pepper_idx = rng.permutation(hw)[: num - num_salt]
    flat[salt_idx] = 1.0
    flat[pepper_idx] = 0.0
    return out


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma (reference RGB2Gray, data.py:231-233)."""
    return img[..., :3] @ np.asarray([0.2989, 0.5870, 0.1140], np.float32)


def select_patch(img: np.ndarray, img_down: np.ndarray, rng):
    """Random patch masking for mask-training mode (data.py:235-246):
    zero everything outside a random box, return the box mask."""
    size = img.shape[0]
    hw = rng.integers(size // 4, size // 2, 2)
    y = int(rng.integers(0, size - hw[0] - 1))
    x = int(rng.integers(0, size - hw[1] - 1))
    out = np.zeros_like(img)
    out_down = np.zeros_like(img_down)
    mask = np.zeros((*img.shape[:2], 1), np.float32)
    out[y : y + hw[0], x : x + hw[1]] = img[y : y + hw[0], x : x + hw[1]]
    out_down[y : y + hw[0], x : x + hw[1]] = img_down[y : y + hw[0], x : x + hw[1]]
    mask[y : y + hw[0], x : x + hw[1]] = 1.0
    return out, out_down, mask


class MvtecDatasetSR:
    """File selection mirrors reference data.py:202-227: train keeps 'good'
    only; test filters by defect names in `mode` (None = all).

    mask_train=True returns (img, img_down, box_mask) patch triples
    (data.py:309-311); gray=True converts to single-channel luma
    (the MvtecDatasetGray variant, data.py:231-233).
    """

    def __init__(
        self,
        files: Sequence[str],
        train: bool = False,
        mode: Optional[Sequence[str] | str] = None,
        max_num: Optional[int] = None,
        denoise: bool = False,
        size: int = 112,
        mask_train: bool = False,
        gray: bool = False,
        seed: int = 0,
    ):
        self.train = train
        self.denoise = denoise
        self.size = size
        self.mask_train = mask_train
        self.gray = gray
        self._rng = np.random.default_rng(seed)
        self.items: List[str] = []
        for f in files:
            if train:
                if "good" in f:
                    self.items.append(f)
            else:
                if mode is None:
                    self.items.append(f)
                elif os.path.basename(os.path.dirname(f)) in mode:
                    self.items.append(f)
            if max_num is not None and len(self.items) == max_num:
                break

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        path = self.items[idx]
        img = _load_rgb(path, self.size)
        if self.gray:
            img = rgb_to_gray(img)[..., None]
        defect = os.path.basename(os.path.dirname(path))
        if self.denoise:
            down = salt_and_pepper(img, seed=0 if not self.train else idx)
            img2, down2 = img * 2.0, down * 2.0
        else:
            img2 = img * 2.0  # [0, 2] range (data.py:294-297)
            down2 = sr_degrade(img2)
        if self.mask_train:
            img2, down2, mask = select_patch(img2, down2, self._rng)
            return img2.astype(np.float32), down2.astype(np.float32), mask
        label = 0 if "good" in path else 1
        return (
            img2.astype(np.float32),
            down2.astype(np.float32),
            label,
            defect,
        )

    def as_arrays(self):
        hs, ls, ys, ds = zip(*(self[i] for i in range(len(self))))
        return np.stack(hs), np.stack(ls), np.asarray(ys), list(ds)
