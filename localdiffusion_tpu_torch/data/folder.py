"""Generic folder-of-images dataset (reference Dataset, ddpm.py:1218-1248).

A copy of `localdiffusion_tpu/data/folder.py` (numpy; PIL imported where an
image is decoded), kept here because the port imports nothing of the JAX
package.

Globs image files under a folder, resize → center-crop → [0,1] float NHWC.
The catch-all loader for ad-hoc image folders (the reference's oct/imagenet
config paths point at trees like this).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from localdiffusion_tpu_torch.data.brats import _center_crop_np


class ImageFolderDataset:
    def __init__(
        self,
        folder: str,
        image_size: int,
        exts: Sequence[str] = ("jpg", "jpeg", "png", "tiff"),
        convert: Optional[str] = "RGB",  # None keeps source mode
        horizontal_flip: bool = False,
        seed: int = 0,
    ):
        self.paths: List[str] = [
            str(p) for ext in exts for p in Path(folder).glob(f"**/*.{ext}")
        ]
        self.image_size = image_size
        self.convert = convert
        self.flip = horizontal_flip
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.paths[idx])
        if self.convert and img.mode != self.convert:
            img = img.convert(self.convert)
        # torchvision T.Resize(size) semantics: shorter side → size
        w, h = img.size
        if w < h:
            nw, nh = self.image_size, int(round(h * self.image_size / w))
        else:
            nh, nw = self.image_size, int(round(w * self.image_size / h))
        img = img.resize((nw, nh), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.flip and self._rng.random() < 0.5:
            arr = arr[:, ::-1]
        return _center_crop_np(arr, (self.image_size, self.image_size))

    def as_arrays(self) -> np.ndarray:
        return np.stack([self[i] for i in range(len(self))])
