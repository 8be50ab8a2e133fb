"""MNIST dataset: IDX parsing + the reference's translation pairs.

A copy of `localdiffusion_tpu/data/mnist.py` (numpy only), kept here because
the port imports nothing of the JAX package.  Equivalent of reference
data.py:746-836 (MNIST Dataset) without the idx2numpy dependency.
Produces NHWC float32 numpy arrays: (hr, lr, label) where hr ∈ [0, 2]
(normalize 2·x/255, data.py:808-809) and lr is the degraded conditioning
image.

Degradation parity note (data.py:825-827): the reference indexes the 4-D
tensor [1,1,28,28] with [:, ::2, ::2], striding dims 1 and 2 — i.e. an
H-only ×2 subsample — then bilinear-resizes back to 28×28.  That quirk is
the default (`lr_mode='h_only'`); `lr_mode='full'` gives the presumably
intended H+W subsample.
"""

from __future__ import annotations

import gzip
import os
import struct as _struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX (ubyte) file, transparently handling .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path, opener = path + ".gz", gzip.open
    with opener(path, "rb") as f:
        data = f.read()
    zero1, zero2, dtype_code, ndim = _struct.unpack(">BBBB", data[:4])
    if zero1 != 0 or zero2 != 0:
        raise ValueError(f"{path}: not an IDX file")
    dims = _struct.unpack(">" + "I" * ndim, data[4 : 4 + 4 * ndim])
    dtype = {
        0x08: np.uint8,
        0x09: np.int8,
        0x0B: np.int16,
        0x0C: np.int32,
        0x0D: np.float32,
        0x0E: np.float64,
    }[dtype_code]
    arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder(">"),
                        offset=4 + 4 * ndim)
    return arr.reshape(dims).astype(dtype)


def _bilinear_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize with half-pixel centers (torch align_corners=False).

    img: [H, W] float32 → [size] float32.
    """
    h, w = img.shape
    oh, ow = size
    if (h, w) == (oh, ow):
        return img
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - np.floor(ys), 0.0, 1.0)
    wy = np.where(ys < 0, 0.0, wy)
    wx = np.clip(xs - np.floor(xs), 0.0, 1.0)
    wx = np.where(xs < 0, 0.0, wx)
    top = img[y0][:, x0] * (1 - wx)[None, :] + img[y0][:, x1] * wx[None, :]
    bot = img[y1][:, x0] * (1 - wx)[None, :] + img[y1][:, x1] * wx[None, :]
    return (top * (1 - wy)[:, None] + bot * wy[:, None]).astype(np.float32)


def degrade(img: np.ndarray, lr_mode: str = "h_only") -> np.ndarray:
    """LR conditioning image: ×2 subsample + bilinear back to full res."""
    if lr_mode == "h_only":
        sub = img[::2, :]  # reference quirk (data.py:825)
    elif lr_mode == "full":
        sub = img[::2, ::2]
    else:
        raise ValueError(lr_mode)
    return _bilinear_resize(sub, img.shape)


class MNISTDataset:
    """Filtered MNIST translation pairs (reference data.py:746-836).

    Args mirror the reference: `num` filters by digit labels, `max_file`
    caps the sample count (stopping at the first `max_file` matches, in file
    order).
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        num: Sequence[int] = tuple(range(10)),
        max_file: Optional[int] = None,
        lr_mode: str = "h_only",
    ):
        if not isinstance(num, (list, tuple)):
            num = [num]
        sel: List[int] = []
        numset = set(int(n) for n in num)
        for i in range(len(images)):
            if int(labels[i]) in numset:
                sel.append(i)
            if max_file is not None and len(sel) == max_file:
                break
        self.images = images[sel]
        self.labels = labels[sel].astype(np.int64)
        self.lr_mode = lr_mode

    def __len__(self) -> int:
        return len(self.images)

    @staticmethod
    def normalize(x: np.ndarray) -> np.ndarray:
        return 2.0 * (x / 255.0)  # [0, 2] range (reference data.py:808-809)

    def __getitem__(self, idx: int):
        img = self.images[idx].astype(np.float32)
        lr = degrade(img, self.lr_mode)
        hr = self.normalize(img)[..., None]  # HWC
        lr = self.normalize(lr)[..., None]
        return hr, lr, int(self.labels[idx])

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the whole dataset as stacked NHWC arrays."""
        hrs, lrs, ys = zip(*(self[i] for i in range(len(self))))
        return np.stack(hrs), np.stack(lrs), np.asarray(ys)


def load_mnist_arrays(
    images_path: str, labels_path: str
) -> Tuple[np.ndarray, np.ndarray]:
    return read_idx(images_path), read_idx(labels_path)
