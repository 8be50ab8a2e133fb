"""BRATS MRI translation datasets (PNG triplets + raw-volume slicing).

A copy of `localdiffusion_tpu/data/brats.py` (numpy; PIL imported where a
PNG is decoded), kept here because the port imports nothing of the JAX
package.  Equivalent of reference data.py:329-442 (MedDataset_png: t1/flair/seg PNG
triplets) and the .mha volume variants (data.py:444-743) with medpy replaced
by a small raw-array hook (medpy is not in this environment; volumes can be
supplied as .npy).  Produces NHWC float32 numpy arrays.

Selection semantics mirror the reference exactly:
  * train keeps only tumor-free slices (unique(seg) size == 1, data.py:350-352)
  * test keeps tumor slices with OOD area > 1% of 256², capped at 50
    (data.py:354-362), or tumor-free capped at 50 (data.py:363-367)
  * center-crop 224, per-modality z-score, optional translate_zero shift by
    |min| per image (data.py:369-410)
  * direction: mode='flair' returns (flair, t1) pairs, else (t1, flair)
    (data.py:440-442)
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from localdiffusion_tpu_torch.config import DataConfig


def _center_crop_np(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    th, tw = size
    pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
    if pad_h or pad_w:
        img = np.pad(
            img,
            [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
            + [(0, 0)] * (img.ndim - 2),
        )
        h, w = img.shape[:2]
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return img[i : i + th, j : j + tw]


class BRATSPngDataset:
    """t1/flair/seg triplets from PNG + .npy seg files.

    `flair_files` are paths to *_flair.png; the t1 and seg companions are
    derived by substitution as the reference does (data.py:344-348).
    """

    def __init__(
        self,
        cfg: DataConfig,
        flair_files: Sequence[str],
        train: bool = True,
        tumor: bool = False,
        mode: str = "flair",
        crop: int = 224,
        max_test: int = 50,
    ):
        self.cfg = cfg
        self.train = train
        self.tumor = tumor
        self.mode = mode
        self.crop = crop
        self.items: List[Tuple[str, str, np.ndarray]] = []
        for flair in flair_files:
            t1 = flair.replace("flair", "t1")
            seg_path = flair.replace("_flair.png", "_seg.npy")
            if not (os.path.exists(t1) and os.path.exists(seg_path)):
                continue
            seg = np.load(seg_path)
            if train:
                if np.unique(seg).size == 1:
                    self.items.append((t1, flair, seg))
            else:
                if tumor:
                    if np.unique(seg).size != 1:
                        ood_prop = np.count_nonzero(seg > 0) / (256.0**2)
                        if ood_prop > 0.01:
                            self.items.append((t1, flair, seg))
                        if len(self.items) == max_test:
                            break
                else:
                    if np.unique(seg).size == 1:
                        self.items.append((t1, flair, seg))
                    if len(self.items) == max_test:
                        break

    def __len__(self):
        return len(self.items)

    def _normalize(self, img: np.ndarray, modality: str) -> np.ndarray:
        if modality == "t1":
            img = (img - self.cfg.mean_t1) / self.cfg.std_t1
        else:
            img = (img - self.cfg.mean_flair) / self.cfg.std_flair
        if self.cfg.translate_zero:
            img = img + abs(img.min())
        return img

    def __getitem__(self, idx: int):
        from PIL import Image

        t1p, flairp, seg = self.items[idx]
        t1 = np.array(Image.open(t1p)).astype(np.float32)
        flair = np.array(Image.open(flairp)).astype(np.float32)
        seg = seg.astype(np.float32)

        size = (self.crop, self.crop)
        t1 = _center_crop_np(t1, size)
        flair = _center_crop_np(flair, size)
        seg = _center_crop_np(seg, size)

        t1 = self._normalize(t1, "t1")[..., None]
        flair = self._normalize(flair, "flair")[..., None]
        seg = seg[..., None]
        if self.mode == "flair":
            return flair, t1, seg
        return t1, flair, seg

    def as_arrays(self):
        hs, ls, ss = zip(*(self[i] for i in range(len(self))))
        return np.stack(hs), np.stack(ls), np.stack(ss)


class BRATSVolumeDataset:
    """Slices from raw 3-D volumes (the .mha path, reference data.py:444-604).

    Volumes are [D, H, W] numpy arrays (converted offline from .mha via
    scripts/convert_mha.py); slice range 60–120 step 5 as in data.py:467-494.

    `slice_filter` reproduces the reference's per-volume selection:
      * "none"           — every slice in range (reference SingleMedDataset,
                           data.py:549-565: all slices of one volume, no
                           filtering)
      * "healthy"        — tumor-free slices only (seg slice has a single
                           unique value; reference train path data.py:467-471)
      * "tumor_capped"   — tumor slices only, at most `per_volume_cap` per
                           volume (reference test tumor=True, data.py:473-484;
                           note the reference's <1% OOD-proportion filter is
                           commented out there — every tumor slice is kept)
      * "healthy_capped" — tumor-free, at most `per_volume_cap` per volume
                           (reference test tumor=False, data.py:486-493)

    `total_cap` stops collection across volumes once that many slices are
    kept — the reference's test path breaks the volume loop at
    `self.total = 28` (data.py:464, 494-495).  None = no cap (train path).
    """

    def __init__(
        self,
        cfg: DataConfig,
        t1_volumes: Sequence[np.ndarray],
        flair_volumes: Sequence[np.ndarray],
        seg_volumes: Optional[Sequence[np.ndarray]] = None,
        slice_range=range(60, 120, 5),
        crop: int = 224,
        mode: str = "flair",
        slice_filter: str = "none",
        per_volume_cap: int = 2,
        total_cap: Optional[int] = None,
    ):
        if slice_filter not in ("none", "healthy", "tumor_capped", "healthy_capped"):
            raise ValueError(f"bad slice_filter {slice_filter}")
        self.cfg = cfg
        self.crop = crop
        self.mode = mode
        self.slices = []
        for vi in range(len(t1_volumes)):
            kept = 0
            for s in slice_range:
                if s >= t1_volumes[vi].shape[0]:
                    continue
                seg = (
                    seg_volumes[vi][s] if seg_volumes is not None else
                    np.zeros_like(t1_volumes[vi][s])
                )
                healthy = np.unique(seg).size == 1  # reference data.py:469
                if slice_filter in ("healthy", "healthy_capped") and not healthy:
                    continue
                if slice_filter == "tumor_capped" and healthy:
                    continue
                self.slices.append((t1_volumes[vi][s], flair_volumes[vi][s], seg))
                kept += 1
                if slice_filter.endswith("_capped") and kept >= per_volume_cap:
                    break  # reference data.py:483-484, 492-493
            if total_cap is not None and len(self.slices) >= total_cap:
                # reference data.py:494-495: the test path stops collecting
                # volumes once self.total (28) slices are gathered
                self.slices = self.slices[:total_cap]
                break

    @classmethod
    def single_volume(
        cls,
        cfg: DataConfig,
        t1: np.ndarray,
        flair: np.ndarray,
        seg: Optional[np.ndarray] = None,
        crop: int = 224,
        mode: str = "flair",
    ) -> "BRATSVolumeDataset":
        """All slices of one volume, unfiltered (reference SingleMedDataset,
        data.py:549-604).

        Deliberate deviation: the reference's SingleMedDataset returns the
        seg slice as a raw [H, W] tensor WITHOUT the center-crop applied to
        the image modalities (data.py:601-604 never calls transform on seg,
        unlike MedDataset data.py:563-565) — an inconsistency that breaks
        batch stacking; here seg is cropped like everything else."""
        return cls(
            cfg,
            [t1],
            [flair],
            None if seg is None else [seg],
            slice_range=range(t1.shape[0]),
            crop=crop,
            mode=mode,
            slice_filter="none",
        )

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, idx):
        t1, flair, seg = self.slices[idx]
        size = (self.crop, self.crop)
        t1 = _center_crop_np(t1.astype(np.float32), size)
        flair = _center_crop_np(flair.astype(np.float32), size)
        seg = _center_crop_np(seg.astype(np.float32), size)
        t1 = ((t1 - self.cfg.mean_t1) / self.cfg.std_t1)[..., None]
        flair = ((flair - self.cfg.mean_flair) / self.cfg.std_flair)[..., None]
        if self.cfg.translate_zero:
            t1 = t1 + abs(t1.min())
            flair = flair + abs(flair.min())
        seg = seg[..., None]
        if self.mode == "flair":
            return flair, t1, seg
        return t1, flair, seg


class BRATSSegDataset:
    """(flair, binary seg) pairs for training the segmentation OOD detector
    (reference MedSegDataset, data.py:606-673)."""

    def __init__(self, base: BRATSPngDataset):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        a, b, seg = self.base[idx]
        return a, (seg > 0).astype(np.float32)
