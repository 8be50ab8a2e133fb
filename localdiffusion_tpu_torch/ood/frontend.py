"""OOD detection front end: conditioning image → (soft mask, binary mask).
Port of `localdiffusion_tpu/ood/frontend.py`.

Stage A of the inference pipeline: preprocessing, PatchCore detection,
threshold ladder, hysteresis refinement and dilation; the seg detector's
sigmoid at 0.5 and dilation; or the manual / none masks.  The device work
(the seg UNet, or the feature pass, nearest-neighbour search and map) runs
on the detector's device; the per-image ladder, refinement and dilation
run on the host.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.ood.patchcore import StageClock
from localdiffusion_tpu_torch.ood.thresholds import (
    dilate_with_backoff,
    ladder_for,
    load_ladder,
    manual_mask,
    refine_masks,
    soft_mask_from_map,
)
from localdiffusion_tpu_torch.ops.resize import imagenet_normalize, resize_bilinear


class OODFrontend:
    """Builds the OOD mask for one conditioning batch.

    detector='patchcore' → anomaly map + ladder (+ hysteresis refinement)
    detector='seg'       → sigmoid(seg_apply(lr)) > 0.5, dilated
    detector='manual'    → left-columns mask
    detector='none'      → uniform ones (the branching bypass)

    `seg_apply` (the seg detector's, e.g. `models.seg_unet.SegDetector`)
    maps the conditioning image [B, H, W, 1], as the pipeline normalizes
    it, to logits [B, H, W, 1] on its `.device`.

    With `time_stages` on, a `detect` records CUDA events on the current
    stream and leaves in `last_split` its milliseconds by stage: for
    patchcore 'features' (the feature pass), 'nn' (nearest-neighbour search
    and image score), 'map' (upsample and blur); for seg 'seg' (the UNet and
    the sigmoid); and 'host' (the ladder, refinement and dilation, from the
    map's arrival on the host).  The split holds only for a detect that has
    the device to itself: under the server's `overlap_detect` the events
    fall between the other batch's Stage B kernels.  Off (the default),
    nothing is recorded.
    """

    def __init__(self, config, patchcore=None, seg_apply=None, time_stages: bool = False):
        self.config = config
        self.patchcore = patchcore
        self.seg_apply = seg_apply
        self.time_stages = time_stages
        det = config.ood.detector
        if det == "patchcore" and patchcore is None:
            raise ValueError("patchcore detector requires a PatchCore instance")
        if det == "seg" and seg_apply is None:
            raise ValueError("seg detector requires a seg model apply fn")
        self.last_split: Dict[str, float] = {}

    def _preprocess_patchcore(self, lr) -> torch.Tensor:
        """The detector's input on the PatchCore's device.  A 'raw' source
        (the denoiser) takes the conditioning image as the pipeline
        normalizes it; otherwise channel repeat, per-dataset
        de/re-normalization, resize to the detector's input and ImageNet
        normalization."""
        cfg = self.config
        dev = self.patchcore.device
        x = lr if isinstance(lr, torch.Tensor) else torch.as_tensor(np.asarray(lr, np.float32))
        x = x.to(dev, torch.float32)
        if getattr(self.patchcore.source, "preprocess", "imagenet") == "raw":
            return x
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        if cfg.data.name == "mri":
            d = cfg.data
            if d.translate_zero:
                x = x - abs((0.0 - d.mean_t1) / d.std_t1)
            x = (x * d.std_t1 + d.mean_t1) / 4096.0
        else:
            # mnist/mvtec arrive in [0, 2]
            x = torch.where(x.max() > 1.0, x / 2.0, x)
        size = cfg.ood.input_size
        return imagenet_normalize(resize_bilinear(x, (size, size)))

    def _ladder_variant(self) -> str:
        cfg = self.config
        name = cfg.data.name
        if name == "mnist":
            return cfg.data.mnist_cls  # '8to3' | '8to5'
        if name == "mri":
            return "t12flair" if "t12flair" in cfg.train.project_name else "flair2t1"
        # mvtec: the category from the path; unknown ones get the default ladder
        for cat in ("transistor", "toothbrush", "grid"):
            if cat in cfg.data.mvtec_path:
                return cat
        return os.path.basename(os.path.dirname(cfg.data.mvtec_path)) or "unknown"

    def detect(self, lr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """→ (mask_pred, binary_mask, anomaly_map or None), numpy [B, H, W, 1]."""
        cfg = self.config
        img_size = cfg.diffusion.image_size
        shape = (lr.shape[0], img_size, img_size, 1)
        det = cfg.ood.detector
        if det == "none":
            ones = np.ones(shape, np.float32)
            return ones, ones, None
        if det == "manual":
            m = manual_mask(shape, cfg.ood.manual_mask_cols)
            return m, m.copy(), None

        strides = self.patchcore.source.strides if self.patchcore is not None else None
        dilate = cfg.ood.resolved_mask_dilate(img_size, strides=strides)
        if det == "seg":
            return self._detect_seg(lr, dilate)
        clock = StageClock(self.patchcore.device) if self.time_stages else None
        amap = self.patchcore(self._preprocess_patchcore(lr), clock=clock)["anomaly_map"]
        if cfg.data.name in ("mnist", "mvtec", "mvtecSR"):
            amap = resize_bilinear(amap, (img_size, img_size))
        amap_np = amap.float().cpu().numpy()
        t_host = time.perf_counter()
        if cfg.ood.ladder_path and os.path.exists(cfg.ood.ladder_path):
            ladder = load_ladder(cfg.ood.ladder_path)  # fitted on normal-set scores
        else:
            name = "mvtec" if "mvtec" in cfg.data.name else cfg.data.name
            ladder = ladder_for(name, self._ladder_variant())
        refine = cfg.ood.mask_refine == "hysteresis"
        mask_pred, binary = soft_mask_from_map(amap_np, ladder, dilate=0 if refine else dilate)
        if refine:
            # per-image re-segmentation and hysteresis growth; the residual
            # dilation comes after it
            mask_pred, binary = refine_masks(
                amap_np, mask_pred, binary, seed=cfg.ood.refine_seed,
                hi_frac=cfg.ood.refine_hi_frac, lo_frac=cfg.ood.refine_lo_frac,
                min_area=cfg.ood.refine_min_area,
            )
            if dilate > 0:
                pairs = [dilate_with_backoff(mask_pred[i], binary[i], dilate)
                         for i in range(len(binary))]
                mask_pred = np.stack([p[0] for p in pairs])
                binary = np.stack([p[1] for p in pairs])
        if clock is not None:
            # 'host': from the map's arrival on the host to the masks
            self.last_split = dict(clock.split(), host=1e3 * (time.perf_counter() - t_host))
        return mask_pred, binary, amap_np

    def _detect_seg(self, lr, dilate: int):
        """The seg detector: binary = sigmoid(logits) > 0.5, each image then
        dilated by `dilate` with the saturation back-off (a mask is never
        grown into the all-ones bypass sentinel); → (binary, binary, the
        probabilities)."""
        clock = StageClock(self.seg_apply.device) if self.time_stages else None
        probs = torch.sigmoid(self.seg_apply(lr).float()).cpu().numpy()
        if clock is not None:
            clock.mark("seg")
        t_host = time.perf_counter()
        binary = (probs > 0.5).astype(np.float32)
        if dilate > 0:
            binary = np.stack([dilate_with_backoff(m, m, dilate)[1] for m in binary])
        if clock is not None:
            self.last_split = dict(clock.split(), host=1e3 * (time.perf_counter() - t_host))
        return binary, binary.copy(), probs
