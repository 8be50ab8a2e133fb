"""Local-diffusion inference pipeline (Stage B with a given or manual mask).

Port of `localdiffusion_tpu/pipeline.py` (`LocalDiffusionPipeline.translate`).
Stage A in this slice is the caller's mask or the configuration's 'manual'
(or 'none') detector; PatchCore and the segmentation detector come later.
Stage B is ancestral DDPM, or DDIM when the configuration samples fewer
steps than it trains (`sampling_timesteps < timesteps`).  There is no device
mesh: the pipeline runs on one device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from localdiffusion_tpu_torch.config import Config, min_max_val_for
from localdiffusion_tpu_torch.diffusion import sampler as S
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.ood.manual import manual_mask
from localdiffusion_tpu_torch.utils.metrics import mse, psnr, ssim


class LocalDiffusionPipeline:
    """Config-driven translation with hallucination suppression."""

    def __init__(self, config: Config, gd: GaussianDiffusion):
        if config.sampler.classifier:
            raise NotImplementedError("classifier-gated sampling: later slice")
        self.config = config
        self.gd = gd
        self.device = gd.device
        self.min_max_val = min_max_val_for(config)

    def detect(self, lr: np.ndarray) -> np.ndarray:
        """Stage A for a batch [B, H, W, C]: the [B, H, W, 1] mask."""
        s = self.gd.image_size
        shape = (lr.shape[0], s, s, 1)
        det = self.config.ood.detector
        if det == "manual":
            return manual_mask(shape, self.config.ood.manual_mask_cols)
        if det == "none":
            return np.ones(shape, np.float32)
        raise NotImplementedError(
            f"detector {det!r}: later slice; pass mask= to translate"
        )

    def translate(self, lr: np.ndarray, hr: Optional[np.ndarray] = None,
                  noise=None, mask: Optional[np.ndarray] = None,
                  gt_region: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One batch through Stage A and Stage B.

        lr (and hr): [B, H, W, C].  `mask` overrides the detector.  `noise`
        is an int seed, a noise source (see diffusion.sampler), or None
        (seed 0).  A uniform-ones mask takes the plain chain, any other mask
        the branched chain, each DDPM or DDIM as the configuration says.
        """
        scfg = self.config.sampler
        dev = self.device
        lr_t = torch.as_tensor(np.asarray(lr, np.float32), device=dev)
        if mask is None:
            mask = self.detect(lr) if scfg.ood_ad else np.ones(
                (lr.shape[0], self.gd.image_size, self.gd.image_size, 1), np.float32
            )
        mask = np.asarray(mask, np.float32)
        uniform = bool(np.all(mask == 1.0))
        branch = scfg.branch_out and not uniform
        gt = (
            torch.as_tensor(np.asarray(hr, np.float32), device=dev)
            if (hr is not None and scfg.use_gt and scfg.start_intermediate)
            else None
        )

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mask_t = torch.as_tensor(mask, device=dev)
        if self.gd.is_ddim_sampling:
            if branch:
                out = S.ddim_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                             noise=noise)
            else:
                out = S.ddim_sample_plain(self.gd, lr_t, self.min_max_val, noise=noise)
        elif branch:
            out = S.ddpm_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                         noise=noise, gt=gt)
        else:
            out = S.ddpm_sample_plain(self.gd, lr_t, self.min_max_val, noise=noise)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0

        result: Dict[str, np.ndarray] = {
            "pred": out.cpu().numpy(),
            "mask": mask,
            "time": np.asarray(dt),
            "branched": np.asarray(branch),
        }
        if hr is not None:
            hr_t = torch.as_tensor(np.asarray(hr, np.float32), device=dev)
            rng = float(self.min_max_val[1])
            result["mse"] = mse(out, hr_t).cpu().numpy()
            result["ssim"] = ssim(out, hr_t, data_range=rng).cpu().numpy()
            result["psnr"] = psnr(out, hr_t, data_range=rng).cpu().numpy()
            if gt_region is not None:
                m = (np.asarray(gt_region, np.float32) > 0).astype(np.float32)
                err = (result["pred"] - np.asarray(hr, np.float32)) ** 2
                result["mse_ood_region"] = np.asarray(
                    float((err * m).sum() / max(float(m.sum()), 1.0))
                )
        return result
