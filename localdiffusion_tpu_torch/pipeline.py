"""Local-diffusion inference pipeline: Stage A, then Stage B.

Port of `localdiffusion_tpu/pipeline.py` (`LocalDiffusionPipeline.translate`).
Stage A is the caller's mask or the front end's (ood/frontend.py): PatchCore
over the WRN50-2's, the seg encoder's or the denoiser's taps with the
fitted ladder (and hysteresis refinement where configured), the seg
detector's thresholded SegUNet, or the 'manual' and 'none' masks.  Stage B is ancestral DDPM, or DDIM when
the configuration samples fewer steps than it trains (`sampling_timesteps <
timesteps`).  With `sampler.classifier` and a classifier gate
(`factory.build_classifier_gate`), the branched DDPM chain's post-fusion
steps are gated; DDIM has no gate, as in the reference.  There is no
device mesh: the pipeline runs on one device.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from localdiffusion_tpu_torch.config import Config, min_max_val_for
from localdiffusion_tpu_torch.diffusion import sampler as S
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import StageClock
from localdiffusion_tpu_torch.utils.metrics import mse, psnr, ssim


class LocalDiffusionPipeline:
    """Config-driven translation with hallucination suppression."""

    def __init__(self, config: Config, gd: GaussianDiffusion,
                 frontend: Optional[OODFrontend] = None, classifier_gate=None):
        """frontend: Stage A's (`factory.build_frontend(config, gd)`); the
        'manual' and 'none' detectors get theirs here when none is given.
        classifier_gate: `factory.build_classifier_gate(...)`, used when
        `sampler.classifier` is set."""
        self.config = config
        self.gd = gd
        self.device = gd.device
        self.min_max_val = min_max_val_for(config)
        if frontend is None and config.ood.detector in ("manual", "none"):
            frontend = OODFrontend(config)
        self.frontend = frontend
        self.classifier_gate = classifier_gate

    def detect(self, lr: np.ndarray):
        """Stage A for a batch [B, H, W, C]: (mask_pred, binary_mask,
        anomaly_map or None), each [B, H, W, 1].  Raises when the pipeline
        has no front end (a PatchCore detector needs one built)."""
        if self.frontend is None:
            raise ValueError(
                f"detector {self.config.ood.detector!r} needs a front end: pass "
                "frontend=factory.build_frontend(config, gd)[0], or pass mask= to translate")
        return self.frontend.detect(np.asarray(lr, np.float32))

    def translate(self, lr: np.ndarray, hr: Optional[np.ndarray] = None,
                  noise=None, mask: Optional[np.ndarray] = None,
                  gt_region: Optional[np.ndarray] = None,
                  retry_noise=None,
                  clock: Optional[StageClock] = None) -> Dict[str, np.ndarray]:
        """One batch through Stage A and Stage B.

        lr (and hr): [B, H, W, C].  `mask` overrides the detector; without
        it Stage A runs (with `sampler.ood_ad`, else the mask is uniform
        ones) and adds 'anomaly_map' to the result: a PatchCore detector's
        map, or the seg detector's probabilities.
        `noise` is an int seed, a noise source (see diffusion.sampler), or
        None (seed 0).  A uniform-ones mask takes the plain chain, any other
        mask the branched chain, each DDPM or DDIM as the configuration
        says.  'time' is Stage B's.  A gated chain adds 'fusion_time', each
        sample's acceptance step, and draws its retries' noise from
        `retry_noise` (see diffusion.sampler).  `clock` is handed to the
        branched DDPM chain, which marks its stages on it (see
        `diffusion.sampler.ddpm_sample_branched`).
        """
        scfg = self.config.sampler
        dev = self.device
        lr_t = torch.as_tensor(np.asarray(lr, np.float32), device=dev)
        amap = None
        if mask is None:
            if scfg.ood_ad:
                mask, _, amap = self.detect(lr)
            else:
                s = self.gd.image_size
                mask = np.ones((lr.shape[0], s, s, 1), np.float32)
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
        fusion_time = None
        if self.gd.is_ddim_sampling:
            if branch:
                out = S.ddim_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                             noise=noise)
            else:
                out = S.ddim_sample_plain(self.gd, lr_t, self.min_max_val, noise=noise)
        elif branch:
            gate = self.classifier_gate if scfg.classifier else None
            out = S.ddpm_sample_branched(self.gd, lr_t, mask_t, scfg, self.min_max_val,
                                         noise=noise, gt=gt, classifier_fn=gate,
                                         return_fusion_time=gate is not None,
                                         retry_noise=retry_noise, clock=clock)
            if gate is not None:
                out, fusion_time = out
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
        if fusion_time is not None:
            result["fusion_time"] = fusion_time.cpu().numpy()
        if amap is not None:
            result["anomaly_map"] = amap
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
