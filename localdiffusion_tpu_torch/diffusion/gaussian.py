"""Gaussian diffusion engine: schedule wiring and model predictions.

Port of `localdiffusion_tpu/diffusion/gaussian.py` (`apply_model`,
`encode_cond`, `model_predictions`).  The JAX package's space-to-depth
execution (`apply_unet_s2d`, taken automatically at ≥128px) is a TPU lane
layout of the same network and is not ported: the port always runs the
standard layout.  Unlike the JAX engine, which takes params per call, this
one owns its UNet and the weights in it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from localdiffusion_tpu_torch.config import DiffusionConfig, ModelConfig
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.ops import diffusion_math as dm
from localdiffusion_tpu_torch.ops.schedules import Schedule, make_schedule


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


def resolve_device(device="cuda") -> torch.device:
    """The card unless the caller asks for the CPU; raises when CUDA is
    asked for and absent, so a run never drops to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class GaussianDiffusion:
    """A denoiser UNet bound to its diffusion schedule, on one device.

    The UNet runs float32 (the flagship's compute dtype) and starts with
    random weights drawn under seed 0; load trained ones with
    `gd.model.load_state_dict(params_from_jax(...))`.
    """

    def __init__(self, model_cfg: ModelConfig, diff_cfg: DiffusionConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.diff_cfg = diff_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the UNet's initial (random) weights
            model = UNet(model_cfg)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.schedule: Schedule = make_schedule(
            diff_cfg.timesteps,
            beta_schedule=diff_cfg.beta_schedule,
            objective=diff_cfg.objective,
            min_snr_loss_weight=diff_cfg.min_snr_loss_weight,
            min_snr_gamma=diff_cfg.min_snr_gamma,
            device=self.device,
        )
        self.num_timesteps = diff_cfg.timesteps
        self.is_ddim_sampling = diff_cfg.is_ddim_sampling
        self.objective = diff_cfg.objective
        self.image_size = diff_cfg.image_size

    @torch.no_grad()
    def apply_model(self, x, cond, t, cond_feat=None):
        return self.model(x, cond, t, cond_feat=cond_feat)

    @torch.no_grad()
    def encode_cond(self, cond):
        return self.model.encode_cond(cond)

    @torch.no_grad()
    def model_predictions(self, x, t, cond_feat, min_max_val: Tuple[float, float],
                          clip_x_start: bool = False,
                          rederive_pred_noise: bool = False) -> ModelPrediction:
        sched = self.schedule
        model_output = self.apply_model(x, None, t, cond_feat=cond_feat)
        lo, hi = min_max_val
        if self.objective == "pred_noise":
            pred_noise = model_output
            x_start = dm.predict_start_from_noise(sched, x, t, pred_noise)
            if clip_x_start:
                x_start = x_start.clamp(lo, hi)
                if rederive_pred_noise:
                    pred_noise = dm.predict_noise_from_start(sched, x, t, x_start)
        else:
            if self.objective == "pred_x0":
                x_start = model_output
            else:  # pred_v
                x_start = dm.predict_start_from_v(sched, x, t, model_output)
            if clip_x_start:
                x_start = x_start.clamp(lo, hi)
            pred_noise = dm.predict_noise_from_start(sched, x, t, x_start)
        return ModelPrediction(pred_noise, x_start)
