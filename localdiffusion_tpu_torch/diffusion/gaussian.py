"""Gaussian diffusion engine: schedule wiring and model predictions.

Port of `localdiffusion_tpu/diffusion/gaussian.py` (`apply_model`,
`encode_cond`, `model_predictions`).  The JAX package's space-to-depth
execution (`apply_unet_s2d`, taken automatically at ≥128px) is a TPU lane
layout of the same network and is not ported: the port always runs the
standard layout, which the tests hold equal to it at 128px.  Unlike the JAX engine, which takes params per call, this
one owns its UNet and the weights in it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from localdiffusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.ops import diffusion_math as dm
from localdiffusion_tpu_torch.ops.schedules import Schedule, make_schedule
from localdiffusion_tpu_torch.utils.precision import full_float32


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

    The UNet computes in `dtype` (float32 or bfloat16; `build_gd` takes it
    from the configuration's `train.compute_dtype`, as the JAX factory
    does) with float32 parameters and a float32 output, so the sampler's
    state stays float32.  It starts with random weights drawn under seed 0;
    load trained ones with `gd.model.load_state_dict(params_from_jax(...))`
    or `load_params_npz`, or `factory.load_params`.

    Every call of the UNet runs its float32 convolutions and products in
    full float32, whatever the process's TF32 flags (`full_float32`): all
    of a float32 UNet's, and a bf16 UNet's final 1×1 conv, which computes in
    float32 as in the JAX package.
    """

    def __init__(self, model_cfg: ModelConfig, diff_cfg: DiffusionConfig,
                 device="cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.diff_cfg = diff_cfg
        self.dtype = dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the UNet's initial (random) weights
            model = UNet(model_cfg, dtype)
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
        """The UNet on NHWC x (and cond, or precomputed cond_feat): float32
        out, as the JAX engine's `apply_model` through `UNet.apply`."""
        with full_float32():
            return self.model(x, cond, t, cond_feat=cond_feat)

    @torch.no_grad()
    def encode_cond(self, cond):
        """Condition features of NHWC cond, in the compute type."""
        with full_float32():
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


def build_gd(cfg: Config, device="cuda") -> GaussianDiffusion:
    """The engine of a configuration, computing in `cfg.train.compute_dtype`
    (the JAX package's `factory.build_gd`)."""
    dtype = getattr(torch, cfg.train.compute_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r} is not float32 or bfloat16")
    return GaussianDiffusion(cfg.model, cfg.diffusion, device=device, dtype=dtype)
