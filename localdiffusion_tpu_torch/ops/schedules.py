"""Beta schedules and the frozen Schedule buffers.

Port of `localdiffusion_tpu/ops/schedules.py`: the coefficients are computed
in numpy float64 on the host and frozen as float32 tensors on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1.0
) -> np.ndarray:
    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    # the endpoint sigmoids are evaluated in float32, as the original
    # torch code does (torch.tensor(start / tau).sigmoid())
    v_start = np.float64(sigmoid(np.float32(start / tau)).astype(np.float32))
    v_end = np.float64(sigmoid(np.float32(end / tau)).astype(np.float32))
    alphas_cumprod = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-timestep diffusion coefficients, one row per training timestep."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    loss_weight: torch.Tensor
    num_timesteps: int = 0
    objective: str = "pred_x0"


def make_schedule(
    timesteps: int,
    beta_schedule: str = "sigmoid",
    objective: str = "pred_x0",
    min_snr_loss_weight: bool = False,
    min_snr_gamma: float = 5.0,
    device="cpu",
    **schedule_kwargs,
) -> Schedule:
    """All diffusion coefficients: float64 host math, float32 tensors."""
    if beta_schedule not in _SCHEDULES:
        raise ValueError(f"unknown beta schedule {beta_schedule}")
    betas = _SCHEDULES[beta_schedule](timesteps, **schedule_kwargs)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.pad(alphas_cumprod[:-1], (1, 0), constant_values=1.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(np.maximum(posterior_variance, 1e-20))
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )

    snr = alphas_cumprod / (1.0 - alphas_cumprod)
    maybe_clipped_snr = np.minimum(snr, min_snr_gamma) if min_snr_loss_weight else snr
    if objective == "pred_noise":
        loss_weight = maybe_clipped_snr / snr
    elif objective == "pred_x0":
        loss_weight = maybe_clipped_snr
    elif objective == "pred_v":
        loss_weight = maybe_clipped_snr / (snr + 1)
    else:
        raise ValueError(f"unknown objective {objective}")

    def as_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Schedule(
        betas=as_dev(betas),
        alphas_cumprod=as_dev(alphas_cumprod),
        alphas_cumprod_prev=as_dev(alphas_cumprod_prev),
        sqrt_alphas_cumprod=as_dev(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=as_dev(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=as_dev(posterior_variance),
        posterior_log_variance_clipped=as_dev(posterior_log_variance_clipped),
        posterior_mean_coef1=as_dev(posterior_mean_coef1),
        posterior_mean_coef2=as_dev(posterior_mean_coef2),
        snr=as_dev(snr),
        loss_weight=as_dev(loss_weight),
        num_timesteps=int(timesteps),
        objective=objective,
    )
