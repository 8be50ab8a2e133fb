"""Diffusion math: q(x_t|x_0), the posterior and the parameterization
conversions.  Port of `localdiffusion_tpu/ops/diffusion_math.py`.

Images are NHWC, as at the JAX package's public functions; `t` is an
integer tensor of shape [B].
"""

from __future__ import annotations

import torch

from localdiffusion_tpu_torch.ops.schedules import Schedule


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] reshaped to [B, 1, 1, ...] with (ndim - 1) trailing singletons."""
    out = a[t]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def q_sample(schedule: Schedule, x_start, t, noise):
    """x_t = sqrt(ᾱ_t)·x₀ + sqrt(1-ᾱ_t)·ε."""
    nd = x_start.ndim
    return (
        extract(schedule.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def predict_start_from_noise(schedule: Schedule, x_t, t, noise):
    """x₀ = sqrt(1/ᾱ_t)·x_t − sqrt(1/ᾱ_t − 1)·ε."""
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def predict_noise_from_start(schedule: Schedule, x_t, t, x0):
    """ε = (sqrt(1/ᾱ_t)·x_t − x₀) / sqrt(1/ᾱ_t − 1)."""
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0
    ) / extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd)


def predict_v(schedule: Schedule, x_start, t, noise):
    """v = sqrt(ᾱ_t)·ε − sqrt(1−ᾱ_t)·x₀."""
    nd = x_start.ndim
    return (
        extract(schedule.sqrt_alphas_cumprod, t, nd) * noise
        - extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * x_start
    )


def predict_start_from_v(schedule: Schedule, x_t, t, v):
    """x₀ = sqrt(ᾱ_t)·x_t − sqrt(1−ᾱ_t)·v."""
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_alphas_cumprod, t, nd) * x_t
        - extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * v
    )


def q_posterior(schedule: Schedule, x_start, x_t, t):
    """Posterior q(x_{t-1} | x_t, x₀): (mean, variance, log-variance)."""
    nd = x_t.ndim
    posterior_mean = (
        extract(schedule.posterior_mean_coef1, t, nd) * x_start
        + extract(schedule.posterior_mean_coef2, t, nd) * x_t
    )
    posterior_variance = extract(schedule.posterior_variance, t, nd)
    posterior_log_variance = extract(schedule.posterior_log_variance_clipped, t, nd)
    return posterior_mean, posterior_variance, posterior_log_variance


def model_output_to_x_start(schedule: Schedule, model_output, x_t, t):
    """Convert a raw model output to an x₀ estimate per the objective."""
    if schedule.objective == "pred_x0":
        return model_output
    if schedule.objective == "pred_noise":
        return predict_start_from_noise(schedule, x_t, t, model_output)
    if schedule.objective == "pred_v":
        return predict_start_from_v(schedule, x_t, t, model_output)
    raise ValueError(f"unknown objective {schedule.objective}")


def normalize_to_neg_one_to_one(img: torch.Tensor) -> torch.Tensor:
    return img * 2.0 - 1.0


def unnormalize_to_zero_to_one(t: torch.Tensor) -> torch.Tensor:
    return (t + 1.0) * 0.5
