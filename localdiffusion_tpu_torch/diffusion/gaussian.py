"""Gaussian diffusion engine: schedule wiring, model predictions and the
training loss.

Port of `localdiffusion_tpu/diffusion/gaussian.py` (`apply_model`,
`encode_cond`, `model_predictions`, `p_losses`, `loss`).  The JAX package's space-to-depth
execution (`apply_unet_s2d`, taken automatically at ≥128px) is a TPU lane
layout of the same network and is not ported: the port always runs the
standard layout, which the tests hold equal to it at 128px.  Unlike the JAX engine, which takes params per call, this
one owns its UNet and the weights in it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.config import Config, DiffusionConfig, ModelConfig
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.ops import diffusion_math as dm
from localdiffusion_tpu_torch.ops.schedules import Schedule, make_schedule
from localdiffusion_tpu_torch.utils.precision import full_float32


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor


class GeneratorDraws:
    """The loss's random draws from one `torch.Generator`, on its device:
    timesteps uniform in [0, T), standard normals, an epoch's permutation
    (`train.trainer.Trainer.train_epoch_resident`) and the
    self-conditioning coin."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    def timesteps(self, b: int, num_timesteps: int) -> torch.Tensor:
        return torch.randint(0, num_timesteps, (b,), generator=self.generator,
                             device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def coin(self) -> bool:
        """Heads with probability 1/2 (one uniform draw, read on the host)."""
        return bool(torch.rand((), generator=self.generator, device=self.device) < 0.5)


class ArrayDraws:
    """Hands out given arrays in order, each of its kind (timesteps,
    normals, permutations, coins) and checked against the shape asked for:
    the JAX package's draws replayed (`jax.random` cannot be reproduced
    without JAX)."""

    def __init__(self, device, timesteps: Sequence = (), normals: Sequence = (),
                 permutations: Sequence = (), coins: Sequence = ()):
        self.device = torch.device(device)
        self._queues = {"timesteps": iter(timesteps), "normal": iter(normals),
                        "permutation": iter(permutations), "coin": iter(coins)}

    def _next(self, kind: str, shape, dtype):
        a = next(self._queues[kind], None)
        if a is None:
            raise RuntimeError(f"no {kind} draw left")
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"{kind} draw of shape {np.shape(a)}, asked {tuple(shape)}")
        return torch.as_tensor(np.array(a, dtype), device=self.device)

    def timesteps(self, b: int, num_timesteps: int) -> torch.Tensor:
        return self._next("timesteps", (b,), np.int64)

    def normal(self, shape) -> torch.Tensor:
        return self._next("normal", shape, np.float32)

    def permutation(self, n: int) -> torch.Tensor:
        return self._next("permutation", (n,), np.int64)

    def coin(self) -> bool:
        return bool(self._next("coin", (), np.bool_))


def as_draws(draws):
    """A draws source from a `torch.Generator` or a source as above."""
    return GeneratorDraws(draws) if isinstance(draws, torch.Generator) else draws


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

    # ------------------------------------------------------------------
    # training loss (the JAX engine's `p_losses` / `loss`)
    # ------------------------------------------------------------------
    def p_losses(self, x_start, cond, t, noise, offset_noise: Optional[torch.Tensor] = None,
                 self_cond: bool = False):
        """The noise-injection loss on NHWC x_start and cond at timesteps t
        [B]: x_t = q_sample(x_start, t, noise + s·offset), the UNet run with
        grad inside `full_float32`, the objective's target (noise, x_start,
        or v), the per-row MSE weighted by `schedule.loss_weight[t]`, then
        the mean.  offset_noise: [B, C], added at `offset_noise_strength`.

        With `model_cfg.self_condition`, `self_cond` is the whole batch's
        coin (reference ddpm.py:1176-1182): heads, a pre-pass predicts x₀
        without gradient (`model_output_to_x_start`) and the UNet takes it
        as `x_self_cond`; tails, it takes zeros.  The JAX engine computes
        the pre-pass either way and zeroes it on tails; the port, as the
        reference, runs it on heads only: the same loss."""
        if self.model_cfg.self_condition != self.model.cfg.self_condition:
            raise ValueError("the engine's model_cfg and its UNet disagree on self_condition")
        sched = self.schedule
        strength = self.diff_cfg.offset_noise_strength
        if offset_noise is not None and strength > 0.0:
            noise = noise + strength * offset_noise[:, None, None, :]
        x = dm.q_sample(sched, x_start, t, noise)
        x_self_cond = None
        if self.model_cfg.self_condition and self_cond:
            with torch.no_grad(), full_float32():
                x_self_cond = dm.model_output_to_x_start(sched, self.model(x, cond, t), x, t)
        with full_float32():
            model_out = self.model(x, cond, t, x_self_cond=x_self_cond)
        if self.objective == "pred_noise":
            target = noise
        elif self.objective == "pred_x0":
            target = x_start
        elif self.objective == "pred_v":
            target = dm.predict_v(sched, x_start, t, noise)
        else:
            raise ValueError(self.objective)
        loss = ((model_out - target) ** 2).mean(dim=(1, 2, 3))
        return (loss * sched.loss_weight[t]).mean()

    def loss(self, x_start, cond, draws):
        """t ~ U[0, T), noise and (with offset noise on) a [B, C] offset from
        `draws` (a `torch.Generator` on this device, or `ArrayDraws`), then
        `p_losses`; x_start mapped to [-1, 1] first under `auto_normalize`.
        The draws' order is the JAX engine's split order: t, noise, offset,
        with self-conditioning's coin drawn first and only then, so a
        default configuration draws what it drew without the option."""
        draws = as_draws(draws)
        b = x_start.shape[0]
        self_cond = draws.coin() if self.model_cfg.self_condition else False
        t = draws.timesteps(b, self.num_timesteps)
        noise = draws.normal(x_start.shape)
        offset = None
        if self.diff_cfg.offset_noise_strength > 0.0:
            offset = draws.normal((b, x_start.shape[-1]))
        if self.diff_cfg.auto_normalize:
            x_start = dm.normalize_to_neg_one_to_one(x_start)
        return self.p_losses(x_start, cond, t, noise, offset, self_cond)

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
