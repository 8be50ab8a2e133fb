"""Local-diffusion DDPM sampling.  Port of `localdiffusion_tpu/diffusion/sampler.py`.

The JAX package runs each phase as a `lax.scan`; here each phase is a
Python loop over the timesteps with static shapes:

  phase A (branched): t ∈ [T-1 .. s+1] — the OOD and IND branches advance
          together as ONE flat [2B] UNet batch (OOD half first), with the
          same noise for both branches;
  fusion at t = s = start_timestep — x_start and the noisy states are
          fused through the binary mask;
  phase B (fused): t ∈ [s-1 .. 0] — one plain chain.

The condition features are encoded once per chain.  The classifier-gated
phase B and DDIM are later slices: asking for them raises.

Noise comes from a noise source: a callable `noise(shape) -> Tensor`, called
once for the initial image and once per step, in chain order (so T + 1
draws per chain, for the plain and the branched sampler alike).  By default
it draws from a `torch.Generator` on the device (`GeneratorNoise`);
`ArrayNoise` hands out given arrays instead, which is how a test replays the
JAX package's key stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.config import SamplerConfig
from localdiffusion_tpu_torch.ops import diffusion_math as dm


class GeneratorNoise:
    """Standard normal noise from a seeded `torch.Generator` on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def __call__(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)


class ArrayNoise:
    """Hands out the given arrays in order, each checked against the shape
    the sampler asks for."""

    def __init__(self, arrays: Sequence[np.ndarray], device):
        self.device = torch.device(device)
        self._arrays = iter(arrays)

    def __call__(self, shape) -> torch.Tensor:
        a = next(self._arrays, None)
        if a is None:
            raise RuntimeError("noise source exhausted")
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"noise of shape {np.shape(a)}, sampler asked {tuple(shape)}")
        return torch.tensor(np.asarray(a, np.float32), device=self.device)


def as_noise(noise, device):
    """A noise source from a seed (int), a noise source, or None (seed 0)."""
    if noise is None:
        return GeneratorNoise(0, device)
    if isinstance(noise, (int, np.integer)):
        return GeneratorNoise(int(noise), device)
    if callable(noise):
        return noise
    raise TypeError(f"noise must be an int seed or a callable, got {type(noise)}")


def reconcile(scfg: SamplerConfig) -> SamplerConfig:
    """A detector- or confidence-driven run forces mask_cond and mask_x on."""
    if (scfg.ood_ad or scfg.ood_confidence) and not (scfg.mask_x and scfg.mask_cond):
        scfg = dataclasses.replace(scfg, mask_x=True, mask_cond=True)
    return scfg


# ---------------------------------------------------------------------------
# mask algebra
# ---------------------------------------------------------------------------

def binarize_mask(mask: torch.Tensor) -> torch.Tensor:
    """OOD-region binary mask: mask >= 1.0 (a soft value below 1 is IND)."""
    return (mask >= 1.0).float()


def partition_cond(cond, binary_mask, cond_in_floor: float):
    """cond_out = cond·mask; cond_in = cond·clip(1-mask, floor, 1)."""
    cond_out = cond * binary_mask
    cond_in = cond * (1.0 - binary_mask).clamp(cond_in_floor, 1.0)
    return cond_out, cond_in


def apply_mask_x(model_output_out, binary_mask, cond_out, min_val: float, policy: str):
    """OOD-branch output under mask_x: 'cond' replaces it by the masked
    condition; 'minval' keeps it inside the mask and sets min_val outside."""
    if policy == "cond":
        return cond_out
    out = model_output_out * binary_mask
    return torch.where(binary_mask == 0.0, torch.full_like(out, min_val), out)


def fuse_noisy_states(x_out_masked, x_in_masked, binary_mask, route: str):
    """'zero_sentinel': where(x_out == 0, x_in, x_out); 'mask': by the mask."""
    if route == "zero_sentinel":
        return torch.where(x_out_masked == 0.0, x_in_masked, x_out_masked)
    return torch.where(binary_mask > 0.0, x_out_masked, x_in_masked)


# ---------------------------------------------------------------------------
# sampling programs
# ---------------------------------------------------------------------------

def _maybe_unnorm(gd, x):
    if x is None or not gd.diff_cfg.auto_normalize:
        return x
    return dm.unnormalize_to_zero_to_one(x)


def _step_noise(noise, shape, t: int):
    """The step's noise, zeroed at t == 0 (the draw is still taken, so the
    stream stays in step with the chain)."""
    n = noise(shape)
    return n if t > 0 else torch.zeros_like(n)


def _tb(t: int, n: int, device):
    return torch.full((n,), t, dtype=torch.long, device=device)


@torch.no_grad()
def ddpm_sample_plain(gd, cond, min_max_val: Tuple[float, float], noise=None,
                      gt=None, use_gt_timestep: Optional[int] = None,
                      return_all: bool = False):
    """Plain (non-branched) ancestral DDPM chain.  cond: [B, H, W, C]."""
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)

    img = noise(shape)
    t_start = gd.num_timesteps
    if gt is not None and use_gt_timestep is not None:
        t_start = int(use_gt_timestep)
        img = dm.q_sample(sched, gt, _tb(t_start, b, device), img)

    cond_feat = gd.encode_cond(cond)
    frames = [img]
    for t in range(t_start - 1, -1, -1):
        tb = _tb(t, b, device)
        out = gd.apply_model(img, None, tb, cond_feat=cond_feat)
        x_start = dm.model_output_to_x_start(sched, out, img, tb).clamp(lo, hi)
        mean, _, logvar = dm.q_posterior(sched, x_start, img, tb)
        img = mean + torch.exp(0.5 * logvar) * _step_noise(noise, shape, t)
        if return_all:
            frames.append(img)
    if return_all:
        return _maybe_unnorm(gd, img), _maybe_unnorm(gd, torch.stack(frames))
    return _maybe_unnorm(gd, img)


@torch.no_grad()
def ddpm_sample_branched(gd, cond, mask, scfg: SamplerConfig,
                         min_max_val: Tuple[float, float], noise=None, gt=None,
                         classifier_fn=None, return_all: bool = False):
    """Branched local-diffusion DDPM with fusion at `start_timestep`.

    cond: [B, H, W, C]; mask: [B, H, W, 1].  Returns the final image
    [B, H, W, C] (or the branch pair [2, B, H, W, C] when start_intermediate
    is False).  `return_all` → (final, frames), frames [T+1, 2, B, H, W, C]:
    the initial noise, then one frame per step (the (OOD, IND) pair while
    branched, the fused image duplicated on the pair axis once fused).
    """
    if scfg.classifier or classifier_fn is not None:
        raise NotImplementedError("classifier-gated phase B: later slice")
    scfg = reconcile(scfg)
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)

    m = binarize_mask(mask)
    cond_out, cond_in = partition_cond(cond, m, scfg.cond_in_floor)

    # condition features: once per chain, not once per step
    feat_pair = torch.cat([gd.encode_cond(cond_out), gd.encode_cond(cond_in)])
    feat_full = gd.encode_cond(cond)

    img0 = noise(shape)
    t_top = gd.num_timesteps
    if scfg.use_gt and gt is not None:
        t_top = int(scfg.use_gt_timestep)
        img0 = dm.q_sample(sched, gt, _tb(t_top, b, device), img0)

    # both branches as ONE flat [2B] batch: OOD half first, then IND
    x2 = torch.cat([img0, img0])
    out_half = torch.cat([torch.ones(b, 1, 1, 1, dtype=torch.bool, device=device),
                          torch.zeros(b, 1, 1, 1, dtype=torch.bool, device=device)])
    if scfg.mask_x_policy == "cond":
        mask_x_repl2 = torch.cat([cond_out, torch.zeros_like(cond_out)])
    else:
        mask_x_mult2 = torch.cat([m, torch.ones_like(m)])
        mask_x_zero2 = torch.cat([m == 0.0, torch.zeros_like(m, dtype=torch.bool)])

    def branch_starts2(x2, tb2):
        """Both branches' x_start, with the mask_x policy on the OOD half,
        clipped."""
        out2 = gd.apply_model(x2, None, tb2, cond_feat=feat_pair)
        xs2 = dm.model_output_to_x_start(sched, out2, x2, tb2)
        if scfg.mask_x:
            if scfg.mask_x_policy == "cond":
                xs2 = torch.where(out_half, mask_x_repl2, xs2)
            else:
                xs2 = torch.where(mask_x_zero2, torch.full_like(xs2, lo), xs2 * mask_x_mult2)
        return xs2.clamp(lo, hi)

    def branched_step(x2, t):
        tb2 = _tb(t, 2 * b, device)
        xs2 = branch_starts2(x2, tb2)
        mean2, _, logvar2 = dm.q_posterior(sched, xs2, x2, tb2)
        n = _step_noise(noise, shape, t)  # shared across the branches
        return mean2 + torch.exp(0.5 * logvar2) * torch.cat([n, n])

    frames = [torch.stack([img0, img0])]

    def record_pair(x2):
        if return_all:
            frames.append(x2.reshape(2, b, *x2.shape[1:]))

    def record_fused(x):
        if return_all:
            frames.append(torch.stack([x, x]))

    def finish(result):
        if return_all:
            return _maybe_unnorm(gd, result), _maybe_unnorm(gd, torch.stack(frames))
        return _maybe_unnorm(gd, result)

    s = int(scfg.start_timestep)
    if not scfg.start_intermediate:
        for t in range(t_top - 1, -1, -1):
            x2 = branched_step(x2, t)
            record_pair(x2)
        return finish(x2.reshape(2, b, *x2.shape[1:]))

    # ---- phase A: branched steps t ∈ [T-1 .. s+1] ----
    for t in range(t_top - 1, s, -1):
        x2 = branched_step(x2, t)
        record_pair(x2)

    # ---- fusion at t = s ----
    t_fuse = min(s, t_top - 1)
    tb2 = _tb(t_fuse, 2 * b, device)
    xs2 = branch_starts2(x2, tb2)
    xs_out, xs_in = xs2[:b], xs2[b:]
    x_start = (xs_in * (1.0 - m) + xs_out).clamp(lo, hi)  # xs_out is mask_x-masked
    x = fuse_noisy_states(x2[:b] * m, x2[b:] * (1.0 - m), m, scfg.fusion_route)
    tb = _tb(t_fuse, b, device)
    mean, _, logvar = dm.q_posterior(sched, x_start, x, tb)
    img = mean + torch.exp(0.5 * logvar) * _step_noise(noise, shape, t_fuse)
    record_fused(img)

    # ---- phase B: fused steps t ∈ [s-1 .. 0] ----
    for t in range(t_fuse - 1, -1, -1):
        tb = _tb(t, b, device)
        out = gd.apply_model(img, None, tb, cond_feat=feat_full)
        x_start = dm.model_output_to_x_start(sched, out, img, tb).clamp(lo, hi)
        mean, _, logvar = dm.q_posterior(sched, x_start, img, tb)
        img = mean + torch.exp(0.5 * logvar) * _step_noise(noise, shape, t)
        record_fused(img)
    return finish(img)
