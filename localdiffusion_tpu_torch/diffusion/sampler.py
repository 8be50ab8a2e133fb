"""Local-diffusion DDPM and DDIM sampling.  Port of
`localdiffusion_tpu/diffusion/sampler.py`.

The JAX package runs each phase as a `lax.scan`; here each phase is a
Python loop over the timesteps with static shapes:

  phase A (branched): t ∈ [T-1 .. s+1] — the OOD and IND branches advance
          together as ONE flat [2B] UNet batch (OOD half first), with the
          same noise for both branches;
  fusion at t = s = start_timestep — x_start and the noisy states are
          fused through the binary mask;
  phase B (fused): t ∈ [s-1 .. 0] — one plain chain, optionally gated by
          a classifier: a rejected sample redoes the step from the saved
          masked branch pair (the retry), until it is accepted.

DDIM (`ddim_sample_plain`, `ddim_sample_branched`) walks the strided time
grid of `ddim_times` in (t, t_next) pairs, with the same [2B] branch pair;
the branched chain fuses at the first pair with t <= times[-s-2].  It has
no gate, as in the reference.

The condition features are encoded once per chain.  `sample` is the
top-level dispatch between these samplers, and `interpolate` the latent
interpolation between two images.

Noise comes from a noise source: a callable `noise(shape) -> Tensor`, called
once for the initial image and once per step, in chain order (so T + 1
draws per DDPM chain, for the plain and the branched sampler alike, gated
or not, and S + 1 per DDIM chain of S pairs, η = 0 included: the JAX
samplers draw then too).  By default it draws from a `torch.Generator` on
the device (`GeneratorNoise`); `ArrayNoise` hands out given arrays instead,
which is how a test replays the JAX package's key stream.

The gate's retries draw from a second source, `retry_noise`, once at each
post-fusion step where the gate runs (the retry is computed there for the
whole batch, used or not), so the main stream, and with it the plain chain,
is the same whether the gate runs or not (the JAX chain splits a key for
the plain step and one for the retry at every post-fusion step).  With
`noise` an int seed (or None, seed 0) and no `retry_noise`, the retries
draw from a generator seeded by `retry_seed(seed)`; with a noise source
given and no `retry_noise`, a retry raises.  An ungated chain builds no
retry source.

Over a mesh (`pipeline.LocalDiffusionPipeline(mesh=...)`) a rank runs a
chain on its 'data' rows, with noise sources that draw for the whole batch
and keep those rows (`parallel.multihost.RowsNoise`), and the branched
samplers take a `branch_split` (`parallel.mesh.BranchSplit`, the JAX
samplers' `branch_sharding`): the rank steps its share of the flat [2B]
pair over 'patch', and the pair is gathered where the chain needs both
halves, at the fusion and at each gated retry.  The fused chain after it
runs replicated over 'patch'.
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


def retry_seed(seed: int) -> int:
    """The seed of the gate's retry noise in a chain seeded by `seed`."""
    return int(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0])


def _no_retry_noise(shape) -> torch.Tensor:
    raise RuntimeError("the classifier gate's retry needs noise: pass retry_noise with a "
                       "given noise source (or noise as an int seed)")


def retry_source(noise, retry_noise, device):
    """The retries' noise source (see the module docstring)."""
    if retry_noise is not None:
        return as_noise(retry_noise, device)
    if noise is None or isinstance(noise, (int, np.integer)):
        return GeneratorNoise(retry_seed(0 if noise is None else noise), device)
    return _no_retry_noise


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


class _Pair:
    """The rows [lo, hi) of the flat [2B] branch pair this rank steps, and
    the pair gathered back (`parallel.mesh.BranchSplit`; the whole pair, no
    gather, without one)."""

    def __init__(self, b: int, split=None):
        self.n, self.split = 2 * b, split
        self.lo, self.hi = (0, 2 * b) if split is None else split.bounds(2 * b)
        self.rows = self.hi - self.lo

    def part(self, x2):
        return x2 if self.split is None else x2[self.lo:self.hi]

    def gather(self, *parts):
        """Each part [rows, ..., C] of the pair whole, [2B, ..., C] (one
        gather for all, concatenated on the channels)."""
        if self.split is None:
            return parts
        whole = self.split.gather(torch.cat(parts, -1), self.n)
        return torch.split(whole, [p.shape[-1] for p in parts], -1)

    def any(self, flag: bool) -> bool:
        return flag if self.split is None else self.split.any(flag)


def _branch_starts(gd, scfg: SamplerConfig, m, cond_out, feat_pair, lo: float, hi: float,
                   pair: _Pair):
    """(x2, tb2[, force_mask_x]) → the branches' x_start from one UNet call
    on `pair`'s rows of the flat [2B] pair (OOD half first), the mask_x
    policy on the OOD half (with mask_x set, or forced as the gate's retry
    forces it), clipped to [lo, hi]."""
    b, device = m.shape[0], m.device
    out_half = pair.part(torch.cat([torch.ones(b, 1, 1, 1, dtype=torch.bool, device=device),
                                    torch.zeros(b, 1, 1, 1, dtype=torch.bool, device=device)]))
    feat_pair = pair.part(feat_pair)
    if scfg.mask_x_policy == "cond":
        mask_x_repl2 = pair.part(torch.cat([cond_out, torch.zeros_like(cond_out)]))
    else:
        mask_x_mult2 = pair.part(torch.cat([m, torch.ones_like(m)]))
        mask_x_zero2 = pair.part(torch.cat([m == 0.0, torch.zeros_like(m, dtype=torch.bool)]))

    def starts(x2, tb2, force_mask_x=False):
        out2 = gd.apply_model(x2, None, tb2, cond_feat=feat_pair)
        xs2 = dm.model_output_to_x_start(gd.schedule, out2, x2, tb2)
        if scfg.mask_x or force_mask_x:
            if scfg.mask_x_policy == "cond":
                xs2 = torch.where(out_half, mask_x_repl2, xs2)
            else:
                xs2 = torch.where(mask_x_zero2, torch.full_like(xs2, lo), xs2 * mask_x_mult2)
        return xs2.clamp(lo, hi)

    return starts


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
                         classifier_fn=None, return_all: bool = False,
                         return_fusion_time: bool = False, retry_noise=None, clock=None,
                         return_debug: bool = False, branch_split=None):
    """Branched local-diffusion DDPM with fusion at `start_timestep`.

    cond: [B, H, W, C]; mask: [B, H, W, 1].  Returns the final image
    [B, H, W, C] (or the branch pair [2, B, H, W, C] when start_intermediate
    is False).  `return_all` → (final, frames), frames [T+1, 2, B, H, W, C]:
    the initial noise, then one frame per step (the (OOD, IND) pair while
    branched, the fused image duplicated on the pair axis once fused).
    `return_fusion_time` appends the per-sample acceptance timestep of the
    gate ([B] int32; `num_timesteps` where the gate never ran) after them.
    `return_debug` appends instead the fusion step's dumps, raw (not
    unnormalized): {'pred_out', 'pred_in'} the branches' clipped x_start
    (the OOD half under mask_x), 'pred_concat' the fused clipped x_start,
    {'x_out', 'x_in'} the masked noisy branch states and 'fusion_time'.

    The gate runs when `scfg.classifier` is set and `classifier_fn` given:
    `classifier_fn(x_start, t)` → [B] float32, accept where > 0.  At each
    post-fusion step a sample not yet accepted takes the plain step if the
    gate accepts its clipped x_start, at t == 0, or once it has been
    rejected `max_classifier_retries` times (0: no budget); otherwise the
    step is redone from the saved masked branch pair with fresh [2B]
    predictions under mask_x (the retry).  Once accepted a sample stays
    on the plain chain.  While any sample is unlatched, every step runs the
    gate and the retry for the whole batch; whether one is left is read on
    the host once per post-fusion step (4 reads at start_timestep 5).
    `retry_noise` draws the retries' noise (see the module docstring).
    `clock` (an `ood.patchcore.StageClock`) is marked at phase B's start
    ('chain') and after each post-fusion step's plain step ('plain'), gate
    ('gate') and retry with the selection ('retry').  `branch_split` (see
    the module docstring) steps this rank's share of the pair, gathers it
    at the fusion and at each retry, and reads the latch over every rank.
    """
    scfg = reconcile(scfg)
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise_arg, noise = noise, as_noise(noise, device)
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

    # both branches as ONE flat [2B] batch: OOD half first, then IND (this
    # rank's rows of it under a branch split)
    pair = _Pair(b, branch_split)
    x2 = pair.part(torch.cat([img0, img0]))
    branch_starts2 = _branch_starts(gd, scfg, m, cond_out, feat_pair, lo, hi, pair)

    def branched_step(x2, t):
        tb2 = _tb(t, pair.rows, device)
        xs2 = branch_starts2(x2, tb2)
        mean2, _, logvar2 = dm.q_posterior(sched, xs2, x2, tb2)
        n = _step_noise(noise, shape, t)  # shared across the branches
        return mean2 + torch.exp(0.5 * logvar2) * pair.part(torch.cat([n, n]))

    debug = {}

    def fuse_step(x2, t, source, force_mask_x=False, capture_debug=False):
        """The fused step at t from (this rank's rows of) the branch pair:
        (image, the whole masked pair).  A retry passes the saved masked
        pair with mask_x forced."""
        xs2, x2 = pair.gather(branch_starts2(x2, _tb(t, pair.rows, device), force_mask_x), x2)
        xs_out, xs_in = xs2[:b], xs2[b:]
        x_start = (xs_in * (1.0 - m) + xs_out).clamp(lo, hi)  # xs_out is mask_x-masked
        x_out, x_in = x2[:b] * m, x2[b:] * (1.0 - m)
        x = fuse_noisy_states(x_out, x_in, m, scfg.fusion_route)
        if capture_debug:
            debug.update(pred_out=xs_out, pred_in=xs_in, pred_concat=x_start,
                         x_out=x_out, x_in=x_in)
        tb = _tb(t, b, device)
        mean, _, logvar = dm.q_posterior(sched, x_start, x, tb)
        img = mean + torch.exp(0.5 * logvar) * _step_noise(source, shape, t)
        return img, torch.cat([x_out, x_in])

    def plain_step(x, t):
        """The fused chain's plain step: (image, its clipped x_start)."""
        tb = _tb(t, b, device)
        out = gd.apply_model(x, None, tb, cond_feat=feat_full)
        x_start = dm.model_output_to_x_start(sched, out, x, tb).clamp(lo, hi)
        mean, _, logvar = dm.q_posterior(sched, x_start, x, tb)
        return mean + torch.exp(0.5 * logvar) * _step_noise(noise, shape, t), x_start

    frames = [torch.stack([img0, img0])]

    def record_pair(x2):
        if return_all:
            frames.append(pair.gather(x2)[0].reshape(2, b, *x2.shape[1:]))

    def record_fused(x):
        if return_all:
            frames.append(torch.stack([x, x]))

    accept_t = torch.full((b,), gd.num_timesteps, dtype=torch.int32, device=device)

    def finish(result, fused=True):
        out = [_maybe_unnorm(gd, result)]
        if return_all:
            out.append(_maybe_unnorm(gd, torch.stack(frames)))
        if return_debug and fused:
            debug["fusion_time"] = accept_t
            out.append(debug)
        elif return_fusion_time and fused:
            out.append(accept_t)
        return tuple(out) if len(out) > 1 else out[0]

    s = int(scfg.start_timestep)
    if not scfg.start_intermediate:
        for t in range(t_top - 1, -1, -1):
            x2 = branched_step(x2, t)
            record_pair(x2)
        x2 = pair.gather(x2)[0]
        return finish(x2.reshape(2, b, *x2.shape[1:]), fused=False)

    # ---- phase A: branched steps t ∈ [T-1 .. s+1] ----
    for t in range(t_top - 1, s, -1):
        x2 = branched_step(x2, t)
        record_pair(x2)

    # ---- fusion at t = s ----
    t_fuse = min(s, t_top - 1)
    img, x_branchout2 = fuse_step(x2, t_fuse, noise, capture_debug=return_debug)
    record_fused(img)
    if clock is not None:
        clock.mark("chain")

    # ---- phase B: fused steps t ∈ [s-1 .. 0], gated or not ----
    gating = scfg.classifier and classifier_fn is not None
    if gating:
        accepted = torch.zeros(b, dtype=torch.bool, device=device)
        rejects = torch.zeros(b, dtype=torch.int32, device=device)
        budget = int(scfg.max_classifier_retries)
        retry = retry_source(noise_arg, retry_noise, device)
    for t in range(t_fuse - 1, -1, -1):
        img_plain, xs_plain = plain_step(img, t)
        if clock is not None:
            clock.mark("plain")
        if not gating:
            img = img_plain
            record_fused(img)
            continue
        accept_now = classifier_fn(xs_plain, t).reshape(b) > 0.0
        if t == 0:
            accept_now = torch.ones_like(accept_now)
        if budget > 0:
            accept_now = accept_now | (rejects >= budget)
        if clock is not None:
            clock.mark("gate")
        img_retry, _ = fuse_step(pair.part(x_branchout2), t, retry, force_mask_x=True)
        use_plain = accepted | accept_now
        img = torch.where(use_plain[:, None, None, None], img_plain, img_retry)
        accept_t = torch.where(accepted | ~accept_now, accept_t, torch.full_like(accept_t, t))
        rejects = rejects + (~use_plain).to(torch.int32)
        accepted = use_plain
        if clock is not None:
            clock.mark("retry")
        record_fused(img)
        # the latch: once every sample is accepted the gate cannot fire
        # again (over a mesh, every sample of every rank)
        gating = t > 0 and pair.any(not bool(accepted.all()))
    return finish(img)


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def ddim_times(total_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """Strided DDIM time grid, descending, with the trailing -1."""
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    return np.asarray(list(reversed(times.astype(int).tolist())))


def _ddim_coeffs(sched, t: int, t_next: int, eta: float):
    """(sqrt(alpha_next), c, sigma) of the DDIM update from t to t_next, as
    float32 tensors computed from the schedule's float32 alphas."""
    alpha = sched.alphas_cumprod[t]
    alpha_next = sched.alphas_cumprod[t_next] if t_next >= 0 else torch.ones_like(alpha)
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
    c = torch.sqrt((1.0 - alpha_next - sigma**2).clamp(min=0.0))
    return torch.sqrt(alpha_next), c, sigma


def _ddim_pairs(gd):
    times = ddim_times(gd.num_timesteps, gd.diff_cfg.resolved_sampling_timesteps)
    return times, [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]


def _ddim_step(gd, img, t: int, t_next: int, cond_feat, min_max_val, eta: float, n):
    """One plain DDIM update with noise n: x_start clipped, pred_noise
    rederived from it; the terminal pair (t_next < 0) returns x_start."""
    pred = gd.model_predictions(img, _tb(t, img.shape[0], img.device), cond_feat,
                                min_max_val, clip_x_start=True, rederive_pred_noise=True)
    if t_next < 0:
        return pred.pred_x_start
    sa, c, sigma = _ddim_coeffs(gd.schedule, t, t_next, eta)
    return pred.pred_x_start * sa + c * pred.pred_noise + sigma * n


@torch.no_grad()
def ddim_sample_plain(gd, cond, min_max_val: Tuple[float, float], noise=None,
                      return_all: bool = False):
    """Plain DDIM over the strided pairs (η = `ddim_sampling_eta`, 0 by
    default): x_start clipped, pred_noise rederived from it; the final pair
    (t_next < 0) returns x_start.  cond: [B, H, W, C]."""
    noise = as_noise(noise, cond.device)
    eta = float(gd.diff_cfg.ddim_sampling_eta)
    shape = (cond.shape[0], gd.image_size, gd.image_size, gd.model_cfg.channels)
    _, pairs = _ddim_pairs(gd)

    img = noise(shape)
    cond_feat = gd.encode_cond(cond)
    frames = [img]
    for t, t_next in pairs:
        # noise drawn at every pair, as the JAX chain draws it
        img = _ddim_step(gd, img, t, t_next, cond_feat, min_max_val, eta, noise(shape))
        if return_all:
            frames.append(img)
    if return_all:
        return _maybe_unnorm(gd, img), _maybe_unnorm(gd, torch.stack(frames))
    return _maybe_unnorm(gd, img)


@torch.no_grad()
def ddim_sample_branched(gd, cond, mask, scfg: SamplerConfig,
                         min_max_val: Tuple[float, float], noise=None,
                         return_all: bool = False, branch_split=None):
    """Branched DDIM with mid-chain fusion.

    The OOD and IND branches step as one [2B] batch (OOD half first, the
    same noise for both) over the pairs before the fusion index, the first
    pair with t <= times[-start_timestep-2].  At that pair the branches'
    x_start (mask_x on the OOD half, clipped, pred_noise rederived from it)
    and pred_noise are fused through the mask, x_start clipped again, and
    the DDIM update taken; the later pairs run plain DDIM.  When the fusion
    pair is the terminal one (t_next < 0) the unfused pair of x_starts is
    returned, as the reference checks t_next < 0 before fusing; with
    `start_intermediate` False, or no pair at or below the fusion time, the
    branches run to the end and the pair [2, B, H, W, C] is returned.

    `return_all` → (final, frames), frames [S+1, 2, B, H, W, C]: the
    initial noise, the branch pair while branched, the fused image
    duplicated on the pair axis after fusion.  There is no classifier gate
    here, as in the reference: a configuration with `sampler.classifier`
    runs ungated.  `branch_split` (see the module docstring) steps this
    rank's share of the pair and gathers it at the fusion pair.
    """
    scfg = reconcile(scfg)
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    eta = float(gd.diff_cfg.ddim_sampling_eta)
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)
    times, pairs = _ddim_pairs(gd)
    fuse_time = int(times[-scfg.start_timestep - 2])
    fuse_idx = next((i for i, (t, _) in enumerate(pairs) if t <= fuse_time), None)

    m = binarize_mask(mask)
    cond_out, cond_in = partition_cond(cond, m, scfg.cond_in_floor)
    feat_pair = torch.cat([gd.encode_cond(cond_out), gd.encode_cond(cond_in)])
    feat_full = gd.encode_cond(cond)

    img0 = noise(shape)
    pair = _Pair(b, branch_split)
    x2 = pair.part(torch.cat([img0, img0]))
    starts2 = _branch_starts(gd, scfg, m, cond_out, feat_pair, lo, hi, pair)

    def branch_preds2(x2, tb2):
        """Both branches' clipped x_start and the pred_noise rederived from
        it."""
        xs2 = starts2(x2, tb2)
        return xs2, dm.predict_noise_from_start(sched, x2, tb2, xs2)

    frames = [torch.stack([img0, img0])]

    def as_pair(x2):
        return x2.reshape(2, b, *x2.shape[1:])

    def finish(result):
        if return_all:
            return _maybe_unnorm(gd, result), _maybe_unnorm(gd, torch.stack(frames))
        return _maybe_unnorm(gd, result)

    def branched_step(x2, t, t_next):
        xs2, pn2 = branch_preds2(x2, _tb(t, pair.rows, device))
        sa, c, sigma = _ddim_coeffs(sched, t, t_next, eta)
        n = noise(shape)  # shared across the branches
        x2 = xs2 if t_next < 0 else xs2 * sa + c * pn2 + sigma * pair.part(torch.cat([n, n]))
        if return_all:
            frames.append(as_pair(pair.gather(x2)[0]))
        return x2

    if not scfg.start_intermediate or fuse_idx is None:
        for t, t_next in pairs:
            x2 = branched_step(x2, t, t_next)
        return finish(as_pair(pair.gather(x2)[0]))

    for t, t_next in pairs[:fuse_idx]:
        x2 = branched_step(x2, t, t_next)

    # ---- fusion pair: the whole pair gathered ----
    t, t_next = pairs[fuse_idx]
    xs2, pn2 = pair.gather(*branch_preds2(x2, _tb(t, pair.rows, device)))
    if t_next < 0:
        if return_all:
            frames.append(as_pair(xs2))
        return finish(as_pair(xs2))
    x_start = fuse_noisy_states(xs2[:b], xs2[b:], m, scfg.fusion_route).clamp(lo, hi)
    pred_noise = fuse_noisy_states(pn2[:b] * m, pn2[b:] * (1.0 - m), m, scfg.fusion_route)
    sa, c, sigma = _ddim_coeffs(sched, t, t_next, eta)
    img = x_start * sa + c * pred_noise + sigma * noise(shape)
    if return_all:
        frames.append(torch.stack([img, img]))

    # ---- plain DDIM on the fused chain ----
    for t, t_next in pairs[fuse_idx + 1:]:
        img = _ddim_step(gd, img, t, t_next, feat_full, min_max_val, eta, noise(shape))
        if return_all:
            frames.append(torch.stack([img, img]))
    return finish(img)


# ---------------------------------------------------------------------------
# latent interpolation and the top-level dispatch
# ---------------------------------------------------------------------------

@torch.no_grad()
def interpolate(gd, x1, x2, cond, min_max_val: Tuple[float, float], t: Optional[int] = None,
                lam: float = 0.5, noise=None):
    """Latent interpolation: both endpoints noised to x_t (t defaults to
    T-1), each with its own draw, lerped by `lam`, then denoised from t-1 to
    0 with x_start clipped to `min_max_val`.  Returns the raw image (not
    unnormalized).  x1, x2, cond: [B, H, W, C].  Noise: two draws for the
    endpoints, then one per step, zeroed at t == 0 (the JAX key stream:
    split(key, 3) for the endpoints, one split per step)."""
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    b = x1.shape[0]
    t = gd.num_timesteps - 1 if t is None else int(t)
    tb = _tb(t, b, device)
    xt1 = dm.q_sample(sched, x1, tb, noise(tuple(x1.shape)))
    xt2 = dm.q_sample(sched, x2, tb, noise(tuple(x2.shape)))
    img = (1.0 - lam) * xt1 + lam * xt2

    cond_feat = gd.encode_cond(cond)
    for tt in range(t - 1, -1, -1):
        tb = _tb(tt, b, device)
        out = gd.apply_model(img, None, tb, cond_feat=cond_feat)
        x_start = dm.model_output_to_x_start(sched, out, img, tb).clamp(lo, hi)
        mean, _, logvar = dm.q_posterior(sched, x_start, img, tb)
        img = mean + torch.exp(0.5 * logvar) * _step_noise(noise, tuple(img.shape), tt)
    return img


def _all_ones(mask) -> bool:
    """Whether every mask value is 1, read on the host: a numpy mask or a
    CPU tensor as it is, a device tensor through one copy."""
    m = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    return bool(m.min() >= 1.0 and m.max() <= 1.0)


def sample(gd, cond, scfg: SamplerConfig, min_max_val: Tuple[float, float], mask=None,
           gt=None, classifier_fn=None, return_all: bool = False, noise=None,
           retry_noise=None):
    """Flag reconciliation, then dispatch to a sampler.

    `reconcile` first (a detector- or confidence-driven run forces mask_x
    and mask_cond on).  The chain branches when `scfg.branch_out` is set and
    a mask is given that is not uniformly ones (decided on the host: the
    detector found no anomaly, the original reverse process runs).  DDIM
    when `gd.is_ddim_sampling`, else DDPM; the plain DDPM chain gets `gt`
    and `use_gt_timestep` only under `use_gt` and `start_intermediate`.
    cond, gt: [B, H, W, C] tensors; mask: [B, H, W, 1], numpy or a tensor
    (moved to cond's device for the branched chain).  `noise` and
    `retry_noise` as the samplers take them (see the module docstring)."""
    scfg = reconcile(scfg)
    branch = scfg.branch_out and mask is not None and not _all_ones(mask)
    if branch and not isinstance(mask, torch.Tensor):
        mask = torch.as_tensor(np.asarray(mask, np.float32), device=cond.device)

    if gd.is_ddim_sampling:
        if branch:
            return ddim_sample_branched(gd, cond, mask, scfg, min_max_val, noise=noise,
                                        return_all=return_all)
        return ddim_sample_plain(gd, cond, min_max_val, noise=noise, return_all=return_all)

    if branch:
        return ddpm_sample_branched(gd, cond, mask, scfg, min_max_val, noise=noise, gt=gt,
                                    classifier_fn=classifier_fn, return_all=return_all,
                                    retry_noise=retry_noise)
    gt_arg = gt if (scfg.use_gt and scfg.start_intermediate) else None
    return ddpm_sample_plain(gd, cond, min_max_val, noise=noise, gt=gt_arg,
                             use_gt_timestep=scfg.use_gt_timestep if gt_arg is not None else None,
                             return_all=return_all)
