"""Local-diffusion DDPM and DDIM sampling.  Port of
`localdiffusion_tpu/diffusion/sampler.py`.

The JAX package runs each phase as a `lax.scan` over a traced timestep; here
each phase is a Python loop over the timesteps with static shapes, whose
every step is a step body handed to a step runner (`steps`):

  phase A (branched): t ∈ [T-1 .. s+1] — the OOD and IND branches advance
          together as ONE flat [2B] UNet batch (OOD half first), with the
          same noise for both branches;
  fusion at t = s = start_timestep — x_start and the noisy states are
          fused through the binary mask;
  phase B (fused): t ∈ [s-1 .. 0] — one plain chain, optionally gated by
          a classifier: a rejected sample redoes the step from the saved
          masked branch pair (the retry), until it is accepted.

A step body is a function of one dict of tensors: the chain's (the
condition features, the masks, the DDIM coefficient table; given once a
chain to `steps.begin`), the step's (the state 'x' and the noise 'n') and
't', a 0-dim int64 tensor on the device that holds the step's timestep.  A
body reads the timestep only through 't' and reads nothing on the host, so
the same body runs eagerly (`EagerSteps`, the default) and as a CUDA graph
captured once and replayed step by step (`diffusion.compiled.GraphSteps`,
which `pipeline.translate` uses on the card: the counterpart of the scan
body traced once).  The decisions between steps (the phase boundaries, the
gate's latch) stay on the host.

DDIM (`ddim_sample_plain`, `ddim_sample_branched`) walks the strided time
grid of `ddim_times` in (t, t_next) pairs, with the same [2B] branch pair;
the branched chain fuses at the first pair with t <= times[-s-2].  It has
no gate, as in the reference.  Its coefficients (√ᾱ_next, c, σ) come from a
table computed once a chain, indexed on the device by t; the terminal pair
(t_next < 0), which returns x_start, is a body of its own.

The condition features are encoded once per chain.  `sample` is the
top-level dispatch between these samplers, and `interpolate` the latent
interpolation between two images.

Noise comes from a noise source: a callable `noise(shape) -> Tensor`, called
once for the initial image and once per step, in chain order (so T + 1
draws per DDPM chain, for the plain and the branched sampler alike, gated
or not, and S + 1 per DDIM chain of S pairs, η = 0 included: the JAX
samplers draw then too; a branched DDIM chain whose fusion pair is the
terminal one draws S).  The draw is taken on the host side of a step and
handed to its body, never inside a body, so a replayed chain draws what the
eager one draws.  By default it draws from a `torch.Generator` on the
device (`GeneratorNoise`); `ArrayNoise` hands out given arrays instead,
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
runs replicated over 'patch'.  Such a chain runs eagerly: its gathers are
collectives between ranks, which a graph cannot hold.
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


def _step_noise(n, t):
    """The step's noise n, zeroed where the device timestep t is 0 (the
    draw is still taken, so the stream stays in step with the chain)."""
    return torch.where(t > 0, n, torch.zeros_like(n))


def _tb(t: int, n: int, device):
    return torch.full((n,), t, dtype=torch.long, device=device)


class EagerSteps:
    """The step runner of an eager chain: `steps(name, body, t, **step)`
    writes t into the device timestep and calls the body at once on the
    chain's tensors (`begin`), the step's and 't'.  `name` is the body's
    program name, which `diffusion.compiled.GraphSteps` captures it under."""

    compiled = False

    def __init__(self, device):
        self.t = torch.zeros((), dtype=torch.long, device=device)
        self.chain = {}

    def begin(self, **tensors) -> None:
        self.chain = tensors

    def __call__(self, name: str, body, t: int, **step):
        self.t.fill_(int(t))
        return body({**self.chain, **step, "t": self.t})


def _as_steps(steps, device):
    return EagerSteps(device) if steps is None else steps


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


def _branch_chain(gd, scfg: SamplerConfig, cond, mask, pair: _Pair) -> dict:
    """The chain tensors of a branched chain: the binary mask 'm', the
    features of the whole condition ('feat_full') and of the partitioned
    pair on `pair`'s rows ('feat_pair'), and the mask_x policy's operands
    on those rows (OOD half first)."""
    m = binarize_mask(mask)
    cond_out, cond_in = partition_cond(cond, m, scfg.cond_in_floor)
    b, device = m.shape[0], m.device
    chain = dict(m=m, feat_full=gd.encode_cond(cond),
                 feat_pair=pair.part(torch.cat([gd.encode_cond(cond_out),
                                                gd.encode_cond(cond_in)])))
    if scfg.mask_x_policy == "cond":
        chain["out_half"] = pair.part(torch.cat([
            torch.ones(b, 1, 1, 1, dtype=torch.bool, device=device),
            torch.zeros(b, 1, 1, 1, dtype=torch.bool, device=device)]))
        chain["mask_x_repl2"] = pair.part(torch.cat([cond_out, torch.zeros_like(cond_out)]))
    else:
        chain["mask_x_mult2"] = pair.part(torch.cat([m, torch.ones_like(m)]))
        chain["mask_x_zero2"] = pair.part(torch.cat([m == 0.0,
                                                     torch.zeros_like(m, dtype=torch.bool)]))
    return chain


def _branch_starts(gd, scfg: SamplerConfig, lo: float, hi: float):
    """(s, x2, tb2[, force_mask_x]) → the branches' x_start from one UNet
    call on (this rank's rows of) the flat [2B] pair x2, the mask_x policy
    on the OOD half (with mask_x set, or forced as the gate's retry forces
    it), clipped to [lo, hi]; s holds the `_branch_chain` tensors."""

    def starts(s, x2, tb2, force_mask_x=False):
        out2 = gd.apply_model(x2, None, tb2, cond_feat=s["feat_pair"])
        xs2 = dm.model_output_to_x_start(gd.schedule, out2, x2, tb2)
        if scfg.mask_x or force_mask_x:
            if scfg.mask_x_policy == "cond":
                xs2 = torch.where(s["out_half"], s["mask_x_repl2"], xs2)
            else:
                xs2 = torch.where(s["mask_x_zero2"], torch.full_like(xs2, lo),
                                  xs2 * s["mask_x_mult2"])
        return xs2.clamp(lo, hi)

    return starts


def _ddpm_update(gd, x_start, x, t, n):
    """x_{t-1} from the clipped x_start: the posterior mean plus its
    standard deviation times the noise (zeroed at t == 0)."""
    mean, _, logvar = dm.q_posterior(gd.schedule, x_start, x, t.expand(x.shape[0]))
    return mean + torch.exp(0.5 * logvar) * _step_noise(n, t)


def _ddpm_plain_body(gd, feat: str, lo: float, hi: float):
    """The plain DDPM step on s['x'] with the features s[feat]: (image,
    its clipped x_start)."""

    def body(s):
        x, t = s["x"], s["t"]
        tb = t.expand(x.shape[0])
        out = gd.apply_model(x, None, tb, cond_feat=s[feat])
        x_start = dm.model_output_to_x_start(gd.schedule, out, x, tb).clamp(lo, hi)
        return _ddpm_update(gd, x_start, x, t, s["n"]), x_start

    return body


@torch.no_grad()
def ddpm_sample_plain(gd, cond, min_max_val: Tuple[float, float], noise=None,
                      gt=None, use_gt_timestep: Optional[int] = None,
                      return_all: bool = False, steps=None):
    """Plain (non-branched) ancestral DDPM chain.  cond: [B, H, W, C].
    `steps`: the step runner (see the module docstring; eager by default)."""
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    steps = _as_steps(steps, device)
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)

    img = noise(shape)
    t_start = gd.num_timesteps
    if gt is not None and use_gt_timestep is not None:
        t_start = int(use_gt_timestep)
        img = dm.q_sample(gd.schedule, gt, _tb(t_start, b, device), img)

    steps.begin(feat=gd.encode_cond(cond))
    step = _ddpm_plain_body(gd, "feat", lo, hi)
    frames = [img]
    for t in range(t_start - 1, -1, -1):
        img, _ = steps("plain", step, t, x=img, n=noise(shape))
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
                         return_debug: bool = False, branch_split=None, steps=None):
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
    `steps`: the step runner (see the module docstring; eager by default):
    the [2B] phase-A step ('branched'), the fusion step ('fuse'; a retry
    under mask_x forced is 'retry', the same step when mask_x is set) and
    the phase-B step ('plain').  `return_debug` needs the eager runner.
    """
    scfg = reconcile(scfg)
    lo, hi = min_max_val
    device = cond.device
    noise_arg, noise = noise, as_noise(noise, device)
    steps = _as_steps(steps, device)
    if return_debug and steps.compiled:
        raise ValueError("return_debug dumps the fusion step's intermediates: use the eager runner")
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)

    # both branches as ONE flat [2B] batch: OOD half first, then IND (this
    # rank's rows of it under a branch split); the condition features
    # once per chain, not once per step
    pair = _Pair(b, branch_split)
    steps.begin(**_branch_chain(gd, scfg, cond, mask, pair))
    starts = _branch_starts(gd, scfg, lo, hi)

    img0 = noise(shape)
    t_top = gd.num_timesteps
    if scfg.use_gt and gt is not None:
        t_top = int(scfg.use_gt_timestep)
        img0 = dm.q_sample(gd.schedule, gt, _tb(t_top, b, device), img0)
    x2 = pair.part(torch.cat([img0, img0]))

    def branched_step(s):
        x2, t = s["x"], s["t"]
        xs2 = starts(s, x2, t.expand(pair.rows))
        n = s["n"]  # shared across the branches
        return _ddpm_update(gd, xs2, x2, t, pair.part(torch.cat([n, n])))

    debug = {}

    def fuse_step(s, force_mask_x=False, capture_debug=False):
        """The fused step from (this rank's rows of) the branch pair:
        (image, the whole masked pair).  A retry passes the saved masked
        pair with mask_x forced."""
        m, t = s["m"], s["t"]
        xs2, x2 = pair.gather(starts(s, s["x"], t.expand(pair.rows), force_mask_x), s["x"])
        xs_out, xs_in = xs2[:b], xs2[b:]
        x_start = (xs_in * (1.0 - m) + xs_out).clamp(lo, hi)  # xs_out is mask_x-masked
        x_out, x_in = x2[:b] * m, x2[b:] * (1.0 - m)
        x = fuse_noisy_states(x_out, x_in, m, scfg.fusion_route)
        if capture_debug:
            debug.update(pred_out=xs_out, pred_in=xs_in, pred_concat=x_start,
                         x_out=x_out, x_in=x_in)
        return _ddpm_update(gd, x_start, x, t, s["n"]), torch.cat([x_out, x_in])

    def fusion_step(s):
        return fuse_step(s, capture_debug=return_debug)

    def retry_step(s):
        return fuse_step(s, force_mask_x=True)

    plain_step = _ddpm_plain_body(gd, "feat_full", lo, hi)

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
            x2 = steps("branched", branched_step, t, x=x2, n=noise(shape))
            record_pair(x2)
        x2 = pair.gather(x2)[0]
        return finish(x2.reshape(2, b, *x2.shape[1:]), fused=False)

    # ---- phase A: branched steps t ∈ [T-1 .. s+1] ----
    for t in range(t_top - 1, s, -1):
        x2 = steps("branched", branched_step, t, x=x2, n=noise(shape))
        record_pair(x2)

    # ---- fusion at t = s ----
    t_fuse = min(s, t_top - 1)
    img, x_branchout2 = steps("fuse", fusion_step, t_fuse, x=x2, n=noise(shape))
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
        retry_name = "fuse" if scfg.mask_x else "retry"  # mask_x set: forcing it changes nothing
    for t in range(t_fuse - 1, -1, -1):
        img_plain, xs_plain = steps("plain", plain_step, t, x=img, n=noise(shape))
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
        img_retry, _ = steps(retry_name, retry_step, t, x=pair.part(x_branchout2),
                             n=retry(shape))
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


def _ddim_coeffs(sched, t, t_next, eta: float):
    """(sqrt(alpha_next), c, sigma) of the DDIM updates from t to t_next
    (int64 tensors of one shape; alpha_next = 1 where t_next < 0), as
    float32 tensors computed from the schedule's float32 alphas."""
    alpha = sched.alphas_cumprod[t]
    alpha_next = torch.where(t_next >= 0, sched.alphas_cumprod[t_next.clamp(min=0)],
                             torch.ones_like(alpha))
    sigma = eta * torch.sqrt((1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha))
    c = torch.sqrt((1.0 - alpha_next - sigma**2).clamp(min=0.0))
    return torch.sqrt(alpha_next), c, sigma


def _ddim_table(gd, pairs, eta: float) -> torch.Tensor:
    """[T, 3] float32 on the device: row t holds (sqrt(alpha_next), c,
    sigma) of the pair (t, t_next) of `pairs` (each t once on the strided
    grid; the other rows are 0), so a step body reads its coefficients by
    the device timestep."""
    dev = gd.schedule.alphas_cumprod.device
    t = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=dev)
    t_next = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=dev)
    table = torch.zeros((gd.num_timesteps, 3), dtype=torch.float32, device=dev)
    table[t] = torch.stack(_ddim_coeffs(gd.schedule, t, t_next, eta), -1)
    return table


def _coeffs_at(s):
    """The step's (sqrt(alpha_next), c, sigma), each 0-dim, from the table."""
    return s["coef"].index_select(0, s["t"].reshape(1))[0].unbind()


def _ddim_pairs(gd):
    times = ddim_times(gd.num_timesteps, gd.diff_cfg.resolved_sampling_timesteps)
    return times, [(int(a), int(b)) for a, b in zip(times[:-1], times[1:])]


def _ddim_bodies(gd, feat: str, min_max_val):
    """The plain DDIM pair on s['x'] with the features s[feat] and noise
    s['n'] (x_start clipped, pred_noise rederived from it), and the
    terminal pair (t_next < 0), which returns x_start."""

    def preds(s):
        x = s["x"]
        return gd.model_predictions(x, s["t"].expand(x.shape[0]), s[feat], min_max_val,
                                    clip_x_start=True, rederive_pred_noise=True)

    def step(s):
        pred = preds(s)
        sa, c, sigma = _coeffs_at(s)
        return pred.pred_x_start * sa + c * pred.pred_noise + sigma * s["n"]

    def terminal(s):
        return preds(s).pred_x_start

    return step, terminal


def _ddim_step(steps, bodies, img, t: int, t_next: int, n):
    """One plain DDIM pair through the runner: the terminal body when
    t_next < 0, which takes no noise."""
    step, terminal = bodies
    if t_next < 0:
        return steps("plain_terminal", terminal, t, x=img)
    return steps("plain", step, t, x=img, n=n)


@torch.no_grad()
def ddim_sample_plain(gd, cond, min_max_val: Tuple[float, float], noise=None,
                      return_all: bool = False, steps=None):
    """Plain DDIM over the strided pairs (η = `ddim_sampling_eta`, 0 by
    default): x_start clipped, pred_noise rederived from it; the final pair
    (t_next < 0) returns x_start.  cond: [B, H, W, C].  `steps`: the step
    runner (see the module docstring; eager by default): the pair
    ('plain') and the terminal pair ('plain_terminal')."""
    noise = as_noise(noise, cond.device)
    steps = _as_steps(steps, cond.device)
    eta = float(gd.diff_cfg.ddim_sampling_eta)
    shape = (cond.shape[0], gd.image_size, gd.image_size, gd.model_cfg.channels)
    _, pairs = _ddim_pairs(gd)

    img = noise(shape)
    steps.begin(feat=gd.encode_cond(cond), coef=_ddim_table(gd, pairs, eta))
    bodies = _ddim_bodies(gd, "feat", min_max_val)
    frames = [img]
    for t, t_next in pairs:
        # noise drawn at every pair, as the JAX chain draws it
        img = _ddim_step(steps, bodies, img, t, t_next, noise(shape))
        if return_all:
            frames.append(img)
    if return_all:
        return _maybe_unnorm(gd, img), _maybe_unnorm(gd, torch.stack(frames))
    return _maybe_unnorm(gd, img)


@torch.no_grad()
def ddim_sample_branched(gd, cond, mask, scfg: SamplerConfig,
                         min_max_val: Tuple[float, float], noise=None,
                         return_all: bool = False, branch_split=None, steps=None):
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
    rank's share of the pair and gathers it at the fusion pair.  `steps`:
    the step runner (see the module docstring; eager by default): the
    branched pair ('branched') and its terminal ('branched_terminal'), the
    fusion pair ('fuse'), the plain pair ('plain') and its terminal
    ('plain_terminal').
    """
    scfg = reconcile(scfg)
    sched = gd.schedule
    lo, hi = min_max_val
    device = cond.device
    noise = as_noise(noise, device)
    steps = _as_steps(steps, device)
    eta = float(gd.diff_cfg.ddim_sampling_eta)
    b = cond.shape[0]
    shape = (b, gd.image_size, gd.image_size, gd.model_cfg.channels)
    times, pairs = _ddim_pairs(gd)
    fuse_time = int(times[-scfg.start_timestep - 2])
    fuse_idx = next((i for i, (t, _) in enumerate(pairs) if t <= fuse_time), None)

    pair = _Pair(b, branch_split)
    steps.begin(coef=_ddim_table(gd, pairs, eta), **_branch_chain(gd, scfg, cond, mask, pair))
    starts = _branch_starts(gd, scfg, lo, hi)

    img0 = noise(shape)
    x2 = pair.part(torch.cat([img0, img0]))

    def branch_preds2(s):
        """Both branches' clipped x_start and the pred_noise rederived from
        it."""
        x2 = s["x"]
        tb2 = s["t"].expand(pair.rows)
        xs2 = starts(s, x2, tb2)
        return xs2, dm.predict_noise_from_start(sched, x2, tb2, xs2)

    def branched_pair(s):
        xs2, pn2 = branch_preds2(s)
        sa, c, sigma = _coeffs_at(s)
        n = s["n"]  # shared across the branches
        return xs2 * sa + c * pn2 + sigma * pair.part(torch.cat([n, n]))

    def branched_terminal(s):
        return branch_preds2(s)[0]

    def fuse_pair(s):
        m = s["m"]
        xs2, pn2 = pair.gather(*branch_preds2(s))
        x_start = fuse_noisy_states(xs2[:b], xs2[b:], m, scfg.fusion_route).clamp(lo, hi)
        pred_noise = fuse_noisy_states(pn2[:b] * m, pn2[b:] * (1.0 - m), m, scfg.fusion_route)
        sa, c, sigma = _coeffs_at(s)
        return x_start * sa + c * pred_noise + sigma * s["n"]

    plain = _ddim_bodies(gd, "feat_full", min_max_val)
    frames = [torch.stack([img0, img0])]

    def as_pair(x2):
        return x2.reshape(2, b, *x2.shape[1:])

    def finish(result):
        if return_all:
            return _maybe_unnorm(gd, result), _maybe_unnorm(gd, torch.stack(frames))
        return _maybe_unnorm(gd, result)

    def branched_step(x2, t, t_next):
        n = noise(shape)  # drawn at the terminal pair too
        if t_next < 0:
            x2 = steps("branched_terminal", branched_terminal, t, x=x2)
        else:
            x2 = steps("branched", branched_pair, t, x=x2, n=n)
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
    if t_next < 0:
        xs2 = pair.gather(steps("branched_terminal", branched_terminal, t, x=x2))[0]
        if return_all:
            frames.append(as_pair(xs2))
        return finish(as_pair(xs2))
    img = steps("fuse", fuse_pair, t, x=x2, n=noise(shape))
    if return_all:
        frames.append(torch.stack([img, img]))

    # ---- plain DDIM on the fused chain ----
    for t, t_next in pairs[fuse_idx + 1:]:
        img = _ddim_step(steps, plain, img, t, t_next, noise(shape))
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
        n = noise(tuple(img.shape))
        img = mean + torch.exp(0.5 * logvar) * (n if tt > 0 else torch.zeros_like(n))
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
