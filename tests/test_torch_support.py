"""Shared pieces of the PyTorch-port parity tests (no tests of its own).

Both packages get the same inputs, made from a seed with numpy, and the same
weights: the JAX params tree is carried into the port by `params_from_jax`.
The samplers get the same noise: `plain_noise` / `branched_noise` draw the
JAX key stream in the JAX samplers' own split order, and the port takes the
arrays through its noise source.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion as TorchGD
from localdiffusion_tpu_torch.utils.params_io import params_from_jax

MMV = (0.0, 2.0)


def small_model_cfg() -> tcfg.ModelConfig:
    """A narrow UNet: dim 8, mults 1/2, full attention at the last stage."""
    return tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True),
                            channels=1, resnet_block_groups=4, attn_heads=2,
                            attn_dim_head=8)


def to_jax(cfg):
    """The JAX package's dataclass with the same field values."""
    cls = getattr(jcfg, type(cfg).__name__)
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jax_config(cfg: tcfg.Config) -> jcfg.Config:
    return jcfg.Config(model=to_jax(cfg.model), diffusion=to_jax(cfg.diffusion),
                       sampler=to_jax(cfg.sampler), ood=to_jax(cfg.ood),
                       data=to_jax(cfg.data), train=to_jax(cfg.train))


def perturbed(params, seed=0, std=0.1):
    """Random-init params with seeded noise on every 1-D leaf (biases and
    norm gains start at 0 or 1, which would hide a swapped mapping)."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 1:
            a = a + std * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map(f, params)


def numpy_params(template, seed=0):
    """A params tree shaped like `template` (a `jax.eval_shape` of the
    init), filled from a seeded numpy generator: kernels N(0, 1/fan_in),
    norm gains 1 and biases 0, each 1-D leaf with 0.1 noise.  It skips
    flax's init, which runs op by op and takes about a minute for a
    4-stage UNet on the CPU."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            base = 1.0 if getattr(path[-1], "key", None) in ("scale", "g") else 0.0
            a = base + 0.1 * rng.standard_normal(s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, template)


def make_pair(model_cfg, diff_cfg, seed=0, dtype="float32", numpy_init=False):
    """(JAX engine, JAX params, port engine on the CPU) sharing weights,
    both computing in `dtype`.  The weights are the JAX init, perturbed, or
    with `numpy_init` drawn by `numpy_params`."""
    jgd = JaxGD(to_jax(model_cfg), to_jax(diff_cfg), dtype=getattr(jnp, dtype))
    if numpy_init:
        template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(seed)))
        params = numpy_params(template, seed)
    else:
        params = perturbed(jgd.init_params(jax.random.PRNGKey(seed)), seed)
    tgd = TorchGD(model_cfg, diff_cfg, device="cpu", dtype=getattr(torch, dtype))
    tgd.model.load_state_dict(params_from_jax(params, tgd.model))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jgd, params, tgd


def plain_noise(key, shape, timesteps):
    """The noise `ddpm_sample_plain` draws from `key`: the initial image,
    then one draw per step."""
    key, init_key = jax.random.split(key)
    out = [jax.random.normal(init_key, shape, dtype=jnp.float32)]
    k = key
    for _ in range(timesteps):
        k, nk = jax.random.split(k)
        out.append(jax.random.normal(nk, shape, dtype=jnp.float32))
    return [np.asarray(a) for a in out]


def branched_noise(key, shape, timesteps, start_timestep):
    """The noise `ddpm_sample_branched` (fused at start_timestep, no gate)
    draws from `key`: initial image, phase A steps, the fusion step, then
    the phase-B steps, which split their key three ways."""
    key, init_key = jax.random.split(key)
    out = [jax.random.normal(init_key, shape, dtype=jnp.float32)]
    k = key
    for _ in range(timesteps - 1, start_timestep, -1):
        k, nk = jax.random.split(k)
        out.append(jax.random.normal(nk, shape, dtype=jnp.float32))
    k, fk = jax.random.split(k)
    out.append(jax.random.normal(fk, shape, dtype=jnp.float32))
    t_fuse = min(start_timestep, timesteps - 1)
    for _ in range(t_fuse):
        k, pk, _rk = jax.random.split(k, 3)
        out.append(jax.random.normal(pk, shape, dtype=jnp.float32))
    return [np.asarray(a) for a in out]


def retry_noise(key, shape, timesteps, start_timestep, gated_steps):
    """The noise the gated `ddpm_sample_branched` draws from `key` for its
    retries: each phase-B step splits its key three ways, (k, pk, rk), and
    the retry at a step where the gate runs draws from rk.  The gate runs
    at the first `gated_steps` phase-B steps (until every sample latched)."""
    key, _ = jax.random.split(key)
    k = key
    for _ in range(timesteps - 1, start_timestep, -1):
        k, _ = jax.random.split(k)
    k, _ = jax.random.split(k)
    out = []
    for _ in range(gated_steps):
        k, _pk, rk = jax.random.split(k, 3)
        out.append(np.asarray(jax.random.normal(rk, shape, dtype=jnp.float32)))
    return out


def flair_targets(cfg, n, seed, tumor=False):
    """(hr FLAIR, lr T1, seg) synthetic brains of the JAX package's data
    module, at `cfg`'s size and normalization."""
    from localdiffusion_tpu.data.synthetic import synthetic_brain_translation

    d = cfg.data
    return synthetic_brain_translation(
        n, cfg.diffusion.image_size, tumor=tumor, seed=seed, mean_t1=d.mean_t1,
        std_t1=d.std_t1, mean_flair=d.mean_flair, std_flair=d.std_flair,
        translate_zero=d.translate_zero)


def narrow_gated(size=64, timesteps=6):
    """`mri256_gated_config()` with a narrow UNet (dim 8), at `size` and T
    `timesteps`, f32, in both packages on shared numpy-drawn weights, and
    the classifier bank JAX builds from 4 normal FLAIR targets (seed 11) as
    scripts/eval_gated_quality.py does (5%; 48 channels, so no k-center
    projection): {cfg, jc, jgd, params, tgd, jpc, tpc, bank}, the two
    PatchCores over the denoiser's taps at t=5 holding that bank."""
    from localdiffusion_tpu.ood.features import DenoiserFeatureSource as JSource
    from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
    from localdiffusion_tpu_torch.ood.features import DenoiserFeatureSource as TSource
    from localdiffusion_tpu_torch.ood.patchcore import PatchCore as TPatchCore

    base = tcfg.mri256_gated_config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, dim=8, attn_heads=2, attn_dim_head=8),
        diffusion=dataclasses.replace(base.diffusion, image_size=size, timesteps=timesteps),
        ood=dataclasses.replace(base.ood, input_size=size, memory_bank_path=None),
        train=dataclasses.replace(base.train, compute_dtype="float32"))
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=3, numpy_init=True)
    jc = jax_config(cfg)
    jpc = JPatchCore(jc.ood, source=JSource(jgd, params, t=5))
    bank = jpc.build_memory_bank([flair_targets(cfg, 4, 11)[0]], sampling_ratio=0.05)
    tpc = TPatchCore(cfg.ood, source=TSource(tgd, t=5), memory_bank=bank)
    return dict(cfg=cfg, jc=jc, jgd=jgd, params=params, tgd=tgd, jpc=jpc, tpc=tpc, bank=bank)


def recording(gate, seen):
    """The gate, each value it returns appended to `seen`."""
    def rec(x, t):
        v = gate(x, t)
        seen.append(v.clone())
        return v
    return rec


def split_threshold(scores):
    """A threshold halfway between the two lowest scores."""
    s = np.sort(np.asarray(scores))
    return float((s[0] + s[1]) / 2)


def left_mask(b, s, cols):
    m = np.zeros((b, s, s, 1), np.float32)
    m[:, :, :cols] = 1.0
    return m


def images(seed, b, s, c=1):
    return np.random.default_rng(seed).uniform(0, 2, (b, s, s, c)).astype(np.float32)


def t_cpu(a):
    return torch.as_tensor(np.asarray(a))
