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


def make_pair(model_cfg, diff_cfg, seed=0):
    """(JAX engine, JAX params, port engine on the CPU) sharing weights."""
    jgd = JaxGD(to_jax(model_cfg), to_jax(diff_cfg))
    params = perturbed(jgd.init_params(jax.random.PRNGKey(seed)), seed)
    tgd = TorchGD(model_cfg, diff_cfg, device="cpu")
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


def left_mask(b, s, cols):
    m = np.zeros((b, s, s, 1), np.float32)
    m[:, :, :cols] = 1.0
    return m


def images(seed, b, s, c=1):
    return np.random.default_rng(seed).uniform(0, 2, (b, s, s, c)).astype(np.float32)


def t_cpu(a):
    return torch.as_tensor(np.asarray(a))
