"""The 256px MRI configuration in the port, against the JAX package.

  * `mri256_config()` is `configs/mri_synthetic_256.yaml`, field by field;
  * the shipped checkpoint `results/mri_synth256_ema.npz` loads with every
    key consumed and every parameter set;
  * its UNet at a 64px input, port vs the JAX `UNet.apply` (the JAX engine
    would take its space-to-depth layout at ≥128px, which equals
    `UNet.apply` up to reassociation): float32 at atol/rtol 1e-4
    (convolution summation order), bfloat16 at relative L2 ≤ 5e-2 and
    correlation ≥ 0.999.  The bf16 bar is what independent bf16 rounding
    gives through the network's ~60 layers: the JAX package's own bf16
    output differs from its float32 output by 1.7e-2 relative L2 on this
    input, and the port's from JAX's by 2.4e-2;
  * the same UNet at a 128px input, port vs the JAX engine's `apply_model`,
    which at ≥128px takes the space-to-depth layout (`apply_unet_s2d`, the
    route the 64px cases never reach): float32 at atol/rtol 1e-4, the
    same bar as the standard layout, since the s2d layout reassociates the
    same float32 sums;
  * a narrow 4-stage chain in bf16 (64px, T=8, minval mask_x, floor 0.95),
    branched, with the JAX key stream replayed: relative L2 ≤ 0.15,
    correlation ≥ 0.99 and a max difference below 5% of the image range.
    Each of the chain's UNet calls carries the bf16 difference above, and
    the posterior steps add them up; a fault in the chain (mask, noise,
    fusion, clipping) shows as O(1) differences.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.utils.params_io import load_params_npz
from test_torch_support import branched_noise, make_pair, to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs/mri_synthetic_256.yaml")
NPZ = os.path.join(ROOT, "results/mri_synth256_ema.npz")
SECTIONS = ["model", "diffusion", "sampler", "ood", "data", "train"]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _corr(got, want):
    return float(np.corrcoef(got.ravel(), want.ravel())[0, 1])


def test_mri256_config_is_the_yaml():
    got = tcfg.mri256_config()
    want = jcfg.Config.load_yaml(YAML)
    with open(YAML) as f:
        parsed = tcfg.Config.from_dict(yaml.safe_load(f))
    for section in SECTIONS:
        for f in dataclasses.fields(getattr(got, section)):
            mine = getattr(getattr(got, section), f.name)
            assert mine == getattr(getattr(want, section), f.name), (section, f.name)
            assert mine == getattr(getattr(parsed, section), f.name), (section, f.name)
    assert tcfg.min_max_val_for(got) == jcfg.min_max_val_for(want)


def test_build_gd_takes_the_compute_dtype():
    cfg = tcfg.mri256_config()
    gd = build_gd(cfg, device="cpu")
    assert gd.dtype == torch.bfloat16 == gd.model.dtype
    assert {p.dtype for p in gd.model.parameters()} == {torch.float32}
    assert sum(p.numel() for p in gd.model.parameters()) == 12_140_481
    f32 = build_gd(cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32")),
                   device="cpu")
    assert f32.dtype == torch.float32
    with pytest.raises(ValueError, match="float16"):
        build_gd(cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float16")),
                 device="cpu")


def test_shipped_checkpoint_loads_every_key():
    if not os.path.exists(NPZ):
        pytest.fail("results/mri_synth256_ema.npz is missing from the checkout")
    gd = build_gd(tcfg.mri256_config(), device="cpu")
    sd = load_params_npz(NPZ, gd.model)
    with np.load(NPZ) as data:
        keys = data.files
        assert all(data[k].dtype == np.float16 for k in keys)  # fp16 storage
        for k in keys[:5]:
            name = k.split("/", 1)[1].replace("/", ".")
            name = name.replace("kernel", "weight").replace("scale", "weight")
            assert float(np.abs(data[k]).max()) > 0
            assert sd[name].abs().max() > 0
    assert len(sd) == len(keys) == len(gd.model.state_dict())
    assert all(v.dtype == torch.float32 for v in sd.values())
    gd.model.load_state_dict(sd)  # strict: no parameter is left unset


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    hi = tcfg.min_max_val_for(tcfg.mri256_config())[1]
    cond = rng.uniform(0, hi, (2, 64, 64, 1)).astype(np.float32)
    return x, cond, np.array([3, 180], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shipped_checkpoint_unet_matches_jax(dtype, unet_inputs):
    x, cond, t = unet_inputs
    jc = jcfg.Config.load_yaml(YAML)
    jgd = JaxGD(jc.model, jc.diffusion, dtype=getattr(jnp, dtype))
    template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    params = jax_load_npz(NPZ, template)
    want = np.asarray(jax.jit(jgd.model.apply)(params, jnp.asarray(x), jnp.asarray(cond),
                                               jnp.asarray(t)))
    cfg = tcfg.mri256_config()
    gd = build_gd(cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype)),
                  device="cpu")
    gd.model.load_state_dict(load_params_npz(NPZ, gd.model))
    got = gd.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t).long())
    assert got.dtype == torch.float32 and got.shape == want.shape  # float32 out, as JAX
    got = got.numpy()
    assert np.abs(want).max() > 0.5  # a trained model, not a zero output
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _rel(got, want) <= 5e-2
        assert _corr(got, want) >= 0.999
        feat = gd.encode_cond(torch.as_tensor(cond))
        assert feat.dtype == torch.bfloat16  # features in the compute type


def test_shipped_checkpoint_at_128px_matches_the_jax_s2d_route():
    rng = np.random.default_rng(6)
    hi = tcfg.min_max_val_for(tcfg.mri256_config())[1]
    x = rng.standard_normal((1, 128, 128, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (1, 128, 128, 1)).astype(np.float32)
    t = np.array([40], np.int32)
    jc = jcfg.Config.load_yaml(YAML)
    assert jc.model.resolve_exact_layout_s2d(128, 128) == 2  # the s2d route is taken
    jgd = JaxGD(jc.model, jc.diffusion)
    template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    params = jax_load_npz(NPZ, template)
    want = np.asarray(jax.jit(jgd.apply_model)(params, jnp.asarray(x), jnp.asarray(cond),
                                               jnp.asarray(t)))
    cfg = tcfg.mri256_config()
    gd = build_gd(cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32")),
                  device="cpu")
    gd.model.load_state_dict(load_params_npz(NPZ, gd.model))
    got = gd.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                         torch.as_tensor(t).long()).numpy()
    assert got.shape == want.shape == x.shape and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_narrow_bf16_branched_chain_matches_jax():
    T, S, B = 8, 64, 2
    mcfg = tcfg.ModelConfig(dim=8, dim_mults=(1, 2, 4, 8),
                            full_attn=(False, False, False, True), channels=1,
                            resnet_block_groups=4, attn_heads=2, attn_dim_head=8,
                            cond_encoder_depth="deep")
    jgd, params, tgd = make_pair(mcfg, tcfg.DiffusionConfig(image_size=S, timesteps=T),
                                 seed=3, dtype="bfloat16", numpy_init=True)
    mri = tcfg.mri256_config()
    scfg = mri.sampler
    assert (scfg.mask_x_policy, scfg.cond_in_floor, scfg.start_timestep) == ("minval", 0.95, 2)
    mmv = tcfg.min_max_val_for(mri)
    rng = np.random.default_rng(1)
    cond = rng.uniform(0, mmv[1], (B, S, S, 1)).astype(np.float32)
    yy, xx = np.mgrid[:S, :S]
    mask = np.zeros((B, S, S, 1), np.float32)
    mask[:, (yy - 30) ** 2 + (xx - 34) ** 2 < 144] = 1.0  # a disc
    key = jax.random.PRNGKey(5)
    want = np.asarray(JS.ddpm_sample_branched(jgd, params, jnp.asarray(cond),
                                              jnp.asarray(mask), key, to_jax(scfg), mmv))
    noise = TS.ArrayNoise(branched_noise(key, (B, S, S, 1), T, scfg.start_timestep), "cpu")
    got = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg,
                                  mmv, noise=noise).numpy()
    assert got.shape == want.shape == (B, S, S, 1)
    assert _rel(got, want) <= 0.15
    assert _corr(got, want) >= 0.99
    assert np.abs(got - want).max() <= 0.05 * (mmv[1] - mmv[0])
