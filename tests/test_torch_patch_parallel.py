"""Port parity: patch-parallel sampling (`parallel/patch.py`).

The tiling, extraction, feather and stitch against the JAX functions bit for
bit (overlap 0 and 8); `patch_parallel_sample` (DDIM and DDPM) and the
bucketed route (a mask touching one patch, none, every patch) against the
JAX functions on a narrow UNet (dim 8, mults 1/2; numpy-drawn weights, no
flax init), a 32px image cut into
nine 16px patches with overlap 4, with the JAX key stream replayed through
`ArrayNoise`.  Tolerance: the chain tests' atol/rtol 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.parallel import patch as JP
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.parallel import patch as TP
from test_torch_support import (
    MMV, branched_noise, images, make_pair, plain_noise, small_model_cfg, to_jax,
)

IMG, PATCH, OVERLAP, T, STEPS = 32, 16, 4, 6, 3
TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize("h,w,patch,overlap", [(32, 32, 16, 0), (40, 56, 16, 8),
                                               (64, 48, 24, 8), (17, 17, 17, 0)])
def test_tiling_and_stitch_match_jax_bit_for_bit(h, w, patch, overlap):
    jg, tg = JP.plan_patches(h, w, patch, overlap), TP.plan_patches(h, w, patch, overlap)
    assert (tg.image_hw, tg.patch, tg.stride, tg.origins) == \
        (jg.image_hw, jg.patch, jg.stride, jg.origins)
    np.testing.assert_array_equal(TP._feather_weight(patch, overlap),
                                  JP._feather_weight(patch, overlap))
    img = np.random.default_rng(h + w).standard_normal((2, h, w, 3)).astype(np.float32)
    tp = TP.extract_patches(torch.as_tensor(img), tg)
    jp = JP.extract_patches(jnp.asarray(img), jg)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(TP._extract_patches_np(img, tg), np.asarray(jp))
    # stitch arbitrary patch contents (not just re-stitched tiles)
    rnd = np.random.default_rng(1).standard_normal(tp.shape).astype(np.float32)
    got = TP.stitch_patches(torch.as_tensor(rnd), tg, 2, overlap).numpy()
    want = np.asarray(JP.stitch_patches(jnp.asarray(rnd), jg, 2, overlap))
    np.testing.assert_array_equal(got, want)
    if overlap == 0:  # tiles stitched back are the image, exactly
        np.testing.assert_array_equal(TP.stitch_patches(tp, tg, 2, 0).numpy(), img)


def test_plan_refuses_bad_geometry():
    with pytest.raises(ValueError):
        TP.plan_patches(16, 16, 32)
    with pytest.raises(ValueError):
        TP.plan_patches(32, 32, 16, overlap=16)


@pytest.fixture(scope="module")
def engines():
    model = small_model_cfg()
    ddim = make_pair(model, tcfg.DiffusionConfig(image_size=IMG, timesteps=T,
                                                 sampling_timesteps=STEPS), seed=2, numpy_init=True)
    ddpm = make_pair(model, tcfg.DiffusionConfig(image_size=IMG, timesteps=T), seed=2,
                     numpy_init=True)
    return {"ddim": ddim, "ddpm": ddpm}


def _inputs(b=1):
    cond = images(4, b, IMG)
    mask = np.zeros((b, IMG, IMG, 1), np.float32)
    mask[:, 2:7, 3:9] = 1.0  # inside patch (0, 0) alone
    mask[:, 20:24, 20:24] = 0.5  # soft: IND after binarization
    return cond, mask


def _rows_shape(n):
    return (n, PATCH, PATCH, 1)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_patch_parallel_sample_matches_jax(engines, sampler):
    jgd, params, tgd = engines[sampler]
    scfg = tcfg.SamplerConfig(start_timestep=2)
    cond, mask = _inputs()
    want = JP.patch_parallel_sample(jgd, params, jnp.asarray(cond), jnp.asarray(mask), KEY,
                                    to_jax(scfg), MMV, patch=PATCH, overlap=OVERLAP)
    n = 9
    noise = (plain_noise(KEY, _rows_shape(n), STEPS) if sampler == "ddim"
             else branched_noise(KEY, _rows_shape(n), T, scfg.start_timestep))
    got = TP.patch_parallel_sample(tgd, cond, mask, scfg, MMV, PATCH, OVERLAP,
                                   noise=ArrayNoise(noise, "cpu"))
    assert got.shape == (1, IMG, IMG, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tgd.image_size == IMG  # the caller's engine is left as it was


@pytest.mark.parametrize("kind", ["one_patch", "all_plain", "all_branched"])
def test_bucketed_matches_jax(engines, kind):
    """The JAX function splits its key into kp (the plain bucket's chain)
    and ko (the branched bucket's): each replayed at its bucket's rows."""
    jgd, params, tgd = engines["ddim"]
    scfg = tcfg.SamplerConfig(start_timestep=2)
    cond, mask = _inputs()
    if kind == "all_plain":
        mask = np.zeros_like(mask)
    elif kind == "all_branched":
        mask = np.ones_like(mask)
    want = JP.patch_parallel_sample_bucketed(jgd, params, cond, mask, KEY, to_jax(scfg), MMV,
                                             patch=PATCH, overlap=OVERLAP)
    n_ood = {"one_patch": 1, "all_plain": 0, "all_branched": 9}[kind]
    kp, ko = jax.random.split(KEY)
    plain = plain_noise(kp, _rows_shape(9 - n_ood), STEPS) if n_ood < 9 else []
    branched = plain_noise(ko, _rows_shape(n_ood), STEPS) if n_ood else []
    got = TP.patch_parallel_sample_bucketed(tgd, cond, torch.as_tensor(mask), scfg, MMV, PATCH,
                                            OVERLAP, noise=ArrayNoise(plain, "cpu"),
                                            branched_noise=ArrayNoise(branched, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bucketed_needs_both_streams(engines):
    _, _, tgd = engines["ddim"]
    cond, mask = _inputs()
    with pytest.raises(ValueError, match="branched_noise"):
        TP.patch_parallel_sample_bucketed(tgd, cond, mask, tcfg.SamplerConfig(), MMV, PATCH,
                                          OVERLAP, noise=ArrayNoise([], "cpu"))
