"""Port parity: the mask algebra and the plain and branched DDPM samplers.

The samplers run a narrow UNet (dim 8, 8px, T=6) on the same weights in
both packages, with the JAX key stream injected into the port.  Final
images and the fusion frame are held at atol/rtol 1e-4: the per-call UNet
difference (~1e-6, summation order) passes through at most 6 posterior
steps and the clip, which do not amplify it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import sampler as TS
from test_torch_support import (
    MMV, branched_noise, images, left_mask, make_pair, plain_noise,
    small_model_cfg, to_jax,
)

T = 6
S = 8
B = 2
TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def pair():
    return make_pair(small_model_cfg(),
                     tcfg.DiffusionConfig(image_size=S, timesteps=T), seed=2)


def test_mask_algebra_matches_jax():
    rng = np.random.default_rng(0)
    mask = rng.choice([0.0, 0.5, 0.99, 1.0, 1.2], size=(2, 4, 4, 1)).astype(np.float32)
    cond = rng.uniform(0, 2, (2, 4, 4, 1)).astype(np.float32)
    out = rng.uniform(0, 2, (2, 4, 4, 1)).astype(np.float32)
    out[0, 0, 0, 0] = 0.0  # a genuine zero inside the state: the sentinel case
    m_j = JS.binarize_mask(jnp.asarray(mask))
    m_t = TS.binarize_mask(torch.as_tensor(mask))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t.numpy()[mask == 0.99].sum() == 0  # soft values below 1 are IND
    for floor in (0.5, 0.95):
        for a, b in zip(JS.partition_cond(jnp.asarray(cond), m_j, floor),
                        TS.partition_cond(torch.as_tensor(cond), m_t, floor)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for policy in ("cond", "minval"):
        a = JS.apply_mask_x(jnp.asarray(out), m_j, jnp.asarray(cond), 0.1, policy)
        b = TS.apply_mask_x(torch.as_tensor(out), m_t, torch.as_tensor(cond), 0.1, policy)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for route in ("zero_sentinel", "mask"):
        a = JS.fuse_noisy_states(jnp.asarray(out) * m_j, jnp.asarray(cond), m_j, route)
        b = TS.fuse_noisy_states(torch.as_tensor(out) * m_t, torch.as_tensor(cond),
                                 m_t, route)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    scfg = TS.reconcile(tcfg.SamplerConfig(mask_x=False, mask_cond=False, ood_ad=True))
    assert scfg.mask_x and scfg.mask_cond
    scfg = TS.reconcile(tcfg.SamplerConfig(mask_x=False, ood_ad=False))
    assert not scfg.mask_x


def test_noise_is_zeroed_at_t0_and_stream_length_is_t_plus_1(pair):
    _, _, tgd = pair
    draws = []

    def noise(shape):
        draws.append(shape)
        return torch.ones(shape)

    cond = torch.as_tensor(images(0, B, S))
    out = TS.ddpm_sample_plain(tgd, cond, MMV, noise=noise)
    assert len(draws) == T + 1
    draws.clear()
    out_b = TS.ddpm_sample_branched(tgd, cond, torch.as_tensor(left_mask(B, S, 3)),
                                    tcfg.SamplerConfig(start_timestep=2), MMV, noise=noise)
    assert len(draws) == T + 1
    assert out.shape == out_b.shape == (B, S, S, 1)


def test_plain_sampler_matches_jax(pair):
    jgd, params, tgd = pair
    cond = images(1, B, S)
    want_final, want_frames = JS.ddpm_sample_plain(
        jgd, params, jnp.asarray(cond), KEY, MMV, return_all=True)
    noise = TS.ArrayNoise(plain_noise(KEY, (B, S, S, 1), T), "cpu")
    got_final, got_frames = TS.ddpm_sample_plain(
        tgd, torch.as_tensor(cond), MMV, noise=noise, return_all=True)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), **TOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), **TOL)


@pytest.mark.parametrize("variant", [
    dict(),  # the flagship's sampler settings
    dict(mask_x_policy="minval", fusion_route="mask", start_timestep=3,
         cond_in_floor=0.95),
    dict(start_timestep=T + 4),  # fusion point above the chain: fuse at T-1
])
def test_branched_sampler_matches_jax(pair, variant):
    jgd, params, tgd = pair
    scfg = tcfg.SamplerConfig(**variant)
    cond = images(2, B, S)
    mask = left_mask(B, S, 3)
    mask[1, :2] = 0.5  # soft values: IND after binarization
    want_final, want_frames = JS.ddpm_sample_branched(
        jgd, params, jnp.asarray(cond), jnp.asarray(mask), KEY, to_jax(scfg), MMV,
        return_all=True)
    noise = TS.ArrayNoise(
        branched_noise(KEY, (B, S, S, 1), T, scfg.start_timestep), "cpu")
    got_final, got_frames = TS.ddpm_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg, MMV, noise=noise,
        return_all=True)
    assert got_frames.shape == want_frames.shape == (T + 1, 2, B, S, S, 1)
    # frame index of the fusion step: initial noise + the phase-A steps
    fusion = 1 + max(T - 1 - scfg.start_timestep, 0)
    np.testing.assert_allclose(got_frames[fusion].numpy(),
                               np.asarray(want_frames[fusion]), **TOL)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), **TOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), **TOL)


def test_branched_without_intermediate_returns_the_pair(pair):
    jgd, params, tgd = pair
    scfg = tcfg.SamplerConfig(start_intermediate=False)
    cond = images(4, B, S)
    mask = left_mask(B, S, 4)
    want = JS.ddpm_sample_branched(jgd, params, jnp.asarray(cond), jnp.asarray(mask),
                                   KEY, to_jax(scfg), MMV)
    # branched all the way down: initial image, then one draw per step
    noise = TS.ArrayNoise(plain_noise(KEY, (B, S, S, 1), T), "cpu")
    got = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask),
                                  scfg, MMV, noise=noise)
    assert got.shape == (2, B, S, S, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_classifier_gate_is_refused(pair):
    """The classifier flag without a gate: the chain runs ungated, as the
    JAX sampler runs it (`use_classifier` needs both), bit for bit the
    unflagged chain, and matches JAX's flagged chain."""
    jgd, params, tgd = pair
    cond = images(9, B, S)
    mask = left_mask(B, S, 3)
    flagged = tcfg.SamplerConfig(classifier=True, start_timestep=3)
    got, ft = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask),
                                      flagged, MMV, noise=4, return_fusion_time=True)
    plain = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask),
                                    tcfg.SamplerConfig(start_timestep=3), MMV, noise=4)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert ft.tolist() == [T] * B
    want = JS.ddpm_sample_branched(jgd, params, jnp.asarray(cond), jnp.asarray(mask), KEY,
                                   to_jax(flagged), MMV)
    got = TS.ddpm_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), flagged, MMV,
        noise=TS.ArrayNoise(branched_noise(KEY, (B, S, S, 1), T, 3), "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_generator_noise_is_reproducible(pair):
    _, _, tgd = pair
    cond = torch.as_tensor(images(5, B, S))
    a = TS.ddpm_sample_plain(tgd, cond, MMV, noise=7)
    b = TS.ddpm_sample_plain(tgd, cond, MMV, noise=TS.GeneratorNoise(7, "cpu"))
    c = TS.ddpm_sample_plain(tgd, cond, MMV, noise=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_model_predictions_match_jax(objective):
    jgd, params, tgd = make_pair(
        small_model_cfg(),
        tcfg.DiffusionConfig(image_size=S, timesteps=T, objective=objective), seed=7)
    cond = images(6, B, S)
    x = np.random.default_rng(8).standard_normal((B, S, S, 1)).astype(np.float32)
    t = np.array([1, 4], np.int32)
    feat_j = jgd.encode_cond(params, jnp.asarray(cond))
    feat_t = tgd.encode_cond(torch.as_tensor(cond))
    for clip, rederive in ((False, False), (True, False), (True, True)):
        want = jgd.model_predictions(params, jnp.asarray(x), jnp.asarray(t), feat_j,
                                     MMV, clip_x_start=clip, rederive_pred_noise=rederive)
        got = tgd.model_predictions(torch.as_tensor(x), torch.as_tensor(t).long(),
                                    feat_t, MMV, clip_x_start=clip,
                                    rederive_pred_noise=rederive)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
