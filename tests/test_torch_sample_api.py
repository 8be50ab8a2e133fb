"""Port parity: the sampler's public remainder, `sample` (the top-level
dispatch), `interpolate` and `ddpm_sample_branched`'s `return_debug`.

A narrow UNet (dim 8, 8px, T=6; DDIM over 3 pairs) on the same weights in
both packages, with the JAX key stream replayed through `ArrayNoise`.
Tolerance: atol/rtol 1e-5 in f32 (the per-call UNet difference is ~1e-6,
summation order, and at most 6 posterior steps and the clip follow it).
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
    MMV, branched_noise, images, left_mask, make_pair, plain_noise, small_model_cfg, to_jax,
)

T, S, B, STEPS = 6, 8, 2, 3
TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(5)
SHAPE = (B, S, S, 1)


@pytest.fixture(scope="module")
def ddpm():
    return make_pair(small_model_cfg(), tcfg.DiffusionConfig(image_size=S, timesteps=T),
                     seed=4)


@pytest.fixture(scope="module")
def ddim():
    return make_pair(small_model_cfg(),
                     tcfg.DiffusionConfig(image_size=S, timesteps=T, sampling_timesteps=STEPS),
                     seed=4)


def _mask():
    m = left_mask(B, S, 3)
    m[1, :2] = 0.5  # soft values: IND after binarization
    return m


def _port(pair, scfg, mask, noise, gt=None, as_tensor=False):
    """The port's `sample` on the shared inputs; the mask numpy or, with
    `as_tensor`, a CPU tensor."""
    _, _, tgd = pair
    m = torch.as_tensor(mask) if (as_tensor and mask is not None) else mask
    return TS.sample(tgd, torch.as_tensor(images(3, B, S)), scfg, MMV, mask=m,
                     gt=None if gt is None else torch.as_tensor(gt),
                     noise=TS.ArrayNoise(noise, "cpu")).numpy()


_JAX = {}  # JAX's result per (engine, configuration, mask, gt): each chain compiles anew


def _both(pair, scfg, mask, noise, gt=None, as_tensor=False):
    """(the port's `sample`, JAX's) on the same inputs."""
    jgd, params, _ = pair
    key = (id(jgd), repr(scfg), None if mask is None else mask.tobytes(),
           None if gt is None else gt.tobytes())
    if key not in _JAX:
        _JAX[key] = np.asarray(JS.sample(
            jgd, params, jnp.asarray(images(3, B, S)), KEY, to_jax(scfg), MMV,
            mask=None if mask is None else jnp.asarray(mask),
            gt=None if gt is None else jnp.asarray(gt)))
    return _port(pair, scfg, mask, noise, gt, as_tensor), _JAX[key]


@pytest.mark.parametrize("mask_kind", ["none", "ones", "ones_tensor"])
def test_sample_takes_the_plain_chain_without_an_anomaly(ddpm, mask_kind):
    """No mask, or a uniformly-one mask (numpy or a tensor): the plain DDPM
    chain, its key stream (one draw more than the steps)."""
    mask = None if mask_kind == "none" else np.ones((B, S, S, 1), np.float32)
    got, want = _both(ddpm, tcfg.SamplerConfig(), mask, plain_noise(KEY, SHAPE, T),
                      as_tensor=mask_kind == "ones_tensor")
    assert got.shape == want.shape == SHAPE
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(mask_x_policy="minval", fusion_route="mask", start_timestep=3, cond_in_floor=0.95),
    dict(branch_out=False),  # branching off: plain whatever the mask
])
def test_sample_branched_ddpm_matches_jax(ddpm, variant):
    scfg = tcfg.SamplerConfig(**variant)
    noise = (branched_noise(KEY, SHAPE, T, scfg.start_timestep) if scfg.branch_out
             else plain_noise(KEY, SHAPE, T))
    got, want = _both(ddpm, scfg, _mask(), noise, as_tensor=True)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mask_kind", ["ones", "branched"])
def test_sample_dispatches_ddim(ddim, mask_kind):
    """sampling_timesteps < timesteps: DDIM, plain under a uniform mask and
    branched (fused at the first pair t <= times[-s-2]) under a mixed one."""
    mask = np.ones((B, S, S, 1), np.float32) if mask_kind == "ones" else _mask()
    got, want = _both(ddim, tcfg.SamplerConfig(start_timestep=1), mask,
                      plain_noise(KEY, SHAPE, STEPS))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("start_intermediate", [True, False])
def test_sample_use_gt(ddpm, start_intermediate):
    """use_gt: the plain chain starts at use_gt_timestep from the noised
    ground truth only with start_intermediate; the branched chain takes gt
    either way (branched to the end without start_intermediate)."""
    scfg = tcfg.SamplerConfig(use_gt=True, use_gt_timestep=4, start_timestep=2,
                              start_intermediate=start_intermediate)
    gt = images(7, B, S)
    steps = 4 if start_intermediate else T
    got, want = _both(ddpm, scfg, np.ones((B, S, S, 1), np.float32),
                      plain_noise(KEY, SHAPE, steps), gt=gt)
    np.testing.assert_allclose(got, want, **TOL)
    noise = (branched_noise(KEY, SHAPE, 4, 2) if start_intermediate
             else plain_noise(KEY, SHAPE, 4))
    got, want = _both(ddpm, scfg, _mask(), noise, gt=gt)
    assert got.shape == want.shape == (SHAPE if start_intermediate else (2, *SHAPE))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("flags", [dict(ood_ad=True), dict(ood_confidence=True)])
def test_sample_reconciles_the_flags(ddpm, flags):
    """A detector- or confidence-driven run forces mask_x and mask_cond on:
    the chain is the reconciled configuration's, not the one given."""
    scfg = tcfg.SamplerConfig(mask_x=False, mask_cond=False, start_timestep=3, **flags)
    noise = branched_noise(KEY, SHAPE, T, 3)
    got, want = _both(ddpm, scfg, _mask(), noise)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, _port(ddpm, TS.reconcile(scfg), _mask(), noise))
    unforced = tcfg.SamplerConfig(mask_x=False, mask_cond=False, ood_ad=False,
                                  start_timestep=3)
    assert not np.array_equal(got, _port(ddpm, unforced, _mask(), noise))


def interpolate_noise(key, shape, t):
    """The noise JAX's `interpolate` draws from `key`: split(key, 3) for
    the two endpoints, then one split per step of t-1 .. 0."""
    key, k1, k2 = jax.random.split(key, 3)
    out = [jax.random.normal(k1, shape), jax.random.normal(k2, shape)]
    for _ in range(t):
        key, nk = jax.random.split(key)
        out.append(jax.random.normal(nk, shape, dtype=jnp.float32))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("t", [None, 3])
def test_interpolate_matches_jax(ddpm, t):
    jgd, params, tgd = ddpm
    x1, x2, cond = images(8, B, S), images(9, B, S), images(10, B, S)
    want = JS.interpolate(jgd, params, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(cond),
                          KEY, MMV, t=t, lam=0.3)
    draws = []
    src = TS.ArrayNoise(interpolate_noise(KEY, SHAPE, T - 1 if t is None else t), "cpu")

    def noise(shape):
        draws.append(shape)
        return src(shape)

    got = TS.interpolate(tgd, torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(cond),
                         MMV, t=t, lam=0.3, noise=noise)
    assert len(draws) == 2 + (T - 1 if t is None else t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", [dict(start_timestep=2), dict(start_timestep=T + 4)])
def test_return_debug_matches_jax(ddpm, variant):
    """The fusion step's six dumps, raw, against JAX's; `return_debug`
    takes precedence over `return_fusion_time` and leaves the image as it
    is without it."""
    jgd, params, tgd = ddpm
    scfg = tcfg.SamplerConfig(**variant)
    cond, mask = images(11, B, S), _mask()
    want_img, want = JS.ddpm_sample_branched(jgd, params, jnp.asarray(cond), jnp.asarray(mask),
                                             KEY, to_jax(scfg), MMV, return_debug=True,
                                             return_fusion_time=True)
    noise = branched_noise(KEY, SHAPE, T, scfg.start_timestep)
    got_img, got = TS.ddpm_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg, MMV,
        noise=TS.ArrayNoise(noise, "cpu"), return_debug=True, return_fusion_time=True)
    keys = {"pred_out", "pred_in", "pred_concat", "x_out", "x_in", "fusion_time"}
    assert set(got) == set(want) == keys
    for k in sorted(keys - {"fusion_time"}):
        assert got[k].shape == SHAPE
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(got["fusion_time"].numpy(), np.asarray(want["fusion_time"]))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), **TOL)
    plain = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg,
                                    MMV, noise=TS.ArrayNoise(noise, "cpu"))
    np.testing.assert_array_equal(plain.numpy(), got_img.numpy())
