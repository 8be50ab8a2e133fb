"""The s2d-stem 256px configuration and DDIM in the port, against the JAX
package.

  * `stem256_config()` is `configs/mri_synthetic_256_stem.yaml`, field by
    field;
  * the shipped stem checkpoint `results/mri_stem256_ema.npz` loads with
    all 346 keys consumed, and its UNet at a 64px input equals the JAX
    engine's `apply_model` at atol/rtol 1e-4 in float32 (convolution
    summation order);
  * the stem's fold is the JAX reshape, channel c·f² + i·f + j;
  * narrow plain and branched DDIM chains (a stem UNet of dim 8, 8px,
    T=6, 3 DDIM pairs) with the JAX key stream replayed, through every
    fusion case: mid-chain, at the first pair, on the terminal pair (the
    unfused pair returned), never (start_timestep -1), and branched all the
    way (start_intermediate False); with η = 0 and η = 0.5.  Frames and
    final images at atol/rtol 1e-4, the bar of test_torch_sampler: the
    per-call UNet difference (~1e-6) passes through 3 DDIM updates and
    the clip, which do not amplify it;
  * `translate` dispatches DDIM (a uniform mask takes the plain chain, any
    other the branched one) and `InferenceServer` serves the stem
    configuration's settings, each equal to the JAX pipeline at 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.ood.frontend import OODFrontend
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.params_io import load_params_npz
from test_torch_support import (
    MMV, images, jax_config, left_mask, make_pair, plain_noise, to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs/mri_synthetic_256_stem.yaml")
NPZ = os.path.join(ROOT, "results/mri_stem256_ema.npz")
SECTIONS = ["model", "diffusion", "sampler", "ood", "data", "train"]
TOL = dict(rtol=1e-4, atol=1e-4)
T, STEPS, S, B = 6, 3, 8, 2
KEY = jax.random.PRNGKey(11)


def test_stem256_config_is_the_yaml():
    got = tcfg.stem256_config()
    want = jcfg.Config.load_yaml(YAML)
    with open(YAML) as f:
        parsed = tcfg.Config.from_dict(yaml.safe_load(f))
    for section in SECTIONS:
        for f in dataclasses.fields(getattr(got, section)):
            mine = getattr(getattr(got, section), f.name)
            assert mine == getattr(getattr(want, section), f.name), (section, f.name)
            assert mine == getattr(getattr(parsed, section), f.name), (section, f.name)
    assert tcfg.min_max_val_for(got) == jcfg.min_max_val_for(want)
    assert got.train.compute_dtype == "float32" and got.diffusion.is_ddim_sampling
    assert got.model.cond_num_blocks == 5  # the deep encoder plus one for the stem


def test_stem_checkpoint_loads_every_key():
    if not os.path.exists(NPZ):
        pytest.fail("results/mri_stem256_ema.npz is missing from the checkout")
    gd = build_gd(tcfg.stem256_config(), device="cpu")
    assert gd.dtype == torch.float32
    sd = load_params_npz(NPZ, gd.model)
    with np.load(NPZ) as data:
        assert len(data.files) == 346
    assert len(sd) == 346 == len(gd.model.state_dict())
    assert tuple(sd["init_conv.weight"].shape) == (32, 4, 7, 7)
    assert tuple(sd["final_conv.weight"].shape) == (4, 32, 1, 1)
    gd.model.load_state_dict(sd)  # strict: no parameter is left unset


def test_stem_fold_is_pixel_unshuffle():
    """The JAX UNet's stem reshape (b, h/f, f, w/f, f, c) → (0,1,3,5,2,4) and
    its inverse are `F.pixel_unshuffle` / `F.pixel_shuffle` on NCHW."""
    f = 2
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    b, h, w, c = x.shape
    want = x.reshape(b, h // f, f, w // f, f, c).transpose(0, 1, 3, 5, 2, 4)
    want = want.reshape(b, h // f, w // f, c * f * f)
    got = F.pixel_unshuffle(torch.as_tensor(x).permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    back = want.reshape(b, h // f, w // f, c, f, f).transpose(0, 1, 4, 2, 5, 3)
    back = back.reshape(b, h, w, c)
    got_back = F.pixel_shuffle(got.permute(0, 3, 1, 2), f).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_back.numpy(), back)
    np.testing.assert_array_equal(back, x)


def test_stem_checkpoint_unet_matches_jax():
    rng = np.random.default_rng(4)
    cfg = tcfg.stem256_config()
    hi = tcfg.min_max_val_for(cfg)[1]
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (2, 64, 64, 1)).astype(np.float32)
    t = np.array([5, 170], np.int32)
    jc = jcfg.Config.load_yaml(YAML)
    jgd = JaxGD(jc.model, jc.diffusion)
    template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    params = jax_load_npz(NPZ, template)
    want = np.asarray(jax.jit(jgd.apply_model)(params, jnp.asarray(x), jnp.asarray(cond),
                                               jnp.asarray(t)))
    gd = build_gd(cfg, device="cpu")
    gd.model.load_state_dict(load_params_npz(NPZ, gd.model))
    got = gd.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t).long())
    assert got.dtype == torch.float32 and got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.5  # a trained model, not a zero output
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="divisible by 16"):
        gd.apply_model(torch.zeros(1, 24, 24, 1), torch.zeros(1, 24, 24, 1),
                       torch.zeros(1).long())


def test_ddim_times_match_jax():
    for total, steps in ((250, 50), (6, 3), (10, 10), (1000, 7)):
        np.testing.assert_array_equal(TS.ddim_times(total, steps), JS.ddim_times(total, steps))


def _stem_model_cfg():
    return tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1,
                            resnet_block_groups=4, attn_heads=2, attn_dim_head=8,
                            stem_space_to_depth=2)


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["eta0", "eta0.5"])
def pair(request):
    dcfg = tcfg.DiffusionConfig(image_size=S, timesteps=T, sampling_timesteps=STEPS,
                                ddim_sampling_eta=request.param)
    return make_pair(_stem_model_cfg(), dcfg, seed=9)


def test_plain_ddim_matches_jax(pair):
    jgd, params, tgd = pair
    cond = images(1, B, S)
    want_final, want_frames = JS.ddim_sample_plain(jgd, params, jnp.asarray(cond), KEY, MMV,
                                                   return_all=True)
    draws = []

    def noise(shape):
        draws.append(shape)
        return src(shape)

    src = TS.ArrayNoise(plain_noise(KEY, (B, S, S, 1), STEPS), "cpu")
    got_final, got_frames = TS.ddim_sample_plain(tgd, torch.as_tensor(cond), MMV,
                                                 noise=noise, return_all=True)
    assert len(draws) == STEPS + 1  # one draw per pair, η = 0 included
    assert got_frames.shape == want_frames.shape == (STEPS + 1, B, S, S, 1)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), **TOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), **TOL)


# times [5, 3, 1, -1]: pairs (5,3), (3,1), (1,-1); fusion at the first pair
# with t <= times[-s-2]
VARIANTS = {
    "mid_chain": dict(start_timestep=1),  # fuse at (3, 1)
    "first_pair_minval_mask_route": dict(start_timestep=2, mask_x_policy="minval",
                                         fusion_route="mask", cond_in_floor=0.95),
    "terminal_pair": dict(start_timestep=0),  # (1, -1): the unfused pair
    "never": dict(start_timestep=-1),  # times[-1] = -1: no pair fuses
    "no_intermediate": dict(start_intermediate=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_branched_ddim_matches_jax(pair, variant):
    jgd, params, tgd = pair
    scfg = tcfg.SamplerConfig(**VARIANTS[variant])
    cond = images(2, B, S)
    mask = left_mask(B, S, 3)
    mask[1, :2] = 0.5  # soft values: IND after binarization
    want_final, want_frames = JS.ddim_sample_branched(
        jgd, params, jnp.asarray(cond), jnp.asarray(mask), KEY, to_jax(scfg), MMV,
        return_all=True)
    noise = TS.ArrayNoise(plain_noise(KEY, (B, S, S, 1), STEPS), "cpu")
    got_final, got_frames = TS.ddim_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg, MMV, noise=noise,
        return_all=True)
    pair_out = variant in ("terminal_pair", "never", "no_intermediate")
    assert got_final.shape == want_final.shape == ((2, B, S, S, 1) if pair_out
                                                   else (B, S, S, 1))
    assert got_frames.shape == want_frames.shape == (STEPS + 1, 2, B, S, S, 1)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), **TOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), **TOL)


def test_branched_ddim_refuses_the_classifier_gate(pair):
    """DDIM has no gate, as in the reference: a configuration with the
    classifier flag runs the ungated branched DDIM chain, bit for bit."""
    _, _, tgd = pair
    cond = torch.as_tensor(images(12, B, S))
    mask = torch.as_tensor(left_mask(B, S, 3))
    gated = TS.ddim_sample_branched(tgd, cond, mask, tcfg.SamplerConfig(classifier=True), MMV,
                                    noise=6)
    plain = TS.ddim_sample_branched(tgd, cond, mask, tcfg.SamplerConfig(), MMV, noise=6)
    np.testing.assert_array_equal(gated.numpy(), plain.numpy())


# ---------------------------------------------------------------------------
# pipeline and server on the stem configuration's settings
# ---------------------------------------------------------------------------

PS = 16  # 16px: divisible by the stem's 2 × the UNet's 2, and SSIM's window fits


def _stem_cfg():
    """`stem256_config()` with a narrow UNet, 16px and T=6 / 3 DDIM pairs:
    detector none, minval mask_x, floor 0.95, float32."""
    base = tcfg.stem256_config()
    return base.replace(
        model=_stem_model_cfg(),
        diffusion=dataclasses.replace(base.diffusion, image_size=PS, timesteps=T,
                                      sampling_timesteps=STEPS),
        ood=dataclasses.replace(base.ood, input_size=PS),
    )


@pytest.fixture(scope="module")
def pipes():
    cfg = _stem_cfg()
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=12)
    jc = jax_config(cfg)
    return JaxPipeline(jc, jgd, params, frontend=OODFrontend(jc)), LocalDiffusionPipeline(cfg,
                                                                                         tgd)


def _disc_masks(b):
    yy, xx = np.mgrid[:PS, :PS]
    m = np.zeros((b, PS, PS, 1), np.float32)
    for i in range(b):
        m[i, (yy - 6 - i) ** 2 + (xx - 8) ** 2 < 16] = 1.0
    return m


def test_translate_dispatches_ddim(pipes):
    jpipe, tpipe = pipes
    hi = tpipe.min_max_val[1]
    lr = images(30, B, PS) * hi / 2
    hr = images(31, B, PS) * hi / 2
    shape = (B, PS, PS, 1)
    # detector none: a uniform mask, the plain DDIM chain
    want = jpipe.translate(lr, hr=hr, key=KEY)
    got = tpipe.translate(lr, hr=hr, noise=TS.ArrayNoise(plain_noise(KEY, shape, STEPS), "cpu"))
    assert not bool(got["branched"]) and not bool(want["branched"])
    np.testing.assert_array_equal(got["mask"], np.ones(shape, np.float32))
    for k in ("pred", "mse", "ssim", "psnr"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    # a disc mask: the branched DDIM chain
    mask = _disc_masks(B)
    want = jpipe.translate(lr, key=KEY, mask=mask)
    got = tpipe.translate(lr, mask=mask,
                          noise=TS.ArrayNoise(plain_noise(KEY, shape, STEPS), "cpu"))
    assert bool(got["branched"]) and bool(want["branched"])
    assert got["pred"].shape == shape
    np.testing.assert_allclose(got["pred"], np.asarray(want["pred"]), **TOL)


def test_server_serves_the_stem_settings(pipes):
    """Two requests, one without a mask (detector none: plain) and one with
    a disc, merged into one branched dispatch of a padded batch of 3; each
    equals the JAX pipeline's answer on the same padded batch and noise."""
    jpipe, tpipe = pipes
    base = jax.random.PRNGKey(1)
    hi = tpipe.min_max_val[1]
    lrs = [images(40 + i, 1, PS)[0] * hi / 2 for i in range(2)]
    masks = [None, _disc_masks(1)[0]]
    srv = InferenceServer(
        tpipe, batch_size=3, max_wait_ms=500,
        noise_for_batch=lambda i: TS.ArrayNoise(
            plain_noise(jax.random.fold_in(base, i), (3, PS, PS, 1), STEPS), "cpu"))
    futs = [srv.submit(lr, m) for lr, m in zip(lrs, masks)]
    with srv:
        outs = [f.result(timeout=120) for f in futs]
    stats = srv.snapshot_stats()
    assert stats["requests"] == 2 and stats["merged_dispatches"] == 1
    full = [np.ones((PS, PS, 1), np.float32), masks[1]]
    pad = lambda rows: np.stack(rows + rows[-1:])
    want = jpipe.translate(pad(lrs), key=jax.random.fold_in(base, 0), mask=pad(full))
    for i, out in enumerate(outs):
        assert out["pred"].shape == (PS, PS, 1) and np.all(np.isfinite(out["pred"]))
        np.testing.assert_allclose(out["pred"], np.asarray(want["pred"])[i], **TOL)
    assert [o["branched"] for o in outs] == [False, True]
