"""Port parity for the evaluation entry points of the pipeline and the
factory: `LocalDiffusionPipeline.run` and `translate_volume` against the
JAX pipeline's, `factory.load_params` on the shipped checkpoints and its
refusals, and `factory.build_pipeline` against the JAX factory's.

A narrow UNet (dim 8, 12px so SSIM's 11×11 window fits, T=6) with the
manual detector; each batch's noise replays the JAX key the JAX loop
splits for it (`ArrayNoise`).  Images and metrics within rtol/atol 1e-4 in
f32, as in test_torch_pipeline.
"""

import os

import jax
import numpy as np
import pytest
import torch

from localdiffusion_tpu.factory import build_pipeline as jax_build_pipeline
from localdiffusion_tpu.ood.frontend import OODFrontend
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.utils.params_io import save_params_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise, GeneratorNoise
from localdiffusion_tpu_torch.factory import build_pipeline, load_params
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_noise, batch_seed
from localdiffusion_tpu_torch.utils.params_io import load_params_npz
from test_torch_support import branched_noise, images, jax_config, make_pair, small_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, T, B = 12, 6, 3
TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(11)
DUMPS = ("hr_all", "lr_all", "pred_all", "ad_masks", "fusion_time")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored after: the Tier-1
    run's six workers share the machine's cores, and PyTorch's default of
    one thread a core slowed these narrow chains tenfold there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(detector="manual"):
    return tcfg.Config(
        model=small_model_cfg(),
        diffusion=tcfg.DiffusionConfig(image_size=S, timesteps=T),
        sampler=tcfg.SamplerConfig(start_timestep=2),
        ood=tcfg.OODConfig(detector=detector, manual_mask_cols=3, input_size=S),
        data=tcfg.DataConfig(name="mnist"),
    )


@pytest.fixture(scope="module")
def pipes():
    cfg = _cfg()
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=12)
    jcfg = jax_config(cfg)
    return (JaxPipeline(jcfg, jgd, params, frontend=OODFrontend(jcfg)),
            LocalDiffusionPipeline(cfg, tgd), params)


def _split_keys(key, n):
    """The per-batch keys the JAX loops split off, in order."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _replay(subs, batch):
    """noise(i) for the port's loops: batch i's branched draws of subs[i]."""
    return lambda i: ArrayNoise(branched_noise(subs[i], (batch, S, S, 1), T, 2), "cpu")


def _region(seed, b):
    m = np.zeros((b, S, S, 1), np.float32)
    r = np.random.default_rng(seed).integers(2, S - 5)
    m[:, r:r + 4, 3:8] = 1.0
    return m


def test_run_matches_jax(pipes, tmp_path):
    """Three batches through `run`: the stacks, the per-batch MSE, the
    region metric and the .npy dumps equal the JAX loop's."""
    jpipe, tpipe, _ = pipes
    pairs = [(images(40 + i, B, S), images(50 + i, B, S)) for i in range(3)]
    gt = [_region(60 + i, B) for i in range(3)]
    want = jpipe.run(pairs, key=KEY, save_prefix=str(tmp_path / "jax_"), verbose=False,
                     gt_masks=gt)
    got = tpipe.run(pairs, noise=_replay(_split_keys(KEY, 3), B),
                    save_prefix=str(tmp_path / "port_"), verbose=False, gt_masks=gt)
    assert set(got) == set(want)
    for k in ("hr_all", "lr_all", "ad_masks", "fusion_time"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pred_all", "mean_mse", "mean_mse_ood_region"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_array_equal(got["fusion_time"], np.full(3 * B, T))
    per_batch = lambda out: ((out["pred_all"] - out["hr_all"]) ** 2).reshape(3, -1).mean(1)
    np.testing.assert_allclose(per_batch(got), per_batch(want), **TOL)
    assert float(got["mean_time"]) > 0
    for name in DUMPS:
        np.testing.assert_allclose(np.load(tmp_path / f"port_{name}.npy"),
                                   np.load(tmp_path / f"jax_{name}.npy"), **TOL, err_msg=name)


def test_run_seeds_each_batch(pipes):
    """With an int seed, batch i samples with `batch_seed(seed, i)`: a
    replay gives the same images, another seed others, and batch_noise
    passes a callable's seed, source or (noise, retry_noise) pair on."""
    _, tpipe, _ = pipes
    pairs = [(images(70 + i, 2, S), images(80 + i, 2, S)) for i in range(2)]
    a = tpipe.run(pairs, noise=3, verbose=False)
    b = tpipe.run(pairs, noise=3, verbose=False)
    c = tpipe.run(pairs, noise=4, verbose=False)
    np.testing.assert_array_equal(a["pred_all"], b["pred_all"])
    assert not np.allclose(a["pred_all"], c["pred_all"])
    one = tpipe.translate(pairs[1][1], noise=batch_seed(3, 1))
    np.testing.assert_array_equal(a["pred_all"][2:], one["pred"])
    assert batch_noise(None, 2) == (batch_seed(0, 2), None)
    src = GeneratorNoise(1, "cpu")
    assert batch_noise(lambda i: src, 5) == (src, None)
    assert batch_noise(lambda i: (i, i + 1), 5) == (5, 6)


def test_translate_volume_pads_the_last_batch(pipes):
    """Five slices in batches of two: the last batch pads by repetition, the
    pad row is dropped, and the region metric comes from the de-padded
    volume, as the JAX pipeline's."""
    jpipe, tpipe, _ = pipes
    hr, lr = images(90, 5, S), images(91, 5, S)
    seg = _region(92, 5)
    ds = [(hr[i], lr[i], seg[i]) for i in range(5)]
    want = jpipe.translate_volume(ds, batch_size=2, key=KEY, verbose=False)
    got = tpipe.translate_volume(ds, batch_size=2, noise=_replay(_split_keys(KEY, 3), 2),
                                 verbose=False)
    assert set(got) == set(want)
    assert got["pred_volume"].shape == (5, S, S, 1)
    assert got["branched_batches"] == want["branched_batches"] == 3
    for k in ("hr_volume", "lr_volume", "mask_volume"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("pred_volume", "mse", "mean_mse_ood_region"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


@pytest.mark.parametrize("npz,builder", [
    ("mri_synth256_ema.npz", tcfg.mri256_config),
    ("mri_stem256_ema.npz", tcfg.stem256_config),
])
def test_load_params_on_the_shipped_checkpoints(npz, builder):
    """Every key of a shipped denoiser snapshot fills one parameter and
    every parameter is filled; the weights land in the engine returned."""
    path = os.path.join(ROOT, "results", npz)
    cfg = builder()
    gd = load_params(cfg, params_npz=path, device="cpu", verbose=False)
    state = load_params_npz(path, build_gd(cfg, device="cpu").model)
    with np.load(path) as data:
        assert len(state) == len(data.files) == len(gd.model.state_dict())
    for name, value in gd.model.state_dict().items():
        assert torch.equal(value, state[name]), name


def test_load_params_refuses_what_it_cannot_load(tmp_path):
    """No random-init fallback: a missing file, a corrupt file, an Orbax
    directory and a snapshot of another network each raise."""
    cfg = _cfg()
    gd = build_gd(cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_params(cfg, gd, params_npz=str(tmp_path / "absent.npz"))
    bad = tmp_path / "corrupt.npz"
    bad.write_bytes(b"not a zip archive")
    with pytest.raises(RuntimeError, match="could not be read"):
        load_params(cfg, gd, params_npz=str(bad))
    orbax = os.path.join(ROOT, "results/mnist_x250/model-best10000")
    with pytest.raises(NotImplementedError, match="exporter"):
        load_params(cfg, gd, params_npz=orbax)
    with pytest.raises(KeyError):
        load_params(cfg, gd, params_npz=os.path.join(ROOT, "results/seg256_params.npz"))


def test_build_pipeline_matches_jax_factory(pipes, tmp_path):
    """Both factories build their pipelines from one npz (manual detector):
    the same masks and images for the same batch and noise.  The port's
    runs on the card unless asked for the CPU, and its seg detector
    without a checkpoint raises, as the JAX factory's does."""
    params = pipes[2]
    npz = str(tmp_path / "narrow.npz")
    save_params_npz(npz, params, dtype=np.float32)
    cfg = _cfg()
    jpipe = jax_build_pipeline(jax_config(cfg), params_npz=npz, verbose=False)
    tpipe = build_pipeline(cfg, params_npz=npz, device="cpu", verbose=False)
    lr, hr = images(93, B, S), images(94, B, S)
    want = jpipe.translate(lr, hr=hr, key=KEY)
    got = tpipe.translate(lr, hr=hr, noise=ArrayNoise(branched_noise(KEY, (B, S, S, 1), T, 2),
                                                      "cpu"))
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for k in ("pred", "mse", "ssim", "psnr"):
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_pipeline(cfg, params_npz=npz, verbose=False)
    seg = _cfg("seg").replace(ood=tcfg.OODConfig(detector="seg", input_size=S,
                                                 seg_model_path=str(tmp_path / "absent.npz")))
    with pytest.raises(ValueError, match="no trained SegUNet"):
        build_pipeline(seg, params_npz=npz, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="seg"):
        jax_build_pipeline(jax_config(seg), params_npz=npz, verbose=False)
