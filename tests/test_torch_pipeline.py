"""Port parity: `LocalDiffusionPipeline.translate` and `InferenceServer`
against the JAX pipeline on the same rows, masks, weights and noise.

A narrow UNet (dim 8, 12px so SSIM's 11×11 window fits, T=6); tolerances as in test_torch_sampler
(atol/rtol 1e-4 on images; the metrics are functions of them).
"""

import jax
import numpy as np
import pytest

from localdiffusion_tpu.ood.frontend import OODFrontend
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.serving import InferenceServer as JaxServer
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_frontend
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer, batch_seed
from test_torch_support import (
    branched_noise, images, jax_config, make_pair, plain_noise, small_model_cfg,
)

S, T, B = 12, 6, 3
TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(5)


def _cfg():
    return tcfg.Config(
        model=small_model_cfg(),
        diffusion=tcfg.DiffusionConfig(image_size=S, timesteps=T),
        sampler=tcfg.SamplerConfig(start_timestep=2),
        ood=tcfg.OODConfig(detector="manual", manual_mask_cols=3, input_size=S),
        data=tcfg.DataConfig(name="mnist"),
    )


@pytest.fixture(scope="module")
def pipes():
    cfg = _cfg()
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=6)
    jcfg = jax_config(cfg)
    jpipe = JaxPipeline(jcfg, jgd, params, frontend=OODFrontend(jcfg))
    return jpipe, LocalDiffusionPipeline(cfg, tgd)


def _noise(key, branched):
    shape = (B, S, S, 1)
    stream = branched_noise(key, shape, T, 2) if branched else plain_noise(key, shape, T)
    return ArrayNoise(stream, "cpu")


def _check(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOL,
                                   err_msg=k)


def test_translate_manual_detector_matches_jax(pipes):
    jpipe, tpipe = pipes
    lr, hr = images(7, B, S), images(8, B, S)
    want = jpipe.translate(lr, hr=hr, key=KEY)
    got = tpipe.translate(lr, hr=hr, noise=_noise(KEY, True))
    assert bool(got["branched"]) and bool(want["branched"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    _check(got, want, ["pred", "mse", "ssim", "psnr"])
    assert set(got) == set(want)


def test_translate_uniform_mask_takes_the_plain_chain(pipes):
    jpipe, tpipe = pipes
    lr, hr = images(9, B, S), images(10, B, S)
    ones = np.ones((B, S, S, 1), np.float32)
    region = np.zeros((B, S, S, 1), np.float32)
    region[:, 2:5, 2:5] = 1.0
    want = jpipe.translate(lr, hr=hr, key=KEY, mask=ones, gt_region=region)
    got = tpipe.translate(lr, hr=hr, noise=_noise(KEY, False), mask=ones,
                          gt_region=region)
    assert not bool(got["branched"]) and not bool(want["branched"])
    _check(got, want, ["pred", "mse", "ssim", "psnr", "mse_ood_region"])


def test_translate_refuses_unported_detectors(pipes):
    """No silent fallback: a PatchCore pipeline without a front end raises
    (a given mask still serves), the sources and detector of later slices
    raise, and a bank-less PatchCore front end without calibration images
    raises."""
    _, tpipe = pipes
    cfg = _cfg()
    pc_cfg = cfg.replace(ood=tcfg.OODConfig(detector="patchcore", feature_source="denoiser"))
    pipe = LocalDiffusionPipeline(pc_cfg, tpipe.gd)
    with pytest.raises(ValueError, match="patchcore.*front end"):
        pipe.translate(images(0, 1, S))
    assert pipe.translate(images(0, 1, S), mask=np.ones((1, S, S, 1)))["pred"].shape == (1, S, S, 1)
    with pytest.raises(ValueError, match="no memory bank"):
        build_frontend(pc_cfg, gd=tpipe.gd, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="later slice"):
        build_frontend(cfg.replace(ood=tcfg.OODConfig(detector="patchcore")), gd=tpipe.gd,
                       device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="seg detector"):
        build_frontend(cfg.replace(ood=tcfg.OODConfig(detector="seg")), gd=tpipe.gd)


@pytest.mark.parametrize("size", [8, 16])
def test_metrics_match_jax(size):
    """MSE, PSNR and SSIM (NaN when the 11×11 window does not fit) on the
    same images; 1e-5 covers float32 summation order."""
    import jax.numpy as jnp
    import torch

    from localdiffusion_tpu.utils import metrics as jm
    from localdiffusion_tpu_torch.utils import metrics as tm

    a, b = images(30, 2, size), images(31, 2, size)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)
    for jf, tf in ((jm.mse, tm.mse), (jm.psnr, tm.psnr), (jm.ssim, tm.ssim)):
        np.testing.assert_allclose(tf(ta, tb).numpy(), np.asarray(jf(ja, jb)),
                                   rtol=1e-5, atol=1e-5)
    assert np.isnan(float(tm.ssim(ta, tb))) == (size < 11)


def _requests():
    ones = np.ones((S, S, 1), np.float32)
    anom = ones.copy()
    anom[:, : S // 2] = 0.5
    lrs = [images(20 + i, 1, S)[0] for i in range(B)]
    return lrs, [ones, anom, None]  # None → the manual detector


@pytest.mark.parametrize("overlap", [True, False])
def test_server_matches_jax_pipeline(pipes, overlap):
    """Three requests (one uniform, two masked) fill one padded batch of 4,
    merged into one branched dispatch; each result equals the JAX pipeline's
    on the same padded batch with the same batch key."""
    jpipe, tpipe = pipes
    base = jax.random.PRNGKey(0)
    srv = InferenceServer(
        tpipe, batch_size=B + 1, max_wait_ms=500, overlap_detect=overlap,
        noise_for_batch=lambda i: ArrayNoise(
            branched_noise(jax.random.fold_in(base, i), (B + 1, S, S, 1), T, 2), "cpu"),
    )
    lrs, masks = _requests()
    futs = [srv.submit(lr, m) for lr, m in zip(lrs, masks)]
    with srv:
        outs = [f.result(timeout=120) for f in futs]
    stats = srv.snapshot_stats()
    assert stats["requests"] == B and stats["batches"] == 1
    assert stats["merged_dispatches"] == 1 and stats["padded_slots"] == 1

    manual = np.zeros((S, S, 1), np.float32)
    manual[:, :3] = 1.0
    full_masks = [masks[0], masks[1], manual]
    pad = lambda rows: np.stack(rows + rows[-1:])
    want = jpipe.translate(pad(lrs), key=jax.random.fold_in(base, 0),
                           mask=pad(full_masks))
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out["pred"], want["pred"][i], **TOL)
        np.testing.assert_array_equal(out["mask"], full_masks[i])
    assert [o["branched"] for o in outs] == [False, True, True]


def test_server_split_dispatch_and_default_seed(pipes):
    """merge_mixed=False sends the plain and branched rows as two dispatches;
    with the default seeds a replay gives identical results."""
    _, tpipe = pipes
    lrs, masks = _requests()

    def serve():
        srv = InferenceServer(tpipe, batch_size=B, max_wait_ms=500,
                              merge_mixed=False, base_seed=3)
        futs = [srv.submit(lr, m) for lr, m in zip(lrs, masks)]
        with srv:
            outs = [f.result(timeout=120) for f in futs]
        return outs, srv.snapshot_stats()

    a, stats = serve()
    b, _ = serve()
    assert stats["plain_dispatches"] == 1 and stats["branched_dispatches"] == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["pred"], y["pred"])
        assert np.all(np.isfinite(x["pred"])) and x["pred"].shape == (S, S, 1)
    assert batch_seed(3, 0) != batch_seed(3, 1)

    # the JAX server's answer to the same rows has the same shapes and routing
    jsrv = JaxServer(pipes[0], batch_size=B, max_wait_ms=500, merge_mixed=False)
    jf = [jsrv.submit(lr, m) for lr, m in zip(lrs, masks)]
    with jsrv:
        jouts = [f.result(timeout=300) for f in jf]
    assert [o["branched"] for o in jouts] == [o["branched"] for o in a]
