"""Port parity for Stage A of the 256px configuration: PatchCore over the
denoiser's own taps, the fitted ladder and the hysteresis mask.

  * `DenoiserFeatureSource` taps against the JAX source (flax
    `capture_intermediates`) through the shipped `results/mri_synth256_ema.npz`
    at a 64px input, for t=5 and the (2, 10) ensemble: float32 within 1e-4
    abs+rel (convolution summation order); bfloat16 under the bars of
    test_torch_mri256 (relative L2 <= 5e-2, correlation >= 0.999); the
    `strides` and layer names equal, the s2d stem's too;
  * `OODFrontend.detect` against the JAX front end with the same bank (the
    JAX PatchCore builds it at 64px from 4 calibration images with its own
    projection; both sides receive it) and the same fitted ladder, float32:
    anomaly maps within 1e-4 relative L2; binary masks equal in every image
    that has no map value within 1e-4 of one of its thresholds (the ladder's
    gate and threshold and the two hysteresis levels), and those are at
    least two of the three;
  * the port's `build_memory_bank` given the JAX projection equals the JAX
    bank on that calibration set: the same rows, each within the taps'
    1e-4 (its embedding differs from JAX's as the taps do);
  * `build_frontend`: it finds `<bank>_ladder.json` beside a bank, and
    raises with no bank and no calibration images;
  * `translate` without a mask and `InferenceServer` without masks on a
    narrowed 256px configuration (dim 8, 32px, T=6, f32), whose bank the
    port's `build_frontend` builds from calibration images: the same masks
    as the JAX pipeline, the branched chain taken, and the same images
    (1e-4, the JAX key stream replayed).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu.data.synthetic import synthetic_brain_translation as j_brains
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.ood.features import DenoiserFeatureSource as JSource
from localdiffusion_tpu.ood.frontend import OODFrontend as JFrontend
from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
from localdiffusion_tpu.ood.thresholds import fit_ladder as j_fit_ladder
from localdiffusion_tpu.ood.thresholds import load_ladder, save_ladder
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation as t_brains
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_frontend, ladder_beside
from localdiffusion_tpu_torch.ood.features import DenoiserFeatureSource as TSource
from localdiffusion_tpu_torch.ood.frontend import OODFrontend as TFrontend
from localdiffusion_tpu_torch.ood.patchcore import PatchCore as TPatchCore
from localdiffusion_tpu_torch.ood.thresholds import near_threshold
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.params_io import load_params_npz
from test_torch_support import branched_noise, jax_config, make_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results/mri_synth256_ema.npz")
S = 64  # the shipped 256px denoiser at a 64px input
MAP_REL, NEAR = 1e-4, 1e-4


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfg64(dtype="float32"):
    base = tcfg.mri256_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=S),
        ood=dataclasses.replace(base.ood, input_size=S, memory_bank_path=None),
        train=dataclasses.replace(base.train, compute_dtype=dtype))


def _brains(n, tumor, seed, size=S):
    d = tcfg.mri256_config().data
    kw = dict(tumor=tumor, seed=seed, mean_t1=d.mean_t1, std_t1=d.std_t1,
              mean_flair=d.mean_flair, std_flair=d.std_flair)
    lr = t_brains(n, size, **kw)[1]
    np.testing.assert_array_equal(lr, j_brains(n, size, **kw)[1])  # the data copy
    return lr


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def denoisers(request):
    """(JAX engine, its params, port engine on the CPU) with the shipped
    256px weights, computing in the parameter's type."""
    dtype = request.param
    cfg = _cfg64(dtype)
    jc = jax_config(cfg)
    jgd = JaxGD(jc.model, jc.diffusion, dtype=getattr(jnp, dtype))
    template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    params = jax_load_npz(NPZ, template)
    tgd = build_gd(cfg, device="cpu")
    tgd.model.load_state_dict(load_params_npz(NPZ, tgd.model))
    return dtype, cfg, jgd, params, tgd


@pytest.mark.parametrize("t", [5, (2, 10)])
def test_denoiser_taps_match_jax(denoisers, t):
    dtype, cfg, jgd, params, tgd = denoisers
    js, ts = JSource(jgd, params, t=t), TSource(tgd, t=t)
    assert ts.layers == js.layers and ts.strides == js.strides
    x = np.random.default_rng(0).uniform(0, tcfg.min_max_val_for(cfg)[1],
                                         (2, S, S, 1)).astype(np.float32)
    want = {k: np.asarray(v) for k, v in jax.jit(js.apply)(jnp.asarray(x)).items()}
    got = ts.apply(torch.as_tensor(x))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            assert _rel(g, w) <= 5e-2 and np.corrcoef(g.ravel(), w.ravel())[0, 1] >= 0.999, k


def test_stem_strides_match_jax():
    cfg = tcfg.stem256_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dim=8))
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, numpy_init=True)
    for t in (5, (2, 10)):
        js, ts = JSource(jgd, params, t=t), TSource(tgd, t=t)
        assert ts.strides == js.strides and ts.layers == js.layers
        assert ts.strides["down3_block2"] == 16
    with pytest.raises(ValueError, match="not down-path blocks"):
        tgd.model.down_taps(torch.zeros(1, 256, 256, 1), torch.zeros(1), ["mid_block1"])


# ---------------------------------------------------------------------------
# the front end at 64px, JAX and port on one bank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frontends(tmp_path_factory):
    """JAX builds the bank from 4 normal brains (its k-center projection
    from PRNGKey(0)) and fits the ladder on their maps; the port's PatchCore
    gets the same bank, ladder and weights."""
    cfg = _cfg64()
    jc = jax_config(cfg)
    jgd = JaxGD(jc.model, jc.diffusion, dtype=jnp.float32)
    params = jax_load_npz(NPZ, jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0))))
    jpc = JPatchCore(jc.ood, source=JSource(jgd, params, t=5))
    jfe = JFrontend(jc, patchcore=jpc)
    calib = _brains(4, False, 42)
    prep = np.asarray(jfe._preprocess_patchcore(jnp.asarray(calib)))
    bank = jpc.build_memory_bank([prep])
    path = str(tmp_path_factory.mktemp("stage_a") / "ladder.json")
    save_ladder(j_fit_ladder([np.asarray(jpc(jnp.asarray(prep))["anomaly_map"])]), path)
    jc = jc.replace(ood=dataclasses.replace(jc.ood, ladder_path=path))
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=path))
    jfe = JFrontend(jc, patchcore=jpc)
    tgd = build_gd(cfg, device="cpu")
    tgd.model.load_state_dict(load_params_npz(NPZ, tgd.model))
    tpc = TPatchCore(cfg.ood, source=TSource(tgd, t=5), memory_bank=bank)
    return dict(cfg=cfg, jfe=jfe, tfe=TFrontend(cfg, patchcore=tpc), tgd=tgd, calib=calib,
                prep=prep, bank=bank, ladder=load_ladder(path))


def _near_threshold(amap, ladder, ood):
    """The port's rule for a map near one of its masks' thresholds."""
    return near_threshold(amap, ladder, NEAR, ood.refine_hi_frac, ood.refine_lo_frac)


def test_frontend_detect_matches_jax(frontends):
    f = frontends
    lr = _brains(3, True, 7)
    jm, jb, ja = f["jfe"].detect(lr)
    f["tfe"].time_stages = True
    try:
        tm, tb, ta = f["tfe"].detect(lr)
    finally:
        f["tfe"].time_stages = False
    assert ta.shape == ja.shape == (3, S, S, 1) and tb.shape == jb.shape
    assert _rel(ta, np.asarray(ja)) <= MAP_REL
    compared = 0
    for i in range(3):
        if _near_threshold(np.asarray(ja)[i], f["ladder"], f["cfg"].ood):
            continue
        np.testing.assert_array_equal(tb[i], jb[i])
        np.testing.assert_allclose(tm[i], jm[i], rtol=1e-3, atol=1e-3)
        compared += 1
    assert compared >= 2
    assert 0 < jb.mean() < 1  # tumours gated, masks neither empty nor full
    assert set(f["tfe"].last_split) == {"features", "nn", "map", "host"}


def test_build_memory_bank_matches_jax(frontends):
    f = frontends
    tpc = f["tfe"].patchcore
    proj = np.array(jax.random.normal(jax.random.PRNGKey(0), (192, 128), dtype=jnp.float32)
                    / jnp.sqrt(jnp.asarray(128, jnp.float32)))
    held = tpc.memory_bank
    try:
        bank = tpc.build_memory_bank([f["prep"]], proj=proj)
    finally:
        tpc.memory_bank = held
    assert bank.shape == f["bank"].shape == (102, 192)  # 10% of 4 x 16 x 16 patches
    np.testing.assert_allclose(bank, f["bank"], rtol=1e-4, atol=1e-4)
    assert tpc.last_build_s["patches"] == 1024


def test_build_frontend_finds_the_ladder_and_refuses_no_bank(frontends, tmp_path):
    f = frontends
    cfg = f["cfg"].replace(ood=dataclasses.replace(f["cfg"].ood, ladder_path=None))
    bank_path = str(tmp_path / "bank.npy")
    with pytest.raises(ValueError, match="no memory bank"):
        build_frontend(cfg.replace(ood=dataclasses.replace(cfg.ood,
                                                           memory_bank_path=bank_path)),
                       gd=f["tgd"], device="cpu", verbose=False)
    np.save(bank_path, f["bank"])
    save_ladder(f["ladder"], ladder_beside(bank_path))
    fe, cfg2 = build_frontend(
        cfg.replace(ood=dataclasses.replace(cfg.ood, memory_bank_path=bank_path)),
        gd=f["tgd"], device="cpu", verbose=False)
    assert cfg2.ood.ladder_path == ladder_beside(bank_path) == str(tmp_path / "bank_ladder.json")
    np.testing.assert_array_equal(fe.patchcore.memory_bank.numpy(), f["bank"])
    lr = _brains(2, True, 8)
    got = fe.detect(lr)
    want = f["tfe"].detect(lr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# translate and the server without masks, narrowed 256px configuration
# ---------------------------------------------------------------------------

N, T = 32, 6


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    base = tcfg.mri256_config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, dim=8, attn_heads=2, attn_dim_head=8),
        diffusion=dataclasses.replace(base.diffusion, image_size=N, timesteps=T,
                                      sampling_timesteps=T),
        ood=dataclasses.replace(base.ood, input_size=N, memory_bank_path=None),
        train=dataclasses.replace(base.train, compute_dtype="float32"))
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=11, numpy_init=True)
    calib = _brains(6, False, 42, N)
    # the port builds its bank from the calibration images; JAX builds its
    # own from the same images (96 channels: no projection, same rows)
    tfe, _ = build_frontend(cfg, gd=tgd, calibration_images=calib, device="cpu",
                            verbose=False)
    jc = jax_config(cfg)
    jpc = JPatchCore(jc.ood, source=JSource(jgd, params, t=5))
    jbank = jpc.build_memory_bank([calib])
    np.testing.assert_allclose(tfe.patchcore.memory_bank.numpy(), jbank, rtol=1e-4, atol=1e-4)
    path = str(tmp_path_factory.mktemp("narrow") / "ladder.json")
    save_ladder(j_fit_ladder([np.asarray(jpc(jnp.asarray(calib))["anomaly_map"])]), path)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=path))
    jc = jc.replace(ood=dataclasses.replace(jc.ood, ladder_path=path))
    tfe.config = cfg
    jpipe = JaxPipeline(jc, jgd, params, frontend=JFrontend(jc, patchcore=jpc))
    tpipe = LocalDiffusionPipeline(cfg, tgd, frontend=tfe)
    return jpipe, tpipe, load_ladder(path)


def _same_masks(got, want):
    """Soft masks: the region at 1 (the grown, dilated binary mask) equal,
    the soft values within 1e-3 (a smooth function of the map)."""
    np.testing.assert_array_equal(got == 1.0, np.asarray(want) == 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_translate_without_mask_matches_jax(narrow):
    jpipe, tpipe, ladder = narrow
    lr = _brains(3, True, 9, N)
    key = jax.random.PRNGKey(4)
    want = jpipe.translate(lr, key=key)
    got = tpipe.translate(lr, noise=ArrayNoise(branched_noise(key, lr.shape, T, 2), "cpu"))
    assert bool(got["branched"]) and bool(want["branched"])
    assert not any(_near_threshold(a, ladder, tpipe.config.ood) for a in want["anomaly_map"])
    _same_masks(got["mask"], want["mask"])
    assert _rel(got["anomaly_map"], want["anomaly_map"]) <= MAP_REL
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-4, atol=1e-4)
    assert set(got) == set(want)


def test_server_without_masks_matches_jax(narrow):
    """Three requests without masks fill a padded batch of 4 on the
    overlapped threads; Stage A runs on the padded rows, and each request
    gets the JAX front end's mask for its row."""
    jpipe, tpipe, _ = narrow
    lrs = list(_brains(3, True, 10, N))
    srv = InferenceServer(tpipe, batch_size=4, max_wait_ms=500, overlap_detect=True)
    futs = [srv.submit(lr) for lr in lrs]
    with srv:
        outs = [f.result(timeout=300) for f in futs]
    stats = srv.snapshot_stats()
    assert stats["requests"] == 3 and stats["batches"] == 1
    want, _, _ = jpipe.frontend.detect(np.stack(lrs + lrs[-1:]))
    for i, out in enumerate(outs):
        _same_masks(out["mask"], want[i])
        assert out["pred"].shape == (N, N, 1) and np.all(np.isfinite(out["pred"]))
    assert any(o["branched"] for o in outs)


def test_bank_cli_builds_what_build_frontend_finds(tmp_path, capsys):
    """`python -m localdiffusion_tpu_torch.ood.bank` on 2 calibration brains
    at 256px (the shipped weights, CPU): a 10% coreset of their 8,192
    patches and the ladder beside it, which `build_frontend` loads with its
    own denoiser; Stage A of a tumour brain then gives a non-empty mask."""
    from localdiffusion_tpu_torch.ood import bank as B

    out = str(tmp_path / "bank.npy")
    B.main(["--out", out, "--n-images", "2", "--device", "cpu", "--feature-npz", NPZ])
    assert "saved fitted ladder" in capsys.readouterr().out
    assert np.load(out).shape == (819, 192)
    base = tcfg.mri256_config()
    cfg = base.replace(ood=dataclasses.replace(base.ood, memory_bank_path=out, feature_npz=NPZ))
    fe, cfg2 = build_frontend(cfg, device="cpu", verbose=False)
    assert cfg2.ood.ladder_path == ladder_beside(out)
    mask, binary, amap = fe.detect(_brains(1, True, 12, 256))
    assert mask.shape == binary.shape == amap.shape == (1, 256, 256, 1)
    assert 0 < binary.mean() < 1
