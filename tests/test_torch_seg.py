"""The seg detector and the seg-encoder feature source in the port, against
the JAX package.

  * a narrow SegUNet (base 8, 16px) with seeded random weights, every
    transposed-conv kernel asymmetric and every bias nonzero: logits within
    1e-5 relative L2 (float32 convolution summation order), and the same
    kernels loaded without the spatial flip miss by far more;
  * the shipped `results/seg256_params.npz` (64 keys, 31,036,481
    parameters, every key consumed) at a 64px input: logits within 1e-5
    relative L2, masks equal off the band |p − 0.5| ≤ 1e-4;
  * `SegEncoderFeatureSource` taps against the JAX source's
    `capture_intermediates`: 1e-5 relative L2 per tap;
  * the seg front end (`mri256_bf16_config()` at 64px: dilation 16 with
    the back-off) and a seg-encoder PatchCore front end (the JAX bank and
    ladder) against `OODFrontend.detect`: probabilities and maps within
    1e-5 relative L2, masks equal off the band;
  * `build_frontend`: seg from an npz; no checkpoint → (None, cfg); an
    Orbax directory, named or found first in the default order, raises;
  * the bank CLI with `--feature-source seg_encoder` on 2 images at 64px
    against the JAX script's construction (the same projection): the same
    rows within 1e-4, and the same ladder;
  * `translate` and `InferenceServer` without masks on a narrowed
    `mri256_bf16_config()` (dim 8, 64px, T=6, DDIM 3 of 6, bf16, dilation
    16·64/256 = 4) with the shipped SegUNet: the JAX front end's masks, and
    the JAX chain with its key stream replayed at the bf16 chain bar of
    test_torch_mri256 (relative L2 ≤ 0.15, correlation ≥ 0.99, max
    difference ≤ 5% of the range).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.data.synthetic import synthetic_brain_translation as j_brains
from localdiffusion_tpu.models.seg_unet import SegUNet as JSeg
from localdiffusion_tpu.ood.features import SegEncoderFeatureSource as JSegSource
from localdiffusion_tpu.ood.frontend import OODFrontend as JFrontend
from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
from localdiffusion_tpu.ood.thresholds import fit_ladder as j_fit_ladder
from localdiffusion_tpu.ood.thresholds import save_ladder
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_frontend
from localdiffusion_tpu_torch.models import seg_unet as SU
from localdiffusion_tpu_torch.ood import features as TF
from localdiffusion_tpu_torch.ood import patchcore as TP
from localdiffusion_tpu_torch.ood.frontend import OODFrontend as TFrontend
from localdiffusion_tpu_torch.ood.thresholds import load_ladder, near_threshold
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from test_torch_support import jax_config, make_pair, plain_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_NPZ = os.path.join(ROOT, "results/seg256_params.npz")
S = 64
REL, BAND = 1e-5, 1e-4


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _cfg(size=S, **ood):
    base = tcfg.mri256_bf16_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=size),
        ood=dataclasses.replace(base.ood, input_size=size, seg_model_path=SEG_NPZ, **ood))


def _brains(n, tumor, seed, size=S):
    d = tcfg.mri256_bf16_config().data
    return j_brains(n, size, tumor=tumor, seed=seed, mean_t1=d.mean_t1, std_t1=d.std_t1,
                    mean_flair=d.mean_flair, std_flair=d.std_flair)[1]


@pytest.fixture(scope="module")
def shipped():
    """The shipped SegUNet in both packages (the JAX tree from the npz on a
    shape-only template, no flax init)."""
    jm = JSeg()
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 1))))
    jparams = jax_load_npz(SEG_NPZ, template)
    tm = SU.SegUNet()
    tm.load_state_dict(SU.load_seg_npz(SEG_NPZ, tm))
    tm.eval().requires_grad_(False)
    return dict(jm=jm, jparams=jparams, japply=jax.jit(lambda x: jm.apply(jparams, x)), tm=tm)


def test_narrow_seg_unet_matches_jax():
    jm = JSeg(base=8)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))))
    rng = np.random.default_rng(1)

    def leaf(s):
        if len(s.shape) > 1:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return (0.2 + 0.5 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map(leaf, template)
    ups = [v["kernel"] for k, v in params["params"].items() if k.endswith("_up")]
    assert len(ups) == 4 and all(not np.allclose(k, k[::-1, ::-1]) for k in ups)
    assert all(np.all(v["bias"] != 0) for k, v in params["params"].items() if "bias" in v)
    x = rng.uniform(0, 3, (2, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = SU.SegUNet(base=8)
    tm.load_state_dict(SU.seg_params_from_jax(params, tm))
    got = tm(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (2, 16, 16, 1) and got.dtype == np.float32
    assert _rel(got, want) <= REL
    # the flip is needed: the same kernels transposed but not flipped miss
    def unflipped_leaf(path, a):
        name, b = SU.torch_leaf(path, a)
        return (name, a.transpose(2, 3, 0, 1)) if path.endswith("_up/kernel") else (name, b)

    unflipped = SU.SegUNet(base=8)
    unflipped.load_state_dict(params_from_jax(params, unflipped, leaf=unflipped_leaf))
    assert _rel(unflipped(torch.as_tensor(x)).detach().numpy(), want) > 1e-2
    # the inverse map gives back the JAX tree
    flat = SU.flax_seg_tree(tm)
    for mod, leaves in params["params"].items():
        for name, leaf_v in jax.tree_util.tree_leaves_with_path(leaves):
            key = "/".join(["params", mod] + [p.key for p in name])
            np.testing.assert_array_equal(flat[key], leaf_v)


def test_shipped_seg_npz_matches_jax(shipped):
    with np.load(SEG_NPZ) as data:
        keys = data.files
    assert len(keys) == 64
    tm = shipped["tm"]
    assert len(tm.state_dict()) == 64
    assert sum(p.numel() for p in tm.parameters()) == 31_036_481
    lr = _brains(3, True, 5)
    want = np.asarray(shipped["japply"](jnp.asarray(lr)))
    got = tm(torch.as_tensor(lr)).numpy()
    assert got.shape == want.shape == (3, S, S, 1)
    assert _rel(got, want) <= REL
    p = _sigmoid(want)
    off = np.abs(p - 0.5) > BAND
    assert off.mean() > 0.99
    np.testing.assert_array_equal((_sigmoid(got) > 0.5)[off], (p > 0.5)[off])
    assert 0 < (p > 0.5).mean() < 1


@pytest.mark.parametrize("layers", [("down2", "down3"), ("inc", "down1", "down4")])
def test_seg_encoder_taps_match_jax(shipped, layers):
    js = JSegSource(shipped["jparams"], layers)
    ts = TF.SegEncoderFeatureSource(shipped["tm"], layers)
    assert ts.layers == js.layers and ts.strides == js.strides and ts.preprocess == "raw"
    x = _brains(2, True, 6)
    want = {k: np.asarray(v) for k, v in jax.jit(js.apply)(jnp.asarray(x)).items()}
    got = ts.apply(torch.as_tensor(x))
    assert set(got) == set(want) == set(layers)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, k
        assert _rel(g, w) <= REL, k


def test_seg_frontend_detect_matches_jax(shipped):
    cfg = _cfg()
    assert cfg.ood.resolved_mask_dilate(S) == 16
    jfe = JFrontend(jax_config(cfg), seg_apply=shipped["japply"])
    tfe = TFrontend(cfg, seg_apply=SU.SegDetector(shipped["tm"]), time_stages=True)
    lr = _brains(3, True, 7)
    jm, jb, jp = (np.asarray(a) for a in jfe.detect(lr))
    tm, tb, tp = tfe.detect(lr)
    assert set(tfe.last_split) == {"seg", "host"}
    assert tp.shape == jp.shape == tb.shape == (3, S, S, 1)
    assert _rel(tp, jp) <= REL
    compared = 0
    for i in range(3):
        if np.any(np.abs(jp[i] - 0.5) <= BAND):
            continue
        np.testing.assert_array_equal(tb[i], jb[i])
        np.testing.assert_array_equal(tm[i], tb[i])
        compared += 1
    assert compared >= 2
    assert 0 < jb.mean() < 1 and not np.any(jb.reshape(3, -1).min(1) >= 1)


def test_seg_encoder_frontend_detect_matches_jax(shipped, tmp_path):
    """PatchCore over the seg encoder's down2 ⊕ down3 (768 channels at
    16×16), the bank JAX builds from 4 normal brains and the ladder fitted
    on their maps, in both packages."""
    cfg = _cfg(detector="patchcore", feature_source="seg_encoder", mask_dilate=-1)
    jc = jax_config(cfg)
    jpc = JPatchCore(jc.ood, source=JSegSource(shipped["jparams"], ("down2", "down3")))
    calib = _brains(4, False, 42)
    bank = jpc.build_memory_bank([calib])
    assert bank.shape == (102, 768)
    path = str(tmp_path / "ladder.json")
    save_ladder(j_fit_ladder([np.asarray(jpc(jnp.asarray(calib))["anomaly_map"])]), path)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=path))
    jc = jc.replace(ood=dataclasses.replace(jc.ood, ladder_path=path))
    tpc = TP.PatchCore(cfg.ood, source=TF.SegEncoderFeatureSource(shipped["tm"]),
                       memory_bank=bank)
    lr = _brains(3, True, 8)
    jm, jb, ja = (np.asarray(a) for a in JFrontend(jc, patchcore=jpc).detect(lr))
    tm, tb, ta = TFrontend(cfg, patchcore=tpc).detect(lr)
    assert ta.shape == ja.shape == (3, S, S, 1)
    assert _rel(ta, ja) <= REL
    ladder = load_ladder(path)
    compared = 0
    for i in range(3):
        if near_threshold(ja[i], ladder, BAND):
            continue
        np.testing.assert_array_equal(tb[i], jb[i])
        np.testing.assert_allclose(tm[i], jm[i], rtol=1e-4, atol=1e-4)
        compared += 1
    assert compared >= 2
    # auto dilation: one cell of down3, 8 output pixels, in both
    assert cfg.ood.resolved_mask_dilate(S, tpc.source.strides) == 8


def test_build_frontend_seg(shipped, tmp_path, monkeypatch):
    cfg = _cfg()
    fe, cfg2 = build_frontend(cfg, device="cpu", verbose=False)
    assert cfg2 is cfg and fe.patchcore is None
    lr = _brains(2, True, 9)
    want = TFrontend(cfg, seg_apply=SU.SegDetector(shipped["tm"])).detect(lr)
    for g, w in zip(fe.detect(lr), want):
        np.testing.assert_array_equal(g, w)
    # no checkpoint: no front end, as in the JAX package
    none = cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=str(tmp_path / "x.npz")))
    assert build_frontend(none, device="cpu", verbose=False) == (None, none)
    with pytest.raises(FileNotFoundError, match="seg_encoder"):
        TF.make_feature_source(none.replace(ood=dataclasses.replace(
            none.ood, feature_source="seg_encoder")), device="cpu", verbose=False)
    # an Orbax directory raises, named or first in the default order
    orbax = tmp_path / "results" / "seg" / "best_dice"
    orbax.mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="exporter"):
        build_frontend(cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=str(orbax))),
                       device="cpu", verbose=False)
    default = cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=None))
    monkeypatch.chdir(tmp_path)
    os.symlink(SEG_NPZ, tmp_path / "results" / "seg256_params.npz")
    with pytest.raises(NotImplementedError, match="Orbax"):
        build_frontend(default, device="cpu", verbose=False)
    orbax.rmdir()
    fe, _ = build_frontend(default, device="cpu", verbose=False)
    for g, w in zip(fe.detect(lr), want):
        np.testing.assert_array_equal(g, w)
    os.remove(tmp_path / "results" / "seg256_params.npz")
    assert build_frontend(default, device="cpu", verbose=False) == (None, default)


def _jax_projection(d, proj_dim=128, seed=0):
    """The k-center projection the JAX package draws from PRNGKey(seed)."""
    return torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (d, proj_dim), dtype=jnp.float32)
        / jnp.sqrt(jnp.asarray(proj_dim, jnp.float32))))


def test_bank_cli_seg_encoder_matches_the_jax_script(shipped, tmp_path, monkeypatch, capsys):
    """`ood.bank --config mri64 --feature-source seg_encoder` on 2 normal
    brains at 64px (512 patches × 768 → 51 rows) against
    scripts/anomaly_model_train.py's steps on the JAX package, its
    k-center projection handed to the port: the same rows within 1e-4 and
    the same ladder.  (At 256px the seg encoder's background patches tie
    within float32 rounding, and the two k-centers part at step ~90 even
    on one embedding; the card's check holds k-center card against CPU.)"""
    from localdiffusion_tpu_torch.ood import bank as B

    monkeypatch.setattr(TP, "random_projection", _jax_projection)
    out = str(tmp_path / "bank.npy")
    res = B.main(["--config", "mri64", "--feature-source", "seg_encoder", "--seg-npz",
                  SEG_NPZ, "--n-images", "2", "--device", "cpu", "--out", out])
    assert "saved fitted ladder" in capsys.readouterr().out
    got = np.load(out)
    assert got.shape == (51, 768) and res["patches"] == 512

    cfg = tcfg.mri64_config()
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore",
                                              feature_source="seg_encoder"))
    jc = jax_config(cfg)
    jpc = JPatchCore(jc.ood, rng=jax.random.PRNGKey(0),
                     source=JSegSource(shipped["jparams"], ("down2", "down3")))
    fe = JFrontend(jc, patchcore=jpc)
    lr = _brains(2, False, 42)
    batches = [np.asarray(fe._preprocess_patchcore(jnp.asarray(lr[i:i + 8])))
               for i in range(0, 2, 8)]
    want = jpc.build_memory_bank(batches, sampling_ratio=0.1, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jl = j_fit_ladder([np.asarray(jpc(jnp.asarray(x))["anomaly_map"]) for x in batches])
    tl = res["ladder"]
    np.testing.assert_allclose(tl.gate, jl.gate, rtol=1e-4)
    for a, b in zip(tl.rungs, jl.rungs, strict=True):
        np.testing.assert_allclose(a.above, b.above, rtol=1e-4)
        if isinstance(b.threshold, str):  # a relative rung, e.g. 'max-1std'
            assert a.threshold == b.threshold
        else:
            np.testing.assert_allclose(a.threshold, b.threshold, rtol=1e-4)


# ---------------------------------------------------------------------------
# translate and the server with the seg detector, narrowed bf16 DDIM chain
# ---------------------------------------------------------------------------

N, T, STEPS = 64, 6, 3
CHAIN_REL, CHAIN_CORR, CHAIN_MAX = 0.15, 0.99, 0.05


@pytest.fixture(scope="module")
def narrow(shipped):
    base = tcfg.mri256_bf16_config()
    cfg = base.replace(
        model=dataclasses.replace(base.model, dim=8, attn_heads=2, attn_dim_head=8),
        diffusion=dataclasses.replace(base.diffusion, image_size=N, timesteps=T,
                                      sampling_timesteps=STEPS),
        ood=dataclasses.replace(base.ood, input_size=N, seg_model_path=SEG_NPZ,
                                mask_dilate=16 * N // 256))
    assert cfg.train.compute_dtype == "bfloat16" and cfg.ood.detector == "seg"
    jgd, params, tgd = make_pair(cfg.model, cfg.diffusion, seed=13, dtype="bfloat16",
                                 numpy_init=True)
    jc = jax_config(cfg)
    jpipe = JaxPipeline(jc, jgd, params, frontend=JFrontend(jc, seg_apply=shipped["japply"]))
    tfe, _ = build_frontend(cfg, device="cpu", verbose=False)
    return jpipe, LocalDiffusionPipeline(cfg, tgd, frontend=tfe)


def _chain_close(got, want, mmv):
    assert _rel(got, want) <= CHAIN_REL
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= CHAIN_CORR
    assert np.abs(got - want).max() <= CHAIN_MAX * (mmv[1] - mmv[0])


def test_translate_with_seg_detector_matches_jax(narrow):
    jpipe, tpipe = narrow
    lr = _brains(4, True, 10, N)  # the server's padded batch: one JAX compile
    key = jax.random.PRNGKey(6)
    want = jpipe.translate(lr, key=key)
    got = tpipe.translate(lr, noise=ArrayNoise(plain_noise(key, lr.shape, STEPS), "cpu"))
    assert bool(got["branched"]) and bool(want["branched"])
    p = np.asarray(want["anomaly_map"])
    assert not np.any(np.abs(p - 0.5) <= BAND)
    np.testing.assert_array_equal(got["mask"], np.asarray(want["mask"]))
    assert 0 < got["mask"].mean() < 1
    assert _rel(got["anomaly_map"], p) <= REL
    _chain_close(got["pred"], np.asarray(want["pred"]), tpipe.min_max_val)
    assert set(got) == set(want)


def test_server_with_seg_detector_matches_jax(narrow):
    """Three requests without masks fill a padded batch of 4 on the
    overlapped threads; the seg detector runs on the padded rows, and each
    request gets the JAX front end's mask and the JAX pipeline's image for
    its row of the same padded batch and batch key."""
    jpipe, tpipe = narrow
    base = jax.random.PRNGKey(2)
    lrs = list(_brains(3, True, 11, N))
    srv = InferenceServer(
        tpipe, batch_size=4, max_wait_ms=500, overlap_detect=True,
        noise_for_batch=lambda i: ArrayNoise(
            plain_noise(jax.random.fold_in(base, i), (4, N, N, 1), STEPS), "cpu"))
    futs = [srv.submit(lr) for lr in lrs]
    with srv:
        outs = [f.result(timeout=300) for f in futs]
    stats = srv.snapshot_stats()
    assert stats["requests"] == 3 and stats["batches"] == 1 and stats["padded_slots"] == 1
    padded = np.stack(lrs + lrs[-1:])
    want = jpipe.translate(padded, key=jax.random.fold_in(base, 0))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out["mask"], np.asarray(want["mask"])[i])
        _chain_close(out["pred"], np.asarray(want["pred"])[i], tpipe.min_max_val)
    assert all(o["branched"] for o in outs)
