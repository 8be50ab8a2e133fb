"""The WRN50-2 feature source in the port, against the JAX package.

One JAX init of the WRN (`PRNGKey(0)`, through layer3, jitted) serves the
module: flax draws each parameter from its module path, so its layer1 and
layer2 are those of a WRN built to layer2 (the shipped 64px bank's).

  * `WideResNet50Features` per tap at a 64px input through layer3, float32,
    the JAX parameters carried across by `params_from_jax`: relative L2 ≤
    1e-5 (convolution summation order);
  * the `backbone_weights_path` route: a torchvision-named state dict (the
    port's own seeded module, with torchvision's extra entries) saved with
    `torch.save`, read by the port (`weights_only=True`) and by the JAX
    package (`convert_torch_state_dict`): the same taps at 1e-5;
  * the defaults: `PatchCore(cfg)` builds the WRN of `cfg.layers` from seed
    0 (deterministic; `wrn_source`'s `generator` changes it), only through the deepest
    stage, with the JAX source's strides and ImageNet preprocessing;
  * the WRN front end on `mri64_config()` with the shipped
    `results/memory_bank_synthetic_brain.npy` (1,638 × 768, embedded with
    JAX's weights) and its ladder, the JAX weights carried across: maps
    within 1e-5 relative L2 and masks equal (but for a map value within
    1e-5 of a threshold); `build_frontend` with the bank and a state dict of
    those weights gives the same masks;
  * the classifier gate's WRN last resort (no classifier bank, no front-end
    PatchCore) against the JAX factory's: on a bank built from the
    calibration pairs and on the detector's bank, the gate's values
    (score − threshold) within 1e-4 of the score, the same decisions;
  * the bank CLI with `--feature-source wrn` on 2 images against the JAX
    script's construction: the same rows within 1e-4 and the same ladder.

The JAX k-center projection (`jax.random.normal(PRNGKey(seed))`) is handed
to the port where a bank is built, as the Stage A tests do.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.data.synthetic import synthetic_brain_translation as j_brains
from localdiffusion_tpu.factory import build_classifier_gate as j_build_gate
from localdiffusion_tpu.ood.frontend import OODFrontend as JFrontend
from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
from localdiffusion_tpu.ood.thresholds import fit_ladder as j_fit_ladder
from localdiffusion_tpu.ood.wide_resnet import WideResNet50Features as JWRN
from localdiffusion_tpu.ood.wide_resnet import convert_torch_state_dict
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.factory import build_classifier_gate, build_frontend
from localdiffusion_tpu_torch.ood import bank as TB
from localdiffusion_tpu_torch.ood import features as TF
from localdiffusion_tpu_torch.ood import patchcore as TP
from localdiffusion_tpu_torch.ood import wide_resnet as W
from localdiffusion_tpu_torch.ood.frontend import OODFrontend as TFrontend
from localdiffusion_tpu_torch.ood.thresholds import load_ladder, near_threshold
from test_torch_support import jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK = os.path.join(ROOT, "results/memory_bank_synthetic_brain.npy")
LAYERS = ("layer1", "layer2", "layer3")
S = 64
REL, NEAR = 1e-5, 1e-5


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _brains(n, tumor, seed, size=S):
    d = tcfg.mri64_config().data
    return j_brains(n, size, tumor=tumor, seed=seed, mean_t1=d.mean_t1, std_t1=d.std_t1,
                    mean_flair=d.mean_flair, std_flair=d.std_flair)[1]


def _jax_projection(d, proj_dim=128, seed=0):
    """The k-center projection the JAX package draws from PRNGKey(seed)."""
    return torch.as_tensor(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (d, proj_dim), dtype=jnp.float32)
        / jnp.sqrt(jnp.asarray(proj_dim, jnp.float32))))


def _subset(params, deepest):
    """The JAX tree's stem and stages up to layer`deepest`."""
    return {"params": {k: v for k, v in params["params"].items()
                       if not k.startswith("layer") or int(k[5]) <= deepest}}


def _torchvision_file(state, path):
    """`state` (torchvision names) with torchvision's other entries, saved
    as torchvision saves a state dict."""
    sd = dict(state)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def jwrn(tmp_path_factory):
    """The JAX WRN's PRNGKey(0) params through layer3 (numpy), and the same
    weights as a torchvision-named state dict, in memory and in a file."""
    jm = JWRN(layers=LAYERS)
    params = jax.tree_util.tree_map(
        np.array, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))))
    state = W.params_from_jax(params, W.WideResNet50Features(LAYERS))
    path = _torchvision_file(state, tmp_path_factory.mktemp("wrn") / "wrn.pth")
    return dict(jm=jm, params=params, state=state, path=path)


@pytest.fixture(scope="module")
def taps(jwrn):
    x = np.random.default_rng(0).standard_normal((2, S, S, 3)).astype(np.float32)
    want = jax.jit(jwrn["jm"].apply)(jwrn["params"], jnp.asarray(x))
    tm = W.WideResNet50Features(LAYERS)
    tm.load_state_dict(jwrn["state"])
    got = tm(torch.as_tensor(x))
    return {k: (got[k].detach().numpy(), np.asarray(want[k])) for k in LAYERS}


@pytest.mark.parametrize("layer,shape", [("layer1", (2, 16, 16, 256)),
                                         ("layer2", (2, 8, 8, 512)),
                                         ("layer3", (2, 4, 4, 1024))])
def test_wrn_taps_match_jax(taps, layer, shape):
    got, want = taps[layer]
    assert got.shape == want.shape == shape and got.dtype == np.float32
    assert _rel(got, want) <= REL


def test_torchvision_state_dict_route_matches_jax(tmp_path):
    """The port's own seeded WRN as a torchvision state dict file: JAX's
    converter and the port's `backbone_weights_path` give the same taps."""
    from localdiffusion_tpu.ood.patchcore import load_backbone_weights as j_load

    tm = W.build_wrn(LAYERS, "cpu", generator=torch.Generator().manual_seed(3))
    path = _torchvision_file(tm.state_dict(), tmp_path / "tv.pth")
    x = np.random.default_rng(1).standard_normal((2, S, S, 3)).astype(np.float32)
    want = jax.jit(JWRN(layers=LAYERS).apply)(j_load(path), jnp.asarray(x))
    sd = torch.load(path, weights_only=True)
    np.testing.assert_array_equal(
        convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})["params"]["conv1"][
            "kernel"], np.asarray(j_load(path)["params"]["conv1"]["kernel"]))
    cfg = tcfg.mri256_bf16_config()
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore", layers=LAYERS,
                                              backbone_weights_path=path, input_size=S))
    src = TF.make_feature_source(cfg, device="cpu", verbose=False)
    got = src.apply(torch.as_tensor(x))
    direct = tm(torch.as_tensor(x))
    for k in LAYERS:
        np.testing.assert_array_equal(got[k].numpy(), direct[k].numpy())
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= REL, k
    with pytest.raises(KeyError, match="lacks"):
        W.load_torchvision_state_dict(W.WideResNet50Features(LAYERS),
                                      {k: v for k, v in sd.items() if "layer3.5" not in k})


def test_wrn_defaults():
    from localdiffusion_tpu.ood.features import WRNFeatureSource as JSource

    cfg = tcfg.mri256_bf16_config().ood
    pc = TP.PatchCore(cfg, device="cpu")
    src = pc.source
    assert isinstance(src, TF.WRNFeatureSource) and src.layers == ("layer2", "layer3")
    assert src.strides == JSource.strides and src.preprocess == JSource.preprocess == "imagenet"
    assert pc.layers == ("layer2", "layer3") and pc.input_size == (256, 256)
    assert not hasattr(src.backbone, "layer4")
    assert not hasattr(W.WideResNet50Features(("layer1",)), "layer2")
    again = TP.PatchCore(cfg, device="cpu").source.backbone.state_dict()
    other = TF.wrn_source(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1)).backbone.state_dict()
    for k, v in src.backbone.state_dict().items():
        assert torch.equal(v, again[k]), k
    assert not torch.equal(src.backbone.conv1.weight, other["conv1.weight"])
    w = src.backbone.layer3[0].conv2.weight
    assert abs(float(w.std()) * np.sqrt(w[0].numel()) - 1.0) < 0.01  # N(0, 1/fan_in)


def _mri64_patchcore():
    cfg = tcfg.mri64_config()
    return cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore"))


def test_wrn_frontend_on_the_shipped_bank_matches_jax(jwrn, tmp_path):
    cfg = _mri64_patchcore()
    ladder_path = os.path.splitext(BANK)[0] + "_ladder.json"
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=ladder_path))
    jc = jax_config(cfg)
    bank = np.load(BANK)
    assert bank.shape == (1638, 768) and bank.dtype == np.float32
    jpc = JPatchCore(jc.ood, backbone_params=_subset(jwrn["params"], 2), memory_bank=bank)
    state = W.params_from_jax(_subset(jwrn["params"], 2), W.WideResNet50Features(cfg.ood.layers))
    tpc = TP.PatchCore(cfg.ood, source=TF.WRNFeatureSource(
        cfg.ood.layers, params=state, input_size=cfg.ood.input_size, device="cpu"),
        memory_bank=bank)
    lr = _brains(4, True, 3)
    jm, jb, ja = (np.asarray(a) for a in JFrontend(jc, patchcore=jpc).detect(lr))
    tfe = TFrontend(cfg, patchcore=tpc)
    tm, tb, ta = tfe.detect(lr)
    assert ta.shape == ja.shape == (4, S, S, 1)
    assert _rel(ta, ja) <= REL
    ladder = load_ladder(ladder_path)
    compared = 0
    for i in range(4):
        if near_threshold(ja[i], ladder, NEAR):
            continue
        np.testing.assert_array_equal(tb[i], jb[i])
        np.testing.assert_allclose(tm[i], jm[i], rtol=1e-4, atol=1e-4)
        compared += 1
    assert compared >= 3 and 0 < jb.mean() < 1
    # the factory's route: the shipped bank, its ladder beside it, the
    # weights through backbone_weights_path
    fcfg = tcfg.mri64_config()
    fcfg = fcfg.replace(ood=dataclasses.replace(fcfg.ood, detector="patchcore",
                                                memory_bank_path=BANK,
                                                backbone_weights_path=jwrn["path"]))
    fe, fcfg2 = build_frontend(fcfg, device="cpu", verbose=False)
    assert fcfg2.ood.ladder_path == ladder_path
    for g, w in zip(fe.detect(lr), (tm, tb, ta)):
        np.testing.assert_array_equal(g, w)


def _gated_cfg(**ood):
    base = tcfg.mri256_gated_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=S),
        ood=dataclasses.replace(base.ood, detector="seg", input_size=S, **ood))


def test_gate_wrn_last_resort_matches_jax(jwrn, tmp_path, monkeypatch):
    """`build_classifier_gate` with no classifier bank and no front-end
    PatchCore builds a WRN PatchCore (layer2 ⊕ layer3, the weights of
    `backbone_weights_path` on both sides) on a bank from the calibration
    pairs' images, against the JAX factory's; then, with that bank saved as
    the detector's, on the detector's bank."""
    monkeypatch.setattr(TP, "random_projection", _jax_projection)
    det_bank = str(tmp_path / "memory_bank_det.npy")  # absent at first
    cfg = _gated_cfg(backbone_weights_path=jwrn["path"], memory_bank_path=det_bank)
    assert cfg.sampler.classifier and cfg.ood.layers == ("layer2", "layer3")
    jc = jax_config(cfg)
    pairs = TB.classifier_calibration_pairs(cfg, n=4)
    x = TB.brains(cfg, 3, True, 30)[0]
    gate = build_classifier_gate(cfg, calibration_pairs=pairs, device="cpu", verbose=False)
    jgate = j_build_gate(jc, None, calibration_pairs=pairs, verbose=False)
    pc = gate.classifier.patchcore
    assert isinstance(pc.source, TF.WRNFeatureSource)
    assert pc.memory_bank.shape == (51, 1536)  # 10% of 8 images x 8 x 8 patches
    want = np.asarray(jax.jit(jgate)(jnp.asarray(x)))
    got = gate(torch.as_tensor(x)).numpy()
    # score − threshold: each term within 1e-4 of its size (the f32
    # distance identity), so the difference within 1e-4 of the score
    score = gate.classifier.score_raw(torch.as_tensor(x)).numpy()
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(score)), (got, want, score)
    np.testing.assert_array_equal(got > 0, want > 0)
    # the detector's bank, where there is one: the same bank, so the same gate
    np.save(det_bank, pc.memory_bank.numpy())
    again = build_classifier_gate(cfg, calibration_pairs=pairs, device="cpu", verbose=False)
    np.testing.assert_array_equal(again.classifier.patchcore.memory_bank.numpy(),
                                  np.load(det_bank))
    assert again.threshold == gate.threshold
    np.testing.assert_array_equal(again(torch.as_tensor(x)).numpy(), got)


def test_bank_cli_wrn_matches_the_jax_script(jwrn, tmp_path, monkeypatch, capsys):
    """`ood.bank --config mri64 --feature-source wrn --backbone-weights` on
    2 normal brains (512 patches × 768 → 51 rows) against
    scripts/anomaly_model_train.py's steps on the JAX package."""
    monkeypatch.setattr(TP, "random_projection", _jax_projection)
    out = str(tmp_path / "bank.npy")
    res = TB.main(["--config", "mri64", "--feature-source", "wrn", "--backbone-weights",
                   jwrn["path"], "--n-images", "2", "--device", "cpu", "--out", out])
    assert "saved fitted ladder" in capsys.readouterr().out
    got = np.load(out)
    assert got.shape == (51, 768) and res["patches"] == 512

    jc = jax_config(_mri64_patchcore())
    jpc = JPatchCore(jc.ood, rng=jax.random.PRNGKey(0),
                     backbone_params=_subset(jwrn["params"], 2))
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
    # a seeded WRN of its own without weights: another bank, as deterministic
    res2 = TB.main(["--config", "mri64", "--feature-source", "wrn", "--seed", "1",
                    "--n-images", "2", "--device", "cpu", "--out", str(tmp_path / "b2.npy")])
    assert res2["bank"].shape == (51, 768) and not np.allclose(res2["bank"], got)
