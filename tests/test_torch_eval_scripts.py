"""The port's command-line entry points against the JAX scripts.

  * `eval_margins` at n=4, batch 2, DDPM, variants plain, gt, gtd, gte and
    gts on a narrow configuration (dim 8, 32px, T=10, weights carried across
    as an npz), the JAX key stream of each batch (`fold_in(PRNGKey(seed),
    b)`) replayed: per-image MSEs against the JAX script's formula on the
    JAX pipeline's outputs (1e-4), `mean_ci` against the JAX script's
    (1e-12), the JSON layout against `results/margins_shipped_swap_r5.json`;
    and the two faults the JAX script has: snapshots of one file name in
    two directories keep their own keys, and `--samplers ddim` on T < 50
    runs a T − 1 step chain;
  * `eval_gated_quality` on a narrow gated configuration (32px, T=6, fused
    at 5, budget 3) with its banks built from 2 images and the gate
    replaced by scripted verdicts: fusion times and the counts of the JAX
    script's formula, both runs' per-image MSEs against the JAX pipeline
    with the same masks, scripted gate and keys, and the layout against
    `results/gated_quality_r5.json`;
  * `test` on `mri64` with 2 images (the shipped denoiser at 64px, the
    shipped SegUNet as the detector), and its ground-truth-mask flow on a
    narrow configuration.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.data.synthetic import synthetic_brain_translation as j_brains
from localdiffusion_tpu.ood.thresholds import dilate_mask as j_dilate
from localdiffusion_tpu.ood.thresholds import erode_mask as j_erode
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.utils.params_io import save_params_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_frontend, load_params
from localdiffusion_tpu_torch.ood import features as TF
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_noise
from localdiffusion_tpu_torch.scripts import eval_gated_quality, eval_margins
from localdiffusion_tpu_torch.scripts import test as test_cli
from test_torch_support import (
    branched_noise, jax_config, make_pair, plain_noise, retry_noise, small_model_cfg,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts.eval_margins import mean_ci as jax_mean_ci  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
S, T, SEED = 32, 10, 777
GS, GT = 32, 6  # the gated configuration's size and T (fused at 5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored after: the Tier-1
    run's six workers share the machine's cores, and PyTorch's default of
    one thread a core slowed these narrow chains tenfold there."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _narrow(base: tcfg.Config, npz: str, size: int, timesteps: int) -> tcfg.Config:
    """`base` with the narrow UNet (dim 8, mults 1/2) at `size` and T, f32,
    its denoiser taps the two stages' and `npz` as their weights."""
    return base.replace(
        model=small_model_cfg(),
        diffusion=dataclasses.replace(base.diffusion, image_size=size, timesteps=timesteps,
                                      sampling_timesteps=None),
        ood=dataclasses.replace(base.ood, input_size=size, feature_npz=npz,
                                feature_layers=("down0_block2", "down1_block2")),
        train=dataclasses.replace(base.train, compute_dtype="float32"))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The narrow margin configuration's engines (JAX, port) on shared
    weights, saved as an npz, registered as the builder 'narrow_mri'."""
    d = tmp_path_factory.mktemp("narrow")
    npz = str(d / "narrow.npz")
    cfg = _narrow(tcfg.mri256_config(), npz, S, T)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, mask_dilate=2))
    jgd, params, _ = make_pair(cfg.model, cfg.diffusion, seed=4, numpy_init=True)
    save_params_npz(npz, params, dtype=np.float32)
    return dict(cfg=cfg, jgd=jgd, params=params, npz=npz, dir=d)


def _register(monkeypatch, name, cfg):
    monkeypatch.setitem(tcfg.CONFIGS, name, lambda: cfg)


def _key(b):
    return jax.random.fold_in(jax.random.PRNGKey(SEED), b)


def _stream(b, mask, timesteps, s):
    """The noise the JAX chain draws from batch b's key for `mask`."""
    shape = mask.shape
    if np.all(mask == 1.0):
        return ArrayNoise(plain_noise(_key(b), shape, timesteps), "cpu")
    return ArrayNoise(branched_noise(_key(b), shape, timesteps, s), "cpu")


def _jax_per_image(pred, hr, g):
    """The JAX script's per-image formula (scripts/eval_margins.py)."""
    err = (np.asarray(pred, np.float32) - hr) ** 2
    whole = err.reshape(err.shape[0], -1).mean(1)
    ood = (err * g).reshape(err.shape[0], -1).sum(1) / (
        np.maximum(g.reshape(g.shape[0], -1).sum(1), 1.0))
    return whole, ood


def _layout(a, b, path=""):
    """The keys of two JSON objects agree, recursively (a may add keys
    at the top)."""
    assert set(b) <= set(a), (path, sorted(set(b) - set(a)))
    for k, v in b.items():
        if isinstance(v, dict) and k != "variants":
            _layout(a[k], v, f"{path}/{k}")


def test_margins_cli_matches_the_jax_formula(narrow, monkeypatch, tmp_path):
    cfg = narrow["cfg"]
    _register(monkeypatch, "narrow_mri", cfg)
    variants = ["plain", "gt", "gtd", "gte", "gts"]
    out = tmp_path / "margins.json"
    res = eval_margins.main(
        ["--config", "narrow_mri", "--params-npz", narrow["npz"], "--images", "4",
         "--batch", "2", "--variants", ",".join(variants), "--samplers", "ddpm",
         "--gte-radius", "1", "--device", "cpu", "--work-dir", str(tmp_path),
         "--out", str(out)],
        noise_for=lambda b, m: _stream(b, m, T, 2))
    assert json.load(open(out)) == json.loads(json.dumps(res))

    d = cfg.data
    hr, lr, seg = j_brains(4, S, tumor=True, seed=SEED, mean_t1=d.mean_t1, std_t1=d.std_t1,
                           mean_flair=d.mean_flair, std_flair=d.std_flair,
                           translate_zero=d.translate_zero)
    g = (seg > 0).astype(np.float32)
    masks = {"plain": np.ones_like(g), "gt": g,
             "gtd": np.stack([j_dilate(g[i], 2) for i in range(4)]),
             "gte": np.stack([j_erode(g[i], 1) for i in range(4)])}
    masks["gts"] = 0.5 * masks["gtd"]
    jpipe = JaxPipeline(jax_config(cfg), narrow["jgd"], narrow["params"])
    per = {}
    for v in variants:
        preds = [jpipe.translate(lr[i:i + 2], key=_key(i // 2), mask=masks[v][i:i + 2])["pred"]
                 for i in (0, 2)]
        whole, ood = _jax_per_image(np.concatenate(preds), hr, g)
        row = res["variants"][f"ddpm/{v}"]
        np.testing.assert_allclose(row["per_image_whole"], whole, **TOL, err_msg=v)
        np.testing.assert_allclose(row["per_image_ood"], ood, **TOL, err_msg=v)
        for name, xs in (("whole", whole), ("ood_region", ood)):
            want = jax_mean_ci(xs)
            assert row[name]["n"] == want["n"] == 4
            np.testing.assert_allclose(row[name]["mean"], want["mean"], **TOL, err_msg=v)
            np.testing.assert_allclose(row[name]["ci95"], want["ci95"], **TOL, err_msg=v)
        per[v] = (whole, ood)
    for v in variants[1:]:
        delta = res["variants"][f"ddpm/{v}_minus_plain"]
        for name, i in (("whole_delta", 0), ("ood_delta", 1)):
            want = jax_mean_ci(per[v][i] - per["plain"][i])
            np.testing.assert_allclose(delta[name]["mean"], want["mean"], **TOL, err_msg=v)
            np.testing.assert_allclose(delta[name]["ci95"], want["ci95"], **TOL, err_msg=v)
    record = json.load(open(os.path.join(ROOT, "results/margins_shipped_swap_r5.json")))
    _layout(res, record)
    for key in ("ddpm/plain", "ddpm/denoiser_minus_plain"):
        got_key = key.replace("denoiser", "gt")
        assert set(res["variants"][got_key]) == set(record["variants"][key]), key


@pytest.mark.parametrize("xs", [[0.3], [1.0, 2.0], list(np.random.default_rng(0).gamma(
    2.0, 0.5, 64)), list(np.random.default_rng(1).normal(-0.2, 0.05, 7))])
def test_mean_ci_is_the_jax_scripts(xs):
    got, want = eval_margins.mean_ci(xs), jax_mean_ci(xs)
    assert got["n"] == want["n"]
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-12, atol=0)
    if want["ci95"] is None:
        assert got["ci95"] is None
    else:
        np.testing.assert_allclose(got["ci95"], want["ci95"], rtol=1e-12, atol=0)


def test_margins_keys_of_one_file_name_do_not_collide(narrow, monkeypatch, tmp_path):
    """Two snapshots named alike in two directories (entries stripped)
    keep a key each: the same weights, so the same numbers."""
    _register(monkeypatch, "narrow_mri", narrow["cfg"])
    paths = []
    for sub in ("a", "b"):
        os.makedirs(tmp_path / sub)
        paths.append(str(tmp_path / sub / "ema.npz"))
        with open(narrow["npz"], "rb") as f, open(paths[-1], "wb") as g:
            g.write(f.read())
    res = eval_margins.main(
        ["--config", "narrow_mri", "--params-npz", f" {paths[0]} , {paths[1]} ", "--images",
         "2", "--batch", "2", "--variants", "plain,gt", "--samplers", "ddpm", "--device",
         "cpu", "--work-dir", str(tmp_path)])
    keys = set(res["variants"])
    assert keys == {f"ema#{k}/ddpm/{v}" for k in (1, 2)
                    for v in ("plain", "gt", "gt_minus_plain")}
    assert (res["variants"]["ema#1/ddpm/gt"]["per_image_ood"]
            == res["variants"]["ema#2/ddpm/gt"]["per_image_ood"])
    assert eval_margins.result_prefixes(["x/a.npz", "y/b.npz"]) == ["a/", "b/"]
    assert eval_margins.result_prefixes(["x/a.npz"]) == [""]


def test_margins_ddim_on_a_short_chain(narrow, monkeypatch, tmp_path):
    """T=10 and a configuration sampling every step: `--samplers ddim`
    runs DDIM over T − 1 = 9 steps (the JAX script pins 50 > T and its
    configuration refuses it)."""
    _register(monkeypatch, "narrow_mri", narrow["cfg"])
    calls = []
    apply = GaussianDiffusion.apply_model
    monkeypatch.setattr(GaussianDiffusion, "apply_model",
                        lambda self, *a, **k: calls.append(self.is_ddim_sampling) or
                        apply(self, *a, **k))
    res = eval_margins.main(
        ["--config", "narrow_mri", "--params-npz", narrow["npz"], "--images", "2",
         "--batch", "2", "--variants", "plain", "--samplers", "ddim", "--device", "cpu",
         "--work-dir", str(tmp_path)])
    assert calls == [True] * 9
    assert np.isfinite(res["variants"]["ddim/plain"]["whole"]["mean"])
    assert eval_margins.ddim_steps(tcfg.mri256_config()) == 50
    assert eval_margins.ddim_steps(tcfg.mri256_bf16_config()) == 50
    short = narrow["cfg"].replace(diffusion=dataclasses.replace(
        narrow["cfg"].diffusion, timesteps=1, sampling_timesteps=None))
    with pytest.raises(ValueError, match="no DDIM chain"):
        eval_margins.ddim_steps(short)


# ---------------------------------------------------------------------------
# the gated quality evaluation
# ---------------------------------------------------------------------------

REJECTS = ({4, 3}, set())  # sample 0 rejected at t=4 and 3, sample 1 never


def _scripted_table():
    table = np.zeros((GT, 2), bool)
    for b, ts in enumerate(REJECTS):
        table[list(ts), b] = True
    return table


def test_gated_cli_with_scripted_verdicts(narrow, monkeypatch, tmp_path):
    npz = narrow["npz"]
    cfg = _narrow(tcfg.mri256_gated_config(), npz, GS, GT)
    _register(monkeypatch, "narrow_gated", cfg)
    table = _scripted_table()
    jgd, params, _ = make_pair(cfg.model, cfg.diffusion, seed=4, numpy_init=True)
    gnpz = str(tmp_path / "gated.npz")
    save_params_npz(gnpz, params, dtype=np.float32)
    shape = (2, GS, GS, 1)
    out = tmp_path / "gated.json"
    res = eval_gated_quality.main(
        ["--config", "narrow_gated", "--params-npz", gnpz, "--images", "2", "--batch", "2",
         "--bank-normals", "2", "--calib", "2", "--bank-images", "2", "--device", "cpu",
         "--work-dir", str(tmp_path), "--out", str(out)],
        noise_for=lambda b: (ArrayNoise(branched_noise(_key(b), shape, GT, 5), "cpu"),
                             ArrayNoise(retry_noise(_key(b), shape, GT, 5, 5), "cpu")),
        gate_for=lambda gate: (lambda xs, t: torch.where(torch.as_tensor(table[t]), -1.0, 1.0)))
    assert json.load(open(out)) == json.loads(json.dumps(res))
    gated = res["variants"]["gated"]
    assert gated["fusion_time"] == [2, 4]
    assert (gated["accepted_first_step"], gated["rejected_at_least_once"]) == (1, 1)
    assert gated["mean_accept_t"] == 3.0
    assert "fusion_time" not in res["variants"]["ungated"]
    assert 0.0 <= res["balanced_acc"] <= 1.0 and np.isfinite(res["threshold"])
    record = json.load(open(os.path.join(ROOT, "results/gated_quality_r5.json")))
    _layout(res, record)
    for tag in ("ungated", "gated"):
        assert set(res["variants"][tag]) == set(record["variants"][tag]), tag

    # the same masks (the port's front end on the bank the run built), the
    # JAX pipelines with the scripted gate and the same keys
    run_cfg = cfg.replace(ood=dataclasses.replace(
        cfg.ood, memory_bank_path=str(tmp_path / "memory_bank_denoiser.npy"), ladder_path=None,
        feature_npz=gnpz))
    gd = load_params(run_cfg, params_npz=gnpz, device="cpu", verbose=False)
    fe, _ = build_frontend(run_cfg, gd=gd, device="cpu", verbose=False)
    d = cfg.data
    hr, lr, seg = j_brains(2, GS, tumor=True, seed=SEED, mean_t1=d.mean_t1, std_t1=d.std_t1,
                           mean_flair=d.mean_flair, std_flair=d.std_flair,
                           translate_zero=d.translate_zero)
    mask = fe.detect(lr)[0]
    assert not np.all(mask == 1.0)
    jc = jax_config(run_cfg.replace(ood=dataclasses.replace(run_cfg.ood,
                                                            classifier_threshold=0.0)))
    jgate = lambda xs, t: jnp.where(jnp.asarray(table)[t], -1.0, 1.0)
    jun = jc.replace(sampler=dataclasses.replace(jc.sampler, classifier=False))
    want_u = JaxPipeline(jun, jgd, params).translate(lr, key=_key(0), mask=mask)
    want_g = JaxPipeline(jc, jgd, params, classifier_gate=jgate).translate(
        lr, key=_key(0), mask=mask)
    np.testing.assert_array_equal(want_g["fusion_time"], gated["fusion_time"])
    g = (seg > 0).astype(np.float32)
    for tag, want in (("ungated", want_u), ("gated", want_g)):
        whole, ood = _jax_per_image(want["pred"], hr, g)
        np.testing.assert_allclose(res["variants"][tag]["per_image_whole"], whole, **TOL)
        np.testing.assert_allclose(res["variants"][tag]["per_image_ood"], ood, **TOL)


def test_gated_cli_builds_its_own_detector_bank_beside_a_margin_run(narrow, monkeypatch,
                                                                      tmp_path):
    """`eval_margins` and `eval_gated_quality` on one work dir: the margin
    run's denoiser bank has the name of the gated run's detector bank, and
    the gated run builds its own over it (its weights, its --bank-images)
    rather than reuse it."""
    npz = narrow["npz"]
    _register(monkeypatch, "narrow_mri", narrow["cfg"])
    _register(monkeypatch, "narrow_gated", _narrow(tcfg.mri256_gated_config(), npz, GS, GT))
    work = str(tmp_path)
    eval_margins.main(
        ["--config", "narrow_mri", "--params-npz", npz, "--images", "2", "--batch", "2",
         "--variants", "denoiser", "--samplers", "ddpm", "--bank-images", "3", "--device",
         "cpu", "--work-dir", work])
    path = os.path.join(work, "memory_bank_denoiser.npy")
    stale = np.load(path)
    built = []
    build = eval_gated_quality.build_bank

    def recorded(cfg, out, **kw):
        res = build(cfg, out, **kw)
        built.append((out, kw["n_images"], res["bank"]))
        return res

    monkeypatch.setattr(eval_gated_quality, "build_bank", recorded)
    eval_gated_quality.main(
        ["--config", "narrow_gated", "--params-npz", npz, "--images", "2", "--batch", "2",
         "--bank-normals", "2", "--calib", "2", "--bank-images", "2", "--device", "cpu",
         "--work-dir", work],
        gate_for=lambda gate: (lambda xs, t: torch.ones(xs.shape[0])))
    assert [(p, n) for p, n, _ in built] == [(path, 2)]
    np.testing.assert_array_equal(np.load(path), built[0][2])
    assert not np.array_equal(np.load(path), stale)


# ---------------------------------------------------------------------------
# the test script
# ---------------------------------------------------------------------------

def test_test_cli_on_mri64(tmp_path, capsys):
    """Two images of the JAX script's test set through `mri64` (the shipped
    denoiser at 64px, the shipped SegUNet's masks, DDIM-50): the dumps
    hold the JAX data and the seg detector's masks, finite images, and the
    printed loss is theirs."""
    prefix = str(tmp_path / "p_")
    out = test_cli.main(["--config", "mri64", "--params-npz",
                         os.path.join(ROOT, "results/mri_synth256_ema.npz"), "--max-images",
                         "2", "--device", "cpu", "--save-prefix", prefix])
    cfg = tcfg.mri64_config()
    d = cfg.data
    hr, lr, _ = j_brains(2, 64, tumor=True, seed=0, mean_t1=d.mean_t1, std_t1=d.std_t1,
                         mean_flair=d.mean_flair, std_flair=d.std_flair,
                         translate_zero=d.translate_zero)
    dumps = {n: np.load(f"{prefix}{n}.npy") for n in
             ("hr_all", "lr_all", "pred_all", "ad_masks", "fusion_time")}
    np.testing.assert_array_equal(dumps["hr_all"], hr)
    np.testing.assert_array_equal(dumps["lr_all"], lr)
    assert dumps["pred_all"].shape == (2, 64, 64, 1) and np.all(np.isfinite(dumps["pred_all"]))
    np.testing.assert_array_equal(dumps["fusion_time"], [250, 250])
    fe, _ = build_frontend(cfg, device="cpu", verbose=False)
    masks = np.concatenate([fe.detect(lr[i:i + 1])[0] for i in range(2)])
    np.testing.assert_array_equal(dumps["ad_masks"], masks)
    per = ((dumps["pred_all"] - hr) ** 2).reshape(2, -1).mean(1)
    np.testing.assert_allclose(out["mean_mse"], per.mean(), rtol=1e-5)
    assert f"Test loss: {float(out['mean_mse']):.4f}" in capsys.readouterr().out


def test_test_cli_ground_truth_masks_without_a_seg_checkpoint(narrow, monkeypatch, tmp_path):
    """No SegUNet: the JAX script's ground-truth-mask flow, one image a
    batch, each batch seeded from 10."""
    cfg = narrow["cfg"].replace(ood=dataclasses.replace(narrow["cfg"].ood, detector="seg"))
    _register(monkeypatch, "narrow_mri", cfg)
    monkeypatch.setattr(TF, "SEG_CANDIDATES", (str(tmp_path / "absent.npz"),))
    out = test_cli.main(["--config", "narrow_mri", "--params-npz", narrow["npz"],
                         "--max-images", "2", "--device", "cpu"])
    assert set(out) == {"mean_mse", "mean_mse_ood_region", "mean_time"}
    hr, lr, seg = eval_margins.brains(cfg, 2, True, 0)
    gd = load_params(cfg, params_npz=narrow["npz"], device="cpu", verbose=False)
    pipe = LocalDiffusionPipeline(cfg, gd)
    mse = [float(pipe.translate(lr[i:i + 1], hr=hr[i:i + 1], noise=batch_noise(10, i)[0],
                                mask=(seg[i:i + 1] > 0).astype(np.float32))["mse"])
           for i in range(2)]
    np.testing.assert_allclose(out["mean_mse"], np.mean(mse), rtol=1e-6)
