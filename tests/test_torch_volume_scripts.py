"""The volume CLIs: the port's `convert_mha` and `translate_volume` against
the JAX scripts.

`convert_mha`: a seeded MetaImage volume (and a compressed one, matched by
a glob) converted by both scripts, the .npy files bit for bit equal.
`translate_volume`: the smallest configuration both accept, the 256px MRI
configuration narrowed (dim 8, 16px, T=4, f32, the manual detector), on
shared weights and a seeded 3-slice volume with its segmentation, at
batch 2 (the last batch padded).  The port's script writes what its
`pipeline.translate_volume` gives, bit for bit; with the JAX key stream
replayed into it, its volumes and printed MSEs match the JAX script's
within atol/rtol 1e-4 (the sampler tests' bar for a T<=6 chain).
"""

import dataclasses
import os
import re
import sys

import jax
import numpy as np
import pytest
import yaml

from localdiffusion_tpu.utils import logging as jax_logging
from localdiffusion_tpu.utils.params_io import save_params_npz as jax_save_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.data.brats import BRATSVolumeDataset
from localdiffusion_tpu_torch.data.mha import save_mha
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_pipeline
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.scripts import convert_mha, translate_volume
from test_torch_support import branched_noise, jax_config, make_pair, small_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import convert_mha as jax_convert_mha  # noqa: E402
from scripts import translate_volume as jax_translate_volume  # noqa: E402

S, T, D, BATCH = 16, 4, 3, 2
TOL = dict(rtol=1e-4, atol=1e-4)


def _run_jax(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["script.py", *argv])
    main()


def test_convert_mha_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    save_mha(str(src / "vol_t1.mha"), rng.integers(0, 4096, (4, 6, 5)).astype(np.int16))
    save_mha(str(src / "vol_flair.mha"), rng.uniform(0, 1, (4, 6, 5)).astype(np.float32),
             compressed=True)
    for argv in ([str(src / "vol_t1.mha"), str(src / "*flair*.mha")],
                 [str(src / "*.mha"), "--dtype", "float32"]):
        _run_jax(monkeypatch, jax_convert_mha.main, [*argv, "--out-dir", str(tmp_path / "jax")])
        want_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT")
        written = convert_mha.main([*argv, "--out-dir", str(tmp_path / "port")])
        assert capsys.readouterr().out.replace(str(tmp_path / "port"), "OUT") == want_out
        assert sorted(os.path.basename(p) for p in written) == ["vol_flair.npy", "vol_t1.npy"]
        for name in ("vol_t1.npy", "vol_flair.npy"):
            want = np.load(tmp_path / "jax" / name)
            got = np.load(tmp_path / "port" / name)
            assert got.dtype == want.dtype and got.shape == want.shape == (4, 6, 5)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        convert_mha.main([str(src / "*.none"), "--out-dir", str(tmp_path / "port")])


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """The narrow configuration (a builder in both packages: a YAML for
    the JAX script, a config for the port's), its shared weights, and a
    seeded volume as .npy files."""
    d = tmp_path_factory.mktemp("volume")
    base = tcfg.mri256_config()
    cfg = base.replace(
        model=small_model_cfg(),
        diffusion=dataclasses.replace(base.diffusion, image_size=S, timesteps=T,
                                      sampling_timesteps=None),
        ood=dataclasses.replace(base.ood, detector="manual", input_size=S, manual_mask_cols=6),
        train=dataclasses.replace(base.train, compute_dtype="float32"))
    _, params, _ = make_pair(cfg.model, cfg.diffusion, seed=6, numpy_init=True)
    npz = str(d / "narrow.npz")
    jax_save_npz(npz, params, dtype=np.float32)
    with open(d / "narrow.yaml", "w") as f:
        yaml.safe_dump(_plain(dataclasses.asdict(jax_config(cfg))), f)
    rng = np.random.default_rng(1)
    vols = {"t1": rng.uniform(0, 3000, (D, 20, 18)), "flair": rng.uniform(0, 3000, (D, 20, 18)),
            "seg": np.zeros((D, 20, 18))}
    vols["seg"][:, 6:12, 4:9] = 2.0
    paths = {}
    for k, v in vols.items():
        paths[k] = str(d / f"vol_{k}.npy")
        np.save(paths[k], v.astype(np.float32))
    return dict(cfg=cfg, npz=npz, yaml=str(d / "narrow.yaml"), paths=paths, vols=vols, dir=d)


def _argv(n, out, config):
    return ["--config", config, "--t1", n["paths"]["t1"], "--flair", n["paths"]["flair"],
            "--seg", n["paths"]["seg"], "--params-npz", n["npz"], "--detector", "manual",
            "--batch", str(BATCH), "--out", out]


def _mses(printed):
    line = [l for l in printed.splitlines() if l.startswith("volume MSE:")][-1]
    return [float(v) for v in re.findall(r"MSE: ([0-9.]+)", line)]


def test_translate_volume_script_is_the_pipeline(narrow, tmp_path, monkeypatch, capsys):
    """The port's script: what `pipeline.translate_volume` gives on the
    same dataset, bit for bit; the masks beside it; the printed MSEs."""
    monkeypatch.setitem(tcfg.CONFIGS, "narrow_volume", lambda: narrow["cfg"])
    out = str(tmp_path / "pred_volume.npy")
    res = translate_volume.main([*_argv(narrow, out, "narrow_volume"), "--device", "cpu"])
    printed = capsys.readouterr().out
    cfg, v = narrow["cfg"], narrow["vols"]
    ds = BRATSVolumeDataset.single_volume(cfg.data, v["t1"].astype(np.float32),
                                          v["flair"].astype(np.float32),
                                          seg=v["seg"].astype(np.float32), crop=S)
    pipe = build_pipeline(cfg.replace(ood=dataclasses.replace(cfg.ood, detector="manual")),
                          narrow["npz"], device="cpu", verbose=False)
    want = pipe.translate_volume(ds, batch_size=BATCH, verbose=False)
    pred, masks = np.load(out), np.load(str(tmp_path / "pred_volume_masks.npy"))
    assert pred.shape == masks.shape == (D, S, S)
    np.testing.assert_array_equal(pred, want["pred_volume"][..., 0])
    np.testing.assert_array_equal(masks, want["mask_volume"][..., 0])
    assert res["branched_batches"] == 2
    assert f"saved {out} {(D, S, S, 1)}" in printed
    np.testing.assert_allclose(_mses(printed), [float(want["mse"]),
                                                float(want["mean_mse_ood_region"])], atol=1e-5)


def test_translate_volume_matches_the_jax_script(narrow, tmp_path, monkeypatch, capsys):
    """The JAX script on the YAML, the port's on the builder with the JAX
    script's key stream (PRNGKey(0), one split per batch, the branched
    chain's draws) replayed: the same files, shapes and printed MSEs."""
    monkeypatch.setattr(jax_logging, "enable_compilation_cache", lambda *a, **k: None)
    jout = str(tmp_path / "jax" / "pred_volume.npy")
    os.makedirs(os.path.dirname(jout))
    _run_jax(monkeypatch, jax_translate_volume.main, _argv(narrow, jout, narrow["yaml"]))
    want_printed = capsys.readouterr().out

    s = narrow["cfg"].sampler.start_timestep
    keys, key = [], jax.random.PRNGKey(0)
    for _ in range(-(-D // BATCH)):
        key, sub = jax.random.split(key)
        keys.append(sub)
    original = LocalDiffusionPipeline.translate_volume

    def replayed(self, dataset, batch_size=8, noise=None, verbose=True):
        return original(self, dataset, batch_size, verbose=verbose, noise=lambda b: ArrayNoise(
            branched_noise(keys[b], (batch_size, S, S, 1), T, s), "cpu"))

    monkeypatch.setattr(LocalDiffusionPipeline, "translate_volume", replayed)
    monkeypatch.setitem(tcfg.CONFIGS, "narrow_volume", lambda: narrow["cfg"])
    pout = str(tmp_path / "port" / "pred_volume.npy")
    os.makedirs(os.path.dirname(pout))
    translate_volume.main([*_argv(narrow, pout, "narrow_volume"), "--device", "cpu"])
    got_printed = capsys.readouterr().out

    for suffix in (".npy", "_masks.npy"):
        want = np.load(jout.replace(".npy", suffix))
        got = np.load(pout.replace(".npy", suffix))
        assert got.shape == want.shape == (D, S, S) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **TOL)
    for line in ("volume (3, 20, 18), target=given", "saved "):
        assert line in want_printed and line in got_printed
    np.testing.assert_allclose(_mses(got_printed), _mses(want_printed), **TOL)
    assert len(_mses(want_printed)) == 2
