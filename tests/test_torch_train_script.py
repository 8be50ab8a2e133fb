"""The port's training CLI (`scripts.train`) on the CPU.

A narrow configuration (dim 8, mults 1/2, 16px, T=10, float32) is registered in
`config.CONFIGS` for each test, as `test_torch_eval_scripts.py` does.  Two
steps in each step mode write the loss CSV, the best and latest
checkpoints, `best_eval.json` and the EMA npz, which `factory.load_params`
reads back as the EMA rounded to fp16; `--resume auto` continues a run so
that 2 + 2 steps equal 4 straight steps; `--init-npz` warm-starts the
parameters and the EMA; the dataset is the JAX script's.
"""

import csv
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.data.datasets import train_arrays
from localdiffusion_tpu_torch.factory import load_params
from localdiffusion_tpu_torch.scripts import train
from test_torch_support import small_model_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts.train import build_dataset as jax_build_dataset  # noqa: E402


def _tiny() -> tcfg.Config:
    base = tcfg.mri256_config()
    return base.replace(
        model=small_model_cfg(),
        diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=10,
                                      sampling_timesteps=None),
        train=dataclasses.replace(base.train, compute_dtype="float32", batch_size=64,
                                  project_name="tiny"))


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setitem(tcfg.CONFIGS, "tiny", _tiny)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, *extra, steps=2, mode="batch"):
    return train.main(["--config", "tiny", "--steps", str(steps), "--step-mode", mode,
                       "--results", str(tmp_path), "--eval-every", "1", "--device", "cpu",
                       *extra])


@pytest.mark.parametrize("mode", ["resident", "epoch", "batch"])
def test_each_step_mode_trains_and_writes_its_files(tmp_path, mode):
    npz = str(tmp_path / "ema.npz")
    out = _run(tmp_path, "--export-npz", npz, mode=mode)
    assert out["step"] == 2 and len(out["losses"]) == 2 and len(out["evals"]) == 2
    assert all(np.isfinite(out["losses"])) and all(np.isfinite(out["evals"]))
    run = tmp_path / "tiny"
    with open(run / "train_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [0, 1]
    with open(run / "best_eval.json") as f:
        best = json.load(f)
    assert best["best"] == min(out["evals"]) and (run / f"model-{best['milestone']}.pt").exists()
    assert (run / "model-latest.pt").exists()
    cfg = _tiny()
    gd = load_params(cfg, params_npz=npz, device="cpu", verbose=False)
    state = torch.load(run / "model-latest.pt", weights_only=True)
    assert state["step"] == 2
    for k, v in gd.model.state_dict().items():
        assert torch.equal(v, state["ema"][k].half().float()), k


def test_resume_auto_equals_a_straight_run(tmp_path):
    straight = _run(tmp_path / "a", steps=4)
    first = _run(tmp_path / "b", steps=2)
    resumed = _run(tmp_path / "b", steps=4)
    assert first["start_step"] == 0 and resumed["start_step"] == 2 and resumed["step"] == 4
    assert first["losses"] + resumed["losses"] == straight["losses"]
    a = torch.load(tmp_path / "a" / "tiny" / "model-latest.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "tiny" / "model-latest.pt", weights_only=True)
    for key in ("params", "ema"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    with open(tmp_path / "b" / "tiny" / "train_loss.csv") as f:
        assert [int(r["step"]) for r in csv.DictReader(f)] == [0, 1, 2, 3]  # appended
    never = _run(tmp_path / "b", "--resume", "never", steps=1)
    assert never["start_step"] == 0


def test_init_npz_warm_starts_params_and_ema(tmp_path):
    src = str(tmp_path / "src.npz")
    _run(tmp_path / "a", "--export-npz", src, steps=1)
    out = str(tmp_path / "out.npz")
    got = _run(tmp_path / "b", "--init-npz", src, "--export-npz", out, steps=0)
    assert got["step"] == 0
    with np.load(src) as a, np.load(out) as b:
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    state = torch.load(tmp_path / "b" / "tiny" / "model-latest.pt", weights_only=True)
    for k in state["params"]:  # params and EMA both from the npz; no step taken
        assert torch.equal(state["params"][k], state["ema"][k])


def test_dataset_is_the_jax_scripts():
    """`data.datasets.train_arrays`, which the script reads, against the JAX
    script's `build_dataset` on the brains and on MNIST (its idx files
    absent: the synthetic digits); `test_torch_data.py` holds every other
    dataset name."""
    cfg = _tiny()
    missing = dataclasses.replace(cfg.data, name="mnist", mnist_path="./absent/train-images",
                                  mnist_labels_path="./absent/train-labels")
    for c in (cfg, cfg.replace(data=missing)):
        for got, want in zip(train_arrays(c), jax_build_dataset(c)):
            for g, w in zip(got, want):
                assert np.array_equal(g, np.asarray(w))


def test_step_seed_depends_on_seed_and_step_only():
    assert train.step_seed(42, 3) == train.step_seed(42, 3)
    assert len({train.step_seed(42, s) for s in range(100)} | {train.step_seed(7, 3)}) == 101
