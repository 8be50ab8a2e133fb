"""The port's configuration I/O against the JAX package's: `load_config`
(a builder name, a `.json` or a `.yaml` path), `Config.to_dict` /
`from_dict` / `save_json` / `save_yaml` / `load_yaml`, `MeshConfig`, and
`reference_dict_to_config` with its per-dataset presets.

  * every `configs/*.yaml` through the port's `load_config` equals the JAX
    `scripts/train.py::load_config`, field by field (lists as tuples);
  * the reference flat dicts of `tests/test_config.py` (and variants
    reaching each preset and branch) give equal configs through both
    `reference_dict_to_config`;
  * `to_dict` → `.json` → `load_config` and `save_yaml` → `load_config`
    round-trip every builder exactly;
  * each builder equals its YAML file but for the differences
    `config.py` documents (`DOCUMENTED`);
  * a command line (`scripts.test`) takes a builder name, a `.json` and a
    `.yaml` path to the same configuration and gives the same images.

The same with YAML blocked is in test_torch_imports.py.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu_torch import config as tcfg
from scripts.train import load_config as jax_load_config
from test_config import REFERENCE_STYLE_YAML

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))

# each builder's file, and the fields where the builder departs from it as
# config.py documents: the MNIST files' idx paths name a directory outside
# the repository (the builders keep the file names under config.MNIST_DIR),
# and the gated builder computes in bf16 where the file names no dtype
MNIST_PATHS = {("data", "mnist_path"), ("data", "mnist_labels_path")}
BUILDER_FILES = {
    "flagship": "mnist.yaml", "mri256": "mri_synthetic_256.yaml",
    "mri256_gated": "mri_synthetic_256_gated.yaml", "mri256_bf16": "mri_synthetic_256_bf16.yaml",
    "stem256": "mri_synthetic_256_stem.yaml", "mri64": "mri_synthetic.yaml",
    "mnist_train": "mnist_train.yaml", "mnist_8to5": "mnist_8to5.yaml",
    "mnist_gated": "mnist_gated.yaml", "mnist_usegt": "mnist_usegt.yaml",
    "mvtec_synthetic": "mvtec_synthetic.yaml", "mvtec_denoise": "mvtec_denoise.yaml",
}
DOCUMENTED = {name: MNIST_PATHS for name in BUILDER_FILES if name.startswith(("flagship", "mnist"))}
DOCUMENTED["mri256_gated"] = {("train", "compute_dtype")}


def _fields(cfg) -> dict:
    """{(section, field): value} of a Config of either package."""
    return {(s, k): v for s, sub in dataclasses.asdict(cfg).items() for k, v in sub.items()}


def test_every_file_is_named():
    assert sorted(BUILDER_FILES.values()) == YAMLS
    assert set(BUILDER_FILES) == set(tcfg.CONFIGS)


@pytest.mark.parametrize("name", YAMLS)
def test_load_config_of_each_file_is_jax_s(name):
    path = os.path.join(ROOT, "configs", name)
    got, want = tcfg.load_config(path), jax_load_config(path)
    assert _fields(got) == _fields(want)
    assert isinstance(got.model.dim_mults, tuple) and isinstance(got.mesh, tcfg.MeshConfig)
    assert tcfg.Config.load_yaml(path) == got


def _reference(**over):
    raw = yaml.safe_load(REFERENCE_STYLE_YAML)
    raw.update(over)
    return raw


REFERENCE_DICTS = {
    "mnist": _reference(),
    "ddim": _reference(timestep=250, ddim_timestep=50),
    "ddim_off": _reference(timestep=250, ddim_timestep=False),
    "mri": _reference(data="mri", img_size=224),
    "mvtec": _reference(data="mvtec", img_size=256, ProjectName="mvtec/"),
    "mvtecSR_seg": _reference(data="mvtecSR", ood_detector={"seg": True, "seg_model": "s.pth"}),
    "unknown_dataset_defaults": {"data": "synthetic_brain", "dim": 16},
    "empty": {},
}


@pytest.mark.parametrize("case", sorted(REFERENCE_DICTS))
def test_reference_dict_to_config_is_jax_s(case, tmp_path):
    raw = REFERENCE_DICTS[case]
    got = tcfg.reference_dict_to_config(raw)
    assert _fields(got) == _fields(jcfg.reference_dict_to_config(raw))
    # the flat form through a file: the YAML reader and load_config's branch
    path = tmp_path / "reference.yaml"
    path.write_text(yaml.safe_dump(raw))
    assert tcfg.load_reference_yaml(str(path)) == got
    if raw:  # an empty file is no dict
        assert tcfg.load_config(str(path)) == got
        assert _fields(jax_load_config(str(path))) == _fields(got)


@pytest.mark.parametrize("name", sorted(tcfg.CONFIGS))
def test_builder_round_trips_through_json_and_yaml(name, tmp_path):
    cfg = tcfg.CONFIGS[name]()
    cfg.save_json(str(tmp_path / "c.json"))
    cfg.save_yaml(str(tmp_path / "c.yaml"))
    assert tcfg.load_config(str(tmp_path / "c.json")) == cfg
    assert tcfg.load_config(str(tmp_path / "c.yaml")) == cfg
    assert tcfg.load_config(name) == cfg
    # the dump is JAX's: its load_config reads the same file to the same fields
    assert _fields(jax_load_config(str(tmp_path / "c.json"))) == _fields(cfg)
    assert cfg.to_dict() == dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(BUILDER_FILES))
def test_builder_is_its_file_but_the_documented_fields(name):
    got = _fields(tcfg.CONFIGS[name]())
    want = _fields(tcfg.load_config(os.path.join(ROOT, "configs", BUILDER_FILES[name])))
    differ = {k for k in got if got[k] != want[k]}
    assert differ == DOCUMENTED.get(name, set())


def test_mesh_section_and_refusals(tmp_path):
    cfg = tcfg.Config.from_dict({"model": {"dim": 16}, "mesh": {"data_axis": 2, "patch_axis": 2}})
    assert cfg.mesh == tcfg.MeshConfig(data_axis=2, patch_axis=2)
    assert _fields(cfg) == _fields(jcfg.Config.from_dict(
        {"model": {"dim": 16}, "mesh": {"data_axis": 2, "patch_axis": 2}}))
    assert tcfg.MeshConfig() == tcfg.MeshConfig(data_axis=-1, patch_axis=1)
    for bad in ("no_such_builder", str(tmp_path / "c.toml")):
        with pytest.raises(ValueError, match="builder name"):
            tcfg.load_config(bad)
    with pytest.raises(FileNotFoundError):
        tcfg.load_config(str(tmp_path / "absent.json"))


NPZ = os.path.join(ROOT, "results", "mri_synth256_ema.npz")


def _tiny():
    """`mri256_config()` at 16px, T=3, f32, the manual mask."""
    base = tcfg.mri256_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=16, timesteps=3,
                                      sampling_timesteps=None),
        ood=dataclasses.replace(base.ood, input_size=16, detector="manual", manual_mask_cols=4),
        train=dataclasses.replace(base.train, compute_dtype="float32"))


def test_cli_takes_a_builder_a_json_and_a_yaml_path(tmp_path, monkeypatch):
    from localdiffusion_tpu_torch.scripts import test as test_script

    monkeypatch.setitem(tcfg.CONFIGS, "tiny_io", _tiny)
    _tiny().save_json(str(tmp_path / "tiny.json"))
    _tiny().save_yaml(str(tmp_path / "tiny.yml"))
    preds = []
    for spec in ("tiny_io", str(tmp_path / "tiny.json"), str(tmp_path / "tiny.yml")):
        res = test_script.main(["--config", spec, "--params-npz", NPZ, "--max-images", "2",
                                "--device", "cpu"])
        preds.append(res["pred_all"])
    assert preds[0].shape == (2, 16, 16, 1)
    for p in preds[1:]:
        np.testing.assert_array_equal(p, preds[0])
