"""The port's configuration against the JAX package's."""

import dataclasses
import os

import pytest
import yaml

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ["model", "diffusion", "sampler", "ood", "data", "train"]
# dataset file locations of configs/mnist.yaml; the serving path reads none
NOT_COPIED = {("data", "mnist_path"), ("data", "mnist_labels_path")}


@pytest.mark.parametrize("section", SECTIONS)
def test_port_dataclasses_have_the_jax_fields_and_defaults(section):
    j = getattr(jcfg.Config(), section)
    t = getattr(tcfg.Config(), section)
    names = [f.name for f in dataclasses.fields(t)]
    assert names == [f.name for f in dataclasses.fields(j)]
    for n in names:
        assert getattr(t, n) == getattr(j, n), n


def test_flagship_config_is_configs_mnist_yaml():
    want = jcfg.Config.load_yaml(os.path.join(ROOT, "configs/mnist.yaml"))
    got = tcfg.flagship_config()
    for section in SECTIONS:
        for f in dataclasses.fields(getattr(got, section)):
            if (section, f.name) in NOT_COPIED:
                continue
            assert getattr(getattr(got, section), f.name) == \
                getattr(getattr(want, section), f.name), (section, f.name)


# each builder and its file; the MNIST files' idx paths name a directory
# outside the repository, so the builders keep the file names in
# DataConfig's default directory (`config.MNIST_DIR`)
BUILDERS = {"mnist_train": "mnist_train.yaml", "mnist_8to5": "mnist_8to5.yaml",
            "mnist_gated": "mnist_gated.yaml", "mnist_usegt": "mnist_usegt.yaml",
            "mvtec_synthetic": "mvtec_synthetic.yaml", "mvtec_denoise": "mvtec_denoise.yaml"}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_is_its_yaml(name):
    want = jcfg.Config.load_yaml(os.path.join(ROOT, "configs", BUILDERS[name]))
    got = tcfg.load_config(name)
    assert got == getattr(tcfg, f"{name}_config")()
    for section in SECTIONS:
        for f in dataclasses.fields(getattr(got, section)):
            g, w = getattr(getattr(got, section), f.name), getattr(getattr(want, section), f.name)
            if (section, f.name) in NOT_COPIED:
                assert os.path.basename(g) == os.path.basename(w), (section, f.name)
                assert os.path.dirname(g) == tcfg.MNIST_DIR or w == g, (section, f.name)
                continue
            assert g == w, (section, f.name)


def test_from_dict_reads_the_yaml_contents():
    with open(os.path.join(ROOT, "configs/mnist.yaml")) as f:
        raw = yaml.safe_load(f)
    got = tcfg.Config.from_dict(raw)
    want = jcfg.Config.from_dict(raw)
    for section in SECTIONS:
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(want, section))


@pytest.mark.parametrize("name,translate_zero", [
    ("mnist", True), ("mri", True), ("mri", False), ("synthetic_brain", True),
    ("mvtec", True),
])
def test_min_max_val_matches_jax(name, translate_zero):
    data = dict(name=name, translate_zero=translate_zero)
    j = jcfg.Config(data=jcfg.DataConfig(**data))
    t = tcfg.Config(data=tcfg.DataConfig(**data))
    assert tcfg.min_max_val_for(t) == jcfg.min_max_val_for(j)


def test_validation_matches_jax():
    for bad in (dict(objective="eps"), dict(beta_schedule="quad"),
                dict(timesteps=10, sampling_timesteps=20)):
        with pytest.raises(ValueError):
            jcfg.DiffusionConfig(**bad)
        with pytest.raises(ValueError):
            tcfg.DiffusionConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.ModelConfig(dim_mults=(1, 2), full_attn=(False,))
    with pytest.raises(ValueError):
        tcfg.SamplerConfig(mask_x_policy="zero")
    with pytest.raises(ValueError):
        tcfg.OODConfig(detector="magic")
