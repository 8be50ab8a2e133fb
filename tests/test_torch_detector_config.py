"""The port's configuration for Stage A's detectors, against the JAX
package.

  * `mri256_bf16_config()` is `configs/mri_synthetic_256_bf16.yaml` and
    `mri64_config()` is `configs/mri_synthetic.yaml`, field by field;
  * `OODConfig.resolved_mask_dilate(image_size, strides)` equals the JAX
    package's over detector × feature source × `mask_dilate` ∈ {-1, 0, 16}
    × two (image size, detector input size) pairs, from the tap names and
    from a source's own `strides`: exact integers.
"""

import dataclasses
import os

import pytest
import yaml

import localdiffusion_tpu.config as jcfg
from localdiffusion_tpu_torch import config as tcfg
from test_torch_support import to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ["model", "diffusion", "sampler", "ood", "data", "train"]


@pytest.mark.parametrize("make_config,name",
                         [(tcfg.mri256_bf16_config, "mri_synthetic_256_bf16"),
                          (tcfg.mri64_config, "mri_synthetic")])
def test_config_is_the_yaml(make_config, name):
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    got = make_config()
    want = jcfg.Config.load_yaml(path)
    with open(path) as f:
        parsed = tcfg.Config.from_dict(yaml.safe_load(f))
    for section in SECTIONS:
        for f in dataclasses.fields(getattr(got, section)):
            mine = getattr(getattr(got, section), f.name)
            assert mine == getattr(getattr(want, section), f.name), (section, f.name)
            assert mine == getattr(getattr(parsed, section), f.name), (section, f.name)
    assert tcfg.min_max_val_for(got) == jcfg.min_max_val_for(want)


# each source's own strides: the WRN's, the seg encoder's, and the
# denoiser's under a space-to-depth ×2 stem (which the names cannot see)
SOURCE_STRIDES = {
    "wrn": {"layer1": 4, "layer2": 8, "layer3": 16, "layer4": 32},
    "seg_encoder": {"inc": 1, "down1": 2, "down2": 4, "down3": 8, "down4": 16},
    "denoiser": {f"down{i}_block{b}": 2 ** i * 2 for i in range(4) for b in (1, 2)},
}


@pytest.mark.parametrize("sizes", [(256, 224), (64, 64)])
@pytest.mark.parametrize("mask_dilate", [-1, 0, 16])
@pytest.mark.parametrize("source", ["wrn", "seg_encoder", "denoiser"])
@pytest.mark.parametrize("detector", ["patchcore", "seg", "manual", "none"])
def test_resolved_mask_dilate_matches_jax(detector, source, mask_dilate, sizes):
    image_size, input_size = sizes
    t = tcfg.OODConfig(detector=detector, feature_source=source, mask_dilate=mask_dilate,
                       input_size=input_size, layers=("layer2", "layer3"))
    j = to_jax(t)
    for strides in (None, SOURCE_STRIDES[source]):
        got = t.resolved_mask_dilate(image_size, strides=strides)
        assert got == j.resolved_mask_dilate(image_size, strides=strides)
        assert isinstance(got, int)
    # a chosen deepest tap
    layers = {"wrn": ("layer1",), "seg_encoder": ("down4",), "denoiser": ("down1_block2",)}
    t2 = dataclasses.replace(t, feature_layers=layers[source])
    assert (t2.resolved_mask_dilate(image_size, SOURCE_STRIDES[source])
            == to_jax(t2).resolved_mask_dilate(image_size, SOURCE_STRIDES[source]))
