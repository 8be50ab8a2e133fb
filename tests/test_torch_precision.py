"""Stage A's convolutions run in full float32 whatever the process's TF32
setting: the seg detector, the WRN50-2 source and the seg-encoder source
turn `torch.backends.cudnn.allow_tf32` off while their networks run and
restore it after (`utils.precision.float32_convs`), also when blocks nest
or overlap across threads.  Narrow networks on the CPU, where the flag is
read but not used: the tests watch the flag from inside the forward.
"""

import threading

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch.models.seg_unet import SegDetector, SegUNet
from localdiffusion_tpu_torch.ood.features import SegEncoderFeatureSource, WRNFeatureSource
from localdiffusion_tpu_torch.utils.precision import float32_convs


def _seen_in_forward(module: torch.nn.Module) -> list:
    seen = []
    module.register_forward_pre_hook(lambda m, a: seen.append(torch.backends.cudnn.allow_tf32))
    return seen


@pytest.mark.parametrize("network", ["seg_detector", "seg_encoder", "wrn"])
@pytest.mark.parametrize("tf32", [True, False])
def test_stage_a_networks_run_without_tf32(network, tf32, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 1)).astype(np.float32)
    if network == "wrn":
        src = WRNFeatureSource(("layer1",), device="cpu")
        seen = _seen_in_forward(src.backbone.conv1)
        out = src.apply(torch.as_tensor(np.repeat(x, 3, axis=-1)))["layer1"]
    else:
        model = SegUNet(base=4).eval()
        seen = _seen_in_forward(model.inc)
        if network == "seg_detector":
            out = SegDetector(model)(x)
        else:
            out = SegEncoderFeatureSource(model, ("inc",)).apply(torch.as_tensor(x))["inc"]
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.isfinite(out).all()


def test_float32_convs_nests_and_overlaps_across_threads(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    inside, leave = threading.Event(), threading.Event()

    def other():
        with float32_convs():
            inside.set()
            leave.wait(10)

    t = threading.Thread(target=other)
    with float32_convs():
        t.start()
        assert inside.wait(10)
        with float32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
    # the other thread's block is still open: TF32 stays off
    assert torch.backends.cudnn.allow_tf32 is False
    leave.set()
    t.join(10)
    assert torch.backends.cudnn.allow_tf32 is True
