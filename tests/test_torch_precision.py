"""The port's float32 paths run in full float32 whatever the process's TF32
setting: one block, `utils.precision.full_float32`, turns off both
`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`
around Stage A's networks (the seg detector, the WRN50-2 and seg-encoder
sources), PatchCore's distance product and the denoiser's every call,
whether `translate`, the server's Stage A or Stage B thread or the bank
builder reaches it; it restores the flags after, also when blocks nest or
overlap across threads.
Narrow networks on the CPU, where
the flags are read but not used: the tests watch them from inside the
forward.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.models.seg_unet import SegDetector, SegUNet
from localdiffusion_tpu_torch.ood import patchcore as TP
from localdiffusion_tpu_torch.ood.bank import build_bank
from localdiffusion_tpu_torch.ood.features import (
    DenoiserFeatureSource,
    SegEncoderFeatureSource,
    WRNFeatureSource,
)
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.precision import full_float32

S = 16


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


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
    """The first block to open turns both flags off, the last to close
    restores them, also when the last is on another thread."""
    _tf32_on(monkeypatch)
    inside, leave = threading.Event(), threading.Event()

    def other():
        with full_float32():
            inside.set()
            leave.wait(10)

    t = threading.Thread(target=other)
    with full_float32():
        t.start()
        assert inside.wait(10)
        with full_float32():
            assert _flags() == (False, False)
    # the other thread's block is still open: TF32 stays off
    assert _flags() == (False, False)
    leave.set()
    t.join(10)
    assert _flags() == (True, True)


def _tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def _denoiser_pipeline(dtype="float32"):
    """A narrow 16px pipeline (dim 8, T=4) whose Stage A is PatchCore over
    its own denoiser's taps, on a bank of two normal images, with hooks
    that record both flags at every UNet call ('forward'), every condition
    encoding ('cond') and every tap pass ('taps', the init conv outside a
    forward) and at every distance product ('nn')."""
    model = tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True),
                             resnet_block_groups=4, attn_heads=2, attn_dim_head=8)
    cfg = tcfg.Config(
        model=model, diffusion=tcfg.DiffusionConfig(image_size=S, timesteps=4),
        sampler=tcfg.SamplerConfig(start_timestep=2),
        ood=tcfg.OODConfig(detector="patchcore", feature_source="denoiser", input_size=S,
                           feature_layers=("down0_block2", "down1_block2"), mask_dilate=0),
        data=tcfg.DataConfig(name="synthetic_brain"),
        train=tcfg.TrainConfig(compute_dtype=dtype))
    gd = build_gd(cfg, device="cpu")
    pc = PatchCore(cfg.ood, source=DenoiserFeatureSource(gd, layers=cfg.ood.feature_layers))
    pc.build_memory_bank([np.random.default_rng(0).uniform(0, 2, (2, S, S, 1))
                          .astype(np.float32)])
    seen = {"forward": [], "cond": [], "taps": [], "nn": []}
    depth = [0]

    def enter(_m, _a):
        depth[0] += 1
        seen["forward"].append(_flags())

    def leave(_m, _a, _o):
        depth[0] -= 1

    gd.model.register_forward_pre_hook(enter)
    gd.model.register_forward_hook(leave)
    def tap(_m, _a):
        if depth[0] == 0:
            seen["taps"].append(_flags())

    gd.model.cond_model.register_forward_pre_hook(lambda m, a: seen["cond"].append(_flags()))
    gd.model.init_conv.register_forward_pre_hook(tap)
    return LocalDiffusionPipeline(cfg, gd, frontend=OODFrontend(cfg, patchcore=pc)), seen


@pytest.fixture
def watch_nn(monkeypatch):
    seen, exact = [], TP.euclidean_dist_sq

    def watched(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return exact(x, y)

    monkeypatch.setattr(TP, "euclidean_dist_sq", watched)
    return seen


def test_translate_runs_the_f32_denoiser_without_tf32(monkeypatch, watch_nn):
    """Both flags on at entry: Stage A's taps and distance products, the
    condition encoding and every UNet call of the chain see both off, and
    both are on again after."""
    _tf32_on(monkeypatch)
    pipe, seen = _denoiser_pipeline()
    lr = np.random.default_rng(1).uniform(0, 2, (2, S, S, 1)).astype(np.float32)
    lr[:, 4:9, 4:9] = 6.0  # an anomaly, so Stage A fires and the chain branches
    out = pipe.translate(lr, noise=1)
    assert out["pred"].shape == (2, S, S, 1) and np.all(np.isfinite(out["pred"]))
    assert len(seen["forward"]) == 4 and seen["cond"] and seen["taps"] and watch_nn
    assert set(seen["forward"] + seen["cond"] + seen["taps"]) == {(False, False)}
    assert set(watch_nn) == {False}
    assert _flags() == (True, True)


def test_server_threads_and_bank_run_without_tf32(monkeypatch, watch_nn, tmp_path):
    """The server's Stage A (collecting thread) and Stage B (sampling
    thread) and the bank builder's taps and ladder fit: every f32 denoiser
    call and distance product without TF32, the flags restored after."""
    _tf32_on(monkeypatch)
    pipe, seen = _denoiser_pipeline()
    lrs = np.random.default_rng(2).uniform(0, 2, (3, S, S, 1)).astype(np.float32)
    srv = InferenceServer(pipe, batch_size=2, max_wait_ms=100)
    futs = [srv.submit(x) for x in lrs]
    with srv:
        outs = [f.result(timeout=120) for f in futs]
    assert all(np.all(np.isfinite(o["pred"])) for o in outs)
    assert seen["forward"] and seen["taps"] and watch_nn
    assert set(seen["forward"] + seen["cond"] + seen["taps"]) == {(False, False)}
    cfg = pipe.config.replace(ood=dataclasses.replace(pipe.config.ood, memory_bank_path=None))
    n_taps = len(seen["taps"])
    build_bank(cfg, str(tmp_path / "bank.npy"), gd=pipe.gd, n_images=2, device="cpu")
    assert len(seen["taps"]) > n_taps and set(seen["taps"]) == {(False, False)}
    assert set(watch_nn) == {False}
    assert _flags() == (True, True)


def test_bf16_denoiser_runs_its_float32_conv_without_tf32(monkeypatch):
    """A bf16 UNet's final 1×1 conv computes in float32 (as in the JAX
    package), so its calls hold TF32 off too."""
    _tf32_on(monkeypatch)
    pipe, seen = _denoiser_pipeline("bfloat16")
    final = []
    pipe.gd.model.final_conv.register_forward_pre_hook(
        lambda m, a: final.append((a[0].dtype, _flags())))
    pipe.translate(np.ones((1, S, S, 1), np.float32), noise=0,
                   mask=np.ones((1, S, S, 1), np.float32))
    assert set(final) == {(torch.float32, (False, False))} and len(final) == 4
    assert _flags() == (True, True)


def test_policy_nests_with_float32_convs_across_threads(monkeypatch):
    """A denoiser block and a Stage A network overlapping on two threads:
    the seg detector's forward, held open on the other thread, sees both
    flags off and keeps them off after the denoiser's block closed; its
    end restores PyTorch's defaults."""
    _tf32_on(monkeypatch)
    inside, leave, seen = threading.Event(), threading.Event(), []
    model = SegUNet(base=4).eval()

    def hold(_m, _a):
        seen.append(_flags())
        inside.set()
        leave.wait(10)

    model.inc.register_forward_pre_hook(hold)
    x = np.zeros((1, S, S, 1), np.float32)
    t = threading.Thread(target=lambda: seen.append(SegDetector(model)(x).shape))
    with full_float32():
        t.start()
        assert inside.wait(10)
        assert _flags() == (False, False)
    assert _flags() == (False, False)
    leave.set()
    t.join(10)
    assert seen == [(False, False), (1, S, S, 1)]
    assert _flags() == (True, True)
