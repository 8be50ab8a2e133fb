"""The port's measuring scripts on the CPU: `scripts.profile_attr` on a trace
of a tiny UNet call that `utils.logging.profile_trace` recorded (every
event in one stage, the stages' shares summing to the total; the UNet's
scopes entered only inside a session) and on a hand-made trace of kernels
tied to their launches; each script's argument parsing and the keys of the
JSON it writes (`record`, fed stand-in numbers: a time comes only from the
card); and each measuring script refusing to run without a card.
"""

import json
import os

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch import config as C
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.scripts import (
    bench_convgeo,
    bench_gated,
    bench_linatt_attrib,
    bench_quant,
    bench_roofline,
    bench_sparse,
    profile_attr,
)
from localdiffusion_tpu_torch.utils import logging as L

CARD = {"device": "stand-in", "nvidia_smi": "stand-in, 700.00 W"}


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    m = C.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1)
    d = C.DiffusionConfig(image_size=8, timesteps=10, objective="pred_x0")
    torch.manual_seed(0)
    gd = GaussianDiffusion(m, d, device="cpu")
    x, cond = torch.randn(2, 8, 8, 1), torch.rand(2, 8, 8, 1)
    t = torch.zeros(2, dtype=torch.long)
    gd.apply_model(x, cond, t)
    out = str(tmp_path_factory.mktemp("trace"))
    assert not L.profiling()
    with L.profile_trace(out):
        assert L.profiling()
        gd.apply_model(x, cond, t)
    assert not L.profiling()
    return out


def test_profile_attr_stages_sum_to_the_total(cpu_trace):
    path = profile_attr.find_trace_file(cpu_trace)
    assert os.path.basename(path) == "trace.json"
    res = profile_attr.attribute(profile_attr.load_events(path))
    assert res["device"] == "cpu" and res["events"] > 0
    total = res["total_us"]
    assert sum(res["by_stage"].values()) == pytest.approx(total, rel=1e-12)
    assert sum(res["by_category"].values()) == pytest.approx(total, rel=1e-12)
    stages = set(res["by_stage"])
    for name in ("init_conv", "time_mlp", "down0_block1", "down1_attn", "mid_attn",
                 "cond_model", "conv_fusion", "up0_block2", "final_res_block", "final_conv"):
        assert name in stages, (name, sorted(stages))
    one = profile_attr.attribute(profile_attr.load_events(path), stage="mid_attn")
    assert one["total_us"] == pytest.approx(res["by_stage"]["mid_attn"])
    text = profile_attr.report(res, top=5)
    assert "== by stage ==" in text and "mid_attn" in profile_attr.report(res, top=40)


def test_unprofiled_calls_enter_no_scope(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or torch.autograd.profiler
                        .record_function(name))
    m = C.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1)
    gd = GaussianDiffusion(m, C.DiffusionConfig(image_size=8, timesteps=10), device="cpu")
    gd.apply_model(torch.randn(1, 8, 8, 1), torch.rand(1, 8, 8, 1), torch.zeros(1).long())
    assert entered == []


def test_profile_attr_ties_kernels_to_their_launches():
    """A hand-made card trace: a kernel goes to the stage whose scope held
    its launch (by correlation id), on the launching thread, even when it
    runs after the scope ended; a kernel launched outside every scope is
    unattributed."""
    ann = lambda name, ts, dur: dict(ph="X", cat="user_annotation", name=name, pid=1, tid=7,
                                     ts=ts, dur=dur)
    launch = lambda corr, ts: dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", pid=1,
                                   tid=7, ts=ts, dur=1, args={"correlation": corr})
    kernel = lambda name, corr, ts, dur: dict(ph="X", cat="kernel", name=name, pid=0, tid=3,
                                              ts=ts, dur=dur, args={"correlation": corr})
    events = [ann("down0_block1", 0, 100), ann("mid_attn", 200, 50),
              launch(1, 10), launch(2, 210), launch(3, 300),
              kernel("conv3x3_stats<32>", 1, 400, 30), kernel("flash_attention", 2, 450, 20),
              kernel("vectorized_elementwise_kernel", 3, 500, 5)]
    res = profile_attr.attribute(events)
    assert res["device"] == "cuda" and res["total_us"] == 55
    assert res["by_stage"] == {"down0_block1": 30, "mid_attn": 20,
                               profile_attr.UNATTRIBUTED: 5}
    assert res["by_category"]["resnet_block"] == 30
    assert res["by_category"]["flash_attention"] == 20


def test_profile_attr_arguments(tmp_path):
    args = profile_attr.parse_args([str(tmp_path), "--top", "5", "--stage", "mid_attn"])
    assert (args.trace, args.top, args.stage, args.run) == (str(tmp_path), 5, "mid_attn", None)
    args = profile_attr.parse_args(["--run", "mri256_bf16", "--batch", "2", "--calls", "3"])
    assert (args.run, args.batch, args.calls, args.device) == ("mri256_bf16", 2, 3, "cuda")
    with pytest.raises(SystemExit):
        profile_attr.parse_args([])
    with pytest.raises(SystemExit):
        profile_attr.parse_args([str(tmp_path), "--run", "mri256_bf16"])


def test_profile_attr_cli_writes_its_json(cpu_trace, tmp_path):
    out = tmp_path / "attr.json"
    res = profile_attr.main([cpu_trace, "--json", str(out), "--top", "3"])
    saved = json.loads(out.read_text())
    assert saved["total_us"] == pytest.approx(res["total_us"])
    assert set(saved) >= {"trace", "device", "events", "total_us", "by_stage", "by_category",
                          "by_stage_category", "by_op"}


def test_bench_gated_arguments_and_record():
    args = bench_gated.parse_args(["--sizes", "28,256", "--real-gate", "--repeats", "2"])
    assert args.sizes == [28, 256] and args.real_gate and args.repeats == 2
    assert bench_gated.model_for(28)[1] == 64 and bench_gated.model_for(256)[1] == 4
    cut = bench_gated.reject_cut(50, 5, 0.2)
    gates = bench_gated.scripted_gates(cut)
    xs = torch.zeros(3, 4, 4, 1)
    assert gates["accept_all"](xs, 49).tolist() == [1.0] * 3
    assert gates["reject_window"](xs, 49).tolist() == [-1.0] * 3
    assert gates["reject_window"](xs, 10).tolist() == [1.0] * 3
    rows = [bench_gated.row(28, "ungated", 64, 2.0, 2.0, None),
            bench_gated.row(28, "gated_20pct", 64, 3.0, 2.0, [5, 9])]
    assert rows[1]["vs_ungated"] == 1.5 and rows[1]["fusion_time_minmax"] == [5, 9]
    rec = bench_gated.record(args, rows, CARD)
    assert set(rec) >= {"script", "card", "timesteps", "start_timestep", "reject_frac",
                        "retries", "rows", "timing"}
    cond, mask = bench_gated.inputs(2, 8, "cpu")
    assert mask[:, :, :2].eq(1).all() and mask[:, :, 2:].eq(0).all()


def test_bench_sparse_arguments_and_record():
    args = bench_sparse.parse_args(["--batch", "2", "--size", "64", "--patch", "32"])
    assert (args.batch, args.size, args.patch, args.timesteps) == (2, 64, 32, 50)
    out = np.zeros((2, 64, 64, 1))
    rec = bench_sparse.record(args, 3.0, 2.0, out, out + 0.5, CARD)
    assert rec["value"] == 1.5 and rec["meets_jax_bar"] and rec["patches"] == 8
    assert rec["out_mean_abs_diff"] == 0.5
    assert set(rec) >= {"metric", "unbucketed_s", "bucketed_s", "ood_patches", "jax_bar"}


def test_roofline_convgeo_quant_arguments_and_records():
    args = bench_roofline.parse_args(["--batch", "1", "--hw", "16"])
    cases = bench_roofline.cases(1, 16, 32, device="cpu")
    assert [c[0] for c in cases][:2] == ["copy (r+w)", "elementwise_scale (r+w)"]
    assert all(c[2] > 0 for c in cases)
    rec = bench_roofline.record(args, [{"op": "copy (r+w)", "ms": 1.0}], CARD)
    assert rec["shape"] == [1, 16, 16, 32] and rec["rows"][0]["op"] == "copy (r+w)"

    args = bench_convgeo.parse_args([])
    assert set(bench_convgeo.CASES) == {"c32_256", "c64_128", "c128_128", "c256_64",
                                        "c512_64", "flag28"}
    assert [bench_convgeo.kernel_admits(c) for c in (32, 64, 128, 256, 512)] == [
        True, True, True, False, False]
    rec = bench_convgeo.record(args, {"c64_128": {"cudnn_tflops": 100.0},
                                      "c256_64": {"cudnn_tflops": 200.0}}, CARD)
    assert rec["s2d_stage1_conv_cost_ratio"] == pytest.approx(2.0)

    args = bench_quant.parse_args(["--iters", "3"])
    rec = bench_quant.record(args, {"matmul_int8_speedup": 2.0}, CARD)
    assert rec["metric"] == "quantization_microbench" and rec["peaks"]["int8_tops"] == 1979.0
    x = torch.randn(1, 5, 6, 3)
    w = torch.randn(4, 3, 3, 3)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    got = bench_quant.im2col3x3(x) @ w.permute(2, 3, 1, 0).reshape(27, 4)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1).reshape(-1, 4))


@pytest.mark.parametrize("mod", [bench_linatt_attrib, bench_gated, bench_sparse,
                                 bench_roofline, bench_convgeo, bench_quant])
def test_measuring_scripts_need_the_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
