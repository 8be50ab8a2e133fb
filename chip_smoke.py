#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line with the elapsed seconds:

1. device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off for convolutions and matrix products (exact float32 checks);
2. build: builds every CUDA source in `localdiffusion_tpu_torch/csrc` with
   nvcc, one process per source, all at once, and prints the times;
3. flagship kernel: the GroupNorm+FiLM+SiLU kernel against its plain version
   at each shape the 28px flagship UNet gives it (batch 64, branched pair
   of 128), float32 and bfloat16, with CUDA-event times (replayed from a
   CUDA graph, so host overhead is left out) of the kernel, the plain
   version, `F.group_norm` alone and the memory bound;
4. flagship main path: with every launch count at 0, `translate` on the
   flagship (seeded random weights, T=50, f32) at batch 64 with the manual
   mask, then an `InferenceServer` answering three requests; the counts
   are read right after;
5. flagship check: the same chain with every kernel's plain version on the
   card, and a small batch on the CPU, against the kernel chain;
6. flagship profile: one chain under torch.profiler;
7. 256px kernels: each kernel of the 256px MRI chain against its plain
   version at the shapes that chain gives it (one UNet call at batch 8 is
   recorded by hooks): full attention [8,1024,4,32] in bf16 and f32 (and
   `scaled_dot_product_attention` timed beside it), the linear-attention
   kv and q kernels at the six linear-attention sites (and their times at
   batch 4 and 8 beside those of the block size the port took from the
   batch before), the fused ResnetBlock's conv3x3_stats (pass 1, pass 2)
   and epilogue at the six shapes of its 13 blocks (up3's two blocks and
   the final block share one), each pass held against its plain
   version and three emulated faults held above the bars, the whole fused
   block against its plain version and beside the unfused block (cuDNN
   convolutions, the GroupNorm kernel, the adds), the GroupNorm kernel at
   the 14 Block shapes outside the fused gate, all in bf16; a row alone
   against the same row in the batch, bit for bit, for linear attention and
   the fused block; errors against tolerances, times and bounds, summed per
   UNet call;
8. 256px main path: with every count at 0, `translate` on the 256px chain
   (full width, seeded random weights, T=250, bf16, branched, the JAX
   package's default fused-ResnetBlock layout) at batch 4 with a given
   disc mask, then an `InferenceServer` answering three 256px requests;
   checks each kernel's launches per UNet call;
9. 256px check: the chain against the same chain with every kernel's plain
   version on the card (same noise), and one UNet call against the CPU;
10. 256px profile: one chain under torch.profiler.

The line before the last is one JSON object with the kernels' numbers; the
last line is the device record.  Any failed check raises, so the exit code
is not 0.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.config import flagship_config, mri256_config
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, build_gd
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.models.blocks import (
    Attention,
    GroupNormFilmSiLU,
    LinearAttention,
    ResnetBlock,
)
from localdiffusion_tpu_torch.ood.manual import manual_mask
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer

KERNELS = ("groupnorm_film_silu", "flash_attention", "linear_attention", "resnet_block")
COUNTERS = {
    "groupnorm_film_silu": groupnorm_film_silu,
    "flash_attention": flash_attention,
    "linear_attention_kv": LA.linear_attention_kv,
    "linear_attention_q": LA.linear_attention_q,
    "conv3x3_stats": RB.conv3x3_stats,
    "epilogue": RB.epilogue,
}

BATCH = 64  # flagship chain
SERVE_BATCH = 8
MRI_BATCH = 4  # 256px chain: an [8] UNet batch in the branched phase
MRI_SERVE_BATCH = 4
FLAGSHIP_PER_CALL = {"groupnorm_film_silu": 32}  # 2 Blocks x 16 ResnetBlocks
# per 256px UNet call: 3 full-attention sites, 6 linear-attention sites, 13
# fused ResnetBlocks (2 conv3x3_stats and an epilogue each) and 2 Blocks x 7
# unfused ResnetBlocks at 32x32
MRI_PER_CALL = {"groupnorm_film_silu": 14, "flash_attention": 3,
                "linear_attention_kv": 6, "linear_attention_q": 6,
                "conv3x3_stats": 26, "epilogue": 13}
MRI_FUSED_BLOCKS, MRI_UNFUSED_BLOCKS = 13, 7
# H100 SXM data-sheet peaks: device memory, float32 outside the tensor cores,
# bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
GN_OPS_PER_ELEMENT = 14  # stats 4, normalize+affine 3, FiLM 2, SiLU 5
# GN kernel vs plain version: float32 differs only by summation order;
# bfloat16 may differ by one rounding step of the output (2^-8 relative)
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# attention kernel vs plain version: float32, summation order.  bfloat16: both
# round the probabilities to bf16 before P·V, but the kernel rounds the
# unnormalised exp(s − m) against a running max and divides by l after the
# product, where the plain version rounds the normalised softmax; with the
# output's own bf16 rounding step that reads 3.9e-3 when the kernel is sound
# (NVIDIA H100 80GB HBM3, 700 W), and the limit is 1e-2
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# linear attention, the JAX tests' bar between the Pallas kernels and their
# reference (bf16 rounding points differ between the streaming and unfused
# forms): atol 0.04 / rtol 0.05 and correlation > 0.999
LINATT_TOL = dict(atol=0.04, rtol=0.05)
# the kv partials, per block, each against its own size (see `kv_errors`):
# m one bf16 step, l 1e-3 and G 5e-3 relative norm, where a sound kernel
# reads l ≤ 1e-4 and G ≤ 1.3e-3 at these sites and at the card-only tests'
# inputs (NVIDIA H100 80GB HBM3, 700 W), and a missed running-max rescale
# of l or G on one sub-tile reads above 1e-2
KV_TOL = dict(m=2**-7, l=1e-3, g=5e-3)
# the fused ResnetBlock's passes against their plain versions on the same
# inputs.  h1, h2: one bf16 step (`bf16_steps`: float32 sums in another
# order round a value one step apart).  The sums (`stats_errors`), relative
# norm per row: against the per-tile sums of the kernel's own h, and
# against the plain version's with the part the one-step h differences
# explain taken out; a sound kernel reads <= 6.1e-8 at these sites (NVIDIA
# H100 80GB HBM3, 700 W), a dropped tile 4.6e-2, and activated padding or
# a missing halo row read ~500 steps of h.  Epilogue: one bf16 step of its
# terms, atol 2^-6 / rtol 2^-7 (sound: 2^-7).  The whole fused block
# against its plain version: the JAX bar, atol 0.05 / rtol 0.06 and
# correlation > 0.999, and relative L2 <= 2e-3 (sound: <= 5.9e-4).
RB_TOL = dict(h_steps=1.0, stats=1e-5, epi_atol=2**-6, epi_rtol=2**-7, block_atol=0.05,
              block_rtol=0.06, block_corr=0.999, block_rel=2e-3)
# flagship final images, kernel vs plain (same card, same noise) and card vs
# CPU: float32 differences of ~1e-6 per call through 50 posterior steps
CHAIN_TOL = 1e-3
# 256px, bf16.  One UNet call, card (kernels) vs CPU (plain versions), same
# weights and inputs: relative L2 <= 5e-2 and correlation >= 0.999, the bar
# the CPU tests hold the port's bf16 UNet to against JAX (independent bf16
# rounding through ~60 layers gives 2e-2); float32: 1e-3.  The 250-step
# chain, kernels vs plain versions: each call carries such bf16 differences
# and the posterior steps add them up, so relative L2 <= 0.1 and correlation
# >= 0.99 on images in [0, 14.6].
MRI_UNET_REL, MRI_UNET_CORR, MRI_UNET_F32_TOL = 5e-2, 0.999, 1e-3
MRI_CHAIN_REL, MRI_CHAIN_CORR = 0.1, 0.99

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def cuda_ms(fn, iters: int = 20, reps: int = 10) -> tuple:
    """(eager, device) mean milliseconds of fn() on the card, by CUDA events.

    eager: back-to-back calls from Python, host overhead included.  device:
    the same calls captured once in a CUDA graph and replayed, so the card
    never waits for the host.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters * reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / (iters * reps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return eager, start.elapsed_time(end) / (iters * reps)


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> tuple:
    """(bound ms, 'bytes' or 'operations')."""
    b_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    o_ms = 1e3 * ops / ops_per_s
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build() -> None:
    """One nvcc per source, all started together."""
    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        times = dict(zip(KERNELS, pool.map(one, KERNELS)))
    for name in KERNELS:
        _build.load(name)
    total = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu {t:.2f}s' for n, t in times.items())} "
        f"(in parallel, {total:.2f}s wall)")


def record_calls(gd, batch: int, cond_max: float) -> dict:
    """The inputs each kernel-bearing module sees in one UNet call at
    `batch` rows (condition drawn in [0, cond_max]), recorded by forward
    pre-hooks: GroupNorm (NHWC shape, FiLM?), linear attention (module, NHWC
    shape, channels_last?), full attention (module, NCHW shape), ResnetBlock
    (module, NHWC shape, channels_last?, fused?)."""
    seen = {"gn": [], "linatt": [], "attn": [], "rb": []}

    def gn_hook(_mod, args):
        seen["gn"].append((tuple(args[0].permute(0, 2, 3, 1).shape),
                           len(args) > 1 and args[1] is not None))

    def la_hook(mod, args):
        x = args[0]
        seen["linatt"].append((mod, tuple(x.permute(0, 2, 3, 1).shape),
                               x.is_contiguous(memory_format=torch.channels_last)))

    def at_hook(mod, args):
        seen["attn"].append((mod, tuple(args[0].shape)))

    def rb_hook(mod, args):
        x = args[0]
        shape = tuple(x.permute(0, 2, 3, 1).shape)
        fused = RB.fuses(shape, mod.block1.proj.out_channels, mod.block1.norm.groups,
                         mod.block1.proj.compute_dtype)
        seen["rb"].append((mod, shape, x.is_contiguous(memory_format=torch.channels_last),
                           fused))

    hooks = {GroupNormFilmSiLU: gn_hook, LinearAttention: la_hook, Attention: at_hook,
             ResnetBlock: rb_hook}
    handles = [m.register_forward_pre_hook(hooks[type(m)])
               for m in gd.model.modules() if type(m) in hooks]
    try:
        s = gd.image_size
        x = torch.randn(batch, s, s, 1, device="cuda")
        feat = gd.encode_cond(torch.rand(batch, s, s, 1, device="cuda") * cond_max)
        gd.apply_model(x, None, torch.full((batch,), 10, device="cuda"), cond_feat=feat)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return seen


def _gn_inputs(shape, film, dtype, gen):
    b, _, _, c = shape
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = (r(*shape) * 1.5 + 0.3).to(dtype)
    scale, shift = (r(b, c), r(b, c)) if film else (None, None)
    return x, r(c), r(c), scale, shift


def gn_kernel_phase(launches, dtypes, time_dtype, label, iters=(20, 10)) -> dict:
    """The GN kernel against its plain version at each (shape, FiLM) of one
    UNet call; times summed over that call's launches, in `time_dtype`."""
    counts = {}
    for key in launches:
        counts[key] = counts.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {dt: 0.0 for dt in dtypes}
    totals = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, group_norm_ms=0.0,
                  bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for (shape, film), n in sorted(counts.items()):
        for dtype in dtypes:
            x, g, b, s, h = _gn_inputs(shape, film, dtype, gen)
            got = groupnorm_film_silu(x, g, b, s, h, groups=8)
            torch.cuda.synchronize()
            want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
            err = (got.float() - want.float()).abs().max().item()
            tol = GN_TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            max_err[dtype] = max(max_err[dtype], err)
            log(f"{label} GN {list(shape)} film={film} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"GN kernel disagrees with its plain version at {shape}")
            if dtype != time_dtype:
                continue
            k_eager, k_ms = cuda_ms(lambda: groupnorm_film_silu(x, g, b, s, h, groups=8), *iters)
            _, p_ms = cuda_ms(lambda: groupnorm_film_silu_reference(x, g, b, s, h, groups=8),
                              *iters)
            xc = x.permute(0, 3, 1, 2)  # NCHW view (channels_last)
            gc, bc = g.to(dtype), b.to(dtype)
            _, l_ms = cuda_ms(lambda: F.group_norm(xc, 8, gc, bc, eps=1e-5), *iters)
            bytes_moved = 2 * x.numel() * x.element_size() + 2 * g.numel() * 4
            if film:
                bytes_moved += 2 * s.numel() * 4
            bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
            ops_ms = 1e3 * GN_OPS_PER_ELEMENT * x.numel() / FP32_OPS_PER_S
            log(f"  device us/launch, x{n} per UNet call: kernel {k_ms * 1e3:.2f} "
                f"(eager from Python {k_eager * 1e3:.2f}) plain {p_ms * 1e3:.2f} "
                f"F.group_norm {l_ms * 1e3:.2f} bound {max(bytes_ms, ops_ms) * 1e3:.2f} "
                f"({bytes_moved / 1e6:.2f} MB)")
            for key, v in (("ms", k_ms), ("eager_ms", k_eager), ("plain_ms", p_ms),
                           ("group_norm_ms", l_ms), ("bound_ms", max(bytes_ms, ops_ms)),
                           ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                totals[key] += n * v
    log(f"{label} GN per UNet call ({len(launches)} launches, {str(time_dtype)[6:]}, device): "
        f"kernel {totals['ms']:.4f}ms (eager {totals['eager_ms']:.4f}ms) "
        f"plain {totals['plain_ms']:.4f}ms F.group_norm {totals['group_norm_ms']:.4f}ms "
        f"bound {totals['bound_ms']:.4f}ms; max_abs_err "
        + " ".join(f"{str(dt)[6:]} {e:.3g}" for dt, e in max_err.items()))
    return dict(totals, max_abs_err=max_err[time_dtype],
                max_abs_err_by_dtype={str(dt)[6:]: e for dt, e in max_err.items()})


def _check_images(name, pred, shape, lo, hi):
    if pred.shape != shape or not np.all(np.isfinite(pred)):
        raise RuntimeError(f"{name}: shape {pred.shape} or non-finite values")
    if pred.min() < lo - 1e-5 or pred.max() > hi + 1e-5:
        raise RuntimeError(f"{name}: values outside [{lo}, {hi}]")


def run_main_path(pipe, lr, hr, mask, per_call, serve_batch, label):
    """The counted run: translate with every count at 0, then three served
    requests (uniform mask: plain; the mask; the mask of row 2 or, for the
    manual detector, none).  Checks each kernel's launches per UNet call."""
    gd = pipe.gd
    T = gd.num_timesteps
    lo, hi = pipe.min_max_val
    b = lr.shape[0]
    reset_counts()
    res = pipe.translate(lr, hr=hr, noise=1, mask=mask)
    chain_counts = read_counts()
    s = pipe.config.sampler.start_timestep
    dt = float(res["time"])
    steps = b * (2 * (T - s) + s)  # a branched step counts as two
    log(f"{label} chain: branched={bool(res['branched'])} {dt * 1e3:.1f}ms for {b} images "
        f"-> {b / dt:.3f} img/s, {steps / dt:.1f} model-steps/s; "
        f"mse {float(res['mse']):.4f} ssim {float(res['ssim']):.4f} "
        f"psnr {float(res['psnr']):.2f}; launches {chain_counts}")
    if not bool(res["branched"]):
        raise RuntimeError("the mask must take the branched chain")
    for name, n in per_call.items():
        if chain_counts[name] != n * T:
            raise RuntimeError(f"{name}: {chain_counts[name]} launches in the chain, "
                               f"expected {n} x {T} UNet calls")
    _check_images(f"{label} chain", res["pred"], lr.shape, lo, hi)

    s_ = gd.image_size
    ones = np.ones((s_, s_, 1), np.float32)
    third = None if pipe.config.ood.detector == "manual" else mask[2]
    reqs = [(lr[0], ones), (lr[1], mask[1]), (lr[2], third)]
    srv = InferenceServer(pipe, batch_size=serve_batch, max_wait_ms=200)
    futs = [srv.submit(x, m) for x, m in reqs]
    t0 = time.perf_counter()
    with srv:
        outs = [f.result(timeout=600) for f in futs]
    served_s = time.perf_counter() - t0
    counts = read_counts()
    stats = srv.snapshot_stats()
    log(f"{label} serving: {stats['requests']} requests in {stats['batches']} batch(es), "
        f"merged {stats['merged_dispatches']} plain {stats['plain_dispatches']} "
        f"branched {stats['branched_dispatches']}, padded {stats['padded_slots']}, "
        f"mean latency {stats['latency_mean_s'] * 1e3:.1f}ms ({served_s:.2f}s wall); "
        f"branched flags {[o['branched'] for o in outs]}")
    dispatches = (stats["merged_dispatches"] + stats["plain_dispatches"]
                  + stats["branched_dispatches"])
    if stats["requests"] != 3 or dispatches < 1:
        raise RuntimeError(f"server stats {stats}")
    if [o["branched"] for o in outs] != [False, True, True]:
        raise RuntimeError("served branched flags wrong")
    for i, o in enumerate(outs):
        _check_images(f"{label} served request {i}", o["pred"], (s_, s_, 1), lo, hi)
    for name, n in per_call.items():
        served = counts[name] - chain_counts[name]
        if served != n * T * dispatches:
            raise RuntimeError(f"{name}: {served} launches while serving")
    log(f"{label} main path: launches {counts} (chain {chain_counts})")
    return res, counts, dict(chain_s=dt, img_per_s=b / dt, model_steps_per_s=steps / dt,
                             serve_latency_mean_s=stats["latency_mean_s"])


def profile_chain(pipe, lr, mask, label, top=12) -> dict:
    """Where one branched chain's time goes on the card (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = pipe.translate(lr, noise=1, mask=mask)
    # the card's own kernels only: an aten op's device time repeats theirs
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = float(res["time"]) * 1e6
    log(f"{label} profile: chain {wall_us / 1e3:.1f}ms wall (profiled), card busy "
        f"{busy_us / 1e3:.1f}ms = {100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.2f}ms {e.count:7d}x  {e.key[:110]}")
    return dict(busy_share=busy_us / wall_us)


# ---------------------------------------------------------------------------
# the 28px flagship
# ---------------------------------------------------------------------------

def flagship() -> dict:
    cfg = flagship_config()
    gd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cuda")
    pipe = LocalDiffusionPipeline(cfg, gd)
    log(f"flagship model: dim {cfg.model.dim} mults {cfg.model.dim_mults}, "
        f"{sum(p.numel() for p in gd.model.parameters())} params (seeded random), "
        f"T={gd.num_timesteps}, {cfg.diffusion.beta_schedule}, {cfg.diffusion.objective}, f32")
    seen = record_calls(gd, 2 * BATCH, pipe.min_max_val[1])
    if len(seen["gn"]) != FLAGSHIP_PER_CALL["groupnorm_film_silu"]:
        raise RuntimeError(f"{len(seen['gn'])} GroupNorm launches per flagship UNet call")
    gn = gn_kernel_phase(seen["gn"], (torch.float32, torch.bfloat16), torch.float32,
                         "flagship")

    rng = np.random.default_rng(0)
    s = gd.image_size
    lr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    mask = manual_mask((BATCH, s, s, 1), cfg.ood.manual_mask_cols)
    pipe.translate(lr, hr=hr, noise=1, mask=mask)  # warm-up (not counted)
    torch.cuda.synchronize()
    res, counts, perf = run_main_path(pipe, lr, hr, mask, FLAGSHIP_PER_CALL, SERVE_BATCH,
                                      "flagship")

    gd.model.use_plain_kernels(True)
    try:
        plain = pipe.translate(lr, noise=1, mask=mask)
    finally:
        gd.model.use_plain_kernels(False)
    err = float(np.abs(plain["pred"] - res["pred"]).max())
    log(f"flagship check: kernel chain vs plain-version chain max_abs_err {err:.3g} "
        f"(tol {CHAIN_TOL:g})")
    if not err <= CHAIN_TOL:
        raise RuntimeError("the flagship kernel chain disagrees with the plain-version chain")
    cpu_gd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cpu")
    cpu_gd.model.load_state_dict({k: v.cpu() for k, v in gd.model.state_dict().items()})
    cpu_pipe = LocalDiffusionPipeline(cfg, cpu_gd)
    shape = (2, s, s, 1)
    stream = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(gd.num_timesteps + 1)]
    on_card = pipe.translate(lr[:2], noise=ArrayNoise(stream, "cuda"), mask=mask[:2])
    on_cpu = cpu_pipe.translate(lr[:2], noise=ArrayNoise(stream, "cpu"), mask=mask[:2])
    err_cpu = float(np.abs(on_card["pred"] - on_cpu["pred"]).max())
    log(f"flagship check: card vs CPU (batch 2, same weights and noise) max_abs_err "
        f"{err_cpu:.3g} (tol {CHAIN_TOL:g})")
    if not err_cpu <= CHAIN_TOL:
        raise RuntimeError("the flagship chain on the card disagrees with the CPU's")
    prof = profile_chain(pipe, lr, mask, "flagship")
    return dict(gn=gn, counts=counts, perf=perf, **prof)


# ---------------------------------------------------------------------------
# the 256px MRI chain
# ---------------------------------------------------------------------------

def attention_kernel_phase(seen) -> dict:
    """The flash kernel against `xla_attention` at the 256px sites' shape,
    in bf16 and f32, with q/k/v cut from a channels_last qkv projection as
    `Attention` cuts them.  Times per launch, bf16."""
    sites = {(s[0], s[2], s[3], m.heads, m.dim_head) for m, s in seen}
    if len(seen) != MRI_PER_CALL["flash_attention"] or len(sites) != 1:
        raise RuntimeError(f"full-attention sites: {[s for _, s in seen]}")
    b, h, w, heads, dh = sites.pop()  # the same [B, N, H, D] at every site
    n = h * w
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(b, 3 * heads * dh, h, w, generator=gen, device="cuda").to(dtype)
        qkv = qkv.contiguous(memory_format=torch.channels_last)
        q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.reshape(b, 3, heads, dh, n).unbind(1))
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = xla_attention(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        log(f"256px attention [{b},{n},{heads},{dh}] {str(dtype)[6:]}: max_abs_err {err:.3g} "
            f"(tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("attention kernel disagrees with its plain version")
        k_eager, k_ms = cuda_ms(lambda: flash_attention(q, k, v), 10, 10)
        _, p_ms = cuda_ms(lambda: xla_attention(q, k, v), 10, 10)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, D]
        _, l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 10, 10)
        flops = 4 * b * heads * n * n * dh  # QK^T and PV
        bytes_moved = 4 * b * n * heads * dh * got.element_size()  # q, k, v in; out
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        bd_ms, bd_by = bound(bytes_moved, flops, rate)
        log(f"  device us/launch: kernel {k_ms * 1e3:.2f} (eager {k_eager * 1e3:.2f}) "
            f"plain {p_ms * 1e3:.2f} SDPA {l_ms * 1e3:.2f} bound {bd_ms * 1e3:.2f} ({bd_by}: "
            f"{flops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.2f} MB)")
        out[str(dtype)[6:]] = dict(ms=k_ms, eager_ms=k_eager, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=bd_ms, bound_by=bd_by, max_abs_err=err)
    return out


def kv_errors(got, want) -> dict:
    """The kv kernel's partials (m, l, G) against the plain version's, each
    measured against its own size, block by block.

    m: the relative difference; both are the max of bf16-rounded k, which
    may round one step apart where float32 sums in another order land on a
    rounding boundary (2^-7 relative at most).  l and G are first put on the
    plain version's max (times exp(m − m_plain)), then compared per block
    as relative L2 over l's 128 columns and relative Frobenius over G's
    C×128.  A norm over the block, not the largest entry: one token whose k
    rounds a step apart moves one column of G by up to ~2^-7 of a token's
    share, while a fault (a missed rescale, a block's G scaled) moves the
    block.  Also the largest |G/l| difference, the number the JSON line
    reports."""
    (m, l, g), (pm, pl, pg) = got, want
    r = torch.exp(m - pm)
    l, g = l * r, g * r[:, :, None, :]
    return dict(
        m=((m - pm).abs() / pm.abs().clamp_min(1e-6)).max().item(),
        l=((l - pl).norm(dim=2) / pl.norm(dim=2)).max().item(),
        g=((g - pg).norm(dim=(2, 3)) / pg.norm(dim=(2, 3))).max().item(),
        ctx=(g / l[:, :, None] - pg / pl[:, :, None]).abs().max().item(),
    )


def _batch_rule(batch: int, n: int) -> int:
    """The block size the port took from the batch before it took it from
    the token count alone (264 blocks in all), for timing the two beside
    each other."""
    per = -(-n // max(1, -(-264 // batch)))
    return -(-per // LA.SUBTILE) * LA.SUBTILE


def linear_attention_kernel_phase(seen) -> dict:
    """The kv and q kernels against their plain versions, and the whole
    two-pass function against the unfused plain version, at each
    linear-attention site of one 256px UNet call (bf16, the site's own
    random weights); row 0 alone against row 0 in the batch.  Times summed
    over the six sites, and kv, q and the two passes with the fold at
    batch 4 and 8 with the block size from the token count (the port's) and
    from the batch (before)."""
    if len(seen) != MRI_PER_CALL["linear_attention_kv"]:
        raise RuntimeError(f"{len(seen)} linear-attention sites, expected 6")
    if not all(cl for _, _, cl in seen):
        raise RuntimeError("a linear-attention input is not channels_last: its NHWC view "
                           f"would be a copy ({[(s, cl) for _, s, cl in seen]})")
    gen = torch.Generator(device="cuda").manual_seed(2)
    tot = {k: dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   ops_ms=0.0, max_abs_err=0.0) for k in ("kv", "q")}
    whole = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    sizing = {(bb, rule): [0.0, 0.0, 0.0] for bb in (4, 8) for rule in ("n", "batch")}
    for mod, shape, _ in seen:
        b, h, w, c = shape
        n = h * w
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(torch.bfloat16)
        xr = x.reshape(b, n, c)
        params = (mod.norm.g, mod.to_qkv.weight[:, :, 0, 0].t(),
                  mod.to_out.weight[:, :, 0, 0].t(), mod.to_out.bias, mod.out_norm.g)
        g_in, w_qkv, w_out, b_out, g_out = (p.detach() for p in params)
        wq, wk, wv = LA.split_qkv(w_qkv)
        per = LA.tokens_per_block(n)
        nb = -(-n // per)

        m, l, gram = LA.linear_attention_kv(xr, g_in, wk, per)
        torch.cuda.synchronize()
        kv_err = kv_errors((m, l, gram), LA.kv_partials_reference(xr, g_in, wk, per))
        err_kv = kv_err["ctx"]
        ok_kv = all(kv_err[k] <= tol for k, tol in KV_TOL.items())
        wtil = LA.fold(*LA.merge_kv(m, l, gram), wv, w_out)
        got = LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out, per)
        torch.cuda.synchronize()
        want = LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out)
        err_q = (got.float() - want.float()).abs().max().item()
        ok_q = torch.allclose(got.float(), want.float(), **LINATT_TOL)
        full = LA.linear_attention(x, g_in, w_qkv, w_out, b_out, g_out)
        ref = LA.linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out)
        err_full = (full.float() - ref.float()).abs().max().item()
        corr = torch.corrcoef(torch.stack([full.float().ravel(), ref.float().ravel()]))[0, 1]
        ok_full = torch.allclose(full.float(), ref.float(), **LINATT_TOL) and corr > 0.999
        log(f"256px linear attention {list(shape)} ({nb} blocks of {per} tokens): kv "
            + ", ".join(f"{k} {kv_err[k]:.3g} (tol {KV_TOL[k]:.3g})" for k in KV_TOL)
            + f", G/l max_abs_err {err_kv:.3g} {'ok' if ok_kv else 'FAIL'}; q "
            f"{err_q:.3g} (tol {LINATT_TOL}) {'ok' if ok_q else 'FAIL'}; two-pass vs "
            f"unfused {err_full:.3g}, corr {float(corr):.6f} {'ok' if ok_full else 'FAIL'}")
        if not (ok_kv and ok_q and ok_full):
            raise RuntimeError(f"linear-attention kernels disagree at {shape}")
        alone = LA.linear_attention(x[:1].clone(), g_in, w_qkv, w_out, b_out, g_out)
        torch.cuda.synchronize()
        if not torch.equal(alone, full[:1]):
            raise RuntimeError(f"linear attention: row 0 alone differs from row 0 in the "
                               f"batch at {shape}")

        def two_pass(xb_, per_):
            m_, l_, g_ = LA.linear_attention_kv(xb_, g_in, wk, per_)
            wt_ = LA.fold(*LA.merge_kv(m_, l_, g_), wv, w_out)
            return LA.linear_attention_q(xb_, g_in, wq, wt_, b_out, g_out, per_)

        for (bb, rule), acc in sizing.items():
            xb_ = xr[:bb].contiguous()
            per_ = LA.tokens_per_block(n) if rule == "n" else _batch_rule(bb, n)
            wt_ = LA.fold(*LA.merge_kv(*LA.linear_attention_kv(xb_, g_in, wk, per_)), wv, w_out)
            for i, fn in enumerate((
                    lambda: LA.linear_attention_kv(xb_, g_in, wk, per_),
                    lambda: LA.linear_attention_q(xb_, g_in, wq, wt_, b_out, g_out, per_),
                    lambda: two_pass(xb_, per_))):
                acc[i] += cuda_ms(fn, 5, 4)[1]

        kv_eager, kv_ms = cuda_ms(lambda: LA.linear_attention_kv(xr, g_in, wk, per), 5, 4)
        _, kv_plain = cuda_ms(lambda: LA.kv_partials_reference(xr, g_in, wk, per), 5, 4)
        q_eager, q_ms = cuda_ms(
            lambda: LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out, per), 5, 4)
        _, q_plain = cuda_ms(
            lambda: LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out), 5, 4)
        _, f_ms = cuda_ms(lambda: LA.linear_attention(x, g_in, w_qkv, w_out, b_out, g_out),
                          5, 4)
        _, f_plain = cuda_ms(
            lambda: LA.linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out), 5, 4)
        xb = x.numel() * 2
        bytes_moved = {"kv": xb + 4 * b * nb * (2 * 128 + c * 128) + c * 128 * 2,
                       "q": 2 * xb + b * 128 * c * 2 + c * 128 * 2}
        flops = 4 * b * n * c * 128  # two [N, C] x [C, 128] products per pass
        op_ms = 1e3 * flops / BF16_OPS_PER_S
        for key, ms, eager, plain, err in (("kv", kv_ms, kv_eager, kv_plain, err_kv),
                                           ("q", q_ms, q_eager, q_plain, err_q)):
            bd_ms = 1e3 * bytes_moved[key] / HBM_BYTES_PER_S
            t = tot[key]
            t["ms"] += ms
            t["eager_ms"] += eager
            t["plain_ms"] += plain
            t["bytes_ms"] += bd_ms
            t["ops_ms"] += op_ms
            t["bound_ms"] += max(bd_ms, op_ms)
            t["max_abs_err"] = max(t["max_abs_err"], err)
            log(f"  {key} device us/launch: kernel {ms * 1e3:.1f} (eager {eager * 1e3:.1f}) "
                f"plain {plain * 1e3:.1f} bound {max(bd_ms, op_ms) * 1e3:.1f}")
        whole["ms"] += f_ms
        whole["plain_ms"] += f_plain
        whole["max_abs_err"] = max(whole["max_abs_err"], err_full)
        log(f"  whole function device us: two-pass {f_ms * 1e3:.1f}, unfused plain "
            f"{f_plain * 1e3:.1f}")
    for key in ("kv", "q"):
        t = tot[key]
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
        log(f"256px linear attention {key} per UNet call (6 launches): kernel {t['ms']:.4f}ms "
            f"(eager {t['eager_ms']:.4f}) plain {t['plain_ms']:.4f}ms bound "
            f"{t['bound_ms']:.4f}ms ({t['bound_by']})")
    log(f"256px linear attention whole per UNet call: two-pass {whole['ms']:.4f}ms, "
        f"unfused plain {whole['plain_ms']:.4f}ms; row 0 alone = row 0 in the batch at "
        f"every site")
    for (bb, rule), (kv_t, q_t, tp_t) in sizing.items():
        log(f"256px linear attention block size from the {rule:5s} at batch {bb}, per UNet "
            f"call (device): kv {kv_t:.4f}ms q {q_t:.4f}ms two passes with the fold "
            f"{tp_t:.4f}ms")
    for key, i in (("kv", 0), ("q", 1)):
        for bb in (4, 8):
            tot[key][f"batch{bb}_ms"] = sizing[(bb, "n")][i]
            tot[key][f"batch{bb}_batch_rule_ms"] = sizing[(bb, "batch")][i]
    return dict(kv=tot["kv"], q=tot["q"], whole=whole)


def bf16_steps(got, want) -> float:
    """|got − want| in bf16 steps, element by element (largest): the step at
    max(|got|, |want|), or at 1/256 of want's largest |value| where both are
    smaller (near 0 float32 sums in another order move a value by more than
    its own step)."""
    got, want = got.float(), want.float()
    floor = want.abs().max() / 256
    _, e = torch.frexp(torch.maximum(torch.maximum(got.abs(), want.abs()), floor))
    return ((got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)).max().item()


def stats_errors(h, s, ss, plain) -> dict:
    """conv3x3_stats' sums against (tiles) the per-tile sums of its own h,
    and (s, ss) the plain version's per-(row, channel) sums with the part
    that the one-step differences between the two h explain taken out;
    each a relative norm per row (largest row)."""
    ph, ps, pss = plain
    ts, tss = RB.tile_sums(h)
    own = torch.cat([ts, tss], 1)
    tiles = ((torch.cat([s, ss], 1) - own).norm(dim=(1, 2)) / own.norm(dim=(1, 2))).max()
    hk, hp = h.double(), ph.double()
    out = dict(tiles=tiles.item())
    for key, got, want, moved in (("s", s, ps, hk - hp), ("ss", ss, pss, hk**2 - hp**2)):
        diff = got.double().sum(1) - want.double().sum(1) - moved.sum(dim=(1, 2))
        out[key] = (diff.norm(dim=1) / want.double().sum(1).norm(dim=1)).max().item()
    return out


def _plain_conv(xin, w, bias, pad):
    """bf16(conv3x3(xin) + bias) of an NHWC float32 input, as the plain
    version computes it (`pad` 1 pads with zeros, 0 takes xin as padded)."""
    cout, cin = w.shape[1], w.shape[2]
    wk = w.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1)
    h = F.conv2d(xin.permute(0, 3, 1, 2), wk, padding=pad).permute(0, 2, 3, 1)
    return (h + bias).to(torch.bfloat16)


def emulated_faults(x, w1, bias1, h1, s1, ss1, plain1, w2, bias2, a1, c1, plain2) -> dict:
    """What three faulty kernels would give, read by the checks of the
    fused block's phase: pass 2 with the activation applied to its zero
    padding too (silu(b) ≠ 0 at the border), pass 1 without the halo row
    above each tile, and pass 1's sums without one tile."""
    bsz, hh, ww, cin = x.shape
    y = h1.float() * a1[:, None, None, :] + c1[:, None, None, :]
    xin = (y * torch.sigmoid(y)).to(torch.bfloat16).float()
    edge = (c1 * torch.sigmoid(c1)).to(torch.bfloat16).float()  # silu(0·a + b)
    xp = edge[:, None, None, :].expand(bsz, hh + 2, ww + 2, -1).clone()
    xp[:, 1:-1, 1:-1] = xin
    padded = _plain_conv(xp, w2, bias2, 0)
    x_cut = x.float().clone()
    th = RB.TILE_H
    x_cut[:, th - 1:hh - 1:th] = 0  # the row above each tile but the first
    no_halo = plain1[0].clone()
    no_halo[:, th::th] = _plain_conv(x_cut, w1, bias1, 1)[:, th::th]
    s_cut, ss_cut = s1.clone(), ss1.clone()
    s_cut[:, s1.shape[1] // 2] = 0
    ss_cut[:, s1.shape[1] // 2] = 0
    return {"activated padding (h2 steps)": bf16_steps(padded, plain2[0]),
            "no halo row (h1 steps)": bf16_steps(no_halo, plain1[0]),
            "dropped tile (sums)": max(stats_errors(h1, s_cut, ss_cut, plain1).values())}


def resnet_block_kernel_phase(seen) -> dict:
    """The fused ResnetBlock's kernels at each shape its 13 blocks take in
    one 256px UNet call (bf16, the first such block's random weights, random
    FiLM): conv3x3_stats for pass 1 and, with its prologue, pass 2, and the
    epilogue, each against its plain version on the kernel's own inputs;
    the whole three-pass block against its plain version; row 0 alone
    against row 0 in the batch; at the first shape, three emulated faults
    read by the same checks.  Times summed over the 13 fused blocks (26
    conv3x3_stats, 13 epilogues): each pass, the whole block, their plain
    versions, cuDNN's bf16 convolution with its bias at each pass's
    operands, and the unfused block as the port runs it outside the gate
    (cuDNN convolutions, the GroupNorm kernel, the adds)."""
    fused = [(m, s, cl) for m, s, cl, f in seen if f]
    if len(fused) != MRI_FUSED_BLOCKS or len(seen) - len(fused) != MRI_UNFUSED_BLOCKS:
        raise RuntimeError(f"{len(fused)} fused and {len(seen) - len(fused)} unfused "
                           f"ResnetBlocks: {[(s, f) for _, s, _, f in seen]}")
    if not all(cl for _, _, cl in fused):
        raise RuntimeError("a fused ResnetBlock's input is not channels_last: its NHWC view "
                           f"would be a copy ({[(s, cl) for _, s, cl in fused]})")
    sites = {}
    for mod, shape, _ in fused:
        sites.setdefault((shape, mod.block1.proj.out_channels), [mod, 0])[1] += 1
    log(f"256px fused ResnetBlocks: {len(fused)} blocks at {len(sites)} shapes "
        f"{[(list(k[0]), k[1], c) for k, (_, c) in sites.items()]}, all inputs channels_last")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = {k: dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0) for k in ("conv", "epi")}
    tot["conv"].update(pass1_ms=0.0, pass2_ms=0.0)
    whole = dict(ms=0.0, plain_ms=0.0, unfused_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                 ops_ms=0.0, max_rel_l2=0.0)
    worst = dict(h_steps=0.0, stats=0.0, epi=0.0)
    faults = None
    for (shape, cout), (mod, count) in sites.items():
        b, hh, ww, cin = shape
        groups = mod.block1.norm.groups
        n = hh * ww * (cout // groups)
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        ss = tuple(torch.randn(b, cout, generator=gen, device="cuda") * 0.3 for _ in range(2))
        with torch.no_grad():
            blk1, blk2 = mod.block1, mod.block2
            w1, w2 = RB.pack_conv3x3(blk1.proj.weight), RB.pack_conv3x3(blk2.proj.weight)
            bias1, bias2 = blk1.proj.bias.float(), blk2.proj.bias.float()
            norm1, norm2 = (blk1.norm.weight, blk1.norm.bias), (blk2.norm.weight, blk2.norm.bias)
            w_res = b_res = None
            if mod.res_conv is not None:
                w_res = mod.res_conv.weight[:, :, 0, 0].to(torch.bfloat16).contiguous()
                b_res = mod.res_conv.bias.float()
            h1, s1, ss1 = RB.conv3x3_stats(x, w1, bias1)
            a1, c1 = RB.gn_affine(s1, ss1, *norm1, *ss, groups, n)
            h2, s2, ss2 = RB.conv3x3_stats(h1, w2, bias2, a1, c1)
            a2, c2 = RB.gn_affine(s2, ss2, *norm2, None, None, groups, n)
            out = RB.epilogue(h2, x, a2, c2, w_res, b_res)
            torch.cuda.synchronize()
            plain1 = RB.conv_stats_reference(x, w1, bias1)
            plain2 = RB.conv_stats_reference(h1, w2, bias2, a1, c1)
            readings = {}
            for tag, got, plain in (("pass1", (h1, s1, ss1), plain1),
                                    ("pass2", (h2, s2, ss2), plain2)):
                readings[tag] = (bf16_steps(got[0], plain[0]), stats_errors(*got, plain))
            want = RB.epilogue_reference(h2, x, a2, c2, w_res, b_res)
            epi_err = (out.float() - want.float()).abs().max().item()
            ok_epi = torch.allclose(out.float(), want.float(), atol=RB_TOL["epi_atol"],
                                    rtol=RB_TOL["epi_rtol"])
            full = RB.resnet_block_fused(x, mod, ss)
            ref = RB.resnet_block_fused_plain(x, mod, ss)
            alone = RB.resnet_block_fused(x[:1].clone(), mod, tuple(t[:1].clone() for t in ss))
            torch.cuda.synchronize()
            if faults is None:
                faults = emulated_faults(x, w1, bias1, h1, s1, ss1, plain1, w2, bias2, a1, c1,
                                         plain2)
        rel = float((full.float() - ref.float()).norm() / ref.float().norm())
        corr = float(torch.corrcoef(torch.stack([full.float().ravel(), ref.float().ravel()]))[0, 1])
        ok_block = (torch.allclose(full.float(), ref.float(), atol=RB_TOL["block_atol"],
                                   rtol=RB_TOL["block_rtol"])
                    and corr > RB_TOL["block_corr"] and rel <= RB_TOL["block_rel"])
        steps = max(r[0] for r in readings.values())
        stats = max(max(r[1].values()) for r in readings.values())
        ok_pass = steps <= RB_TOL["h_steps"] and stats <= RB_TOL["stats"]
        batch_free = torch.equal(alone, full[:1])
        log(f"256px fused block {list(shape)} -> {cout} (x{count}): "
            + "; ".join(f"{t} h {r[0]:.3g} steps, sums "
                        + " ".join(f"{k} {v:.3g}" for k, v in r[1].items())
                        for t, r in readings.items())
            + f" (bars {RB_TOL['h_steps']:g} step, {RB_TOL['stats']:g}); epilogue max_abs_err "
            f"{epi_err:.3g} {'ok' if ok_epi else 'FAIL'}; block vs plain rel L2 {rel:.3g} corr "
            f"{corr:.6f} {'ok' if ok_block else 'FAIL'}; row 0 alone "
            f"{'= row 0 in the batch' if batch_free else 'DIFFERS'}")
        if not (ok_pass and ok_epi and ok_block and batch_free):
            raise RuntimeError(f"the fused ResnetBlock's kernels disagree at {shape}")
        worst = dict(h_steps=max(worst["h_steps"], steps), stats=max(worst["stats"], stats),
                     epi=max(worst["epi"], epi_err))
        whole["max_rel_l2"] = max(whole["max_rel_l2"], rel)

        xc, h1c = x.permute(0, 3, 1, 2), h1.permute(0, 3, 1, 2)  # channels_last NCHW views
        w1c, w2c = (w.reshape(3, 3, cout, -1).permute(2, 3, 0, 1)
                    .contiguous(memory_format=torch.channels_last) for w in (w1, w2))
        b1h, b2h = bias1.to(torch.bfloat16), bias2.to(torch.bfloat16)
        with torch.no_grad():
            p1_eager, p1_ms = cuda_ms(lambda: RB.conv3x3_stats(x, w1, bias1), 5, 4)
            p2_eager, p2_ms = cuda_ms(lambda: RB.conv3x3_stats(h1, w2, bias2, a1, c1), 5, 4)
            _, p1_plain = cuda_ms(lambda: RB.conv_stats_reference(x, w1, bias1), 5, 4)
            _, p2_plain = cuda_ms(lambda: RB.conv_stats_reference(h1, w2, bias2, a1, c1), 5, 4)
            _, p1_lib = cuda_ms(lambda: F.conv2d(xc, w1c, b1h, padding=1), 5, 4)
            _, p2_lib = cuda_ms(lambda: F.conv2d(h1c, w2c, b2h, padding=1), 5, 4)
            e_eager, e_ms = cuda_ms(lambda: RB.epilogue(h2, x, a2, c2, w_res, b_res), 5, 4)
            _, e_plain = cuda_ms(lambda: RB.epilogue_reference(h2, x, a2, c2, w_res, b_res),
                                 5, 4)
            _, f_ms = cuda_ms(lambda: RB.resnet_block_fused(x, mod, ss), 5, 4)
            _, f_plain = cuda_ms(lambda: RB.resnet_block_fused_plain(x, mod, ss), 5, 4)

            def unfused():
                h = blk2(blk1(xc, ss))
                return h + (mod.res_conv(xc) if mod.res_conv is not None else xc)

            _, u_ms = cuda_ms(unfused, 5, 4)
        pix = b * hh * ww
        tiles = RB.num_tiles(hh, ww)

        def conv_bytes(ci, affine):
            return (pix * (ci + cout) * 2 + 9 * cout * ci * 2 + cout * 4
                    + 2 * b * tiles * cout * 4 + (2 * b * ci * 4 if affine else 0))

        conv_ops = lambda ci: 2 * pix * cout * 9 * ci
        res_bytes = cout * cin * 2 + cout * 4 if w_res is not None else 0
        res_ops = 2 * pix * cin * cout if w_res is not None else 0
        epi_bytes = pix * (2 * cout + cin) * 2 + 2 * b * cout * 4 + res_bytes
        block_bytes = (pix * (cin + cout) * 2 + 9 * cout * (cin + cout) * 2 + 6 * cout * 4
                       + 2 * b * cout * 4 + res_bytes)
        block_ops = conv_ops(cin) + conv_ops(cout) + res_ops
        for key, ms, eager, plain, lib, nbytes, ops, err in (
                ("conv", p1_ms + p2_ms, p1_eager + p2_eager, p1_plain + p2_plain,
                 p1_lib + p2_lib, conv_bytes(cin, False) + conv_bytes(cout, True),
                 conv_ops(cin) + conv_ops(cout),
                 max((got - want.float()).abs().max().item()
                     for got, want in ((h1.float(), plain1[0]), (h2.float(), plain2[0])))),
                ("epi", e_ms, e_eager, e_plain, 0.0, epi_bytes, res_ops, epi_err)):
            b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / BF16_OPS_PER_S
            t = tot[key]
            for k2, v in (("ms", ms), ("eager_ms", eager), ("plain_ms", plain),
                          ("library_ms", lib), ("bytes_ms", b_ms), ("ops_ms", o_ms),
                          ("bound_ms", max(b_ms, o_ms))):
                t[k2] += count * v
            t["max_abs_err"] = max(t["max_abs_err"], err)
        tot["conv"]["pass1_ms"] += count * p1_ms
        tot["conv"]["pass2_ms"] += count * p2_ms
        wb_ms, wo_ms = 1e3 * block_bytes / HBM_BYTES_PER_S, 1e3 * block_ops / BF16_OPS_PER_S
        for k2, v in (("ms", f_ms), ("plain_ms", f_plain), ("unfused_ms", u_ms),
                      ("bytes_ms", wb_ms), ("ops_ms", wo_ms), ("bound_ms", max(wb_ms, wo_ms))):
            whole[k2] += count * v
        cb1, cb2 = (bound(conv_bytes(ci, aff), conv_ops(ci), BF16_OPS_PER_S)[0]
                    for ci, aff in ((cin, False), (cout, True)))
        log(f"  device us/launch: pass 1 {p1_ms * 1e3:.1f} (eager {p1_eager * 1e3:.1f}, plain "
            f"{p1_plain * 1e3:.1f}, cuDNN conv {p1_lib * 1e3:.1f}, bound {cb1 * 1e3:.1f}); "
            f"pass 2 {p2_ms * 1e3:.1f} (eager {p2_eager * 1e3:.1f}, plain {p2_plain * 1e3:.1f}, "
            f"cuDNN conv {p2_lib * 1e3:.1f}, bound {cb2 * 1e3:.1f}); epilogue {e_ms * 1e3:.1f} "
            f"(plain {e_plain * 1e3:.1f}, bound "
            f"{bound(epi_bytes, res_ops, BF16_OPS_PER_S)[0] * 1e3:.1f}); whole block fused "
            f"{f_ms * 1e3:.1f}, plain {f_plain * 1e3:.1f}, unfused {u_ms * 1e3:.1f}, bound "
            f"{max(wb_ms, wo_ms) * 1e3:.1f}")
    for label, reading in faults.items():
        bar = RB_TOL["stats"] if "sums" in label else RB_TOL["h_steps"]
        log(f"256px fused block emulated fault, {label}: {reading:.3g} (bar {bar:g}) "
            f"{'caught' if reading > bar else 'MISSED'}")
        if not reading > bar:
            raise RuntimeError(f"the checks miss an emulated fault: {label}")
    for t in tot.values():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    whole["bound_by"] = "bytes" if whole["bytes_ms"] >= whole["ops_ms"] else "operations"
    c, e = tot["conv"], tot["epi"]
    log(f"256px fused ResnetBlock per UNet call (13 blocks, device): conv3x3_stats x26 "
        f"{c['ms']:.4f}ms (pass 1 {c['pass1_ms']:.4f}, pass 2 {c['pass2_ms']:.4f}; eager "
        f"{c['eager_ms']:.4f}) plain {c['plain_ms']:.4f} cuDNN conv {c['library_ms']:.4f} "
        f"bound {c['bound_ms']:.4f} ({c['bound_by']}); epilogue x13 {e['ms']:.4f}ms (eager "
        f"{e['eager_ms']:.4f}) plain {e['plain_ms']:.4f} bound {e['bound_ms']:.4f} "
        f"({e['bound_by']}); whole blocks fused {whole['ms']:.4f}ms, plain "
        f"{whole['plain_ms']:.4f}, unfused (cuDNN + GN kernel) {whole['unfused_ms']:.4f}, "
        f"bound {whole['bound_ms']:.4f} ({whole['bound_by']}); worst readings: h "
        f"{worst['h_steps']:.3g} steps, sums {worst['stats']:.3g}, epilogue "
        f"{worst['epi']:.3g}, block rel L2 {whole['max_rel_l2']:.3g}")
    return dict(conv=c, epi=e, whole=whole, worst=worst, faults=faults)


def mri256() -> dict:
    cfg = mri256_config()
    gd = build_gd(cfg, device="cuda")
    pipe = LocalDiffusionPipeline(cfg, gd)
    lo, hi = pipe.min_max_val
    log(f"256px model: dim {cfg.model.dim} mults {cfg.model.dim_mults}, full_attn "
        f"{cfg.model.full_attn}, {sum(p.numel() for p in gd.model.parameters())} params "
        f"(seeded random), compute {gd.dtype}, T={gd.num_timesteps}, "
        f"{cfg.diffusion.beta_schedule}, {cfg.diffusion.objective}, mask_x "
        f"{cfg.sampler.mask_x_policy}, cond_in_floor {cfg.sampler.cond_in_floor}, "
        f"min_max_val ({lo}, {hi:.4f})")

    seen = record_calls(gd, 2 * MRI_BATCH, hi)
    log(f"256px UNet call at batch {2 * MRI_BATCH}: {len(seen['gn'])} GN, "
        f"{len(seen['linatt'])} linear-attention sites {[s for _, s, _ in seen['linatt']]}, "
        f"{len(seen['attn'])} full-attention sites, {sum(f for *_, f in seen['rb'])} of "
        f"{len(seen['rb'])} ResnetBlocks fused")
    if len(seen["gn"]) != MRI_PER_CALL["groupnorm_film_silu"]:
        raise RuntimeError(f"{len(seen['gn'])} GroupNorm launches per 256px UNet call")
    attn = attention_kernel_phase(seen["attn"])
    linatt = linear_attention_kernel_phase(seen["linatt"])
    rb = resnet_block_kernel_phase(seen["rb"])
    gn = gn_kernel_phase(seen["gn"], (torch.bfloat16,), torch.bfloat16, "256px", (5, 4))

    rng = np.random.default_rng(0)
    s = gd.image_size
    lr = rng.uniform(0, hi, (MRI_BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, hi, (MRI_BATCH, s, s, 1)).astype(np.float32)
    yy, xx = np.mgrid[:s, :s]
    mask = np.zeros((MRI_BATCH, s, s, 1), np.float32)
    for i in range(MRI_BATCH):  # a disc of radius 25, the synthetic tumour's
        cy, cx = 90 + 20 * i, 150 - 15 * i
        mask[i, (yy - cy) ** 2 + (xx - cx) ** 2 < 25**2] = 1.0
    res, counts, perf = run_main_path(pipe, lr, hr, mask, MRI_PER_CALL, MRI_SERVE_BATCH,
                                      "256px")

    gd.model.use_plain_kernels(True)
    try:
        plain = pipe.translate(lr, noise=1, mask=mask)
    finally:
        gd.model.use_plain_kernels(False)
    a, p = res["pred"].ravel(), plain["pred"].ravel()
    rel = float(np.linalg.norm(a - p) / np.linalg.norm(p))
    corr = float(np.corrcoef(a, p)[0, 1])
    log(f"256px check: kernel chain vs plain-version chain (same noise): relative L2 "
        f"{rel:.4g} (tol {MRI_CHAIN_REL:g}), correlation {corr:.6f} (tol {MRI_CHAIN_CORR:g}), "
        f"max_abs_err {float(np.abs(a - p).max()):.4g}; plain chain {float(plain['time']):.2f}s")
    if not (rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR):
        raise RuntimeError("the 256px kernel chain disagrees with the plain-version chain")

    x = rng.standard_normal((2, s, s, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (2, s, s, 1)).astype(np.float32)
    t = np.array([7, 180])
    for dtype in ("bfloat16", "float32"):
        c2 = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        card = build_gd(c2, device="cuda")
        cpu = build_gd(c2, device="cpu")
        cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
        got = card.apply_model(torch.as_tensor(x, device="cuda"),
                               torch.as_tensor(cond, device="cuda"),
                               torch.as_tensor(t, device="cuda")).cpu().numpy()
        t0 = time.perf_counter()
        want = cpu.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                               torch.as_tensor(t)).numpy()
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
        if dtype == "bfloat16":
            ok = rel <= MRI_UNET_REL and corr >= MRI_UNET_CORR
            bar = f"relative L2 <= {MRI_UNET_REL:g}, correlation >= {MRI_UNET_CORR:g}"
        else:
            ok = bool(np.allclose(got, want, rtol=MRI_UNET_F32_TOL, atol=MRI_UNET_F32_TOL))
            bar = f"{MRI_UNET_F32_TOL:g} abs+rel"
        log(f"256px check: one UNet call, card vs CPU (batch 2, {dtype}): max_abs_err "
            f"{err:.4g}, relative L2 {rel:.4g}, correlation {corr:.6f} ({bar}) "
            f"{'ok' if ok else 'FAIL'}; CPU call {cpu_s:.1f}s")
        if not ok:
            raise RuntimeError(f"the 256px UNet on the card disagrees with the CPU's ({dtype})")
        del card, cpu

    prof = profile_chain(pipe, lr, mask, "256px", top=16)
    return dict(attn=attn, linatt=linatt, rb=rb, gn=gn, counts=counts, perf=perf, **prof)


def main() -> None:
    phase_device()
    phase_build()
    flag = flagship()
    mri = mri256()

    attn, lin, gn = mri["attn"]["bfloat16"], mri["linatt"], mri["gn"]
    counts = mri["counts"]
    kernels = [
        dict(name="groupnorm_film_silu", route="cuda",
             source="localdiffusion_tpu_torch/csrc/groupnorm_film_silu.cu",
             replaces="localdiffusion_tpu/ops/pallas_groupnorm.py:74",
             launches=counts["groupnorm_film_silu"] + flag["counts"]["groupnorm_film_silu"],
             max_abs_err=gn["max_abs_err"], ms=gn["ms"], plain_ms=gn["plain_ms"],
             bound_ms=gn["bound_ms"],
             bound_by="bytes" if gn["bytes_ms"] >= gn["ops_ms"] else "operations",
             library_ms=None, per="256px UNet call, 14 launches, bf16",
             launches_256px=counts["groupnorm_film_silu"],
             launches_flagship=flag["counts"]["groupnorm_film_silu"],
             group_norm_ms=gn["group_norm_ms"], flagship_ms=flag["gn"]["ms"],
             flagship_plain_ms=flag["gn"]["plain_ms"],
             flagship_bound_ms=flag["gn"]["bound_ms"],
             flagship_max_abs_err=flag["gn"]["max_abs_err"]),
        dict(name="flash_attention", route="cuda",
             source="localdiffusion_tpu_torch/csrc/flash_attention.cu",
             replaces="localdiffusion_tpu/ops/pallas_attention.py:26",
             launches=counts["flash_attention"], max_abs_err=attn["max_abs_err"],
             ms=attn["ms"], plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"],
             bound_by=attn["bound_by"], library_ms=attn["library_ms"],
             per="one launch at [8,1024,4,32] bf16 (3 per 256px UNet call)",
             f32_ms=mri["attn"]["float32"]["ms"],
             f32_max_abs_err=mri["attn"]["float32"]["max_abs_err"]),
    ]
    for key, src_line in (("kv", 149), ("q", 201)):
        t = lin[key]
        kernels.append(dict(
            name=f"linear_attention_{key}", route="cuda",
            source="localdiffusion_tpu_torch/csrc/linear_attention.cu",
            replaces=f"localdiffusion_tpu/ops/pallas_linear_attention.py:{src_line}",
            launches=counts[f"linear_attention_{key}"], max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            per="256px UNet call, 6 launches (one per site), bf16",
            **{k: t[k] for k in ("batch4_ms", "batch8_ms", "batch4_batch_rule_ms",
                                 "batch8_batch_rule_ms")}))
    rb, whole = mri["rb"], mri["rb"]["whole"]
    block = dict(block_ms=whole["ms"], block_plain_ms=whole["plain_ms"],
                 block_unfused_ms=whole["unfused_ms"], block_bound_ms=whole["bound_ms"],
                 block_bound_by=whole["bound_by"], block_max_rel_l2=whole["max_rel_l2"])
    for name, key, src_line, per in (
            ("conv3x3_stats", "conv", 74,
             "256px UNet call, 26 launches (pass 1 and 2 of 13 fused blocks), bf16; "
             "library: cuDNN conv + bias alone"),
            ("epilogue", "epi", 133, "256px UNet call, 13 launches, bf16")):
        t = rb[key]
        kernels.append(dict(
            name=name, route="cuda", source="localdiffusion_tpu_torch/csrc/resnet_block.cu",
            replaces=f"localdiffusion_tpu/ops/pallas_resnet_block.py:{src_line}",
            launches=counts[name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"] if key == "conv" else None, per=per,
            **({"pass1_ms": t["pass1_ms"], "pass2_ms": t["pass2_ms"]} if key == "conv"
               else {}), **block))
    log(f"end to end: flagship {json.dumps(flag['perf'])}; 256px {json.dumps(mri['perf'])}; "
        f"busy share flagship {flag['busy_share']:.4f} 256px {mri['busy_share']:.4f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
