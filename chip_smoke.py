#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed on its own line with the elapsed seconds:

1. device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off for convolutions and matrix products (exact float32 checks);
2. build: builds the CUDA kernels from `localdiffusion_tpu_torch/csrc` with
   nvcc and prints how long it took;
3. kernel: the GroupNorm+FiLM+SiLU kernel against its plain PyTorch version
   at each shape the flagship UNet gives it (batch 64, branched pair of
   128), with and without FiLM, in float32 and bfloat16; prints the error
   against the tolerance and CUDA-event times (replayed from a CUDA graph,
   so host overhead is left out) of the kernel, the plain version,
   `F.group_norm` alone and the memory bound;
4. main path: with every launch count at 0, `LocalDiffusionPipeline.translate`
   on the 28px flagship (seeded random weights, T=50) at batch 64 with the
   manual mask, then an `InferenceServer` (batch 8) answering three requests;
   checks that the kernel ran 32 times per UNet call;
5. check: the same chain with the plain GroupNorm on the card, and a small
   batch on the CPU, each against the kernel chain's images;
6. profile: one chain under torch.profiler: the card's busy share and the
   operations that take its time.

The line before the last is one JSON object with the kernel's numbers; the
last line is the device record.  Any failed check raises, so the exit code
is not 0.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.config import flagship_config
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.models.blocks import GroupNormFilmSiLU
from localdiffusion_tpu_torch.ood.manual import manual_mask
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer

BATCH = 64
SERVE_BATCH = 8
GN_LAUNCHES_PER_UNET_CALL = 32  # two Blocks in each of the 16 ResnetBlocks
# H100 SXM data-sheet peaks: device memory, and float32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
GN_OPS_PER_ELEMENT = 14  # stats 4, normalize+affine 3, FiLM 2, SiLU 5
# kernel vs plain version: float32 differs only by summation order; bfloat16
# may differ by one rounding step of the output (2^-8 relative)
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# final images of the chain, kernel vs plain GroupNorm (same card, same
# noise) and card vs CPU: float32 differences of ~1e-6 per call, carried
# through 50 posterior steps and clipped to [0, 2]
CHAIN_TOL = 1e-3

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


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


def phase_build() -> float:
    t0 = time.perf_counter()
    _build.load("groupnorm_film_silu")
    dt = time.perf_counter() - t0
    log(f"build: groupnorm_film_silu.cu with nvcc in {dt:.2f}s "
        f"-> {_build.library_path('groupnorm_film_silu').name}")
    return dt


def gn_launch_shapes(gd, batch: int):
    """(NHWC shape, FiLM?) of each GroupNorm launch in one UNet call at
    `batch` rows, recorded by hooks on the model's GroupNorm modules."""
    seen = []

    def hook(_mod, args):
        seen.append((tuple(args[0].permute(0, 2, 3, 1).shape),
                     len(args) > 1 and args[1] is not None))

    norms = [m for m in gd.model.modules() if isinstance(m, GroupNormFilmSiLU)]
    handles = [m.register_forward_pre_hook(hook) for m in norms]
    try:
        s = gd.image_size
        x = torch.randn(batch, s, s, 1, device="cuda")
        feat = gd.encode_cond(torch.rand(batch, s, s, 1, device="cuda") * 2)
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


def phase_kernel(gd) -> dict:
    """The kernel against its plain version at the main path's shapes; the
    times are summed over the launches of one UNet call (batch 128)."""
    launches = gn_launch_shapes(gd, 2 * BATCH)
    if len(launches) != GN_LAUNCHES_PER_UNET_CALL:
        raise RuntimeError(f"{len(launches)} GroupNorm launches per UNet call, "
                           f"expected {GN_LAUNCHES_PER_UNET_CALL}")
    counts = {}
    for key in launches:
        counts[key] = counts.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    totals = dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, group_norm_ms=0.0,
                  bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    for (shape, film), n in sorted(counts.items()):
        for dtype in (torch.float32, torch.bfloat16):
            x, g, b, s, h = _gn_inputs(shape, film, dtype, gen)
            got = groupnorm_film_silu(x, g, b, s, h, groups=8)
            torch.cuda.synchronize()
            want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
            err = (got.float() - want.float()).abs().max().item()
            tol = GN_TOL[dtype]
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            max_err[dtype] = max(max_err[dtype], err)
            log(f"kernel {list(shape)} film={film} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {tol:g} abs+rel) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"kernel disagrees with its plain version at {shape}")
            if dtype != torch.float32:
                continue  # the flagship runs float32: time that
            k_eager, k_ms = cuda_ms(lambda: groupnorm_film_silu(x, g, b, s, h, groups=8))
            _, p_ms = cuda_ms(lambda: groupnorm_film_silu_reference(x, g, b, s, h, groups=8))
            xc = x.permute(0, 3, 1, 2)  # NCHW view (channels_last)
            _, l_ms = cuda_ms(lambda: F.group_norm(xc, 8, g, b, eps=1e-5))
            bytes_moved = 2 * x.numel() * x.element_size() + 2 * g.numel() * 4
            if film:
                bytes_moved += 2 * s.numel() * 4
            bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
            ops_ms = 1e3 * GN_OPS_PER_ELEMENT * x.numel() / FP32_OPS_PER_S
            bound = max(bytes_ms, ops_ms)
            log(f"  device times, x{n} per UNet call: kernel {k_ms * 1e3:.2f}us "
                f"(eager from Python {k_eager * 1e3:.2f}us) plain {p_ms * 1e3:.2f}us "
                f"F.group_norm {l_ms * 1e3:.2f}us bound {bound * 1e3:.2f}us "
                f"({bytes_moved / 1e6:.2f} MB)")
            totals["ms"] += n * k_ms
            totals["eager_ms"] += n * k_eager
            totals["plain_ms"] += n * p_ms
            totals["group_norm_ms"] += n * l_ms
            totals["bound_ms"] += n * bound
            totals["bytes_ms"] += n * bytes_ms
            totals["ops_ms"] += n * ops_ms
    log(f"kernel per UNet call (32 launches, f32, device): kernel {totals['ms']:.4f}ms "
        f"(eager {totals['eager_ms']:.4f}ms) "
        f"plain {totals['plain_ms']:.4f}ms F.group_norm {totals['group_norm_ms']:.4f}ms "
        f"bound {totals['bound_ms']:.4f}ms; max_abs_err f32 {max_err[torch.float32]:.3g} "
        f"bf16 {max_err[torch.bfloat16]:.3g}")
    return dict(totals, max_abs_err=max_err[torch.float32],
                max_abs_err_bf16=max_err[torch.bfloat16])


def _check_images(name, pred, shape, lo=0.0, hi=2.0):
    if pred.shape != shape or not np.all(np.isfinite(pred)):
        raise RuntimeError(f"{name}: shape {pred.shape} or non-finite values")
    if pred.min() < lo - 1e-5 or pred.max() > hi + 1e-5:
        raise RuntimeError(f"{name}: values outside [{lo}, {hi}]")


def phase_main_path(pipe, lr, hr, mask):
    """The counted run: translate at batch 64, then three served requests."""
    gd = pipe.gd
    T = gd.num_timesteps
    pipe.translate(lr, hr=hr, noise=1, mask=mask)  # warm-up (not counted)
    torch.cuda.synchronize()

    groupnorm_film_silu.launches = 0
    res = pipe.translate(lr, hr=hr, noise=1, mask=mask)
    after_chain = groupnorm_film_silu.launches
    s = pipe.config.sampler.start_timestep
    dt = float(res["time"])
    steps = BATCH * (2 * (T - s) + s)  # a branched step counts as two
    log(f"chain: branched={bool(res['branched'])} {dt * 1e3:.1f}ms for {BATCH} images "
        f"-> {BATCH / dt:.2f} img/s, {steps / dt:.1f} model-steps/s; "
        f"mse {float(res['mse']):.4f} ssim {float(res['ssim']):.4f} "
        f"psnr {float(res['psnr']):.2f}; kernel launches {after_chain}")
    if not bool(res["branched"]):
        raise RuntimeError("the manual mask must take the branched chain")
    if after_chain != GN_LAUNCHES_PER_UNET_CALL * T:
        raise RuntimeError(f"{after_chain} kernel launches, expected "
                           f"{GN_LAUNCHES_PER_UNET_CALL} x {T} UNet calls")
    _check_images("chain", res["pred"], lr.shape)

    s_ = gd.image_size
    ones = np.ones((s_, s_, 1), np.float32)
    srv = InferenceServer(pipe, batch_size=SERVE_BATCH, max_wait_ms=200)
    reqs = [(lr[0], ones), (lr[1], mask[1]), (lr[2], None)]  # None: manual detector
    futs = [srv.submit(x, m) for x, m in reqs]
    t0 = time.perf_counter()
    with srv:
        outs = [f.result(timeout=300) for f in futs]
    served_s = time.perf_counter() - t0
    launches = groupnorm_film_silu.launches
    stats = srv.snapshot_stats()
    log(f"serving: {stats['requests']} requests in {stats['batches']} batch(es), "
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
        _check_images(f"served request {i}", o["pred"], (s_, s_, 1))
    if launches - after_chain != GN_LAUNCHES_PER_UNET_CALL * T * dispatches:
        raise RuntimeError(f"{launches - after_chain} kernel launches while serving")
    log(f"main path: kernel launches {launches} "
        f"(chain {after_chain} + serving {launches - after_chain})")
    return res, launches


def phase_check(pipe, lr, mask, res):
    """The kernel chain against the plain-GroupNorm chain on the card, and a
    small batch against the same chain on the CPU."""
    gd = pipe.gd
    gd.model.use_plain_groupnorm(True)
    try:
        plain = pipe.translate(lr, noise=1, mask=mask)
    finally:
        gd.model.use_plain_groupnorm(False)
    err = float(np.abs(plain["pred"] - res["pred"]).max())
    log(f"check: kernel chain vs plain-GroupNorm chain max_abs_err {err:.3g} "
        f"(tol {CHAIN_TOL:g})")
    if not err <= CHAIN_TOL:
        raise RuntimeError("the kernel chain disagrees with the plain-GroupNorm chain")

    cfg = pipe.config
    cpu_gd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cpu")
    cpu_gd.model.load_state_dict({k: v.cpu() for k, v in gd.model.state_dict().items()})
    cpu_pipe = LocalDiffusionPipeline(cfg, cpu_gd)
    rng = np.random.default_rng(2)
    shape = (2, gd.image_size, gd.image_size, 1)
    stream = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(gd.num_timesteps + 1)]
    on_card = pipe.translate(lr[:2], noise=ArrayNoise(stream, "cuda"), mask=mask[:2])
    on_cpu = cpu_pipe.translate(lr[:2], noise=ArrayNoise(stream, "cpu"), mask=mask[:2])
    err_cpu = float(np.abs(on_card["pred"] - on_cpu["pred"]).max())
    log(f"check: card vs CPU (batch 2, same weights and noise) max_abs_err "
        f"{err_cpu:.3g} (tol {CHAIN_TOL:g})")
    if not err_cpu <= CHAIN_TOL:
        raise RuntimeError("the card's chain disagrees with the CPU's")


def phase_profile(pipe, lr, mask) -> None:
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
    log(f"profile: chain {wall_us / 1e3:.1f}ms wall (profiled), card busy "
        f"{busy_us / 1e3:.1f}ms = {100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.2f}ms {e.count:6d}x  {e.key[:100]}")


def main() -> None:
    phase_device()
    phase_build()

    cfg = flagship_config()
    gd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cuda")
    pipe = LocalDiffusionPipeline(cfg, gd)
    log(f"model: flagship UNet dim {cfg.model.dim} mults {cfg.model.dim_mults}, "
        f"{sum(p.numel() for p in gd.model.parameters())} params (seeded random), "
        f"T={gd.num_timesteps}, {cfg.diffusion.beta_schedule}, {cfg.diffusion.objective}")

    gn = phase_kernel(gd)

    rng = np.random.default_rng(0)
    s = gd.image_size
    lr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    mask = manual_mask((BATCH, s, s, 1), cfg.ood.manual_mask_cols)
    res, launches = phase_main_path(pipe, lr, hr, mask)
    phase_check(pipe, lr, mask, res)
    phase_profile(pipe, lr, mask)

    print(json.dumps({"kernels": [{
        "name": "groupnorm_film_silu",
        "route": "cuda",
        "source": "localdiffusion_tpu_torch/csrc/groupnorm_film_silu.cu",
        "replaces": "localdiffusion_tpu/ops/pallas_groupnorm.py:74",
        "launches": launches,
        "max_abs_err": gn["max_abs_err"],
        "ms": gn["ms"],
        "plain_ms": gn["plain_ms"],
        "bound_ms": gn["bound_ms"],
        "bound_by": "bytes" if gn["bytes_ms"] >= gn["ops_ms"] else "operations",
        "library_ms": None,
        "group_norm_ms": gn["group_norm_ms"],
        "max_abs_err_bf16": gn["max_abs_err_bf16"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
