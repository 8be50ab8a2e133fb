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
   version, `F.group_norm` alone and the memory bound, per site with its
   launch plan (blocks a row); row 0 alone against row 0 in the batch, bit
   for bit;
4. flagship main path: with every launch count at 0, `translate` on the
   flagship (seeded random weights, T=50, f32) at batch 64 with the manual
   mask, then an `InferenceServer` answering three requests; the counts
   are read right after and every kernel's launches checked;
5. flagship check: the same chain with every kernel's plain version on the
   card, and a small batch on the CPU, against the kernel chain;
6. flagship profile: one chain under torch.profiler;
7. 256px kernels: each kernel of the 256px MRI chain against its plain
   version at the shapes that chain gives it (one UNet call at batch 8 is
   recorded by hooks): full attention [8,1024,4,32] in bf16 and f32 (and
   `scaled_dot_product_attention` timed beside it, and the time its
   exponentials need on the special-function units), the linear-attention
   kv and q kernels at the six linear-attention sites (each bound by the
   largest of its bytes, tensor operations and exponentials; the merge and
   fold between them; kv, q and the whole function at batch 4 and 8), the
   fused ResnetBlock's conv3x3_stats (pass 1, pass 2)
   and epilogue at the six shapes of its 13 blocks (up3's two blocks and
   the final block share one), each pass held against its plain
   version and three emulated faults held above the bars, the whole fused
   block against its plain version and beside the unfused block (cuDNN
   convolutions, the GroupNorm kernels, the adds), the GroupNorm op at the
   14 Block shapes outside the fused gate (the single-pass kernel at
   32x32x128, the tiled stats/apply pair past the row gate at 32x32x256,
   each pass held on its own and timed both with L2 flushed before each
   call and replayed from a CUDA graph), all in bf16; a row alone
   against the same row in the batch, bit for bit, for linear attention,
   the fused block, its epilogue, the single-pass GroupNorm and the tiled
   pair (its row sums and its output); errors
   against tolerances, times and bounds, summed per UNet call and per site
   (the epilogue's six, the single-pass GroupNorm's with its plan); one
   whole UNet call at batch 8, eager (host included);
8. 256px main path: with every count at 0, `translate` on the 256px chain
   (full width, seeded random weights, T=250, bf16, branched, the JAX
   package's default fused-ResnetBlock layout) at batch 4 with a given
   disc mask, then an `InferenceServer` answering three 256px requests;
   checks each kernel's launches per UNet call;
9. 256px check: the chain against the same chain with every kernel's plain
   version on the card (same noise), and one UNet call against the CPU;
10. 256px profile: one chain under torch.profiler;
11. Stage A (the 256px configuration's detector: PatchCore over the
    denoiser's down2_block2 and down3_block2 taps at t=5, bf16, the same
    seeded random weights): (a) a bank at the deployment's size, 200
    normal synthetic brains → 819,200 patches → a 10% k-center coreset of
    81,920 × 192, and its ladder fitted on their maps, through
    `ood.bank.build_bank` (seconds of the taps, k-center and the ladder);
    (b) Stage A on 2 tumour brains, card against CPU with the same weights
    and bank in float32 and bf16, and with the kernels against their plain
    versions on the card; (c) k-center on the card against the CPU on a
    20,000 × 192 embedding, k = 2,000, one projection: the same rows;
    (d) with every count at 0, `translate` without a mask on 4 tumour
    brains (the bank and ladder found by `build_frontend`): Stage A, split
    into the feature pass, the nearest-neighbour search, the map and the
    host's ladder and refinement, then the branched bf16 chain, Stage A's
    launches counted apart from Stage B's; then an `InferenceServer`
    answering four requests without masks in two batches, the second's
    Stage A overlapping the first's chain;
12. stem kernels: the s2d-stem configuration (`stem256_config()`, the
    README's recommended 256px deployment: f32, DDIM-50, plain chain) at
    full width, one UNet call at batch 8 recorded: the GroupNorm op at its
    40 Block shapes (the tiled pair at the 14 past the row gate) and full
    attention at its three 16x16 sites, f32, against their plain versions,
    timed as in phase 7;
13. stem main path: with every count at 0, the plain DDIM-50 chain at batch
    4 (detector none), the branched DDIM-50 chain with disc masks, then an
    `InferenceServer` answering three requests; every kernel's launches
    checked per UNet call;
14. stem check: both chains against the same chains with every kernel's
    plain version (same noise), and one UNet call against the CPU, f32;
15. stem profile: the plain chain under torch.profiler.

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
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.config import flagship_config, mri256_config, stem256_config
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, build_gd
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise
from localdiffusion_tpu_torch.factory import build_frontend
from localdiffusion_tpu_torch.models.blocks import (
    Attention,
    GroupNormFilmSiLU,
    LinearAttention,
    ResnetBlock,
)
from localdiffusion_tpu_torch.ood.bank import build_bank, calibration_images
from localdiffusion_tpu_torch.ood.features import DenoiserFeatureSource
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import (
    PatchCore,
    kcenter_greedy_indices,
    random_projection,
)
from localdiffusion_tpu_torch.ood.thresholds import manual_mask, near_threshold
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer

KERNELS = ("groupnorm_film_silu", "groupnorm_tiled", "flash_attention", "linear_attention",
           "resnet_block")
COUNTERS = {
    "groupnorm_film_silu": groupnorm_film_silu,  # the single-pass kernel
    "gn_tiled_stats": G.gn_tiled_stats,
    "gn_tiled_apply": G.gn_tiled_apply,
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
STEM_BATCH = 4  # s2d-stem chain: an [8] UNet batch in the branched phase
STEM_SERVE_BATCH = 4
# launches per UNet call of every kernel on each path (0 where absent)
FLAGSHIP_PER_CALL = {"groupnorm_film_silu": 32}  # 2 Blocks x 16 ResnetBlocks
# per 256px UNet call: 3 full-attention sites, 6 linear-attention sites, 13
# fused ResnetBlocks (2 conv3x3_stats and an epilogue each) and 2 Blocks x 7
# unfused ResnetBlocks at 32x32: down3's 4 GN at 32x32x128 (512 KiB, the
# single-pass kernel), the mid blocks', conv_fusion's and up0's 10 at
# 32x32x256 (1 MiB, past the row gate: the tiled pair)
MRI_PER_CALL = {"groupnorm_film_silu": 4, "gn_tiled_stats": 10, "gn_tiled_apply": 10,
                "flash_attention": 3, "linear_attention_kv": 6, "linear_attention_q": 6,
                "conv3x3_stats": 26, "epilogue": 13}
MRI_FUSED_BLOCKS, MRI_UNFUSED_BLOCKS = 13, 7
# per s2d-stem UNet call (f32: no ResnetBlock fuses, linear attention takes
# the plain module): 40 GN, of which down0's, up2's, up3's and the final
# block's 14 are past the row gate (128x128x32 and 64x64x64) and 26 are not
# (down1's 64x64x32 sits exactly at it); full attention at the three 16x16
# sites (256 tokens)
STEM_PER_CALL = {"groupnorm_film_silu": 26, "gn_tiled_stats": 14, "gn_tiled_apply": 14,
                 "flash_attention": 3}
# H100 SXM data-sheet peaks: device memory, float32 outside the tensor cores,
# bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# exponentials per clock per SM on the special-function units (CUDA C++
# programming guide, arithmetic instruction throughput, compute capability 9.0)
SFU_EXP_PER_CLOCK_PER_SM = 16
GN_OPS_PER_ELEMENT = 14  # stats 4, normalize+affine 3, FiLM 2, SiLU 5
GN_STATS_OPS_PER_ELEMENT = 3  # tiled pair: sum, square, sum of squares
GN_APPLY_OPS_PER_ELEMENT = 8  # normalize+affine 3, SiLU 5; FiLM adds 2
# GN kernel vs plain version: float32 differs only by summation order;
# bfloat16 may differ by one rounding step of the output (2^-8 relative)
GN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the tiled pair vs its plain version: float32 3e-5, the JAX package's bar
# for its tiled kernel (tests/test_pallas_kernels.py); bfloat16 one output
# step.  Its row sums [B, 2, C], per row, relative norm against the plain
# sums: 1e-5, where a sound kernel reads 0 but for a rare tie (both sum in
# float64 and round once) and one dropped slice of 8 reads above 1e-2
GN_TILED_F32_TOL = 3e-5
GN_PARTIALS_TOL = 1e-5
# read between the timed calls of `cold_ms`: five times the card's 50 MiB L2
L2_FLUSH_BYTES = 256 * 2**20
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
# the kv kernel's merged rows, each against its own size (see `kv_errors`):
# m one bf16 step, l 1e-3 and G 5e-3 relative norm, where a sound kernel
# reads l ≤ 1e-6 and G ≤ 5e-4 at these sites (NVIDIA H100 80GB HBM3, 700 W)
# and a block's partial dropped or merged twice moves a row by its share
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
# Stage A of the 256px configuration (PatchCore over the denoiser's taps at
# t=5, down2_block2 ⊕ down3_block2 = 192 channels at 64x64): the bank of 200
# normal brains, 819,200 patches, a 10% k-center coreset; per detect call the
# down path to down3_block2 launches down3's 4 single-pass GN (2 unfused
# blocks at 32x32x128), down0-2's 3 linear-attention sites (kv and q) and 6
# fused blocks (12 conv3x3_stats, 6 epilogues).  Card vs CPU in float32:
# maps within 1e-4 relative L2, binary masks equal but for images with a
# map value within 1e-4 of one of their thresholds; in bf16 (and kernels
# against plain versions) the one-UNet-call bars above.  k-center: the same
# rows on the card and the CPU (float64 distances rounded to float32).
STAGE_A_CALIB, STAGE_A_BANK_SHAPE = 200, (81_920, 192)
STAGE_A_PER_DETECT = {"groupnorm_film_silu": 4, "linear_attention_kv": 3,
                      "linear_attention_q": 3, "conv3x3_stats": 12, "epilogue": 6}
STAGE_A_F32_REL, STAGE_A_NEAR = 1e-4, 1e-4
KCENTER_CHECK = (20_000, 2_000)  # rows, k
STAGE_A_SERVE_BATCH = 2  # four requests, two batches: the second's Stage A overlaps
STAGE_A_WAVE_S = 0.5  # between them: past the first batch's Stage A
STAGE_A_DIR = Path(__file__).resolve().parent / "build" / "stage_a"
# s2d stem, float32.  The DDIM-50 chains, kernels vs plain versions (same
# noise), and one UNet call, card vs CPU: float32 sums in another order
# (~1e-6 per call) through 50 DDIM updates: relative L2 <= 1e-3, and for
# the UNet call 1e-3 abs+rel
STEM_CHAIN_REL, STEM_UNET_F32_TOL = 1e-3, 1e-3

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


def cold_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device ms of fn() with its inputs out of L2, as a bound on device
    memory assumes: each call after a sum over `L2_FLUSH_BYTES` (reads, so
    L2 is left holding clean lines of it), captured in a CUDA graph and
    replayed (`cuda_ms`), less the same graph of the sums alone (the mean of
    one replay before and one after).  What fn writes may stay in L2, as it
    does on the main path."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")

    def alone():
        torch.sum(flush, 0, out=sink)

    def both():
        torch.sum(flush, 0, out=sink)
        fn()

    before = cuda_ms(alone, iters, reps)[1]
    t = cuda_ms(both, iters, reps)[1]
    return t - (before + cuda_ms(alone, iters, reps)[1]) / 2


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> tuple:
    """(bound ms, 'bytes' or 'operations')."""
    b_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    o_ms = 1e3 * ops / ops_per_s
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


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


def _gn_close(got, want, tiled) -> tuple:
    """(max abs error, within tolerance?) of a GN output against its plain
    version: `GN_TOL` for the single-pass kernel; for the tiled pair 3e-5 in
    float32 and one output step in bfloat16 (`bf16_steps`)."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        ok = (bf16_steps(got, want) <= 1.0 if tiled
              else torch.allclose(got.float(), want.float(), rtol=GN_TOL[got.dtype],
                                  atol=GN_TOL[got.dtype]))
    else:
        tol = GN_TILED_F32_TOL if tiled else GN_TOL[got.dtype]
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
    return err, bool(ok)


def gn_kernel_phase(launches, dtypes, time_dtype, label, iters=(20, 10)) -> dict:
    """The GN op at each (shape, FiLM) of one UNet call: below the row gate
    the single-pass kernel, past it the tiled pair, each against its plain
    version.  For the pair also each pass on its own: the stats pass's row
    sums per row against the plain sums of the same slices (relative norm <=
    `GN_PARTIALS_TOL`, which one dropped slice fails), the apply pass against
    its plain version on the kernel's sums, and row 0 alone against row 0 in
    the batch, bit for bit, in the sums and the output.  Times summed over
    the call's launches, in `time_dtype`: each kernel, its plain version,
    the memory and operation bounds; per op (single pass, tiled pair) also
    `F.group_norm` alone.  A kernel's `ms` is a CUDA-graph replay, where a
    row that fits in L2 stays there between calls; for the tiled passes,
    whose rows reach 16 MiB and whose apply would read x from L2 below its
    device-memory bound, `ms` is `cold_ms` (L2 flushed before each call)
    and the replay is `warm_ms`."""
    counts = {}
    for key in launches:
        counts[key] = counts.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {dt: 0.0 for dt in dtypes}
    zero = lambda: dict(ms=0.0, warm_ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        bytes_ms=0.0, ops_ms=0.0, group_norm_ms=0.0, launches=0,
                        max_abs_err=0.0)
    parts = {k: zero() for k in ("single", "stats", "apply", "pair")}
    for key in ("single", "stats", "apply"):
        parts[key]["by_site"] = []
    worst_sums = 0.0
    for (shape, film), n in sorted(counts.items()):
        tiled = G.large_block(shape)
        b, hh, ww, c = shape
        for dtype in dtypes:
            x, g, bt, s, h = _gn_inputs(shape, film, dtype, gen)
            got = groupnorm_film_silu(x, g, bt, s, h, groups=8)
            torch.cuda.synchronize()
            err, ok = _gn_close(got, G.groupnorm_film_silu_plain(x, g, bt, s, h, groups=8),
                                tiled)
            max_err[dtype] = max(max_err[dtype], err)
            extra = ""
            if not tiled:
                plan = G.gn_plan(hh, ww, c, 8, x.element_size())
                alone = groupnorm_film_silu(x[:1].clone(), g, bt,
                                            *(t[:1].clone() if t is not None else None
                                              for t in (s, h)), groups=8)
                torch.cuda.synchronize()
                batch_free = torch.equal(alone, got[:1])
                ok = ok and batch_free
                extra = (f"; {plan['k']} blocks a row of {plan['pixels']} px "
                         f"({'resident' if plan['resident'] else 'streamed'}), row 0 alone "
                         f"{'= row 0 in the batch' if batch_free else 'DIFFERS'}")
            if tiled:
                tplan = G.gn_tiled_plan(hh, ww, c, dtype)
                sums = G.gn_tiled_stats(x)
                applied = G.gn_tiled_apply(x, sums, g, bt, s, h, groups=8)
                alone = groupnorm_film_silu(x[:1].clone(), g, bt,
                                            *(t[:1].clone() if t is not None else None
                                              for t in (s, h)), groups=8)
                sums_alone = G.gn_tiled_stats(x[:1].clone())
                torch.cuda.synchronize()
                plain_sums = G.tiled_stats_reference(x)
                rel = ((sums - plain_sums).flatten(1).norm(dim=1)
                       / plain_sums.flatten(1).norm(dim=1)).max().item()
                p_err = (sums - plain_sums).abs().max().item()
                a_err, a_ok = _gn_close(applied, G.tiled_apply_reference(
                    x, sums, g, bt, s, h, groups=8), True)
                batch_free = torch.equal(alone, got[:1]) and torch.equal(sums_alone, sums[:1])
                worst_sums = max(worst_sums, rel)
                if dtype == time_dtype:
                    parts["stats"]["max_abs_err"] = max(parts["stats"]["max_abs_err"], p_err)
                    parts["apply"]["max_abs_err"] = max(parts["apply"]["max_abs_err"], a_err)
                ok = ok and rel <= GN_PARTIALS_TOL and a_ok and batch_free
                extra = (f"; stats a cluster of {tplan['k']} blocks a row of "
                         f"{tplan['pixels']} px, apply tiles of {tplan['apply_pixels']} px; "
                         f"row sums rel {rel:.3g} per row (tol {GN_PARTIALS_TOL:g}), apply "
                         f"on them {a_err:.3g}, row 0 alone "
                         f"{'= row 0 in the batch' if batch_free else 'DIFFERS'} "
                         "(sums and output)")
            log(f"{label} GN {list(shape)} film={film} {str(dtype)[6:]} "
                f"{'tiled pair' if tiled else 'single pass'}: max_abs_err {err:.3g}{extra} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"GN kernels disagree with their plain versions at {shape}")
            if dtype != time_dtype:
                continue
            xc = x.permute(0, 3, 1, 2)  # NCHW view (channels_last)
            gc, bc = g.to(dtype), bt.to(dtype)
            _, l_ms = cuda_ms(lambda: F.group_norm(xc, 8, gc, bc, eps=1e-5), *iters)
            esize, film_bytes = x.element_size(), (2 * s.numel() * 4 if film else 0)
            param_bytes = 2 * g.numel() * 4 + film_bytes
            if not tiled:
                k_eager, k_ms = cuda_ms(lambda: groupnorm_film_silu(x, g, bt, s, h, groups=8),
                                        *iters)
                _, p_ms = cuda_ms(lambda: groupnorm_film_silu_reference(x, g, bt, s, h,
                                                                        groups=8), *iters)
                rows = {"single": (k_ms, k_eager, p_ms, 2 * x.numel() * esize + param_bytes,
                                   GN_OPS_PER_ELEMENT * x.numel())}
                warm = {"single": k_ms}
                parts["single"]["group_norm_ms"] += n * l_ms
                parts["single"]["by_site"].append(dict(
                    shape=list(shape), film=film, launches=n, k=plan["k"],
                    pixels=plan["pixels"], resident=plan["resident"], ms=k_ms, plain_ms=p_ms,
                    bound_ms=max(1e3 * rows["single"][3] / HBM_BYTES_PER_S,
                                 1e3 * rows["single"][4] / FP32_OPS_PER_S)))
            else:
                pb = sums.numel() * 4
                apply_ops = (GN_APPLY_OPS_PER_ELEMENT + (2 if film else 0)) * x.numel()
                timed = {
                    "stats": (lambda: G.gn_tiled_stats(x), lambda: G.tiled_stats_reference(x),
                              x.numel() * esize + pb, GN_STATS_OPS_PER_ELEMENT * x.numel()),
                    "apply": (lambda: G.gn_tiled_apply(x, sums, g, bt, s, h, groups=8),
                              lambda: G.tiled_apply_reference(x, sums, g, bt, s, h, groups=8),
                              2 * x.numel() * esize + pb + param_bytes, apply_ops),
                    "pair": (lambda: groupnorm_film_silu(x, g, bt, s, h, groups=8),
                             lambda: G.groupnorm_film_silu_plain(x, g, bt, s, h, groups=8),
                             2 * x.numel() * esize + param_bytes,
                             (GN_STATS_OPS_PER_ELEMENT + GN_APPLY_OPS_PER_ELEMENT
                              + (2 if film else 0)) * x.numel()),
                }
                rows, warm = {}, {}
                for key, (fn, plain_fn, nbytes, ops) in timed.items():
                    k_eager, warm[key] = cuda_ms(fn, *iters)
                    _, p_ms = cuda_ms(plain_fn, *iters)
                    rows[key] = (cold_ms(fn), k_eager, p_ms, nbytes, ops)
                parts["pair"]["group_norm_ms"] += n * l_ms
                parts["pair"]["max_abs_err"] = max(parts["pair"]["max_abs_err"], err)
                parts["stats"]["by_site"].append(dict(
                    shape=list(shape), film=film, launches=n, k=tplan["k"],
                    pixels=tplan["pixels"], ms=rows["stats"][0], warm_ms=warm["stats"],
                    bound_ms=max(rows["stats"][3] / HBM_BYTES_PER_S,
                                 rows["stats"][4] / FP32_OPS_PER_S) * 1e3))
                parts["apply"]["by_site"].append(dict(
                    shape=list(shape), film=film, launches=n,
                    apply_pixels=tplan["apply_pixels"], ms=rows["apply"][0],
                    warm_ms=warm["apply"],
                    bound_ms=max(rows["apply"][3] / HBM_BYTES_PER_S,
                                 rows["apply"][4] / FP32_OPS_PER_S) * 1e3))
            if not tiled:
                parts["single"]["max_abs_err"] = max(parts["single"]["max_abs_err"], err)
            for key, (k_ms, k_eager, p_ms, nbytes, ops) in rows.items():
                b_ms, o_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
                t = parts[key]
                for k2, v in (("ms", k_ms), ("warm_ms", warm[key]), ("eager_ms", k_eager),
                              ("plain_ms", p_ms),
                              ("bound_ms", max(b_ms, o_ms)), ("bytes_ms", b_ms),
                              ("ops_ms", o_ms)):
                    t[k2] += n * v
                t["launches"] += n
            log(f"  device us/launch, x{n} per UNet call: "
                + "; ".join(f"{key} {r[0] * 1e3:.2f} ("
                            + (f"L2 flushed; replayed {warm[key] * 1e3:.2f}, " if tiled else "")
                            + f"eager {r[1] * 1e3:.2f}, plain "
                            f"{r[2] * 1e3:.2f}, bound "
                            f"{max(r[3] / HBM_BYTES_PER_S, r[4] / FP32_OPS_PER_S) * 1e6:.2f})"
                            for key, r in rows.items())
                + f"; F.group_norm {l_ms * 1e3:.2f} ({x.numel() * esize / 1e6:.2f} MB of x)")
    for t in parts.values():
        t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations"
    log(f"{label} GN per UNet call ({len(launches)} ops, {str(time_dtype)[6:]}, device): "
        + "; ".join(f"{key} x{t['launches']} {t['ms']:.4f}ms ("
                    + (f"replayed {t['warm_ms']:.4f}, " if key != "single" else "")
                    + f"eager {t['eager_ms']:.4f}) plain "
                    f"{t['plain_ms']:.4f} bound {t['bound_ms']:.4f} ({t['bound_by']})"
                    + (f" F.group_norm {t['group_norm_ms']:.4f}" if key in ("single", "pair")
                       else "")
                    for key, t in parts.items() if t["launches"])
        + "; max_abs_err " + " ".join(f"{str(dt)[6:]} {e:.3g}" for dt, e in max_err.items())
        + f"; row sums worst rel {worst_sums:.3g}")
    return dict(parts, max_abs_err=max_err[time_dtype], worst_sums=worst_sums,
                max_abs_err_by_dtype={str(dt)[6:]: e for dt, e in max_err.items()})


def check_gn_sites(sites, per_call, label) -> None:
    """The GN ops one UNet call recorded split at the row gate as `per_call`
    says: single-pass launches below it, one stats and one apply past it."""
    large = sum(G.large_block(shape) for shape, _ in sites)
    got = {"groupnorm_film_silu": len(sites) - large, "gn_tiled_stats": large,
           "gn_tiled_apply": large}
    if any(per_call.get(k, 0) != v for k, v in got.items()):
        raise RuntimeError(f"{label}: GN ops per UNet call {got}, expected {per_call}")
    log(f"{label} UNet call: {len(sites)} GN ops, {len(sites) - large} single pass and {large} "
        f"past the row gate (shapes {sorted({(s, G.large_block(s)) for s, _ in sites})})")


def _check_images(name, pred, shape, lo, hi):
    if pred.shape != shape or not np.all(np.isfinite(pred)):
        raise RuntimeError(f"{name}: shape {pred.shape} or non-finite values")
    if pred.min() < lo - 1e-5 or pred.max() > hi + 1e-5:
        raise RuntimeError(f"{name}: values outside [{lo}, {hi}]")


def check_counts(got: dict, per_call: dict, calls: int, what: str) -> None:
    """Every kernel's launches in `got` equal its launches per UNet call
    (`per_call`, 0 where absent) times `calls`."""
    for name, n in got.items():
        if n != per_call.get(name, 0) * calls:
            raise RuntimeError(f"{what}: {name} launched {n} times, expected "
                               f"{per_call.get(name, 0)} x {calls} UNet calls")


def run_main_path(pipe, lr, hr, chains, per_call, serve_batch, label):
    """The counted run: with every count at 0, `translate` once per entry of
    `chains` (mask, whether it must take the branched chain), then three
    served requests (uniform mask: plain; the last chain's mask of row 1;
    of row 2 or, for the manual detector, none).  Checks every kernel's
    launches per UNet call in each chain and while serving; the UNet rows
    of each chain (a branched call counts its two halves) are counted by a
    hook for model-steps/s."""
    gd = pipe.gd
    calls = gd.diff_cfg.resolved_sampling_timesteps  # UNet calls per chain (DDPM or DDIM)
    lo, hi = pipe.min_max_val
    b = lr.shape[0]
    rows = [0]
    hook = gd.model.register_forward_pre_hook(
        lambda _m, args: rows.__setitem__(0, rows[0] + args[0].shape[0]))
    results, perf = [], {}
    reset_counts()
    try:
        for mask, want_branched in chains:
            before, rows[0] = read_counts(), 0
            res = pipe.translate(lr, hr=hr, noise=1, mask=mask)
            got = {k: v - before[k] for k, v in read_counts().items()}
            dt = float(res["time"])
            kind = "branched" if want_branched else "plain"
            log(f"{label} {kind} chain: {dt * 1e3:.1f}ms for {b} images -> {b / dt:.3f} img/s, "
                f"{rows[0] / dt:.1f} model-steps/s ({rows[0]} UNet rows in {calls} calls); "
                f"mse {float(res['mse']):.4f} ssim {float(res['ssim']):.4f} "
                f"psnr {float(res['psnr']):.2f}; launches {got}")
            if bool(res["branched"]) != want_branched:
                raise RuntimeError(f"{label}: the {kind} chain took the wrong sampler")
            check_counts(got, per_call, calls, f"{label} {kind} chain")
            _check_images(f"{label} {kind} chain", res["pred"], lr.shape, lo, hi)
            results.append(res)
            perf[kind] = dict(chain_s=dt, img_per_s=b / dt, model_steps_per_s=rows[0] / dt)
    finally:
        hook.remove()
    chain_counts = read_counts()

    s_ = gd.image_size
    ones = np.ones((s_, s_, 1), np.float32)
    mask = chains[-1][0]
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
    check_counts({k: v - chain_counts[k] for k, v in counts.items()}, per_call,
                 calls * dispatches, f"{label} serving")
    log(f"{label} main path: launches {counts} (chains {chain_counts})")
    perf["serve_latency_mean_s"] = stats["latency_mean_s"]
    return results, counts, perf


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
    check_gn_sites(seen["gn"], FLAGSHIP_PER_CALL, "flagship")
    gn = gn_kernel_phase(seen["gn"], (torch.float32, torch.bfloat16), torch.float32,
                         "flagship")

    rng = np.random.default_rng(0)
    s = gd.image_size
    lr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    mask = manual_mask((BATCH, s, s, 1), cfg.ood.manual_mask_cols)
    pipe.translate(lr, hr=hr, noise=1, mask=mask)  # warm-up (not counted)
    torch.cuda.synchronize()
    (res,), counts, perf = run_main_path(pipe, lr, hr, [(mask, True)], FLAGSHIP_PER_CALL,
                                         SERVE_BATCH, "flagship")

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

def attention_kernel_phase(seen, expected, dtypes, label) -> dict:
    """The flash kernel against `xla_attention` at the `expected` sites'
    shape (one shape for all), in each of `dtypes`, with q/k/v cut from a
    channels_last qkv projection as `Attention` cuts them.  Times per
    launch."""
    sites = {(s[0], s[2], s[3], m.heads, m.dim_head) for m, s in seen}
    if len(seen) != expected or len(sites) != 1:
        raise RuntimeError(f"full-attention sites: {[s for _, s in seen]}")
    b, h, w, heads, dh = sites.pop()  # the same [B, N, H, D] at every site
    n = h * w
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dtype in dtypes:
        qkv = torch.randn(b, 3 * heads * dh, h, w, generator=gen, device="cuda").to(dtype)
        qkv = qkv.contiguous(memory_format=torch.channels_last)
        q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.reshape(b, 3, heads, dh, n).unbind(1))
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = xla_attention(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        log(f"{label} attention [{b},{n},{heads},{dh}] {str(dtype)[6:]}: max_abs_err {err:.3g} "
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
        # the softmax's exponentials on the special-function units, one per score
        sfu_ms = 1e3 * b * heads * n * n / (
            torch.cuda.get_device_properties(0).multi_processor_count
            * SFU_EXP_PER_CLOCK_PER_SM * max_sm_clock_hz())
        log(f"  device us/launch: kernel {k_ms * 1e3:.2f} (eager {k_eager * 1e3:.2f}) "
            f"plain {p_ms * 1e3:.2f} SDPA {l_ms * 1e3:.2f} bound {bd_ms * 1e3:.2f} ({bd_by}: "
            f"{flops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.2f} MB); exponentials on the SFUs "
            f"{sfu_ms * 1e3:.2f}")
        out[str(dtype)[6:]] = dict(ms=k_ms, eager_ms=k_eager, plain_ms=p_ms, library_ms=l_ms,
                                   bound_ms=bd_ms, bound_by=bd_by, sfu_ms=sfu_ms,
                                   max_abs_err=err)
    return out


def kv_errors(got, want) -> dict:
    """The kv kernel's merged rows (m, l, G) against the plain version's,
    each measured against its own size, row by row.

    m: the relative difference; both are the max of bf16-rounded k, which
    may round one step apart where float32 sums in another order land on a
    rounding boundary (2^-7 relative at most).  l and G are first put on the
    plain version's max (times exp(m − m_plain)), then compared per row as
    relative L2 over l's 128 columns and relative Frobenius over G's C×128.
    A norm over the row, not the largest entry: one token whose k rounds a
    step apart moves one column of G by up to ~2^-7 of a token's share,
    while a fault (a missed rescale, a block's partial dropped or merged
    twice) moves the row.  Also the largest |G/l| difference, the number
    the JSON line reports."""
    (m, l, g), (pm, pl, pg) = got, want
    r = torch.exp(m - pm)
    l, g = l * r, g * r[:, None, :]
    return dict(
        m=((m - pm).abs() / pm.abs().clamp_min(1e-6)).max().item(),
        l=((l - pl).norm(dim=1) / pl.norm(dim=1)).max().item(),
        g=((g - pg).norm(dim=(1, 2)) / pg.norm(dim=(1, 2))).max().item(),
        ctx=(g / l[:, None] - pg / pl[:, None]).abs().max().item(),
    )


def linear_attention_kernel_phase(seen) -> dict:
    """The kv and q kernels against their plain versions, and the whole
    two-pass function against the unfused plain version, at each
    linear-attention site of one 256px UNet call (bf16, the site's own
    random weights); row 0 alone against row 0 in the batch.  Each pass's
    bound is the largest of three floors: its bytes, its tensor operations
    and its exponentials on the special-function units.  Times summed over
    the six sites, and kv, q and the two passes with the fold at batch 4
    and 8."""
    if len(seen) != MRI_PER_CALL["linear_attention_kv"]:
        raise RuntimeError(f"{len(seen)} linear-attention sites, expected 6")
    if not all(cl for _, _, cl in seen):
        raise RuntimeError("a linear-attention input is not channels_last: its NHWC view "
                           f"would be a copy ({[(s, cl) for _, s, cl in seen]})")
    gen = torch.Generator(device="cuda").manual_seed(2)
    sfu_per_s = (torch.cuda.get_device_properties(0).multi_processor_count
                 * SFU_EXP_PER_CLOCK_PER_SM * max_sm_clock_hz())
    floors = ("bytes", "tensor", "sfu")
    tot = {k: dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   **{f"{f}_ms": 0.0 for f in floors}, max_abs_err=0.0) for k in ("kv", "q")}
    whole = dict(ms=0.0, plain_ms=0.0, merge_fold_ms=0.0, max_abs_err=0.0)
    sizing = {bb: [0.0, 0.0, 0.0] for bb in (4, 8)}
    for mod, shape, _ in seen:
        b, h, w, c = shape
        n = h * w
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(torch.bfloat16)
        xr = x.reshape(b, n, c)
        params = (mod.norm.g, mod.to_qkv.weight[:, :, 0, 0].t(),
                  mod.to_out.weight[:, :, 0, 0].t(), mod.to_out.bias, mod.out_norm.g)
        g_in, w_qkv, w_out, b_out, g_out = (p.detach() for p in params)
        wq, wk, wv = LA.split_qkv(w_qkv)
        nb = LA.blocks_per_row(n)
        per = max(e - s for s, e in LA.block_ranges(n, nb))

        m, l, gram = LA.linear_attention_kv(xr, g_in, wk, nb)
        torch.cuda.synchronize()
        kv_err = kv_errors((m, l, gram), LA.kv_reference(xr, g_in, wk, nb))
        err_kv = kv_err["ctx"]
        ok_kv = all(kv_err[k] <= tol for k, tol in KV_TOL.items())
        wtil = LA.fold(l, gram, wv, w_out)
        got = LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out)
        torch.cuda.synchronize()
        want = LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out)
        err_q = (got.float() - want.float()).abs().max().item()
        ok_q = torch.allclose(got.float(), want.float(), **LINATT_TOL)
        full = LA.linear_attention(x, g_in, w_qkv, w_out, b_out, g_out)
        ref = LA.linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out)
        err_full = (full.float() - ref.float()).abs().max().item()
        corr = torch.corrcoef(torch.stack([full.float().ravel(), ref.float().ravel()]))[0, 1]
        ok_full = torch.allclose(full.float(), ref.float(), **LINATT_TOL) and corr > 0.999
        log(f"256px linear attention {list(shape)}: kv "
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

        for bb, acc in sizing.items():
            xb_, x4_ = xr[:bb].contiguous(), x[:bb].contiguous()
            wt_ = LA.fold(*LA.linear_attention_kv(xb_, g_in, wk, nb)[1:], wv, w_out)
            for i, fn in enumerate((
                    lambda: LA.linear_attention_kv(xb_, g_in, wk, nb),
                    lambda: LA.linear_attention_q(xb_, g_in, wq, wt_, b_out, g_out),
                    lambda: LA.linear_attention(x4_, g_in, w_qkv, w_out, b_out, g_out))):
                acc[i] += cuda_ms(fn, 5, 4)[1]

        kv_eager, kv_ms = cuda_ms(lambda: LA.linear_attention_kv(xr, g_in, wk, nb), 5, 4)
        _, kv_plain = cuda_ms(lambda: LA.kv_reference(xr, g_in, wk, nb), 5, 4)
        q_eager, q_ms = cuda_ms(
            lambda: LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out), 5, 4)
        _, q_plain = cuda_ms(
            lambda: LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out), 5, 4)
        _, f_ms = cuda_ms(lambda: LA.linear_attention(x, g_in, w_qkv, w_out, b_out, g_out),
                          5, 4)
        _, f_plain = cuda_ms(
            lambda: LA.linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out), 5, 4)
        xb = x.numel() * 2
        # each input read once, each output written once: kv reads x and Wk
        # and writes m, l and G per row; q reads x, Wq and each row's W~ and
        # writes the output
        bytes_moved = {"kv": xb + c * 128 * 2 + 4 * b * (2 * 128 + c * 128),
                       "q": 2 * xb + c * 128 * 2 + b * 128 * c * 2}
        flops = 4 * b * n * c * 128  # two [N, C] x [C, 128] products per pass
        sfu_ms = 1e3 * b * n * 128 / sfu_per_s  # one exponential per token and column
        for key, ms, eager, plain, err in (("kv", kv_ms, kv_eager, kv_plain, err_kv),
                                           ("q", q_ms, q_eager, q_plain, err_q)):
            fl = {"bytes": 1e3 * bytes_moved[key] / HBM_BYTES_PER_S,
                  "tensor": 1e3 * flops / BF16_OPS_PER_S, "sfu": sfu_ms}
            t = tot[key]
            t["ms"] += ms
            t["eager_ms"] += eager
            t["plain_ms"] += plain
            for f in floors:
                t[f"{f}_ms"] += fl[f]
            t["bound_ms"] += max(fl.values())
            t["max_abs_err"] = max(t["max_abs_err"], err)
            log(f"  {key} device us/launch: kernel {ms * 1e3:.1f} (eager {eager * 1e3:.1f}) "
                f"plain {plain * 1e3:.1f} bound {max(fl.values()) * 1e3:.1f} ("
                + ", ".join(f"{f} {fl[f] * 1e3:.1f}" for f in floors)
                + f"; {max(fl, key=fl.get)})")
        whole["ms"] += f_ms
        whole["plain_ms"] += f_plain
        whole["merge_fold_ms"] += f_ms - kv_ms - q_ms
        whole["max_abs_err"] = max(whole["max_abs_err"], err_full)
        log(f"  whole function device us: two-pass {f_ms * 1e3:.1f}, unfused plain "
            f"{f_plain * 1e3:.1f}; merge + fold (two-pass − kv − q) "
            f"{(f_ms - kv_ms - q_ms) * 1e3:.1f}; launch plan: kv {nb} blocks a row of up to "
            f"{per} tokens in clusters of {LA.CLUSTER}, the cluster with the row's last "
            f"block merging; q a persistent grid of two-warpgroup blocks")
    for key in ("kv", "q"):
        t = tot[key]
        t["bound_floor"] = max(floors, key=lambda f: t[f"{f}_ms"])
        t["bound_by"] = "bytes" if t["bound_floor"] == "bytes" else "operations"
        log(f"256px linear attention {key} per UNet call (6 launches): kernel {t['ms']:.4f}ms "
            f"(eager {t['eager_ms']:.4f}) plain {t['plain_ms']:.4f}ms bound "
            f"{t['bound_ms']:.4f}ms (floors: "
            + ", ".join(f"{f} {t[f'{f}_ms']:.4f}" for f in floors)
            + f"; bound by {t['bound_floor']})")
    log(f"256px linear attention whole per UNet call: two-pass {whole['ms']:.4f}ms "
        f"(merge + fold {whole['merge_fold_ms']:.4f}), unfused plain {whole['plain_ms']:.4f}ms; "
        f"row 0 alone = row 0 in the batch at every site")
    for bb, (kv_t, q_t, tp_t) in sizing.items():
        log(f"256px linear attention at batch {bb}, per UNet call (device): kv {kv_t:.4f}ms "
            f"q {q_t:.4f}ms two passes with the fold {tp_t:.4f}ms")
    for key, i in (("kv", 0), ("q", 1)):
        for bb in (4, 8):
            tot[key][f"batch{bb}_ms"] = sizing[bb][i]
    for bb in (4, 8):
        whole[f"batch{bb}_ms"] = sizing[bb][2]
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
    tot["conv"].update(pass1_ms=0.0, pass2_ms=0.0, by_shape=[])
    tot["epi"]["by_site"] = []
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
            epi_alone = RB.epilogue(h2[:1].clone(), x[:1].clone(), a2[:1].clone(),
                                    c2[:1].clone(), w_res, b_res)
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
        batch_free = torch.equal(alone, full[:1]) and torch.equal(epi_alone, out[:1])
        log(f"256px fused block {list(shape)} -> {cout} (x{count}): "
            + "; ".join(f"{t} h {r[0]:.3g} steps, sums "
                        + " ".join(f"{k} {v:.3g}" for k, v in r[1].items())
                        for t, r in readings.items())
            + f" (bars {RB_TOL['h_steps']:g} step, {RB_TOL['stats']:g}); epilogue max_abs_err "
            f"{epi_err:.3g} {'ok' if ok_epi else 'FAIL'}; block vs plain rel L2 {rel:.3g} corr "
            f"{corr:.6f} {'ok' if ok_block else 'FAIL'}; row 0 alone (epilogue, whole block) "
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
        tot["conv"]["by_shape"].append(dict(
            shape=list(shape), cout=cout, count=count, pass1_ms=p1_ms, pass2_ms=p2_ms,
            pass1_eager_ms=p1_eager, pass2_eager_ms=p2_eager, cudnn_pass1_ms=p1_lib,
            cudnn_pass2_ms=p2_lib))
        wb_ms, wo_ms = 1e3 * block_bytes / HBM_BYTES_PER_S, 1e3 * block_ops / BF16_OPS_PER_S
        for k2, v in (("ms", f_ms), ("plain_ms", f_plain), ("unfused_ms", u_ms),
                      ("bytes_ms", wb_ms), ("ops_ms", wo_ms), ("bound_ms", max(wb_ms, wo_ms))):
            whole[k2] += count * v
        cb1, cb2 = (bound(conv_bytes(ci, aff), conv_ops(ci), BF16_OPS_PER_S)[0]
                    for ci, aff in ((cin, False), (cout, True)))
        plan = RB.epilogue_plan(b, hh * ww, cout, cin, w_res is not None,
                                torch.cuda.get_device_properties(0).multi_processor_count)
        tot["epi"]["by_site"].append(dict(
            shape=list(shape), cout=cout, count=count, res_conv=w_res is not None, ms=e_ms,
            eager_ms=e_eager, plain_ms=e_plain,
            bound_ms=bound(epi_bytes, res_ops, BF16_OPS_PER_S)[0],
            **{k: plan[k] for k in ("per", "blocks", "smem")}))
        log(f"  device us/launch: pass 1 {p1_ms * 1e3:.1f} (eager {p1_eager * 1e3:.1f}, plain "
            f"{p1_plain * 1e3:.1f}, cuDNN conv {p1_lib * 1e3:.1f}, bound {cb1 * 1e3:.1f}); "
            f"pass 2 {p2_ms * 1e3:.1f} (eager {p2_eager * 1e3:.1f}, plain {p2_plain * 1e3:.1f}, "
            f"cuDNN conv {p2_lib * 1e3:.1f}, bound {cb2 * 1e3:.1f}); epilogue {e_ms * 1e3:.1f} "
            f"(eager {e_eager * 1e3:.1f}, plain {e_plain * 1e3:.1f}, bound "
            f"{bound(epi_bytes, res_ops, BF16_OPS_PER_S)[0] * 1e3:.1f}; {plan['blocks']} "
            f"blocks, up to {plan['per']} items a {'warpgroup' if w_res is not None else 'thread'}"
            f"); whole block fused "
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


def unet_call_ms(gd, batch: int, cond_max: float, reps: int = 10) -> float:
    """Eager milliseconds of one UNet call at `batch` rows, host overhead
    included: CUDA events around back-to-back calls after a warm-up."""
    s = gd.image_size
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(batch, s, s, 1, generator=gen, device="cuda")
    feat = gd.encode_cond(torch.rand(batch, s, s, 1, generator=gen, device="cuda") * cond_max)
    t = torch.full((batch,), 10, device="cuda")
    with torch.no_grad():
        for _ in range(2):
            gd.apply_model(x, None, t, cond_feat=feat)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            gd.apply_model(x, None, t, cond_feat=feat)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def disc_masks(b: int, s: int) -> np.ndarray:
    """[b, s, s, 1] masks, each a disc of radius 25 (the synthetic tumour's)
    at its own place."""
    yy, xx = np.mgrid[:s, :s]
    mask = np.zeros((b, s, s, 1), np.float32)
    for i in range(b):
        cy, cx = 90 + 20 * i, 150 - 15 * i
        mask[i, (yy - cy) ** 2 + (xx - cx) ** 2 < 25**2] = 1.0
    return mask


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
    check_gn_sites(seen["gn"], MRI_PER_CALL, "256px")
    attn = attention_kernel_phase(seen["attn"], MRI_PER_CALL["flash_attention"],
                                  (torch.float32, torch.bfloat16), "256px")
    linatt = linear_attention_kernel_phase(seen["linatt"])
    rb = resnet_block_kernel_phase(seen["rb"])
    gn = gn_kernel_phase(seen["gn"], (torch.bfloat16,), torch.bfloat16, "256px", (5, 4))
    rb["unet_call_eager_ms"] = unet_call_ms(gd, 2 * MRI_BATCH, hi)
    log(f"256px UNet call at batch {2 * MRI_BATCH}, eager (host included): "
        f"{rb['unet_call_eager_ms']:.3f}ms")

    rng = np.random.default_rng(0)
    s = gd.image_size
    lr = rng.uniform(0, hi, (MRI_BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, hi, (MRI_BATCH, s, s, 1)).astype(np.float32)
    mask = disc_masks(MRI_BATCH, s)
    (res,), counts, perf = run_main_path(pipe, lr, hr, [(mask, True)], MRI_PER_CALL,
                                         MRI_SERVE_BATCH, "256px")

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


# ---------------------------------------------------------------------------
# Stage A of the 256px configuration: PatchCore over the denoiser's taps
# ---------------------------------------------------------------------------

class CountedFrontend:
    """Wraps a front end: each `detect` is timed on the host clock (the
    device drained before and after) and its kernel launches are counted
    apart from Stage B's."""

    def __init__(self, inner):
        self.inner = inner
        self.calls, self.launches, self.seconds = 0, {}, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def detect(self, lr):
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = self.inner.detect(lr)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        for k, v in read_counts().items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        self.calls += 1
        return out


def _stage_a_frontend(cfg, gd, bank):
    """A PatchCore front end over `gd`'s taps with the given bank."""
    src = DenoiserFeatureSource(gd, t=cfg.ood.feature_t)
    return OODFrontend(cfg, patchcore=PatchCore(cfg.ood, source=src, memory_bank=bank))


def _map_agreement(got, want) -> tuple:
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return rel, float(np.corrcoef(got.ravel(), want.ravel())[0, 1])


def stage_a256() -> dict:
    """(a) a bank at the deployment's size, (b) Stage A on the card against
    the CPU and against the plain versions, (c) k-center on the card against
    the CPU, (d) the counted main path: `translate` and the server without
    masks."""
    cfg = mri256_config()
    gd = build_gd(cfg, device="cuda")
    s = gd.image_size
    d = cfg.data
    brains = lambda n, tumor, seed: synthetic_brain_translation(
        n, s, tumor=tumor, seed=seed, mean_t1=d.mean_t1, std_t1=d.std_t1,
        mean_flair=d.mean_flair, std_flair=d.std_flair)[1]

    # (a) the bank: 200 normal brains → 819,200 patches → a 10% coreset
    t0 = time.perf_counter()
    calib = calibration_images(cfg, STAGE_A_CALIB)
    data_s = time.perf_counter() - t0
    STAGE_A_DIR.mkdir(parents=True, exist_ok=True)
    bank_path = str(STAGE_A_DIR / "memory_bank_mri256_denoiser.npy")
    built = build_bank(cfg, bank_path, gd=gd, images=calib)
    bank, secs, lad = built["bank"], built["seconds"], built["ladder"]
    log(f"Stage A bank: {STAGE_A_CALIB} normal brains at {s}px (made in {data_s:.2f}s), "
        f"{built['patches']} patches -> {bank.shape} {bank.dtype} ({bank.nbytes / 1e6:.1f} MB); "
        f"taps {secs['taps']:.3f}s, k-center {secs['kcenter']:.3f}s "
        f"({bank.shape[0]} steps), ladder fit {secs['ladder']:.3f}s (the calibration maps); "
        f"ladder gate {lad.gate:.6g}, rungs {[(r.above, r.threshold) for r in lad.rungs]}")
    if bank.shape != STAGE_A_BANK_SHAPE or not np.all(np.isfinite(bank)):
        raise RuntimeError(f"Stage A bank {bank.shape}, expected {STAGE_A_BANK_SHAPE}")
    lcfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=built["ladder_path"]))

    # (b) card against CPU (f32, bf16), kernels against plain versions (bf16)
    lr2 = brains(2, True, 7)
    checks = {}
    state = {k: v.cpu() for k, v in gd.model.state_dict().items()}
    for dtype in ("float32", "bfloat16"):
        c2 = lcfg.replace(train=dataclasses.replace(lcfg.train, compute_dtype=dtype))
        card = gd if dtype == "bfloat16" else build_gd(c2, device="cuda")
        card.model.load_state_dict(state)
        cpu = build_gd(c2, device="cpu")
        cpu.model.load_state_dict(state)
        fe_card, fe_cpu = _stage_a_frontend(c2, card, bank), _stage_a_frontend(c2, cpu, bank)
        _, b_card, m_card = fe_card.detect(lr2)
        t0 = time.perf_counter()
        _, b_cpu, m_cpu = fe_cpu.detect(lr2)
        cpu_s = time.perf_counter() - t0
        rel, corr = _map_agreement(m_card, m_cpu)
        differ = [int((b_card[i] != b_cpu[i]).sum()) for i in range(len(lr2))]
        if dtype == "float32":
            near = [near_threshold(m_cpu[i], lad, STAGE_A_NEAR, c2.ood.refine_hi_frac,
                                   c2.ood.refine_lo_frac) for i in range(len(lr2))]
            ok = rel <= STAGE_A_F32_REL and all(n == 0 or nr for n, nr in zip(differ, near))
            bar = (f"map rel L2 <= {STAGE_A_F32_REL:g}; masks equal but where a map value is "
                   f"within {STAGE_A_NEAR:g} of a threshold (near: {near})")
        else:
            ok = rel <= MRI_UNET_REL and corr >= MRI_UNET_CORR
            bar = f"map rel L2 <= {MRI_UNET_REL:g}, correlation >= {MRI_UNET_CORR:g}"
        log(f"Stage A check, card vs CPU ({dtype}, batch 2 tumour brains, same weights and "
            f"bank): map rel L2 {rel:.4g}, correlation {corr:.7f}, max_abs_err "
            f"{float(np.abs(m_card - m_cpu).max()):.4g} (map max {float(m_cpu.max()):.4g}); "
            f"binary pixels differing {differ} of {b_cpu[0].size}, OOD share card "
            f"{float(b_card.mean()):.4f} CPU {float(b_cpu.mean()):.4f} ({bar}) "
            f"{'ok' if ok else 'FAIL'}; CPU Stage A {cpu_s:.1f}s")
        if not ok:
            raise RuntimeError(f"Stage A on the card disagrees with the CPU's ({dtype})")
        checks[f"card_vs_cpu_{dtype}"] = dict(rel_l2=rel, corr=corr, binary_differ=differ)
        if dtype == "bfloat16":
            gd.model.use_plain_kernels(True)
            try:
                _, b_plain, m_plain = fe_card.detect(lr2)
            finally:
                gd.model.use_plain_kernels(False)
            rel, corr = _map_agreement(m_card, m_plain)
            ok = rel <= MRI_UNET_REL and corr >= MRI_UNET_CORR
            log(f"Stage A check, kernels vs plain versions on the card (bf16): map rel L2 "
                f"{rel:.4g}, correlation {corr:.7f}, binary pixels differing "
                f"{[int((b_card[i] != b_plain[i]).sum()) for i in range(len(lr2))]} ({bar}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("Stage A with the kernels disagrees with the plain versions")
            checks["kernels_vs_plain_bfloat16"] = dict(rel_l2=rel, corr=corr)
        else:
            del card
        del cpu, fe_cpu

    # (c) k-center, card against CPU, one projection, on the denoiser's own
    # embedding of five calibration brains
    n, k = KCENTER_CHECK
    emb = PatchCore(cfg.ood, source=DenoiserFeatureSource(gd, t=cfg.ood.feature_t)).embed(
        calib[:5])[:n].contiguous()
    proj = random_projection(emb.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = kcenter_greedy_indices(emb, k, proj=proj).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = kcenter_greedy_indices(emb.cpu(), k, proj=proj)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(on_card, on_cpu)
    first = int((on_card != on_cpu).nonzero()[0, 0]) if not same else None
    log(f"Stage A check, k-center card vs CPU ({n} x {emb.shape[1]}, k {k}, projection "
        f"seed 0): indices {'identical' if same else f'DIFFER from step {first}'}; "
        f"card {card_s:.2f}s, CPU {cpu_s:.2f}s")
    if not same:
        raise RuntimeError("k-center on the card picks other rows than on the CPU")
    checks["kcenter_identical"] = True

    # (d) the counted main path: translate and the server, no masks
    fe, cfg2 = build_frontend(cfg.replace(ood=dataclasses.replace(
        cfg.ood, memory_bank_path=bank_path)), gd=gd, device="cuda", verbose=False)
    if cfg2.ood.ladder_path != built["ladder_path"]:
        raise RuntimeError(f"build_frontend found ladder {cfg2.ood.ladder_path!r}")
    counted = CountedFrontend(fe)
    pipe = LocalDiffusionPipeline(cfg2, gd, frontend=counted)
    lo, hi = pipe.min_max_val
    lr = brains(MRI_BATCH, True, 11)
    hr = synthetic_brain_translation(MRI_BATCH, s, tumor=True, seed=11, mean_t1=d.mean_t1,
                                     std_t1=d.std_t1, mean_flair=d.mean_flair,
                                     std_flair=d.std_flair)[0]
    fe.detect(lr)  # warm-up (not counted)
    calls = gd.diff_cfg.resolved_sampling_timesteps
    fe.time_stages = True  # the split of a detect that has the card to itself
    reset_counts()
    res = pipe.translate(lr, hr=hr, noise=1)
    total = read_counts()
    fe.time_stages = False
    stage_a = dict(counted.launches)
    stage_b = {k2: v - stage_a[k2] for k2, v in total.items()}
    split = fe.last_split
    det_s, chain_s = counted.seconds[-1], float(res["time"])
    log(f"Stage A main path: translate without a mask, batch {MRI_BATCH} tumour brains: "
        f"Stage A {det_s * 1e3:.2f}ms wall (device timeline: feature pass "
        f"{split['features']:.3f}ms, nearest-neighbour search and score {split['nn']:.3f}ms, "
        f"map {split['map']:.3f}ms; host ladder, refinement and dilation "
        f"{split['host']:.3f}ms); OOD share {float((res['mask'] == 1).mean()):.4f}, "
        f"per image {[round(float((m == 1).mean()), 4) for m in res['mask']]}; then the "
        f"{'branched' if bool(res['branched']) else 'PLAIN'} bf16 chain "
        f"{chain_s * 1e3:.1f}ms -> {MRI_BATCH / chain_s:.3f} img/s; mse "
        f"{float(res['mse']):.4f}; launches Stage A {stage_a}, Stage B {stage_b}")
    if not bool(res["branched"]):
        raise RuntimeError("Stage A gated no tumour brain: the chain was not branched")
    if res["anomaly_map"].shape != (MRI_BATCH, s, s, 1):
        raise RuntimeError(f"anomaly map {res['anomaly_map'].shape}")
    check_counts(stage_a, STAGE_A_PER_DETECT, 1, "Stage A detect")
    check_counts(stage_b, MRI_PER_CALL, calls, "Stage A main path, Stage B chain")
    _check_images("Stage A main path chain", res["pred"], lr.shape, lo, hi)
    chain_counts = read_counts()

    srv = InferenceServer(pipe, batch_size=STAGE_A_SERVE_BATCH, max_wait_ms=50,
                          overlap_detect=True)
    t0 = time.perf_counter()
    with srv:
        # two waves: the second batch's Stage A runs while the first samples
        futs = [srv.submit(x) for x in lr[:STAGE_A_SERVE_BATCH]]
        time.sleep(STAGE_A_WAVE_S)
        futs += [srv.submit(x) for x in lr[STAGE_A_SERVE_BATCH:]]
        outs = [f.result(timeout=600) for f in futs]
    served_s = time.perf_counter() - t0
    stats = srv.snapshot_stats()
    counts = read_counts()
    served = {k2: v - chain_counts[k2] for k2, v in counts.items()}
    detects = counted.calls - 1  # less the translate's
    dispatches = (stats["merged_dispatches"] + stats["plain_dispatches"]
                  + stats["branched_dispatches"])
    log(f"Stage A serving: {stats['requests']} requests without masks in {stats['batches']} "
        f"batches of {STAGE_A_SERVE_BATCH}, {dispatches} dispatch(es), overlap_batches "
        f"{stats['overlap_batches']}, mean latency {stats['latency_mean_s'] * 1e3:.1f}ms, max "
        f"{stats['latency_max_s'] * 1e3:.1f}ms ({served_s:.2f}s wall); detects {detects} "
        f"({', '.join(f'{x * 1e3:.1f}' for x in counted.seconds[1:])} ms); branched flags "
        f"{[o['branched'] for o in outs]}")
    if stats["requests"] != len(lr) or detects != stats["batches"]:
        raise RuntimeError(f"server stats {stats}, {detects} detects")
    for i, o in enumerate(outs):
        _check_images(f"Stage A served request {i}", o["pred"], (s, s, 1), lo, hi)
    # an overlapped detect shares the counters with the other batch's chain,
    # so the served launches are checked as one sum
    for name, n in served.items():
        want = (STAGE_A_PER_DETECT.get(name, 0) * detects
                + MRI_PER_CALL.get(name, 0) * calls * dispatches)
        if n != want:
            raise RuntimeError(f"Stage A serving: {name} launched {n} times, expected {want} "
                               f"({detects} detects, {dispatches} chains of {calls} calls)")
    log(f"Stage A main path: launches {counts} (translate's Stage A {stage_a})")
    perf = dict(stage_a_ms=det_s * 1e3, split_ms=split, chain_s=chain_s,
                img_per_s=MRI_BATCH / chain_s, serve_latency_mean_s=stats["latency_mean_s"],
                overlap_batches=stats["overlap_batches"],
                bank_seconds=dict(secs, data=data_s), bank_shape=list(bank.shape))
    return dict(counts=counts, perf=perf, checks=checks)


# ---------------------------------------------------------------------------
# the s2d-stem 256px configuration (the README's recommended deployment)
# ---------------------------------------------------------------------------

def stem256() -> dict:
    cfg = stem256_config()
    gd = build_gd(cfg, device="cuda")
    pipe = LocalDiffusionPipeline(cfg, gd)
    lo, hi = pipe.min_max_val
    log(f"stem model: dim {cfg.model.dim} mults {cfg.model.dim_mults}, stem s2d x"
        f"{cfg.model.stem_space_to_depth}, {sum(p.numel() for p in gd.model.parameters())} "
        f"params (seeded random), compute {gd.dtype}, T={gd.num_timesteps}, DDIM "
        f"{cfg.diffusion.sampling_timesteps} steps (eta {cfg.diffusion.ddim_sampling_eta}), "
        f"detector {cfg.ood.detector}, mask_x {cfg.sampler.mask_x_policy}, min_max_val "
        f"({lo}, {hi:.4f})")

    seen = record_calls(gd, 2 * STEM_BATCH, hi)
    log(f"stem UNet call at batch {2 * STEM_BATCH}: {len(seen['gn'])} GN, "
        f"{len(seen['attn'])} full-attention sites, {len(seen['linatt'])} linear-attention "
        f"sites (plain module in f32), {sum(f for *_, f in seen['rb'])} of {len(seen['rb'])} "
        f"ResnetBlocks fused")
    check_gn_sites(seen["gn"], STEM_PER_CALL, "stem")
    if any(f for *_, f in seen["rb"]):
        raise RuntimeError("a float32 ResnetBlock took the fused (bf16) block")
    attn = attention_kernel_phase(seen["attn"], STEM_PER_CALL["flash_attention"],
                                  (torch.float32,), "stem")
    gn = gn_kernel_phase(seen["gn"], (torch.float32,), torch.float32, "stem")

    rng = np.random.default_rng(2)
    s = gd.image_size
    lr = rng.uniform(0, hi, (STEM_BATCH, s, s, 1)).astype(np.float32)
    hr = rng.uniform(0, hi, (STEM_BATCH, s, s, 1)).astype(np.float32)
    mask = disc_masks(STEM_BATCH, s)
    pipe.translate(lr, noise=1)  # warm-up (not counted)
    torch.cuda.synchronize()
    # the deployment's default: detector none, so the plain chain; then the
    # branched chain with the disc masks
    (res_p, res_b), counts, perf = run_main_path(
        pipe, lr, hr, [(None, False), (mask, True)], STEM_PER_CALL, STEM_SERVE_BATCH, "stem")

    gd.model.use_plain_kernels(True)
    try:
        plain = [pipe.translate(lr, noise=1, mask=m) for m in (None, mask)]
    finally:
        gd.model.use_plain_kernels(False)
    checks = {}
    for kind, got, want in (("plain", res_p, plain[0]), ("branched", res_b, plain[1])):
        a, p = got["pred"].ravel(), want["pred"].ravel()
        rel = float(np.linalg.norm(a - p) / np.linalg.norm(p))
        checks[kind] = rel
        log(f"stem check: {kind} DDIM chain, kernels vs plain versions (same noise): "
            f"relative L2 {rel:.4g} (tol {STEM_CHAIN_REL:g}), max_abs_err "
            f"{float(np.abs(a - p).max()):.4g}; plain-version chain {float(want['time']):.2f}s")
        if not rel <= STEM_CHAIN_REL:
            raise RuntimeError(f"the stem {kind} chain disagrees with its plain-version chain")

    x = rng.standard_normal((2, s, s, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (2, s, s, 1)).astype(np.float32)
    t = np.array([9, 201])
    cpu = build_gd(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gd.model.state_dict().items()})
    got = gd.apply_model(torch.as_tensor(x, device="cuda"), torch.as_tensor(cond, device="cuda"),
                         torch.as_tensor(t, device="cuda")).cpu().numpy()
    t0 = time.perf_counter()
    want = cpu.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t)).numpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    ok = bool(np.allclose(got, want, rtol=STEM_UNET_F32_TOL, atol=STEM_UNET_F32_TOL))
    checks["unet_card_vs_cpu_max_abs_err"] = err
    log(f"stem check: one UNet call, card vs CPU (batch 2, float32): max_abs_err {err:.4g}, "
        f"relative L2 {rel:.4g} ({STEM_UNET_F32_TOL:g} abs+rel) {'ok' if ok else 'FAIL'}; "
        f"CPU call {cpu_s:.1f}s")
    if not ok:
        raise RuntimeError("the stem UNet on the card disagrees with the CPU's")
    del cpu

    prof = profile_chain(pipe, lr, None, "stem", top=16)
    return dict(attn=attn, gn=gn, counts=counts, perf=perf, checks=checks, **prof)


def _row(t: dict, warm: bool = False) -> dict:
    """A GN part's numbers under the kernels line's keys (and the replayed
    time of a tiled pass, `warm_ms`)."""
    return dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], max_abs_err=t["max_abs_err"],
                **({"warm_ms": t["warm_ms"]} if warm else {}))


def main() -> None:
    phase_device()
    phase_build()
    flag = flagship()
    mri = mri256()
    stage_a = stage_a256()
    stem = stem256()

    phases = {"flagship": flag, "256px": mri, "stage_a": stage_a, "stem": stem}
    launches = {name: {label: ph["counts"][name] for label, ph in phases.items()}
                for name in COUNTERS}
    total = {name: sum(v.values()) for name, v in launches.items()}
    attn, lin, gn = mri["attn"]["bfloat16"], mri["linatt"], mri["gn"]
    sgn = stem["gn"]
    kernels = [
        dict(name="groupnorm_film_silu", route="cuda",
             source="localdiffusion_tpu_torch/csrc/groupnorm_film_silu.cu",
             replaces="localdiffusion_tpu/ops/pallas_groupnorm.py:74",
             launches=total["groupnorm_film_silu"], **_row(gn["single"]), library_ms=None,
             per="256px UNet call, 4 launches (32x32x128), bf16",
             launches_by_phase=launches["groupnorm_film_silu"],
             group_norm_ms=gn["single"]["group_norm_ms"],
             flagship=_row(flag["gn"]["single"]), stem=_row(sgn["single"]),
             stem_group_norm_ms=sgn["single"]["group_norm_ms"],
             by_site={label: ph["gn"]["single"]["by_site"]
                      for label, ph in (("256px", mri), ("stem", stem), ("flagship", flag))}),
    ]
    for name, key, src_line in (("gn_tiled_stats", "stats", 231),
                                ("gn_tiled_apply", "apply", 251)):
        kernels.append(dict(
            name=name, route="cuda", source="localdiffusion_tpu_torch/csrc/groupnorm_tiled.cu",
            replaces=f"localdiffusion_tpu/ops/pallas_groupnorm.py:{src_line}",
            launches=total[name], **_row(sgn[key], True), library_ms=None,
            per="stem UNet call, 14 launches (128x128x32 and 64x64x64, batch 8), f32; "
                "library: none computes the pass (the whole op's F.group_norm alone beside)",
            timing="ms: cold_ms, L2 flushed by a read before each call (x from device "
                   "memory, as bound_ms assumes); warm_ms and plain_ms: CUDA-graph replay, "
                   "x left in L2 by the call before",
            launches_by_phase=launches[name], mri256=_row(gn[key], True),
            pair_stem=dict(_row(sgn["pair"], True), group_norm_ms=sgn["pair"]["group_norm_ms"]),
            pair_256px=dict(_row(gn["pair"], True), group_norm_ms=gn["pair"]["group_norm_ms"]),
            sums_worst_rel=max(sgn["worst_sums"], gn["worst_sums"]),
            by_site={"256px": gn[key]["by_site"], "stem": sgn[key]["by_site"]}))
    sattn = stem["attn"]["float32"]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="localdiffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="localdiffusion_tpu/ops/pallas_attention.py:26",
        launches=total["flash_attention"], max_abs_err=attn["max_abs_err"],
        ms=attn["ms"], plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"],
        bound_by=attn["bound_by"], library_ms=attn["library_ms"],
        per="one launch at [8,1024,4,32] bf16 (3 per 256px UNet call)",
        launches_by_phase=launches["flash_attention"],
        sfu_ms=attn["sfu_ms"], f32_ms=mri["attn"]["float32"]["ms"],
        f32_max_abs_err=mri["attn"]["float32"]["max_abs_err"],
        stem_f32=dict(per="one launch at [8,256,4,32] f32 (3 per stem UNet call)",
                      **{k: sattn[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "bound_by", "sfu_ms", "max_abs_err")})))
    for key, src_line in (("kv", 149), ("q", 201)):
        t = lin[key]
        kernels.append(dict(
            name=f"linear_attention_{key}", route="cuda",
            source="localdiffusion_tpu_torch/csrc/linear_attention.cu",
            replaces=f"localdiffusion_tpu/ops/pallas_linear_attention.py:{src_line}",
            launches=total[f"linear_attention_{key}"], max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            per="256px UNet call, 6 launches (one per site), bf16",
            **{k: t[k] for k in ("bound_floor", "bytes_ms", "tensor_ms", "sfu_ms",
                                 "batch4_ms", "batch8_ms")},
            two_pass_ms=lin["whole"]["ms"], merge_fold_ms=lin["whole"]["merge_fold_ms"],
            two_pass_batch4_ms=lin["whole"]["batch4_ms"],
            two_pass_batch8_ms=lin["whole"]["batch8_ms"]))
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
            launches=total[name], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"] if key == "conv" else None, per=per,
            **({"pass1_ms": t["pass1_ms"], "pass2_ms": t["pass2_ms"],
                "eager_ms": t["eager_ms"], "by_shape": t["by_shape"],
                "unet_call_eager_ms": rb["unet_call_eager_ms"]} if key == "conv"
               else {"by_site": t["by_site"]}), **block))
    if any(k["launches"] < 1 for k in kernels):
        raise RuntimeError(f"a kernel never launched on the main paths: {launches}")
    log("end to end: " + "; ".join(f"{label} {json.dumps(ph['perf'])}"
                                   for label, ph in phases.items())
        + "; busy share " + " ".join(f"{label} {ph['busy_share']:.4f}"
                                     for label, ph in phases.items() if "busy_share" in ph)
        + f"; stem checks {json.dumps(stem['checks'])}; Stage A checks "
        + json.dumps(stage_a["checks"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
