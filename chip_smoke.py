#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, dataset, parallel and I/O paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line with the elapsed seconds:

1. device: requires CUDA, prints the card's name and power limit and
   PyTorch's TF32 flags, which the script leaves at their defaults: the
   float32 phases (flagship, stem, the gated chain's float32 part, the
   shipped checkpoints, the datasets) are entered with both flags on, a
   user's worst case, print them at entry and check at their exit that every block of
   the port's precision policy (`utils/precision.py`) restored them; the
   kernel phases' comparisons with the plain versions run inside that
   policy's `full_float32` block;
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
12. the classifier-gated configuration (`mri256_gated_config()`: fused at
    t=5, the gate PatchCore over the same taps on its own bank, suppress,
    3 retries), on Stage A's denoiser and detector bank: (a) the
    classifier's bank, 64 normal FLAIR targets → 262,144 patches → a 5%
    coreset of 13,107 × 192 (`ood.bank.build_classifier_bank`), and its
    threshold ROC-calibrated on 32 + 32 images by `build_classifier_gate`
    (seconds, threshold, balanced accuracy); (b) its scores on the card
    against the CPU, f32 and bf16, on 4 + 4 of those images, and with the
    kernels against their plain versions on all 64; (c) with every count
    at 0, `translate` without a mask on 4 tumour brains (Stage A, the
    branched chain, the gated phase B: `fusion_time`, the first gated
    step's verdicts, phase B on the device's timeline split into plain
    steps, gate and retry), then an `InferenceServer` answering four
    requests without masks; each kernel's launches checked against the
    UNet calls, detects and gated steps (a tap pass and a [2B] retry
    each); (d) the chain at T = 50 (cut for the time limit, full width)
    with the threshold forced to +inf (always accept: `fusion_time` 4,
    bit-equal to the ungated chain) and to −inf (always reject: 3
    rejections, then the budget: `fusion_time` 1, the gate at 4 steps),
    each against the same chain with the plain versions;
13. the 256px bf16 seg configuration (`mri256_bf16_config()`: DDIM-50,
    bf16, the seg detector, dilation 16), batch 4, all at full width with
    seeded weights: (a) a seeded SegUNet (base 64) written as a JAX-format
    npz under `build/stage_a/` and loaded by `build_frontend`; its logits
    on the card against the CPU (f32), the masks off the 0.5 band;
    `translate` without a mask (the seg detect, then the branched DDIM-50
    chain), the chain against its plain versions (same noise and mask), a
    DDIM-5 chain of the same weights under torch.profiler, the seg UNet's
    kernels too, then an `InferenceServer` answering three requests
    without masks.  The phase runs with cuDNN's TF32 on, PyTorch's
    default: Stage A's networks turn it off themselves; (b) the WRN50-2 source (`detector="patchcore"`): its bank of 200
    brains through `python -m localdiffusion_tpu_torch.ood.bank
    --feature-source wrn` (20,480 × 1,536; seconds of taps, k-center and
    ladder), the taps and k-center card vs CPU, detect at batch 4 card vs
    CPU with its split, `translate` without a mask; (c) the seg-encoder
    source: its bank (50 brains, 20,480 × 768), detect card vs CPU; (d) the
    classifier gate's WRN last resort (`mri256_gated_config()` with the seg
    detector and no bank: a WRN bank from 16 + 16 calibration images),
    scores card vs CPU, and as a control the card's scores with the
    distance product in TF32, which must fail the bar; Stage A launches none of the eight kernels, Stage B
    each chain's;
14. stem kernels: the s2d-stem configuration (`stem256_config()`, the
    README's recommended 256px deployment: f32, DDIM-50, plain chain) at
    full width, one UNet call at batch 8 recorded: the GroupNorm op at its
    40 Block shapes (the tiled pair at the 14 past the row gate) and full
    attention at its three 16x16 sites, f32, against their plain versions,
    timed as in phase 7;
15. stem main path: with every count at 0, the plain DDIM-50 chain at batch
    4 (detector none), the branched DDIM-50 chain with disc masks, then an
    `InferenceServer` answering three requests; every kernel's launches
    checked per UNet call;
16. stem check: both chains against the same chains with every kernel's
    plain version (same noise), and one UNet call against the CPU, f32;
17. stem profile: the plain chain under torch.profiler;
18. the shipped checkpoints (`results/*.npz`, tracked in git; each file's
    size and sha256 printed, a missing one raises): `mri_synth256_ema.npz`
    in `mri256_config()` (one UNet call at batch 2, bf16) and
    `mri_stem256_ema.npz` in `stem256_config()` (f32), each loaded by
    `factory.load_params` on the card and on the CPU and held at the
    one-UNet-call bars; `seg256_params.npz`'s logits at batch 2 through
    `build_frontend`, card vs CPU; then, with every count at 0, the margin
    evaluation's entry point (`scripts.eval_margins.main`) at n=8, batch 8,
    DDPM T=250, variants plain and denoiser, on the trained denoiser: its
    bank of 50 brains and ladder built on the card under
    `build/shipped/`, Stage A's masks, both chains; the launches checked
    against the UNet calls and tap passes; the per-variant OOD-region MSE
    and the delta printed, not judged (n=8 cannot resolve the margin).

19. training (`mri256_config()` at full width, batch 8, bf16, seeded
    weights, the 256 synthetic training brains at 256px): (a) with every
    count at 0, through `train.trainer.Trainer` one resident epoch (32
    microbatches, the dataset on the card, the permutation drawn there),
    one streamed epoch and 4 batch steps, then `scripts.train` for 2
    resident steps with its eval chain (T=250 on 8 test brains), a
    checkpoint and an EMA npz under `build/train_smoke/`; each
    microbatch's forward launches a serving UNet call's kernels and a
    backward none (each kernel's `torch.autograd.Function` recomputes its
    backward through its plain reference); wall seconds a step, the
    forward and backward of a microbatch on the card (CUDA events), the
    step's peak memory, the eval MSE and the checkpoint's bytes; (b) on
    the shipped `mri_synth256_ema.npz`, one batch's loss and whole
    gradient with the kernels against the plain modules on the card
    (same t and noise) and, at batch 2, against the CPU: loss within 1e-2
    relative, gradient within 5e-2 relative L2 and cosine >= 0.998, the
    worst leaf named; (c) the flagship's f32 step, entered with both TF32
    flags on: 2 batch steps, one step's gradient card vs CPU within 1e-3,
    both flags off inside every backward and restored after; (d) 30 batch
    steps from seeded weights lower a fixed-draw loss on 16 held-out
    brains (the shipped checkpoint's printed beside); (e) `save`/`load`
    restore the trainer bit for bit, the exported npz serves through
    `factory.load_params` as the EMA rounded to fp16 and its UNet call is
    bit-equal to that of the rounded EMA; (f) the 30th step under
    torch.profiler, split into forward, backward, clip + Adam and EMA on
    the device's timeline, with the step's busy share.

20. datasets (entered with both TF32 flags on; the real MNIST, BraTS and
    MVTec files are not in the repository, and the card's machine has no
    PIL for the BraTS and MVTec PNGs): 2,048 + 2,048 seeded synthetic
    digits written as MNIST idx files (images raw, labels gzipped, train
    and t10k) under `build/datasets/`, read back exactly by
    `load_mnist_arrays`; with every count at 0, through the command lines:
    `scripts.train` on `mnist_train_config()` (2 epoch steps at batch 64,
    T=250, f32, and its eval chain; the training set the idx files' digit
    8), the bank CLI on `mnist_gated_config()` (the WRN50-2 at 84px over
    200 digits), `scripts.test` on `mnist_8to5`, `mnist_usegt` and
    `mnist_gated` (its gate on that bank) at 4 t10k images each; then
    `mvtec_synthetic_config()` (64px, 3 channels, f32: 32 single-pass GN
    and 3 f32 attention launches a UNet call): `scripts.train` for 4
    resident steps over the 192 training textures at batch 16,
    `scripts.test` on 4 defective textures (img/s, launches per chain),
    its chain against the plain versions (same noise, 1e-3) and one UNet
    call against the CPU (1e-3 abs+rel); one `scripts.test` batch of
    `mvtec_denoise_config()`; each run's launches checked against its UNet
    calls;
21. self_cond (`mri256_config()` with self-conditioning and learned Fourier
    time features, bf16, batch 8, seeded weights): a loss with the coin on
    heads launches each kernel twice a UNet call's count (the no-grad
    pre-pass and the grad pass), on tails once, its backward none; 4
    batch steps through `Trainer` (coins heads, tails, heads, tails) with
    learned features, then with random ones, whose weights come out
    bit-unchanged; gradients with the kernels against the plain modules on
    both coins (same t and noise; the training phase's bf16 bars); the
    trained model's branched chain at T=50 of its weights, batch 4 (zeros for the
    estimate, as the samplers pass none) against its plain versions (the
    256px chain bars);
22. serve (`mri256_bf16_config()`: the shipped denoiser and seg detector,
    DDIM-50, bf16, batch 4): `python -m localdiffusion_tpu_torch.scripts.serve
    --port 0` started in a new process, as a user starts it (the seconds to
    bind and of its warm-up, one request without a mask, /healthz, stopped
    by an interrupt); then, in this process, `scripts.serve.build_server`
    (warmed up) behind loopback HTTP with every count at 0: 6 requests,
    two at a time (a half mask, all ones, none: the seg detector decides),
    each two in one batch; every status 200, /stats, /healthz, a 3-channel
    body's 400; the launches as the chains' UNet calls; each dispatch run
    again through `pipe.translate` with its batch's noise, and each served
    pred bit for bit its row; latency median and maximum;
23. sampler_api: `sample` on `mri256_config()` (full width, T cut to 25)
    with an all-ones mask and a half mask, bit for bit the direct sampler
    call with the same launches; `interpolate` at full width, batch 4,
    bf16, T=50 from t = T-1, against its plain-version chain (the 256px
    chain bars); `return_debug` on the trained flagship (the exported
    `results_torch/mnist_x250_best10000.npz`), its six entries card vs CPU
    with the same numpy noise (the flagship's bar);
24. mnist_trained (entered with both TF32 flags on): the two exported MNIST
    checkpoints (`results_torch/*.npz`, size and sha256 printed), one UNet
    call each card vs CPU (1e-4), the test CLI on 2 seeded t10k digits
    (idx files written under `build/mnist_trained/`, the manual mask) on
    the card and on the CPU with the same numpy noise (mean MSE within the
    flagship's bar), and an `InferenceServer` answering 8 requests from
    the mnist_u150 weights;
25. aux (entered with both TF32 flags on): `scripts.train_seg` at 256px (2
    epochs, batch 4) into `build/aux/`, its npz served by the seg
    detector (one detect); `scripts.train_mnist_cls` (2 epochs on the
    seeded t10k digits) and `scripts.eval_translation` of the trained
    flagship's translations; `scripts.convert_mha` of three seeded 8-slice
    MetaImage volumes (one zlib-compressed), bit for bit `load_mha`'s, and
    `scripts.translate_volume` on them (`mri256_bf16_config()`, batch 4),
    its launches as its chains' calls;
26. patch (entered with both TF32 flags on): `scripts.patch_demo` as a
    user runs it (`mri64_config()`, the shipped denoiser, a 256px tumour
    brain in 25 patches of 64px, overlap 8, DDIM-50, f32: a [50] UNet
    batch, the single-pass GN in every Block), its first call's and
    steady state's seconds and MSE; the demo's whole call kernels vs plain
    on the card and the tumour's patch chain card vs CPU (the same numpy
    noise, the f32 chain bar); the stitch of overlap 0 exact; the bf16 patch call
    (`mri256_bf16_config()`, the shipped denoiser, a 384px image in 4
    patches of 256px, overlap 128: an [8] UNet batch at 256px, all eight
    kernels)
    against its plain versions (the 256px chain bars); the bucketed route
    against the unbucketed one with each row's noise the same, its UNet
    rows counted by a hook (a plain patch one row a step);
27. distributed: two ranks on the one card (gloo; NCCL refuses two ranks
    on one device) take one 256px bf16 batch step of 8, replicated and
    then FSDP, each against the one-process step on the same global batch
    and draws (the training bars on the update), FSDP's share of all the
    state a rank holds (parameters, gradients, Adam, EMA); then a one-rank NCCL
    `scripts.train --coordinator ... --fsdp` of 2 batch steps under
    `build/parallel/`, its checkpoint written by the primary and loaded
    back;
28. stream: `StreamLoader` over .npy shards of 256px brains through
    `device_prefetch`, the device batches bit for bit the host's, an epoch
    step fed through it equal to one fed without it, the copies off the
    consumer's stream in a `profile_trace` trace;
29. reference_ckpt: a seeded reference checkpoint of the 256px layout
    (12.1M parameters) through the converter's CLI, its EMA npz one UNet
    call card vs CPU;
30. features: `scripts.eval_patchcore_features` with 2 refits on the
    denoiser and WRN50-2 sources at 256px, the IoUs printed;
31. native: the data kernels built with g++ and held against the numpy
    route;
32. mesh_serve: `InferenceServer` over a mesh pipeline
    (`build_pipeline(mesh=...)`) on two ranks of the one card (gloo),
    `mri256_bf16_config()` with the shipped denoiser and seg detector,
    batch 4 of tumour brains without masks (Stage A on the first rank, each
    dispatch broadcast, the other rank following): on a data = 2 x patch =
    1 mesh, then data = 1 x patch = 2; each rank's launches against the
    one-process server's on the same requests (a launch covers whatever rows
    it is given), the served images against one process's (rel. L2 and max
    |diff|), the masks bit for bit, each mesh's wall time;
33. linatt_attrib (entered with both TF32 flags on): with every count at 0,
    `scripts.bench_linatt_attrib` as a user runs it (the JAX script's rows
    at the 256px stage-0 shape, [8, 256, 256, 32] bf16: the shipping pair,
    the elementwise and copy floors, each pass alone and with its
    exponentials made linear), its launches read after; then the kv and q
    kernels' attribution variants (every exponential a * 0.5 + 1) against
    their plain versions (l and G per row, the q pass given W~ on its
    well-conditioned tokens) and the copy kernel bit for bit, each timed
    beside its plain version, its bound and (the copy) `Tensor.copy_`;
34. tensor_parallel: two ranks on the one card (gloo) over
    `make_mesh(model=2)`, each holding its half of the shipped 256px
    denoiser (`shard_tensor_parallel`): one UNet call at batch 4 of
    `mri256_bf16_config()` in bf16 and in float32 with TF32 off, and a
    10-step branched DDIM chain in bf16, each against one process (bf16:
    the call's rel. L2 and correlation, the chain's rel. L2 at the section-2
    bars; float32 1e-4), each rank's launches a call against one process's,
    and its parameter bytes against the whole;
35. aged trace: `profile_trace` of a block of a few milliseconds in this
    process, then as old as the whole run and at least 800 s old (a run
    on a fast card waits for that age): every kernel the block launched
    must be in the trace (a bare `torch.profiler` session of the same block
    is printed beside it).  The offset of the card's timestamps from the
    host clock (`utils.logging.read_device_clock`) is read after the 256px,
    training and mesh_serve phases and printed with the process's age.

Stage B runs compiled on every main path (`translate` on the card without
a mesh captures each sampler's step bodies as CUDA graphs at the first
chain of a key and replays them; a body's first step runs eagerly and is
the warm-up, so a chain launches and counts what the eager one does;
PatchCore's score without a clock is one graph a key).  Each profiled
chain runs once unprofiled first, so the profile reads replays.  Five
configurations hold their compiled chain against its eager twin
(`translate` with `pipe.compiles` cleared, the same noise and mask) in
their phases: the flagship (phase 4), the 256px chain (8; its T=50 cut
also profiled eagerly), the stem's plain DDIM-50 (15), the seg DDIM-50
chain (13a) and the gated 256px chain (12c): outputs bit for bit, launches
equal, the walls, peak memory (allocated and reserved, the graphs' pool
counted in the latter) and each program's graphs, nodes, capture and
instantiation seconds; the compiled phase, before the aged trace, requires
all five and prints them together.

The serve phase's in-process server reads its configuration from a `.json`
dump of `mri256_bf16_config()` (`Config.save_json`, `config.load_config`),
and its every dispatch again through a pipeline built from the builder
must give the served pred bit for bit.

The line before the last is one JSON object with the kernels' numbers
(each with `train_launches`, its launches in the training phase's main
path, and `backward`, what its backward recomputes through); the last
line is the device record.  Any failed check raises, so the exit code
is not 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gzip
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.config import (
    flagship_config,
    load_config,
    mnist_8to5_config,
    mnist_gated_config,
    mnist_train_config,
    mnist_usegt_config,
    mri64_config,
    mri256_bf16_config,
    mri256_config,
    mri256_gated_config,
    mvtec_denoise_config,
    mvtec_synthetic_config,
    min_max_val_for,
    stem256_config,
)
from localdiffusion_tpu_torch.data.datasets import bank_images, test_arrays, train_arrays
from localdiffusion_tpu_torch.data.mnist import MNISTDataset, load_mnist_arrays
from localdiffusion_tpu_torch.data.loader import ArrayLoader
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation, synthetic_digits
from localdiffusion_tpu_torch.diffusion.gaussian import ArrayDraws, GaussianDiffusion, build_gd
from localdiffusion_tpu_torch.diffusion.sampler import ArrayNoise, GeneratorNoise
from localdiffusion_tpu_torch.factory import (
    build_classifier_gate,
    build_frontend,
    build_pipeline,
    classifier_bank_beside,
    load_params,
)
from localdiffusion_tpu_torch.models.blocks import (
    Attention,
    GroupNormFilmSiLU,
    LinearAttention,
    ResnetBlock,
)
from localdiffusion_tpu_torch.models.seg_unet import (
    SegDetector,
    SegUNet,
    flax_seg_tree,
    load_seg_npz,
)
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.ood import patchcore as PC
from localdiffusion_tpu_torch.ood.bank import (
    build_bank,
    build_classifier_bank,
    classifier_calibration_pairs,
)
from localdiffusion_tpu_torch.ood.bank import main as bank_main
from localdiffusion_tpu_torch.ood.classifier import ClassifierPatchCore, balanced_accuracy
from localdiffusion_tpu_torch.ood.features import (
    DenoiserFeatureSource,
    SegEncoderFeatureSource,
    WRNFeatureSource,
)
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import (
    PatchCore,
    StageClock,
    compute_anomaly_score,
    kcenter_greedy_indices,
    nearest_neighbors,
    random_projection,
)
from localdiffusion_tpu_torch.ood.thresholds import manual_mask, near_threshold
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops import copy_probe as CP
from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)
from localdiffusion_tpu_torch.parallel.multihost import RowsNoise, row_range
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_seed
from localdiffusion_tpu_torch.scripts import eval_margins
from localdiffusion_tpu_torch.scripts import test as test_script
from localdiffusion_tpu_torch.scripts import train as train_script
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.train.trainer import Trainer, clip_by_global_norm, ema_update
from localdiffusion_tpu_torch.utils.logging import launch_gaps_us, profile_trace, read_device_clock
from localdiffusion_tpu_torch.utils.params_io import save_params_npz
from localdiffusion_tpu_torch.utils.precision import full_float32

KERNELS = ("groupnorm_film_silu", "groupnorm_tiled", "flash_attention", "linear_attention",
           "resnet_block", "copy_probe")
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
# the classifier-gated configuration: its own bank of 64 normal FLAIR
# targets at 256px, 262,144 patches, a 5% coreset (the JAX script's
# bank_rows).  Scores card vs CPU in f32 (TF32 off) on 4 + 4 of the 64
# calibration images (the CPU's time): the set within 1e-4 relative L2
# (Stage A's f32 bar); each score recomputed in float64 from each side's
# own patch embeddings within 1e-4 relative (what the card's float32 taps
# change: 2.5e-5 read); each float32 score within 3e-4 relative.  A score
# is one patch's distance by |x|² − 2x·y + |y|², whose float32 rounding put
# a score 2.1e-4 from its float64 value on the card's GEMM and 3.8e-5 on
# the CPU's, so two sides may differ by their sum, 2.5e-4 (1.45e-4 read;
# H100 80GB HBM3, 700 W).  In bf16 and kernels vs
# plain versions the one-UNet-call bar.  The forced chains at T = 50 (the
# script's time limit) against the chain bars; at the configuration file's
# float32 against the stem's float32 chain bar, 1e-3.
GATED_BANK_IMAGES, GATED_BANK_SHAPE = 64, (13_107, 192)
GATED_F32_REL, GATED_F32_SCORE_REL = 1e-4, 3e-4
GATED_CHECK_PER_CLASS, GATED_FORCED_T = 4, 50
# the 256px bf16 seg configuration (`mri256_bf16_config()`), batch 4.  Its
# Stage A networks (SegUNet, WRN50-2) are cuDNN convs and GroupNorm in f32,
# no kernel of the eight; Stage B is the 256px UNet, DDIM-50, bf16, all
# eight.  Card vs CPU in f32 (the networks turn cuDNN's TF32 off
# themselves): seg logits, WRN taps and the maps within 1e-4 relative L2
# (Stage A's f32 bar); seg masks equal off the band |p − 0.5| <= 1e-3;
# PatchCore masks equal but near a threshold.  The WRN bank: 200 brains →
# 204,800 patches × 1,536 (layer2 ⊕ layer3) → 10%; the seg-encoder bank:
# 50 brains (cut from 200 for time) → 204,800 × 768 → 10%.  The chain's
# device time from a DDIM-5 chain of the same weights under the profiler.
# The gate's WRN last resort: 16 + 16 calibration images; each score's
# float64 recomputation from each side's embeddings within 1e-4 (6.1e-6
# read), the f32 scores within 3e-4 relative L2 and each within 5e-4: at
# 1,536 channels the distance identity's f32 rounding put a score 2.7e-4
# from its float64 value on the card and 1.0e-4 on the CPU, and the sides
# 1.7e-4 apart in relative L2, 3.0e-4 at the worst score (H100 80GB HBM3,
# 700 W).  The control, the card's distance product in TF32, must fail the
# per-score bar (7.4e-4 to 3.7e-3 from the CPU's f32 scores in a CPU
# emulation of TF32's rounding, `gate_tf32_emulation.py`).
SEG_WRN_BATCH, SEG_SEED, SEG_PROFILE_STEPS = 4, 7, 5
MRI_PROFILE_STEPS = 50  # the 256px profiled chain: ancestral T=50 of the T=250 weights
SEG_LOGIT_REL, SEG_BAND, SEG_WRN_F32_REL = 1e-4, 1e-3, 1e-4
WRN_BANK_BRAINS, WRN_BANK_SHAPE = 200, (20_480, 1_536)
SEGENC_BANK_BRAINS, SEGENC_BANK_SHAPE = 50, (20_480, 768)
WRN_KCENTER_CHECK = (20_480, 2_048)  # rows, k
GATE_WRN_PAIRS = 16
GATE_WRN_F32_REL, GATE_WRN_F32_SCORE_REL = 3e-4, 5e-4
# s2d stem, float32.  The DDIM-50 chains, kernels vs plain versions (same
# noise), and one UNet call, card vs CPU: float32 sums in another order
# (~1e-6 per call) through 50 DDIM updates: relative L2 <= 1e-3, and for
# the UNet call 1e-3 abs+rel
STEM_CHAIN_REL, STEM_UNET_F32_TOL = 1e-3, 1e-3

# the shipped checkpoints (tracked in git), each on the card against the
# CPU: the 256px denoiser in mri256_config() (bf16, the one-UNet-call bar
# above), the stem denoiser in stem256_config() (f32, 1e-3 abs+rel) and the
# SegUNet's logits (f32, 1e-4 relative L2, masks equal off |p − 0.5| <=
# 1e-3); then the margin evaluation on the trained 256px denoiser: n=8 in
# one batch of 8, DDPM T=250, plain and denoiser, the detector's bank of
# 200 brains built on the card from the trained taps.  n=8 cannot resolve
# the margin: it is reported, not judged.
RESULTS = Path(__file__).resolve().parent / "results"
SHIPPED = ("mri_synth256_ema.npz", "mri_stem256_ema.npz", "seg256_params.npz")
SHIPPED_DIR = STAGE_A_DIR.parent / "shipped"
# the margin run's detector bank: 50 brains (200 before the attribution and
# tensor-parallel phases came in)
MARGIN_IMAGES, MARGIN_BATCH, MARGIN_BANK = 8, 8, 50
# the training path (`mri256_config()`: batch 8, bf16, the 256 synthetic
# training brains at 256px): one resident epoch (32 microbatches), one
# streamed epoch, 4 batch steps, then `scripts.train` for 2 resident steps
# and its eval chain (T=250 on 8 test brains).  Each microbatch's forward
# launches a serving UNet call's kernels (MRI_PER_CALL); a backward
# launches none: it recomputes through the plain references.  Gradients
# with the kernels against the plain modules on the card and against the
# CPU: the one-UNet-call bf16 bars (loss within 1e-2 relative, the whole
# gradient within 5e-2 relative L2 and cosine >= 0.998) on the shipped
# checkpoint card vs CPU (both through the Functions: their plain forward
# on the CPU) and on seeded weights kernels vs plain modules; f32, kernels
# vs plain and the flagship's step card vs CPU, within 1e-3 relative L2,
# the flagship's f32 bar.  On the shipped checkpoint in bf16 the kernels vs
# the plain modules are held to the cosine alone: the trained model's
# residual is ~1% of its output, below bf16's rounding of the activations,
# so its gradient moves by 10-20% between bf16 computations (the kernel
# path in bf16 against f32: 0.176 relative L2, kernels against the plain
# modules 0.098, cosine 0.99988; NVIDIA H100 80GB HBM3, 700 W) while a
# missing or wrong gradient turns the cosine; the loss and the L2 are
# printed beside that bf16-vs-f32 floor.
TRAIN_DIR = STAGE_A_DIR.parent / "train_smoke"
TRAIN_BATCH_STEPS, TRAIN_SPLIT_REPS, TRAIN_LEARN_STEPS, TRAIN_HELD_OUT = 4, 5, 30, 16
TRAIN_SCRIPT_STEPS = 2
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_COS, TRAIN_F32_GRAD_REL = 1e-2, 5e-2, 0.998, 1e-3
TRAIN_CPU_BATCH = 2
# what each kernel's backward recomputes through (the JAX custom_vjp's
# reference, ported)
BACKWARD = {
    "groupnorm_film_silu": "groupnorm_film_silu_reference (ops/groupnorm.py)",
    "gn_tiled_stats": "groupnorm_film_silu_reference (ops/groupnorm.py)",
    "gn_tiled_apply": "groupnorm_film_silu_reference (ops/groupnorm.py)",
    "flash_attention": "xla_attention (ops/attention.py)",
    "linear_attention_kv": "linear_attention_reference (ops/linear_attention.py)",
    "linear_attention_q": "linear_attention_reference (ops/linear_attention.py)",
    "conv3x3_stats": "resnet_block_reference (ops/resnet_block.py)",
    "epilogue": "resnet_block_reference (ops/resnet_block.py)",
}

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f}s] {msg}", flush=True)


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def tf32_flags() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@contextlib.contextmanager
def tf32_on_at_entry(label: str):
    """A float32 phase entered with both TF32 flags on, a user's worst case
    (PyTorch's default has cuDNN's on): the port's float32 paths must turn
    them off for themselves.  Prints the flags at entry and checks, at the
    exit, that every block restored them; then puts back the setting the
    phase found."""
    saved = tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    log(f"{label}: entered with cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    try:
        yield
        if tf32_flags() != (True, True):
            raise RuntimeError(f"{label} left the TF32 flags at {tf32_flags()}")
        log(f"{label}: left with both TF32 flags on again (restored)")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def plain_in_float32(fn):
    """A kernel phase: its comparisons with the plain versions, whose
    float32 parts (convolutions, products) the bars assume exact, run
    inside the port's `full_float32` block, whatever the process's TF32
    flags."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with full_float32():
            return fn(*args, **kwargs)
    return inner


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
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; PyTorch's TF32 defaults, "
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
        s, mc = gd.image_size, gd.model.cfg
        x = torch.randn(batch, s, s, mc.channels, device="cuda")
        feat = gd.encode_cond(torch.rand(batch, s, s, mc.resolved_cond_channels,
                                         device="cuda") * cond_max)
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


@plain_in_float32
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


class _Tally:
    """A count of passes that `_build.count_launch` adds to, as it adds to
    a kernel wrapper's launches: a pass made while a graph captures is
    recorded with the capture's launches and counted at each replay."""

    def __init__(self):
        self.launches = 0


UNET_PASSES = {"calls": _Tally(), "rows": _Tally(), "taps": _Tally()}


def tally_unet_passes() -> None:
    """For the rest of the run, every UNet call (and its rows, one count a
    row) and every tap pass (`UNet.down_taps`, PatchCore's denoiser
    features) adds to `UNET_PASSES` where it runs, through
    `_build.count_launch`: a replayed graph runs no Python, and counts the
    passes its capture made as it counts the capture's launches."""
    forward, down_taps = UNet.forward, UNet.down_taps

    @functools.wraps(forward)
    def counted_forward(self, x, *args, **kwargs):
        _build.count_launch(UNET_PASSES["calls"])
        for _ in range(x.shape[0]):
            _build.count_launch(UNET_PASSES["rows"])
        return forward(self, x, *args, **kwargs)

    @functools.wraps(down_taps)
    def counted_taps(self, *args, **kwargs):
        _build.count_launch(UNET_PASSES["taps"])
        return down_taps(self, *args, **kwargs)

    UNet.forward, UNet.down_taps = counted_forward, counted_taps


@contextlib.contextmanager
def counted_passes():
    """The UNet calls, rows and tap passes made inside the block
    (`tally_unet_passes`), as {'calls', 'rows', 'taps'}, filled when the
    block ends."""
    before = {k: t.launches for k, t in UNET_PASSES.items()}
    seen = {}
    try:
        yield seen
    finally:
        seen.update({k: t.launches - before[k] for k, t in UNET_PASSES.items()})


@contextlib.contextmanager
def eager_chains(pipe):
    """`pipe.translate` runs the eager samplers inside the block: the
    compiled chain's twin."""
    compiles, pipe.compiles = pipe.compiles, False
    try:
        yield
    finally:
        pipe.compiles = compiles


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
    launches per UNet call in each chain and while serving; the UNet calls
    and rows of each chain (a branched call counts its two halves) are
    counted where they run (`counted_passes`), for model-steps/s."""
    gd = pipe.gd
    calls = gd.diff_cfg.resolved_sampling_timesteps  # UNet calls per chain (DDPM or DDIM)
    lo, hi = pipe.min_max_val
    b = lr.shape[0]
    results, perf = [], {}
    reset_counts()
    for mask, want_branched in chains:
        before = read_counts()
        with counted_passes() as seen:
            res = pipe.translate(lr, hr=hr, noise=1, mask=mask)
        rows = seen["rows"]
        got = {k: v - before[k] for k, v in read_counts().items()}
        dt = float(res["time"])
        kind = "branched" if want_branched else "plain"
        log(f"{label} {kind} chain: {dt * 1e3:.1f}ms for {b} images -> {b / dt:.3f} img/s, "
            f"{rows / dt:.1f} model-steps/s ({rows} UNet rows in {seen['calls']} calls); "
            f"mse {float(res['mse']):.4f} ssim {float(res['ssim']):.4f} "
            f"psnr {float(res['psnr']):.2f}; launches {got}")
        if bool(res["branched"]) != want_branched:
            raise RuntimeError(f"{label}: the {kind} chain took the wrong sampler")
        if seen["calls"] != calls:
            raise RuntimeError(f"{label} {kind} chain: {seen['calls']} UNet calls, not {calls}")
        check_counts(got, per_call, calls, f"{label} {kind} chain")
        _check_images(f"{label} {kind} chain", res["pred"], lr.shape, lo, hi)
        results.append(res)
        perf[kind] = dict(chain_s=dt, img_per_s=b / dt, model_steps_per_s=rows / dt)
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


def profile_chain(pipe, lr, mask, label, top=12, eager=False) -> dict:
    """Where one branched chain's time goes on the card (torch.profiler,
    the card's activity only: the host's op events add nothing to the
    kernels' sums and took ~2 minutes of host time to summarise for the
    256px chain's 245,000 kernels; the sums agree within 0.01%, NVIDIA H100
    80GB HBM3, 700 W).  The chain is the compiled one, its programs
    captured by an unprofiled chain first, or with `eager` the eager
    twin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with eager_chains(pipe) if eager else contextlib.nullcontext():
        pipe.translate(lr, noise=1, mask=mask)  # captures, unprofiled
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = pipe.translate(lr, noise=1, mask=mask)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = float(res["time"]) * 1e6
    log(f"{label} profile ({'eager' if eager else 'compiled'}): chain {wall_us / 1e3:.1f}ms "
        f"wall (profiled), card busy "
        f"{busy_us / 1e3:.1f}ms = {100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.2f}ms {e.count:7d}x  {e.key[:110]}")
    return dict(busy_share=busy_us / wall_us, busy_ms=busy_us / 1e3)


COMPILED = {}  # configuration → its compiled chain against the eager twin
COMPILED_LABELS = ("flagship", "256px", "stem", "seg", "gated")


def _program_summary(pipe) -> dict:
    """Each of the pipeline's programs ('name@batch'): graphs, nodes by
    step body, capture and instantiation seconds, replays."""
    out = pipe.programs.summary()
    return {f"{k[0]}@{k[1]}" + ("/plain" if not all(k[-1]) else ""): v
            for k, v in out["programs"].items()}


def compiled_twin(label, pipe, lr, hr, mask, want) -> dict:
    """A configuration's compiled chain against its eager twin: `translate`
    once more through the captured programs (every step a replay) and once
    with the eager samplers (`eager_chains`), with the same noise (seed 1)
    and mask.  The outputs
    (and a gated chain's fusion_time) equal each other's and `want`'s (the
    main path's chain, which captured) bit for bit, and the launches are
    the same; prints the walls, each chain's peak memory (allocated and
    reserved, which holds the graphs' pool, after `empty_cache`) and each
    program's graphs, nodes, capture and instantiation seconds."""
    runs = {}
    for kind, eager in (("compiled", False), ("eager", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = read_counts()
        with eager_chains(pipe) if eager else contextlib.nullcontext():
            res = pipe.translate(lr, hr=hr, noise=1, mask=mask)
        torch.cuda.synchronize()
        runs[kind] = dict(res=res, launches={k: v - before[k] for k, v in read_counts().items()},
                          base_bytes=base, peak_allocated=torch.cuda.max_memory_allocated(),
                          peak_reserved=torch.cuda.max_memory_reserved())
    c, e = runs["compiled"]["res"], runs["eager"]["res"]
    keys = ["pred"] + (["fusion_time"] if "fusion_time" in want else [])
    bit_equal = all(np.array_equal(r[k], e[k]) for r in (c, want) for k in keys)
    launches_equal = runs["compiled"]["launches"] == runs["eager"]["launches"]
    programs = _program_summary(pipe)
    rec = dict(compiled_s=float(c["time"]), eager_s=float(e["time"]),
               first_chain_s=float(want["time"]), bit_equal=bit_equal,
               launches_equal=launches_equal, launches=runs["compiled"]["launches"],
               max_abs_diff=float(np.abs(c["pred"] - e["pred"]).max()),
               memory={k: {m: runs[k][m] for m in ("base_bytes", "peak_allocated",
                                                  "peak_reserved")} for k in runs},
               programs=programs)
    gib = 2.0**30
    log(f"compiled {label}: chain {rec['compiled_s'] * 1e3:.1f}ms compiled (replays; the main "
        f"path's {rec['first_chain_s'] * 1e3:.1f}ms) vs {rec['eager_s'] * 1e3:.1f}ms eager "
        f"(x{rec['eager_s'] / rec['compiled_s']:.2f}); bit for bit {bit_equal} (max |diff| "
        f"{rec['max_abs_diff']:.3g}), launches equal {launches_equal}; peak memory allocated/"
        f"reserved compiled {runs['compiled']['peak_allocated'] / gib:.3f}/"
        f"{runs['compiled']['peak_reserved'] / gib:.3f} GiB, eager "
        f"{runs['eager']['peak_allocated'] / gib:.3f}/{runs['eager']['peak_reserved'] / gib:.3f} "
        f"GiB (base {runs['eager']['base_bytes'] / gib:.3f}); programs "
        + "; ".join(f"{k}: {v['graphs']} graphs, nodes {v['nodes']}, capture "
                    f"{v['capture_s']:.3f}s, instantiate {v['instantiate_s']:.3f}s, "
                    f"{v['replays']} replays" for k, v in programs.items()))
    if not (bit_equal and launches_equal):
        raise RuntimeError(f"{label}: the compiled chain differs from the eager one: {rec}")
    COMPILED[label] = rec
    return rec


def top_kernels(fn, label, top=8) -> dict:
    """The card's kernels of one fn() by device time (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"{label} profile: {busy_us / 1e3:.3f}ms of kernels, "
        f"{sum(e.count for e in kernels)} launches")
    ranked = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    for e in ranked:
        log(f"  {e.self_device_time_total / 1e3:8.3f}ms {e.count:5d}x  {e.key[:110]}")
    return dict(busy_ms=busy_us / 1e3,
                top={e.key[:80]: e.self_device_time_total / 1e3 for e in ranked})


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
    compiled_twin("flagship", pipe, lr, hr, mask, res)

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

@plain_in_float32
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


@plain_in_float32
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


@plain_in_float32
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
    pipe.translate(lr, hr=hr, noise=1, mask=mask)  # captures (not counted)
    torch.cuda.synchronize()
    (res,), counts, perf = run_main_path(pipe, lr, hr, [(mask, True)], MRI_PER_CALL,
                                         MRI_SERVE_BATCH, "256px")
    compiled_twin("256px", pipe, lr, hr, mask, res)

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

    # the profiled chain at a fifth of the depth (ancestral T=50, the same
    # weights and UNet calls a step): summarising the T=250 chain's 245,000
    # kernels took ~80 s of host time
    cut = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, timesteps=MRI_PROFILE_STEPS,
                                                    sampling_timesteps=None))
    gd_cut = build_gd(cut, device="cuda")
    gd_cut.model.load_state_dict(gd.model.state_dict())
    pipe_cut = LocalDiffusionPipeline(cut, gd_cut)
    label = f"256px (T={MRI_PROFILE_STEPS} of the T={gd.num_timesteps} chain's weights)"
    prof = profile_chain(pipe_cut, lr, mask, label, top=16)
    prof_eager = profile_chain(pipe_cut, lr, mask, label, top=4, eager=True)
    COMPILED["256px"].update(busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
                             eager_busy_share=prof_eager["busy_share"],
                             eager_busy_ms=prof_eager["busy_ms"],
                             profiled_steps=MRI_PROFILE_STEPS)
    del gd_cut, pipe_cut
    prof["busy_ms"] *= gd.num_timesteps / MRI_PROFILE_STEPS
    log(f"256px chain device time: {prof['busy_ms']:.1f}ms of kernels for the "
        f"T={gd.num_timesteps} chain (T={MRI_PROFILE_STEPS} profiled, x"
        f"{gd.num_timesteps // MRI_PROFILE_STEPS})")
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
        # waits for this thread's stream, not the whole device: the server's
        # sampling thread may be capturing a graph, which a device-wide wait
        # breaks
        torch.cuda.current_stream().synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = self.inner.detect(lr)
        torch.cuda.current_stream().synchronize()
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
    calib = bank_images(cfg, STAGE_A_CALIB)
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
    return dict(counts=counts, perf=perf, checks=checks, gd=gd, bank_path=bank_path)


# ---------------------------------------------------------------------------
# the classifier-gated 256px configuration: Stage A, the branched chain and
# the gated phase B
# ---------------------------------------------------------------------------

class CountedGate:
    """Wraps a sampler gate: counts its calls (the gated steps: one retry
    each) and the kernel launches of its tap passes, and records its values
    on the device."""

    def __init__(self, inner):
        self.inner = inner
        self.calls, self.launches, self.values = 0, {}, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, x_start, t=None):
        before = read_counts()
        v = self.inner(x_start, t)
        for k, n in read_counts().items():
            self.launches[k] = self.launches.get(k, 0) + n - before[k]
        self.calls += 1
        self.values.append(v)
        return v


def expected_gated(calls: int, gated_steps: int, detects: int) -> dict:
    """Launches of `detects` Stage A detects and chains of `calls` UNet calls
    in all whose gate ran at `gated_steps` steps: each gated step adds a tap
    pass (the gate) and a [2B] UNet call (the retry)."""
    return {k: (MRI_PER_CALL.get(k, 0) * (calls + gated_steps)
                + STAGE_A_PER_DETECT.get(k, 0) * (gated_steps + detects)) for k in COUNTERS}


def _check_launches(got: dict, want: dict, what: str) -> None:
    if any(got[k] != want[k] for k in COUNTERS):
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def _score_agreement(got, want) -> tuple:
    """(max relative difference of a score, relative L2 of the scores)."""
    return (float(np.max(np.abs(got - want) / np.abs(want))),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)))


def scores_float64(cls, x) -> np.ndarray:
    """The classifier's image scores of x recomputed on the card in float64
    from its own float32 patch embeddings: the nearest-neighbour distances
    and the reweighting in float64, so the float32 rounding of the distance
    identity drops out and only the embeddings' differences remain."""
    pc = cls.patchcore
    bank = pc.memory_bank.to("cuda", torch.float64)
    out = []
    for i in range(0, len(x), 8):
        emb = pc.embed_map(cls._prep(x[i:i + 8]))
        b, _, _, c = emb.shape
        e = emb.reshape(-1, c).to("cuda", torch.float64)
        dist, loc = nearest_neighbors(e, bank, 1)
        out.append(compute_anomaly_score(dist.reshape(b, -1), loc.reshape(b, -1), e, bank,
                                         pc.num_neighbors).cpu().numpy())
    return np.concatenate(out)


def gated256(gd, bank_path) -> dict:
    """The classifier-gated configuration on Stage A's denoiser (the same
    seeded random weights) and detector bank: (a) the classifier's bank and
    its ROC threshold, (b) its scores on the card against the CPU and
    against the plain versions, (c) the counted main path: `translate`
    without a mask and the server, gated, (d) the chain with forced
    thresholds, whose decisions cannot flip on rounding."""
    cfg = mri256_gated_config().replace(ood=dataclasses.replace(
        mri256_gated_config().ood, memory_bank_path=bank_path))
    s = gd.image_size
    d = cfg.data
    log(f"gated 256px: start_timestep {cfg.sampler.start_timestep}, classifier_obj "
        f"{cfg.sampler.classifier_obj}, polarity {cfg.sampler.classifier_polarity}, retry "
        f"budget {cfg.sampler.max_classifier_retries}, threshold ROC-calibrated; Stage A's "
        f"weights and detector bank ({bank_path})")

    # (a) the classifier's bank: 64 normal FLAIR targets -> a 5% coreset
    obj_path = classifier_bank_beside(bank_path, cfg)
    built = build_classifier_bank(cfg, obj_path, gd=gd, n_images=GATED_BANK_IMAGES)
    bank, secs = built["bank"], built["seconds"]
    if bank.shape != GATED_BANK_SHAPE or not np.all(np.isfinite(bank)):
        raise RuntimeError(f"classifier bank {bank.shape}, expected {GATED_BANK_SHAPE}")
    fe, cfg = build_frontend(cfg, gd=gd, device="cuda", verbose=False)
    pairs = classifier_calibration_pairs(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gate = build_classifier_gate(cfg, frontend=fe, calibration_pairs=pairs, gd=gd,
                                 verbose=False)
    calib_s = time.perf_counter() - t0
    labels, scores = gate.classifier.calibration
    thr = gate.threshold
    acc = balanced_accuracy(labels, scores, thr)
    sn, sl = scores[labels == 1], scores[labels == 2]
    log(f"gated bank: {GATED_BANK_IMAGES} normal FLAIR at {s}px, {built['patches']} patches "
        f"-> {bank.shape} ({bank.nbytes / 1e6:.1f} MB) at {obj_path}; taps {secs['taps']:.3f}s, "
        f"k-center {secs['kcenter']:.3f}s ({bank.shape[0]} steps); calibration "
        f"{len(pairs)} images ({len(sn)} normal, {len(sl)} with a lesion) {calib_s:.3f}s; ROC "
        f"threshold {thr:.6g}, balanced accuracy {acc:.4f}; scores normal "
        f"{sn.mean():.4f}+-{sn.std():.4f}, lesion {sl.mean():.4f}+-{sl.std():.4f}")
    if not np.isfinite(thr):
        raise RuntimeError("the ROC threshold separates nothing: the gate would never reject")

    # (b) the classifier's scores: card against CPU (f32, bf16) on a subset
    # of the calibration images, kernels against plain versions on all
    x_all = np.concatenate([img for img, _ in pairs])
    sub = np.r_[0:GATED_CHECK_PER_CLASS, len(sn):len(sn) + GATED_CHECK_PER_CLASS]
    state = {k: v.cpu() for k, v in gd.model.state_dict().items()}
    checks = {}

    def classifier_on(g):
        return ClassifierPatchCore(PatchCore(cfg.ood, source=DenoiserFeatureSource(
            g, t=cfg.ood.feature_t), memory_bank=bank))

    def scores_of(cls, x):
        return np.concatenate([cls.score_raw(x[i:i + 8]).cpu().numpy()
                               for i in range(0, len(x), 8)])

    for dtype in ("float32", "bfloat16"):
        c2 = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
        card = gd if dtype == "bfloat16" else build_gd(c2, device="cuda")
        card.model.load_state_dict(state)
        cpu = build_gd(c2, device="cpu")
        cpu.model.load_state_dict(state)
        cls_card, cls_cpu = classifier_on(card), classifier_on(cpu)
        got = scores_of(cls_card, x_all[sub])
        t0 = time.perf_counter()
        want = scores_of(cls_cpu, x_all[sub])
        cpu_s = time.perf_counter() - t0
        worst, rel = _score_agreement(got, want)
        check = dict(max_rel=worst, rel_l2=rel)
        if dtype == "float32":
            # the cause of the worst score's difference: each side's score
            # again in float64 from the same side's embeddings
            got64 = scores_float64(cls_card, x_all[sub])
            want64 = scores_float64(cls_cpu, x_all[sub])
            emb_worst, _ = _score_agreement(got64, want64)
            own = [_score_agreement(got, got64)[0], _score_agreement(want, want64)[0]]
            i = int(np.argmax(np.abs(got - want) / np.abs(want)))
            ok = (rel <= GATED_F32_REL and worst <= GATED_F32_SCORE_REL
                  and emb_worst <= GATED_F32_REL)
            bar = (f"relative L2 <= {GATED_F32_REL:g}, each score <= {GATED_F32_SCORE_REL:g}, "
                   f"each float64 score <= {GATED_F32_REL:g}")
            kind = "normal" if i < GATED_CHECK_PER_CLASS else "lesion"
            detail = (f"; the worst, score {i} ({kind}): float32 card {got[i]:.7f}, CPU "
                      f"{want[i]:.7f}, float64 from the card's "
                      f"embeddings {got64[i]:.9f}, from the CPU's {want64[i]:.9f}; float64 scores "
                      f"card vs CPU: max relative difference {emb_worst:.4g}; each side's float32 "
                      f"score vs its float64: max relative difference card {own[0]:.4g}, CPU "
                      f"{own[1]:.4g}")
            check.update(max_rel_float64=emb_worst, float32_vs_float64_card=own[0],
                         float32_vs_float64_cpu=own[1], worst_index=i,
                         worst=dict(card=float(got[i]), cpu=float(want[i]),
                                    card_float64=float(got64[i]), cpu_float64=float(want64[i])))
        else:
            ok = rel <= MRI_UNET_REL
            bar, detail = f"relative L2 <= {MRI_UNET_REL:g}", ""
        log(f"gated check, classifier scores card vs CPU ({dtype}, {len(sub)} of the "
            f"{len(x_all)} calibration images, cut for the CPU's time; same weights and bank): "
            f"relative L2 {rel:.4g}, max relative difference of a score {worst:.4g}{detail} "
            f"({bar}) {'ok' if ok else 'FAIL'}; CPU {cpu_s:.1f}s")
        if not ok:
            raise RuntimeError(f"the classifier on the card disagrees with the CPU's ({dtype})")
        checks[f"scores_card_vs_cpu_{dtype}"] = check
        if dtype == "float32":
            del card
        del cpu
    got = scores_of(classifier_on(gd), x_all)
    gd.model.use_plain_kernels(True)
    try:
        want = scores_of(classifier_on(gd), x_all)
    finally:
        gd.model.use_plain_kernels(False)
    worst, rel = _score_agreement(got, want)
    ok = rel <= MRI_UNET_REL
    log(f"gated check, classifier scores kernels vs plain versions on the card (bf16, all "
        f"{len(x_all)} calibration images): relative L2 {rel:.4g} (<= {MRI_UNET_REL:g}), max "
        f"relative difference of a score {worst:.4g}; decisions at the threshold differ for "
        f"{int(np.sum((got > thr) != (want > thr)))} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the classifier with the kernels disagrees with the plain versions")
    checks["scores_kernels_vs_plain_bfloat16"] = dict(max_rel=worst, rel_l2=rel)

    # (c) the counted main path: translate without a mask, then the server
    counted_fe, counted_gate = CountedFrontend(fe), CountedGate(gate)
    pipe = LocalDiffusionPipeline(cfg, gd, frontend=counted_fe, classifier_gate=counted_gate)
    lo, hi = pipe.min_max_val
    hr, lr, _ = synthetic_brain_translation(MRI_BATCH, s, tumor=True, seed=11,
                                            mean_t1=d.mean_t1, std_t1=d.std_t1,
                                            mean_flair=d.mean_flair, std_flair=d.std_flair)
    calls = gd.diff_cfg.resolved_sampling_timesteps
    t_fuse = cfg.sampler.start_timestep
    reset_counts()
    clock = StageClock("cuda")
    res = pipe.translate(lr, hr=hr, noise=1, clock=clock)
    total = read_counts()
    ft = res["fusion_time"]
    split = clock.split()
    steps = counted_gate.calls
    chain_s = float(res["time"])
    if not bool(res["branched"]):
        raise RuntimeError("Stage A gated no tumour brain: the chain was not branched")
    if steps != t_fuse - int(ft.min()) or len(ft) != MRI_BATCH:
        raise RuntimeError(f"the gate ran at {steps} steps, fusion_time {ft.tolist()}")
    _check_launches(total, expected_gated(calls, steps, 1), "gated main path translate")
    _check_images("gated main path chain", res["pred"], lr.shape, lo, hi)
    values = torch.stack(counted_gate.values).float().cpu().numpy()
    phase_b = {k: split[k] for k in ("plain", "gate", "retry")}
    log(f"gated main path: translate without a mask, batch {MRI_BATCH} tumour brains: "
        f"fusion_time {ft.tolist()}: {int(np.sum(ft == t_fuse - 1))} accepted at the first "
        f"gated step (t={t_fuse - 1}), {int(np.sum(ft < t_fuse - 1))} rejected at least once; "
        f"the gate ran at {steps} steps (values {np.round(values, 4).tolist()}); chain "
        f"{chain_s * 1e3:.1f}ms wall -> {MRI_BATCH / chain_s:.3f} img/s (Stage A "
        f"{counted_fe.seconds[-1] * 1e3:.2f}ms before it); device timeline: up to phase B "
        f"(Stage A included) {split['chain']:.1f}ms, phase B ({t_fuse} steps) plain steps "
        f"{phase_b['plain']:.2f}ms, gate {phase_b['gate']:.2f}ms, retry {phase_b['retry']:.2f}ms; mse "
        f"{float(res['mse']):.4f}; launches {total} (Stage A {counted_fe.launches}, gate "
        f"{counted_gate.launches})")
    chain_counts = read_counts()
    srv = InferenceServer(pipe, batch_size=MRI_BATCH, max_wait_ms=500)
    gate_calls, detects = counted_gate.calls, counted_fe.calls
    t0 = time.perf_counter()
    with srv:
        futs = [srv.submit(x) for x in lr]
        outs = [f.result(timeout=600) for f in futs]
    served_s = time.perf_counter() - t0
    stats = srv.snapshot_stats()
    counts = read_counts()
    served_steps = counted_gate.calls - gate_calls
    dispatches = (stats["merged_dispatches"] + stats["plain_dispatches"]
                  + stats["branched_dispatches"])
    log(f"gated serving: {stats['requests']} requests without masks in {stats['batches']} "
        f"batch(es), {dispatches} dispatch(es), mean latency {stats['latency_mean_s'] * 1e3:.1f}ms "
        f"({served_s:.2f}s wall); the gate ran at {served_steps} steps; branched flags "
        f"{[o['branched'] for o in outs]}")
    if stats["requests"] != MRI_BATCH or dispatches != 1 or counted_fe.calls - detects != 1:
        raise RuntimeError(f"gated server stats {stats}")
    for i, o in enumerate(outs):
        _check_images(f"gated served request {i}", o["pred"], (s, s, 1), lo, hi)
    _check_launches({k: counts[k] - chain_counts[k] for k in COUNTERS},
                    expected_gated(calls, served_steps, 1), "gated serving")
    log(f"gated main path: launches {counts}")
    compiled_twin("gated", pipe, lr, hr, res["mask"], res)

    # (d) forced thresholds at T = 50: always accept, always reject
    cut = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, timesteps=GATED_FORCED_T))
    gd50 = build_gd(cut, device="cuda")
    gd50.model.load_state_dict(gd.model.state_dict())
    mask = res["mask"]
    forced = {}
    for name, threshold in (("accept", np.inf), ("reject", -np.inf)):
        cls = classifier_on(gd50)
        cls.threshold = threshold
        fpipe = LocalDiffusionPipeline(cut, gd50, classifier_gate=CountedGate(
            cls.as_sampler_gate("suppress")))
        reset_counts()
        out = fpipe.translate(lr, noise=2, mask=mask)
        got_counts = read_counts()
        fsteps = fpipe.classifier_gate.calls
        want_ft = [t_fuse - 1] * MRI_BATCH if name == "accept" else [1] * MRI_BATCH
        want_steps = 1 if name == "accept" else t_fuse - 1
        if out["fusion_time"].tolist() != want_ft or fsteps != want_steps:
            raise RuntimeError(f"always {name}: fusion_time {out['fusion_time'].tolist()}, "
                               f"gate at {fsteps} steps")
        _check_launches(got_counts, expected_gated(GATED_FORCED_T, fsteps, 0),
                        f"always {name}")
        gd50.model.use_plain_kernels(True)
        try:
            plain = fpipe.translate(lr, noise=2, mask=mask)
        finally:
            gd50.model.use_plain_kernels(False)
        a, p = out["pred"].ravel(), plain["pred"].ravel()
        rel = float(np.linalg.norm(a - p) / np.linalg.norm(p))
        corr = float(np.corrcoef(a, p)[0, 1])
        same_ft = plain["fusion_time"].tolist() == out["fusion_time"].tolist()
        ok = rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR and same_ft
        line = (f"gated forced, always {name} (suppress, threshold {threshold}; T cut to "
                f"{GATED_FORCED_T} for the time limit, full width): fusion_time "
                f"{out['fusion_time'].tolist()}, the gate at {fsteps} steps; launches "
                f"{got_counts}; kernels vs plain versions: relative L2 {rel:.4g}, correlation "
                f"{corr:.6f}, fusion_time equal {same_ft}")
        if name == "accept":
            ungated = LocalDiffusionPipeline(cut, gd50).translate(lr, noise=2, mask=mask)
            bit = bool(np.array_equal(out["pred"], ungated["pred"]))
            line += f"; bit-equal to the ungated chain (same seed): {bit}"
            ok = ok and bit
            forced["accept_bit_equal"] = bit
        log(line + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the forced 'always {name}' chain failed its checks")
        forced[name] = dict(rel_l2=rel, corr=corr, gate_steps=fsteps)
    with tf32_on_at_entry("gated float32"):
        forced["reject_float32"] = gated_float32(cut, gd50, mask, lr, classifier_on)
    del gd50
    perf = dict(chain_s=chain_s, img_per_s=MRI_BATCH / chain_s, phase_b_ms=phase_b,
                phase_b_ms_per_step={k: v / t_fuse for k, v in phase_b.items()},
                gate_steps=steps, fusion_time=ft.tolist(), threshold=thr,
                balanced_accuracy=acc, serve_latency_mean_s=stats["latency_mean_s"],
                bank_seconds=dict(secs, calibration=calib_s), bank_shape=list(bank.shape))
    return dict(counts=counts, perf=perf, checks=dict(checks, forced=forced))


def gated_float32(cut, gd50, mask, lr, classifier_on) -> dict:
    """Always reject at the configuration file's float32 (T = 50, full
    width): the kernels that serve float32 (the GroupNorm and attention
    kernels; the fused ResnetBlock and linear attention take bf16 only)
    counted through the gated chain, and held against the plain versions."""
    c32 = cut.replace(train=dataclasses.replace(cut.train, compute_dtype="float32"))
    gd32 = build_gd(c32, device="cuda")
    gd32.model.load_state_dict(gd50.model.state_dict())
    t_fuse = c32.sampler.start_timestep
    cond = torch.as_tensor(np.concatenate([lr, lr]), device="cuda")
    with torch.no_grad():
        feat = gd32.encode_cond(cond)
        reset_counts()
        gd32.apply_model(torch.randn_like(cond), None,
                         torch.full((len(cond),), t_fuse, dtype=torch.long, device="cuda"),
                         cond_feat=feat)
    per_call = read_counts()  # one [2B] UNet call
    reset_counts()
    ungated = LocalDiffusionPipeline(c32, gd32).translate(lr, noise=2, mask=mask)
    per_chain = read_counts()
    cls = classifier_on(gd32)
    cls.threshold = -np.inf
    gate = CountedGate(cls.as_sampler_gate("suppress"))
    pipe = LocalDiffusionPipeline(c32, gd32, classifier_gate=gate)
    reset_counts()
    out = pipe.translate(lr, noise=2, mask=mask)
    got, steps, tap_launches = read_counts(), gate.calls, dict(gate.launches)
    # the ungated chain is T UNet calls; each gated step adds a tap pass
    # (counted by the gate) and a [2B] UNet call, the retry
    want = {k: per_call[k] * (GATED_FORCED_T + steps) + tap_launches.get(k, 0)
            for k in COUNTERS}
    if any(per_chain[k] != per_call[k] * GATED_FORCED_T for k in COUNTERS) or got != want:
        raise RuntimeError(f"float32 always reject: launches {got}, expected {want} (one UNet "
                           f"call {per_call}, the ungated chain {per_chain}, gate "
                           f"{tap_launches})")
    if not (per_call["groupnorm_film_silu"] and per_call["flash_attention"]):
        raise RuntimeError(f"a float32 UNet call launched no GroupNorm or attention kernel: "
                           f"{per_call}")
    if out["fusion_time"].tolist() != [1] * len(lr) or steps != t_fuse - 1:
        raise RuntimeError(f"float32 always reject: fusion_time {out['fusion_time'].tolist()}, "
                           f"gate at {steps} steps")
    gd32.model.use_plain_kernels(True)
    try:
        plain = pipe.translate(lr, noise=2, mask=mask)
    finally:
        gd32.model.use_plain_kernels(False)
    a, p = out["pred"].ravel(), plain["pred"].ravel()
    rel = float(np.linalg.norm(a - p) / np.linalg.norm(p))
    corr = float(np.corrcoef(a, p)[0, 1])
    same_ft = plain["fusion_time"].tolist() == out["fusion_time"].tolist()
    moved = float(np.linalg.norm(a - ungated["pred"].ravel()) / np.linalg.norm(p))
    ok = rel <= STEM_CHAIN_REL and same_ft and np.all(np.isfinite(a))
    log(f"gated forced, always reject at the configuration file's float32 (suppress, threshold "
        f"-inf; T cut to {GATED_FORCED_T}, full width): fusion_time {out['fusion_time'].tolist()}, "
        f"the gate at {steps} steps; launches {got} (one UNet call {per_call}, the "
        f"gate's tap passes {tap_launches}); kernels vs plain versions: relative L2 {rel:.4g} "
        f"(<= {STEM_CHAIN_REL:g}), correlation {corr:.8f}, fusion_time equal {same_ft}; the "
        f"retries moved the image from the ungated chain's by {moved:.4g} relative L2 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the float32 'always reject' chain failed its checks")
    return dict(rel_l2=rel, corr=corr, gate_steps=steps, launches=got, per_call=per_call,
                per_tap_pass={k: v // steps for k, v in tap_launches.items()})


# ---------------------------------------------------------------------------
# the 256px bf16 seg configuration: the seg detector, the WRN50-2 and
# seg-encoder sources, the classifier gate's WRN last resort
# ---------------------------------------------------------------------------

def _seeded_seg_npz(path: Path) -> str:
    """A SegUNet (base 64) with PyTorch's default init under `SEG_SEED`,
    written as the JAX package's slim npz (flat `params/...` keys, fp16)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEG_SEED)
        model = SegUNet()
    tree = flax_seg_tree(model)
    np.savez(path, **{k: v.astype(np.float16) for k, v in tree.items()})
    return str(path)


def _seg_cpu(npz: str) -> SegUNet:
    model = SegUNet()
    model.load_state_dict(load_seg_npz(npz, model))
    return model.eval().requires_grad_(False)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _detect_card_vs_cpu(label, fe_card, fe_cpu, lr, ladder, ood) -> dict:
    """A PatchCore front end's detect on the card against the CPU's: the
    map within `SEG_WRN_F32_REL`, the masks equal but in an image with a map
    value within `STAGE_A_NEAR` of a threshold.  Prints the card's split."""
    fe_card.time_stages = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        _, b_card, m_card = fe_card.detect(lr)
    finally:
        fe_card.time_stages = False
    card_ms = 1e3 * (time.perf_counter() - t0)
    split = fe_card.last_split
    t0 = time.perf_counter()
    _, b_cpu, m_cpu = fe_cpu.detect(lr)
    cpu_s = time.perf_counter() - t0
    rel = _rel_l2(m_card, m_cpu)
    differ = [int((b_card[i] != b_cpu[i]).sum()) for i in range(len(lr))]
    near = [near_threshold(m_cpu[i], ladder, STAGE_A_NEAR, ood.refine_hi_frac,
                           ood.refine_lo_frac) for i in range(len(lr))]
    ok = rel <= SEG_WRN_F32_REL and all(n == 0 or nr for n, nr in zip(differ, near))
    log(f"{label} detect, card vs CPU (f32, batch {len(lr)} tumour brains, same weights and "
        f"bank): map rel L2 {rel:.4g} (tol {SEG_WRN_F32_REL:g}), max_abs_err "
        f"{float(np.abs(m_card - m_cpu).max()):.4g}; binary pixels differing {differ} (near a "
        f"threshold: {near}); OOD share per image "
        f"{[round(float(b.mean()), 4) for b in b_card]} {'ok' if ok else 'FAIL'}; card "
        f"{card_ms:.2f}ms wall (features {split['features']:.3f}ms, nn {split['nn']:.3f}ms, "
        f"map {split['map']:.3f}ms, host {split['host']:.3f}ms); CPU {cpu_s:.1f}s")
    if not ok:
        raise RuntimeError(f"{label}: detect on the card disagrees with the CPU's")
    return dict(map_rel_l2=rel, binary_differ=differ, split_ms=split, detect_ms=card_ms)


def _counted_translate(label, pipe, counted, lr, hr, calls) -> tuple:
    """With every count at 0, `translate` without a mask: Stage A (its
    launches apart) and the branched chain, `calls` UNet calls of the 256px
    kernels.  → (result, Stage A launches, Stage B launches)."""
    lo, hi = pipe.min_max_val
    reset_counts()
    res = pipe.translate(lr, hr=hr, noise=1)
    total = read_counts()
    stage_a = {k: counted.launches.get(k, 0) for k in COUNTERS}
    counted.launches = {}
    stage_b = {k: v - stage_a[k] for k, v in total.items()}
    chain_s = float(res["time"])
    log(f"{label} main path: translate without a mask, batch {len(lr)} tumour brains: Stage A "
        f"{counted.seconds[-1] * 1e3:.2f}ms wall, mask areas "
        f"{[int(m.sum()) for m in res['mask']]} px of {res['mask'][0].size}; then the "
        f"{'branched' if bool(res['branched']) else 'PLAIN'} bf16 DDIM-{calls} chain "
        f"{chain_s * 1e3:.1f}ms -> {len(lr) / chain_s:.3f} img/s; mse {float(res['mse']):.4f}; "
        f"launches Stage A {stage_a}, Stage B {stage_b}")
    if not bool(res["branched"]):
        raise RuntimeError(f"{label}: the chain was not branched")
    check_counts(stage_a, {}, 1, f"{label} Stage A detect")
    check_counts(stage_b, MRI_PER_CALL, calls, f"{label} Stage B chain")
    _check_images(f"{label} chain", res["pred"], lr.shape, lo, hi)
    return res, stage_a, stage_b


def scores_tf32(cls, x) -> np.ndarray:
    """The control of the f32 score bar: the classifier's image scores of x
    with the distance product in TF32 on the card (the search turns TF32
    off for itself; that block is lifted for this call only)."""
    block, flag = PC.full_float32, torch.backends.cuda.matmul.allow_tf32
    PC.full_float32 = contextlib.nullcontext
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return cls.score_raw(x).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
        PC.full_float32 = block


def seg_wrn256() -> dict:
    """`mri256_bf16_config()` with cuDNN's TF32 on, as PyTorch has it by
    default: Stage A's networks must turn it off themselves (and restore
    it).  See `_seg_wrn256`."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = _seg_wrn256()
        if not torch.backends.cudnn.allow_tf32:
            raise RuntimeError("Stage A left cuDNN's TF32 off")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def _seg_wrn256() -> dict:
    """(1) the seg detector (a seeded SegUNet through `build_frontend`),
    card vs CPU, `translate` and the server without masks, the chain
    against its plain versions, a DDIM-5 chain profiled; (2) the WRN50-2
    source (`detector="patchcore"`): its bank through the bank CLI, taps,
    k-center and detect card vs CPU, `translate`; (3) the seg-encoder
    source: its bank, detect card vs CPU; (4) the classifier gate's WRN
    last resort, scores card vs CPU and the TF32 control."""
    t_phase = time.perf_counter()
    cfg = mri256_bf16_config()
    gd = build_gd(cfg, device="cuda")
    s = gd.image_size
    d = cfg.data
    calls = gd.diff_cfg.resolved_sampling_timesteps
    brains = lambda n, tumor, seed: synthetic_brain_translation(
        n, s, tumor=tumor, seed=seed, mean_t1=d.mean_t1, std_t1=d.std_t1,
        mean_flair=d.mean_flair, std_flair=d.std_flair)
    _, lr, _ = brains(SEG_WRN_BATCH, True, 11)
    hr = brains(SEG_WRN_BATCH, True, 11)[0]
    lr2 = lr[:2]
    STAGE_A_DIR.mkdir(parents=True, exist_ok=True)
    checks, perf, counts = {}, {}, {k: 0 for k in COUNTERS}

    # (1) the seg detector
    npz = _seeded_seg_npz(STAGE_A_DIR / "seg_seeded.npz")
    scfg = cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=npz))
    fe, _ = build_frontend(scfg, device="cuda", verbose=False)
    if fe is None or fe.seg_apply is None:
        raise RuntimeError("build_frontend gave no seg front end for a seg checkpoint")
    seg_card = fe.seg_apply.model
    log(f"seg detector: SegUNet base 64, {sum(p.numel() for p in seg_card.parameters())} "
        f"params (seeded, {npz} in the JAX npz format, fp16), f32, mask_dilate "
        f"{scfg.ood.resolved_mask_dilate(s)}, Stage B {cfg.model.dim_mults} bf16 DDIM-{calls} "
        f"of T={gd.num_timesteps}, {sum(p.numel() for p in gd.model.parameters())} params")
    seg_cpu = SegDetector(_seg_cpu(npz))
    got = fe.seg_apply(lr2).cpu().numpy()
    t0 = time.perf_counter()
    want = seg_cpu(lr2).numpy()
    cpu_s = time.perf_counter() - t0
    rel = _rel_l2(got, want)
    p_card, p_cpu = (1 / (1 + np.exp(-v.astype(np.float64))) for v in (got, want))
    band = np.abs(p_cpu - 0.5) <= SEG_BAND
    differ = int(((p_card > 0.5) != (p_cpu > 0.5))[~band].sum())
    ok = rel <= SEG_LOGIT_REL and differ == 0
    log(f"seg check, logits card vs CPU (f32, batch 2 at {s}px; cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32} around the call): rel L2 {rel:.4g} "
        f"(tol {SEG_LOGIT_REL:g}), max_abs_err {float(np.abs(got - want).max()):.4g}; masks "
        f"differ at {differ} pixels off the band |p - 0.5| <= {SEG_BAND:g}, which holds "
        f"{int(band.sum())} of {band.size} pixels; raw mask areas "
        f"{[int(m.sum()) for m in (p_cpu > 0.5)]} {'ok' if ok else 'FAIL'}; CPU {cpu_s:.1f}s")
    if not ok:
        raise RuntimeError("the seg detector on the card disagrees with the CPU's")
    checks["seg_logits_rel_l2"], checks["seg_band_pixels"] = rel, int(band.sum())

    counted = CountedFrontend(fe)
    pipe = LocalDiffusionPipeline(scfg, gd, frontend=counted)
    fe.detect(lr)  # warm-up
    fe.time_stages = True  # the split of a detect that has the card to itself
    fe.detect(lr)
    fe.time_stages = False
    perf["seg_split_ms"] = fe.last_split
    log(f"seg detect at batch {SEG_WRN_BATCH}, alone on the card: the UNet and sigmoid "
        f"{fe.last_split['seg']:.3f}ms (device timeline), the host's dilation by "
        f"{scfg.ood.resolved_mask_dilate(s)} with its back-off {fe.last_split['host']:.3f}ms")
    perf["seg_unet_kernels"] = top_kernels(lambda: fe.seg_apply(lr), "seg UNet at batch 4")
    res, _, sb = _counted_translate("seg", pipe, counted, lr, hr, calls)
    for k in COUNTERS:
        counts[k] += sb[k]
    compiled_twin("seg", pipe, lr, hr, res["mask"], res)
    perf["seg_chain_s"], perf["seg_detect_ms"] = float(res["time"]), counted.seconds[-1] * 1e3
    gd.model.use_plain_kernels(True)
    try:
        plain = pipe.translate(lr, noise=1, mask=res["mask"])
    finally:
        gd.model.use_plain_kernels(False)
    a, p = res["pred"].ravel(), plain["pred"].ravel()
    rel, corr = _rel_l2(a, p), float(np.corrcoef(a, p)[0, 1])
    log(f"seg check: DDIM-{calls} chain, kernels vs plain versions (same noise and mask): "
        f"relative L2 {rel:.4g} (tol {MRI_CHAIN_REL:g}), correlation {corr:.6f} (tol "
        f"{MRI_CHAIN_CORR:g}); plain-version chain {float(plain['time']):.2f}s")
    if not (rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR):
        raise RuntimeError("the seg chain with the kernels disagrees with its plain versions")
    checks["seg_chain_rel_l2"], checks["seg_chain_corr"] = rel, corr
    cut = scfg.replace(diffusion=dataclasses.replace(scfg.diffusion,
                                                     sampling_timesteps=SEG_PROFILE_STEPS))
    gd5 = build_gd(cut, device="cuda")
    gd5.model.load_state_dict(gd.model.state_dict())
    prof = profile_chain(LocalDiffusionPipeline(cut, gd5), lr, res["mask"],
                         f"seg DDIM-{SEG_PROFILE_STEPS} (the DDIM-{calls} chain's weights)", top=8)
    del gd5
    per_call = prof["busy_ms"] / SEG_PROFILE_STEPS
    log(f"seg chain device time: {per_call:.2f}ms of kernels a UNet call (DDIM-"
        f"{SEG_PROFILE_STEPS} profiled), x{calls} = {per_call * calls:.1f}ms for the DDIM-{calls} "
        f"chain, {100 * per_call * calls / (perf['seg_chain_s'] * 1e3):.1f}% of its "
        f"{perf['seg_chain_s'] * 1e3:.1f}ms wall")
    perf["seg_chain_busy_ms_per_call"] = per_call
    perf["seg_profile_busy_share"] = prof["busy_share"]

    before = read_counts()
    srv = InferenceServer(pipe, batch_size=SEG_WRN_BATCH, max_wait_ms=200)
    futs = [srv.submit(x) for x in lr[:3]]
    t0 = time.perf_counter()
    with srv:
        outs = [f.result(timeout=600) for f in futs]
    served_s = time.perf_counter() - t0
    stats = srv.snapshot_stats()
    served = {k: v - before[k] for k, v in read_counts().items()}
    dispatches = (stats["merged_dispatches"] + stats["plain_dispatches"]
                  + stats["branched_dispatches"])
    log(f"seg serving: {stats['requests']} requests without masks in {stats['batches']} "
        f"batch(es), {dispatches} dispatch(es), padded {stats['padded_slots']}, mean latency "
        f"{stats['latency_mean_s'] * 1e3:.1f}ms ({served_s:.2f}s wall); branched flags "
        f"{[o['branched'] for o in outs]}; launches {served}")
    if stats["requests"] != 3 or dispatches < 1:
        raise RuntimeError(f"seg server stats {stats}")
    for i, o in enumerate(outs):
        _check_images(f"seg served request {i}", o["pred"], (s, s, 1), *pipe.min_max_val)
    check_counts(served, MRI_PER_CALL, calls * dispatches, "seg serving")
    for k in COUNTERS:
        counts[k] += served[k]
    perf["seg_serve_latency_mean_s"] = stats["latency_mean_s"]
    del seg_cpu

    # (2) the WRN50-2 source: the bank through the CLI, 200 brains at 256px
    wcfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore"))
    wrn_bank = STAGE_A_DIR / "memory_bank_synthetic_brain_256_wrn.npy"
    built = bank_main(["--config", "mri256_bf16", "--feature-source", "wrn", "--seed", "0",
                       "--n-images", str(WRN_BANK_BRAINS), "--out", str(wrn_bank)])
    bank, secs = built["bank"], built["seconds"]
    log(f"WRN bank: {WRN_BANK_BRAINS} normal brains at {s}px, layers {wcfg.ood.layers}, "
        f"{built['patches']} patches x {bank.shape[1]} -> {bank.shape}; taps "
        f"{secs['taps']:.3f}s, k-center {secs['kcenter']:.3f}s ({bank.shape[0]} steps), ladder "
        f"{secs['ladder']:.3f}s; ladder gate {built['ladder'].gate:.6g}")
    if bank.shape != WRN_BANK_SHAPE or not np.all(np.isfinite(bank)):
        raise RuntimeError(f"WRN bank {bank.shape}, expected {WRN_BANK_SHAPE}")
    perf["wrn_bank_seconds"] = secs
    wsrc = built["patchcore"].source
    wsrc_cpu = WRNFeatureSource(wcfg.ood.layers, input_size=s, device="cpu")
    x2 = OODFrontend(wcfg, patchcore=built["patchcore"])._preprocess_patchcore(lr2)
    got = {k: v.cpu().numpy() for k, v in wsrc.apply(x2).items()}
    want = wsrc_cpu.apply(x2.cpu())
    rels = {k: _rel_l2(got[k], want[k].numpy()) for k in got}
    log(f"WRN check, taps card vs CPU (f32, batch 2, shapes "
        f"{ {k: tuple(v.shape) for k, v in got.items()} }): rel L2 {rels} (tol "
        f"{SEG_WRN_F32_REL:g})")
    if not all(r <= SEG_WRN_F32_REL for r in rels.values()):
        raise RuntimeError("the WRN's taps on the card disagree with the CPU's")
    checks["wrn_taps_rel_l2"] = rels
    n, k = WRN_KCENTER_CHECK
    emb = built["patchcore"].embed(OODFrontend(wcfg, patchcore=built["patchcore"])
                                   ._preprocess_patchcore(bank_images(wcfg, 20)))[:n]
    proj = random_projection(emb.shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = kcenter_greedy_indices(emb.contiguous(), k, proj=proj).cpu()
    card_s = time.perf_counter() - t0
    on_cpu = kcenter_greedy_indices(emb.cpu(), k, proj=proj)
    same = torch.equal(on_card, on_cpu)
    log(f"WRN check, k-center card vs CPU ({n} x {emb.shape[1]}, k {k}): indices "
        f"{'identical' if same else 'DIFFER'}; card {card_s:.2f}s")
    if not same:
        raise RuntimeError("k-center on the card picks other rows than on the CPU (WRN)")
    checks["wrn_kcenter_identical"] = True
    del emb
    wcfg = wcfg.replace(ood=dataclasses.replace(wcfg.ood, memory_bank_path=str(wrn_bank)))
    wfe, wcfg2 = build_frontend(wcfg, device="cuda", verbose=False)
    if wcfg2.ood.ladder_path != built["ladder_path"]:
        raise RuntimeError(f"build_frontend found ladder {wcfg2.ood.ladder_path!r}")
    wfe_cpu = OODFrontend(wcfg2, patchcore=PatchCore(wcfg2.ood, memory_bank=bank, device="cpu"))
    wfe.detect(lr)  # warm-up
    checks["wrn_detect"] = _detect_card_vs_cpu("WRN", wfe, wfe_cpu, lr, built["ladder"],
                                               wcfg2.ood)
    del wfe_cpu
    wcounted = CountedFrontend(wfe)
    wpipe = LocalDiffusionPipeline(wcfg2, gd, frontend=wcounted)
    res, _, sb = _counted_translate("WRN", wpipe, wcounted, lr, hr, calls)
    for k2 in COUNTERS:
        counts[k2] += sb[k2]
    perf["wrn_chain_s"], perf["wrn_detect_ms"] = float(res["time"]), wcounted.seconds[-1] * 1e3

    # (3) the seg-encoder source: the seeded SegUNet's down2 ⊕ down3
    se_bank = STAGE_A_DIR / "memory_bank_synthetic_brain_256_seg_encoder.npy"
    built = bank_main(["--config", "mri256_bf16", "--feature-source", "seg_encoder",
                       "--seg-npz", npz, "--n-images", str(SEGENC_BANK_BRAINS),
                       "--out", str(se_bank)])
    bank, secs = built["bank"], built["seconds"]
    log(f"seg-encoder bank: {SEGENC_BANK_BRAINS} normal brains, down2 + down3, "
        f"{built['patches']} patches x {bank.shape[1]} -> {bank.shape}; taps "
        f"{secs['taps']:.3f}s, k-center {secs['kcenter']:.3f}s, ladder {secs['ladder']:.3f}s")
    if bank.shape != SEGENC_BANK_SHAPE or not np.all(np.isfinite(bank)):
        raise RuntimeError(f"seg-encoder bank {bank.shape}, expected {SEGENC_BANK_SHAPE}")
    perf["seg_encoder_bank_seconds"] = secs
    ecfg = scfg.replace(ood=dataclasses.replace(
        scfg.ood, detector="patchcore", feature_source="seg_encoder",
        memory_bank_path=str(se_bank)))
    efe, ecfg2 = build_frontend(ecfg, device="cuda", verbose=False)
    efe_cpu = OODFrontend(ecfg2, patchcore=PatchCore(
        ecfg2.ood, source=SegEncoderFeatureSource(_seg_cpu(npz)), memory_bank=bank))
    efe.detect(lr)  # warm-up
    checks["seg_encoder_detect"] = _detect_card_vs_cpu("seg-encoder", efe, efe_cpu, lr,
                                                       built["ladder"], ecfg2.ood)
    del efe_cpu, efe

    # (4) the classifier gate's WRN last resort: no classifier bank, no
    # front-end PatchCore (the detector is seg), a bank from the pairs
    base = mri256_gated_config()
    gcfg = base.replace(ood=dataclasses.replace(base.ood, detector="seg",
                                                memory_bank_path=None))
    pairs = classifier_calibration_pairs(gcfg, n=GATE_WRN_PAIRS)
    t0 = time.perf_counter()
    gate = build_classifier_gate(gcfg, calibration_pairs=pairs, device="cuda", verbose=False)
    setup_s = time.perf_counter() - t0
    gpc = gate.classifier.patchcore
    labels, scores = gate.classifier.calibration
    cls_cpu = ClassifierPatchCore(PatchCore(gcfg.ood, memory_bank=gpc.memory_bank.cpu(),
                                            device="cpu"), threshold=gate.threshold)
    x = np.concatenate([pairs[i][0] for i in (0, 1, GATE_WRN_PAIRS, GATE_WRN_PAIRS + 1)])
    got = gate.classifier.score_raw(x).cpu().numpy()
    want = cls_cpu.score_raw(x).numpy()
    got64, want64 = scores_float64(gate.classifier, x), scores_float64(cls_cpu, x)
    worst, rel = _score_agreement(got, want)
    emb_worst, _ = _score_agreement(got64, want64)
    ctl_worst, ctl_rel = _score_agreement(scores_tf32(gate.classifier, x), want)
    ok = (isinstance(gpc.source, WRNFeatureSource) and emb_worst <= GATED_F32_REL
          and rel <= GATE_WRN_F32_REL and worst <= GATE_WRN_F32_SCORE_REL
          and ctl_worst > GATE_WRN_F32_SCORE_REL)
    log(f"gate WRN last resort: {type(gpc.source).__name__} {gpc.layers}, bank "
        f"{tuple(gpc.memory_bank.shape)} from {len(pairs)} calibration images, threshold "
        f"{gate.threshold:.6g}, balanced accuracy "
        f"{balanced_accuracy(labels, scores, gate.threshold):.4f} ({setup_s:.2f}s); scores "
        f"card vs CPU (f32, 2 + 2 images): {got.round(5).tolist()} vs "
        f"{want.round(5).tolist()}, rel L2 {rel:.4g} (tol {GATE_WRN_F32_REL:g}), worst "
        f"{worst:.4g} (tol {GATE_WRN_F32_SCORE_REL:g}); in float64 from each side's embeddings "
        f"worst {emb_worst:.4g} (tol {GATED_F32_REL:g}); each side's f32 vs its float64: card "
        f"{_score_agreement(got, got64)[0]:.4g}, CPU {_score_agreement(want, want64)[0]:.4g}; "
        f"control, the card's distance product in TF32: rel L2 {ctl_rel:.4g}, worst "
        f"{ctl_worst:.4g} (must exceed {GATE_WRN_F32_SCORE_REL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the gate's WRN last resort disagrees with the CPU's")
    checks.update(gate_wrn_scores_rel_l2=rel, gate_wrn_worst=worst,
                  gate_wrn_worst_float64=emb_worst, gate_wrn_tf32_control_worst=ctl_worst)
    perf["gate_wrn_setup_s"] = setup_s
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"seg/WRN phase: {perf['phase_s']:.1f}s; main-path launches {counts}")
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
    compiled_twin("stem", pipe, lr, hr, None, res_p)

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


# ---------------------------------------------------------------------------
# the shipped checkpoints: parity card vs CPU, then a small margin run
# ---------------------------------------------------------------------------

def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _unet_card_vs_cpu(label, cfg, npz, rng, f32: bool) -> dict:
    """One UNet call at batch 2 with the snapshot's weights, loaded by
    `factory.load_params` on the card and on the CPU: bf16 against the
    one-UNet-call bar, f32 against 1e-3 abs+rel."""
    card = load_params(cfg, params_npz=str(npz), device="cuda", verbose=False)
    cpu = load_params(cfg, params_npz=str(npz), device="cpu", verbose=False)
    s = cfg.diffusion.image_size
    hi = LocalDiffusionPipeline(cfg, cpu).min_max_val[1]
    x = rng.standard_normal((2, s, s, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (2, s, s, 1)).astype(np.float32)
    t = np.array([5, 180])
    got = card.apply_model(torch.as_tensor(x, device="cuda"), torch.as_tensor(cond, device="cuda"),
                           torch.as_tensor(t, device="cuda")).cpu().numpy()
    t0 = time.perf_counter()
    want = cpu.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t)).numpy()
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    rel = _rel_l2(got, want)
    corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
    if f32:
        ok = bool(np.allclose(got, want, rtol=STEM_UNET_F32_TOL, atol=STEM_UNET_F32_TOL))
        bar = f"{STEM_UNET_F32_TOL:g} abs+rel"
    else:
        ok = rel <= MRI_UNET_REL and corr >= MRI_UNET_CORR
        bar = f"relative L2 <= {MRI_UNET_REL:g}, correlation >= {MRI_UNET_CORR:g}"
    log(f"shipped check, {label}: one UNet call card vs CPU (batch 2, {card.dtype}, TF32 flags "
        f"{tf32_flags()} around it): max_abs_err {err:.4g}, relative L2 {rel:.4g}, correlation "
        f"{corr:.8f} ({bar}) {'ok' if ok else 'FAIL'}; CPU {cpu_s:.1f}s")
    if not ok:
        raise RuntimeError(f"the shipped {label} on the card disagrees with the CPU's")
    return dict(max_abs_err=err, rel_l2=rel, corr=corr)


def _seg_card_vs_cpu(npz) -> dict:
    """The shipped SegUNet's logits at batch 2 (256px tumour brains) through
    `build_frontend`'s seg detector, card vs CPU."""
    cfg = mri256_bf16_config()
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=str(npz)))
    fe_card, _ = build_frontend(cfg, device="cuda", verbose=False)
    fe_cpu, _ = build_frontend(cfg, device="cpu", verbose=False)
    d = cfg.data
    lr = synthetic_brain_translation(2, cfg.diffusion.image_size, tumor=True, seed=5,
                                     mean_t1=d.mean_t1, std_t1=d.std_t1,
                                     mean_flair=d.mean_flair, std_flair=d.std_flair)[1]
    got = fe_card.seg_apply(lr).cpu().numpy()
    t0 = time.perf_counter()
    want = fe_cpu.seg_apply(lr).numpy()
    cpu_s = time.perf_counter() - t0
    rel = _rel_l2(got, want)
    p_card, p_cpu = (1 / (1 + np.exp(-v.astype(np.float64))) for v in (got, want))
    band = np.abs(p_cpu - 0.5) <= SEG_BAND
    differ = int(((p_card > 0.5) != (p_cpu > 0.5))[~band].sum())
    ok = rel <= SEG_LOGIT_REL and differ == 0
    log(f"shipped check, seg256_params.npz: logits card vs CPU (f32, batch 2 tumour brains at "
        f"256px): rel L2 {rel:.4g} (tol {SEG_LOGIT_REL:g}), max_abs_err "
        f"{float(np.abs(got - want).max()):.4g}; masks differ at {differ} pixels off the band "
        f"|p - 0.5| <= {SEG_BAND:g}, which holds {int(band.sum())} of {band.size}; mask areas "
        f"{[int(m.sum()) for m in (p_cpu > 0.5)]} {'ok' if ok else 'FAIL'}; CPU {cpu_s:.1f}s")
    if not ok:
        raise RuntimeError("the shipped SegUNet on the card disagrees with the CPU's")
    return dict(rel_l2=rel, band_pixels=int(band.sum()))


def shipped256() -> dict:
    """The shipped checkpoints: each file hashed and read (a missing one
    raises and names it: no seeded weights stand in), each held card vs
    CPU; then, with every count at 0, the margin evaluation through its
    entry point (`scripts.eval_margins.main`) on the trained 256px denoiser:
    the detector's bank and ladder built on the card, Stage A's masks, the
    plain and branched DDPM chains; each kernel's launches checked against
    the UNet calls and tap passes (`counted_passes`)."""
    t_phase = time.perf_counter()
    paths = {name: RESULTS / name for name in SHIPPED}
    for name, path in paths.items():
        if not path.is_file():
            raise FileNotFoundError(f"the shipped checkpoint {path} is missing (it is tracked in "
                                    "git; the card's copy must carry results/*.npz)")
        log(f"shipped {name}: {path.stat().st_size} bytes, sha256 {sha256(path)}")
    rng = np.random.default_rng(21)
    checks = {
        "mri_synth256": _unet_card_vs_cpu("mri_synth256_ema.npz in mri256_config()",
                                          mri256_config(), paths["mri_synth256_ema.npz"], rng,
                                          f32=False),
        "stem256": _unet_card_vs_cpu("mri_stem256_ema.npz in stem256_config()",
                                     stem256_config(), paths["mri_stem256_ema.npz"], rng, f32=True),
        "seg256": _seg_card_vs_cpu(paths["seg256_params.npz"]),
    }

    SHIPPED_DIR.mkdir(parents=True, exist_ok=True)
    argv = ["--config", "mri256", "--params-npz", str(paths["mri_synth256_ema.npz"]),
            "--images", str(MARGIN_IMAGES), "--batch", str(MARGIN_BATCH), "--samplers", "ddpm",
            "--variants", "plain,denoiser", "--bank-images", str(MARGIN_BANK),
            "--work-dir", str(SHIPPED_DIR), "--out", str(SHIPPED_DIR / "margins.json")]
    reset_counts()
    t0 = time.perf_counter()
    with counted_passes() as seen:
        res = eval_margins.main(argv)
    margin_s = time.perf_counter() - t0
    counts = read_counts()
    calls, taps = [seen["calls"]], [seen["taps"]]
    want = {k: MRI_PER_CALL.get(k, 0) * calls[0] + STAGE_A_PER_DETECT.get(k, 0) * taps[0]
            for k in COUNTERS}
    if counts != want or calls[0] != 2 * mri256_config().diffusion.timesteps:
        raise RuntimeError(f"shipped margin run: launches {counts}, expected {want} "
                           f"({calls[0]} UNet calls, {taps[0]} tap passes)")
    v = res["variants"]
    ood = {k: v[f"ddpm/{k}"]["ood_region"]["mean"] for k in ("plain", "denoiser")}
    delta = v["ddpm/denoiser_minus_plain"]
    for k in ("plain", "denoiser"):
        per = np.asarray(v[f"ddpm/{k}"]["per_image_ood"] + v[f"ddpm/{k}"]["per_image_whole"])
        if per.shape != (2 * MARGIN_IMAGES,) or not np.all(np.isfinite(per)):
            raise RuntimeError(f"shipped margin run, {k}: per-image MSEs {per}")
    log(f"shipped margin run (python -m localdiffusion_tpu_torch.scripts.eval_margins "
        f"{' '.join(argv)}): n={res['n']}, DDPM T=250, bf16: OOD-region MSE plain "
        f"{ood['plain']:.4f}, denoiser {ood['denoiser']:.4f}, delta "
        f"{delta['ood_delta']['mean']:+.4f} CI {delta['ood_delta']['ci95']} "
        f"({delta['ood_delta_pct']:+.2f}%); whole-image plain "
        f"{v['ddpm/plain']['whole']['mean']:.4f}, denoiser {v['ddpm/denoiser']['whole']['mean']:.4f}"
        f"; reported, not judged (n=8); {margin_s:.1f}s (plain chain {v['ddpm/plain']['wall_s']}s, "
        f"denoiser chain {v['ddpm/denoiser']['wall_s']}s); {calls[0]} UNet calls and {taps[0]} "
        f"tap passes, launches {counts}")
    checks["margin"] = dict(ood_plain=ood["plain"], ood_denoiser=ood["denoiser"],
                            ood_delta=delta["ood_delta"]["mean"],
                            ood_delta_ci=delta["ood_delta"]["ci95"],
                            ood_delta_pct=delta["ood_delta_pct"])
    phase_s = time.perf_counter() - t_phase
    log(f"shipped phase: {phase_s:.1f}s")
    return dict(counts=counts, checks=checks,
                perf=dict(phase_s=phase_s, margin_s=margin_s,
                          plain_chain_s=v["ddpm/plain"]["wall_s"],
                          denoiser_chain_s=v["ddpm/denoiser"]["wall_s"]))


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _seeded(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _grads(gd, x, cond, t, noise, coin=None) -> tuple:
    """(loss, {name: gradient on the CPU}) of one batch with the given t,
    noise and (self-conditioning) coin, the parameters' gradients cleared
    first; a parameter that takes no gradient is left out."""
    gd.model.zero_grad(set_to_none=True)
    dev = gd.device
    with full_float32():
        loss = gd.loss(torch.as_tensor(x, device=dev), torch.as_tensor(cond, device=dev),
                       ArrayDraws(dev, [t], [noise], coins=[] if coin is None else [coin]))
        loss.backward()
    grads = {k: p.grad.detach().float().cpu() for k, p in gd.model.named_parameters()
             if p.requires_grad}
    gd.model.zero_grad(set_to_none=True)
    return loss.item(), grads


def _grad_agreement(label, got, want, loss_bar, rel_bar, cos_bar) -> dict:
    """Loss relative difference, whole-gradient relative L2 and cosine,
    and the worst leaf by relative L2; raises past the bars (an infinite
    bar, or cos_bar None: not judged)."""
    (lg, g), (lw, w) = got, want
    a = torch.cat([v.flatten() for v in g.values()]).double()
    b = torch.cat([w[k].flatten() for k in g]).double()
    rel = float((a - b).norm() / b.norm())
    cos = float(a @ b / (a.norm() * b.norm()))
    loss_rel = abs(lg - lw) / abs(lw)
    leaf = {k: float((g[k].double() - w[k].double()).norm() / w[k].double().norm().clamp_min(1e-30))
            for k in g}
    worst = max(leaf, key=leaf.get)
    ok = loss_rel <= loss_bar and rel <= rel_bar and (cos_bar is None or cos >= cos_bar)
    bar = lambda v: f"bar {v:g}" if np.isfinite(v) else "not judged"
    log(f"training check, {label}: loss {lg:.6g} vs {lw:.6g} (relative {loss_rel:.3g}, "
        f"{bar(loss_bar)}); whole gradient relative L2 {rel:.4g} ({bar(rel_bar)}), cosine "
        f"{cos:.7f}{'' if cos_bar is None else f' (bar {cos_bar:g})'}; worst leaf {worst} "
        f"{leaf[worst]:.4g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"training check {label} failed")
    return dict(loss_rel=loss_rel, grad_rel_l2=rel, cos=cos, worst_leaf=worst,
                worst_leaf_rel=leaf[worst])


def _split_step(tr, hr, lr, reps: int) -> dict:
    """Device ms of a microbatch's forward (the loss) and backward apart, by
    CUDA events around each on the stream, over `reps` microbatches; the
    launches of each: the forward a UNet call's, the backward none."""
    gd = tr.gd
    x, c = (torch.as_tensor(a[:8], device="cuda") for a in (hr, lr))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fwd, bwd = [], []
    for i in range(reps):
        draws = _seeded(900 + i)
        before = read_counts()
        with full_float32():
            ev[0].record()
            loss = gd.loss(x, c, draws)
            ev[1].record()
            mid = read_counts()
            loss.backward()
            ev[2].record()
        torch.cuda.synchronize()
        after = read_counts()
        check_counts({k: mid[k] - before[k] for k in mid}, MRI_PER_CALL, 1, "training forward")
        launched = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
        if launched:
            raise RuntimeError(f"a backward launched kernels of the eight: {launched}")
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
    tr.optimizer.zero_grad(set_to_none=True)
    return dict(fwd_ms=float(np.median(fwd)), bwd_ms=float(np.median(bwd)))


def _profile_step(tr, hr, lr, draws, label) -> dict:
    """One batch step spelled out as `Trainer.train_batch_step` composes it
    (forward, backward, clip + Adam, EMA), each part ended by a
    synchronise, under one torch.profiler window (the card's activity, as
    `profile_chain`): each part's span on the device's timeline (CUDA events
    at its ends) and its host wall, and the step's busy share (the kernels'
    time over the step's wall).  The EMA, at a step where it updates and
    its decay is still 0, must leave the EMA equal to the parameters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gd = tr.gd
    x, c = (torch.as_tensor(a, device="cuda") for a in (hr, lr))
    tr.optimizer.zero_grad(set_to_none=True)
    box = {}

    def forward():
        with full_float32():
            box["loss"] = gd.loss(x, c, draws)

    def backward():
        with full_float32():
            box["loss"].backward()

    def clip_adam():
        clip_by_global_norm([p.grad for p in tr.params], tr.cfg.max_grad_norm)
        tr.optimizer.step()
        tr.step += 1

    def ema():
        ema_update(tr.ema_model.parameters(), tr.model.parameters(), tr.step, tr.ema_cfg)

    parts = (("forward", forward), ("backward", backward), ("clip_adam", clip_adam),
             ("ema", ema))
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
    host = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_step = time.perf_counter()
        events[0].record()
        for (name, fn), ev in zip(parts, events[1:]):
            t0 = time.perf_counter()
            fn()
            ev.record()
            torch.cuda.synchronize()
            host[name] = 1e3 * (time.perf_counter() - t0)
        wall_ms = 1e3 * (time.perf_counter() - t_step)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {name: dict(device_ms=a.elapsed_time(b), host_ms=host[name])
             for (name, _), a, b in zip(parts, events[:-1], events[1:])}
    log(f"{label} profile: one batch step (step {tr.step}) {wall_ms:.1f}ms wall (profiled, a "
        f"synchronise after each part), {sum(e.count for e in kernels)} kernels, card busy "
        f"{busy_ms:.2f}ms = {100 * busy_ms / wall_ms:.1f}%; on the device's timeline "
        + "; ".join(f"{n} {v['device_ms']:.2f}ms (host {v['host_ms']:.1f}ms)"
                    for n, v in split.items()))
    if tr.step % tr.ema_cfg.update_every or tr.step > tr.ema_cfg.update_after_step:
        raise RuntimeError(f"step {tr.step}: the profiled step must update the EMA with decay 0")
    if not all(torch.equal(e, p) for e, p in zip(tr.ema_model.parameters(),
                                                  tr.model.parameters())):
        raise RuntimeError(f"{label} profile: the EMA update did not copy the parameters")
    return dict(busy_share=busy_ms / wall_ms, busy_ms=busy_ms, step_ms=wall_ms, split=split)


def _fixed_loss(gd, hr, lr, t, noise) -> float:
    """The loss on held-out brains with fixed t and noise, no gradient, in
    batches of 8."""
    total = 0.0
    with torch.no_grad():
        for i in range(0, len(hr), 8):
            total += gd.loss(torch.as_tensor(hr[i:i + 8], device="cuda"),
                             torch.as_tensor(lr[i:i + 8], device="cuda"),
                             ArrayDraws("cuda", [t[i:i + 8]], [noise[i:i + 8]])).item()
    return total / (len(hr) // 8)


def _state_equal(a: Trainer, b: Trainer) -> bool:
    same = a.step == b.step
    for x, y in zip(list(a.model.state_dict().values()) + list(a.ema_model.state_dict().values()),
                    list(b.model.state_dict().values()) + list(b.ema_model.state_dict().values())):
        same = same and torch.equal(x, y)
    for sa, sb in zip(a.optimizer.state_dict()["state"].values(),
                      b.optimizer.state_dict()["state"].values()):
        same = same and all(torch.equal(sa[k], sb[k]) for k in sa)
    return same


def training256() -> dict:
    """(a) the train path at full width and its launches, (b) gradients with
    and without the kernels on the shipped checkpoint, and card vs CPU, (c)
    the flagship's f32 step entered with both TF32 flags on, (d) learning,
    (e) the state's round trips, (f) one profiled batch step."""
    t_phase = time.perf_counter()
    base = mri256_config()
    cfg = base.replace(train=dataclasses.replace(base.train, results_dir=str(TRAIN_DIR)))
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    (hr_tr, lr_tr), (hr_te, lr_te) = train_arrays(cfg)
    gd = build_gd(cfg, device="cuda")
    tr = Trainer(gd, cfg.train)
    nb = len(hr_tr) // cfg.train.batch_size
    log(f"training: mri256_config() at full width, {sum(p.numel() for p in tr.params)} params "
        f"(seeded random), compute {gd.dtype}, float32 params and Adam state, batch "
        f"{cfg.train.batch_size}, {len(hr_tr)} training brains at {gd.image_size}px")
    data_hr, data_lr = (torch.as_tensor(a, device="cuda") for a in (hr_tr, lr_tr))
    tr.train_batch_step(hr_tr[:8], lr_tr[:8], _seeded(0))  # warm-up (not counted)
    torch.cuda.synchronize()

    # (a) the main path: every count at 0, the Trainer's three steps
    reset_counts()
    wall = {}
    t0 = time.perf_counter()
    loss_res = tr.train_epoch_resident(data_hr, data_lr, _seeded(1))
    torch.cuda.synchronize()
    wall["resident_epoch_s"] = time.perf_counter() - t0
    check_counts(read_counts(), MRI_PER_CALL, nb, "training resident epoch")
    before = read_counts()
    t0 = time.perf_counter()
    loader = ArrayLoader(hr_tr, lr_tr, batch_size=cfg.train.batch_size, seed=42)
    loss_epoch = tr.train_epoch_step(loader.epoch_batches(0), _seeded(2))
    torch.cuda.synchronize()
    wall["streamed_epoch_s"] = time.perf_counter() - t0
    check_counts({k: v - before[k] for k, v in read_counts().items()}, MRI_PER_CALL, nb,
                 "training streamed epoch")
    before = read_counts()
    t0 = time.perf_counter()
    batch_losses = [tr.train_batch_step(hr_tr[8 * i:8 * i + 8], lr_tr[8 * i:8 * i + 8],
                                        _seeded(3 + i)) for i in range(TRAIN_BATCH_STEPS)]
    torch.cuda.synchronize()
    wall["batch_step_s"] = (time.perf_counter() - t0) / TRAIN_BATCH_STEPS
    check_counts({k: v - before[k] for k, v in read_counts().items()}, MRI_PER_CALL,
                 TRAIN_BATCH_STEPS, "training batch steps")
    split = _split_step(tr, hr_tr, lr_tr, TRAIN_SPLIT_REPS)
    torch.cuda.reset_peak_memory_stats()
    tr.train_batch_step(hr_tr[:8], lr_tr[:8], _seeded(8))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [loss_res, loss_epoch] + batch_losses
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"training losses not finite: {losses}")
    log(f"training main path: resident epoch ({nb} microbatches) {wall['resident_epoch_s']:.3f}s, "
        f"streamed epoch {wall['streamed_epoch_s']:.3f}s, batch step {wall['batch_step_s']:.3f}s "
        f"wall; a microbatch on the device (CUDA events, median of {TRAIN_SPLIT_REPS}) forward "
        f"{split['fwd_ms']:.2f}ms, backward {split['bwd_ms']:.2f}ms, none of the eight kernels "
        f"in a backward; peak memory of a batch step {peak_gib:.2f} GiB; losses "
        f"{[round(v, 4) for v in losses]}; step {tr.step}")

    before = read_counts()
    npz = TRAIN_DIR / "ema.npz"
    t0 = time.perf_counter()
    out = train_script.main(["--config", "mri256", "--steps", str(TRAIN_SCRIPT_STEPS),
                             "--step-mode", "resident", "--eval-every", str(TRAIN_SCRIPT_STEPS),
                             "--results", str(TRAIN_DIR), "--resume", "never",
                             "--export-npz", str(npz)])
    torch.cuda.synchronize()
    script_s = time.perf_counter() - t0
    eval_calls = cfg.diffusion.timesteps * len(out["evals"])
    check_counts({k: v - before[k] for k, v in read_counts().items()}, MRI_PER_CALL,
                 TRAIN_SCRIPT_STEPS * nb + eval_calls, "training script")
    run = Path(out["results_dir"])
    ckpt_bytes = (run / "model-latest.pt").stat().st_size
    if out["step"] != TRAIN_SCRIPT_STEPS or not np.isfinite(out["evals"]).all():
        raise RuntimeError(f"the training script ended at {out['step']}, evals {out['evals']}")
    for f in ("train_loss.csv", "best_eval.json", "model-latest.pt"):
        if not (run / f).exists():
            raise RuntimeError(f"the training script wrote no {f}")
    counts = read_counts()
    log(f"training script: {TRAIN_SCRIPT_STEPS} resident steps and {len(out['evals'])} eval "
        f"chain(s) ({eval_calls} UNet calls) in {script_s:.1f}s; eval sample MSE "
        f"{out['evals']}; phase means {json.dumps(out['phase_means_s'])}; checkpoint "
        f"{ckpt_bytes} bytes, EMA npz {npz.stat().st_size} bytes; main-path launches {counts}")

    # (b) gradients: kernels against the plain modules and the card against the CPU
    rng = np.random.default_rng(17)
    t = rng.integers(0, cfg.diffusion.timesteps, 8)
    noise = rng.standard_normal((8, gd.image_size, gd.image_size, 1)).astype(np.float32)
    x, c = hr_tr[:8], lr_tr[:8]

    def kernels_vs_plain(engine):
        with_k = _grads(engine, x, c, t, noise)
        engine.model.use_plain_kernels(True)
        try:
            return with_k, _grads(engine, x, c, t, noise)
        finally:
            engine.model.use_plain_kernels(False)

    seeded_k, seeded_p = kernels_vs_plain(build_gd(cfg, device="cuda"))
    checks = dict(seeded=_grad_agreement(
        "seeded 256px, kernels vs plain modules on the card (batch 8, bf16)", seeded_k,
        seeded_p, TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_COS))
    shipped = load_params(cfg, params_npz=str(RESULTS / SHIPPED[0]), device="cuda",
                          verbose=False)
    with_k, plain = kernels_vs_plain(shipped)
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    f32_k, f32_p = kernels_vs_plain(load_params(cfg32, params_npz=str(RESULTS / SHIPPED[0]),
                                                device="cuda", verbose=False))
    checks["shipped_f32"] = _grad_agreement(
        "shipped 256px, kernels vs plain modules on the card (batch 8, f32: the GroupNorm and "
        "attention Functions)", f32_k, f32_p, TRAIN_F32_GRAD_REL, TRAIN_F32_GRAD_REL, None)
    floor = _grad_agreement("shipped 256px, the kernel path in bf16 vs in f32 (batch 8: the "
                            "bf16 floor, not judged)", with_k, f32_k, np.inf, np.inf, None)
    checks["shipped"] = _grad_agreement(
        "shipped 256px, kernels vs plain modules on the card (batch 8, bf16; loss and L2 beside "
        f"the floor: bf16 vs f32 {floor['loss_rel']:.4g} and {floor['grad_rel_l2']:.4g})",
        with_k, plain, np.inf, np.inf, TRAIN_GRAD_COS)
    checks["shipped"]["floor"] = floor
    whole = float(torch.cat([v.flatten() for v in plain[1].values()]).norm())
    flat = [k for k, v in with_k[1].items()
            if float(v.abs().max()) == 0 and float(plain[1][k].norm()) >= 1e-6 * whole]
    if flat:
        raise RuntimeError(f"leaves with no gradient through the kernels: {flat}")
    cpu = build_gd(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in shipped.model.state_dict().items()})
    n = TRAIN_CPU_BATCH
    card_small = _grads(shipped, x[:n], c[:n], t[:n], noise[:n])
    t0 = time.perf_counter()
    cpu_small = _grads(cpu, x[:n], c[:n], t[:n], noise[:n])
    checks["cpu"] = _grad_agreement(f"shipped 256px, card vs CPU (batch {n}, bf16; CPU "
                                    f"{time.perf_counter() - t0:.1f}s)", card_small, cpu_small,
                                    TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_COS)
    del cpu

    # (c) the f32 path
    with tf32_on_at_entry("training f32"):
        checks["f32"] = _train_f32()

    # (d) learning, (f) profile, (e) state
    ho_t = rng.integers(0, cfg.diffusion.timesteps, TRAIN_HELD_OUT)
    ho_noise = rng.standard_normal((TRAIN_HELD_OUT,) + hr_te.shape[1:]).astype(np.float32)
    ho = (hr_te[:TRAIN_HELD_OUT], lr_te[:TRAIN_HELD_OUT], ho_t, ho_noise)
    learner = Trainer(build_gd(cfg, device="cuda"), cfg.train)
    start = _fixed_loss(learner.gd, *ho)
    for i in range(TRAIN_LEARN_STEPS - 1):
        j = (8 * i) % len(hr_tr)
        learner.train_batch_step(hr_tr[j:j + 8], lr_tr[j:j + 8], _seeded(100 + i))
    j = (8 * (TRAIN_LEARN_STEPS - 1)) % len(hr_tr)
    prof = _profile_step(learner, hr_tr[j:j + 8], lr_tr[j:j + 8], _seeded(99), "training")
    end = _fixed_loss(learner.gd, *ho)
    shipped_loss = _fixed_loss(shipped, *ho)
    log(f"training learning: fixed-draw loss on {TRAIN_HELD_OUT} held-out brains, seeded "
        f"weights {start:.6g} -> {end:.6g} after {learner.step} batch steps "
        f"({'lower' if end < start else 'NOT lower'}); the shipped checkpoint {shipped_loss:.6g}")
    if not end < start:
        raise RuntimeError("30 batch steps did not lower the held-out loss")
    learner.save("smoke")
    back = Trainer(build_gd(cfg, device="cuda"), cfg.train)
    back.load("smoke")
    if not _state_equal(learner, back):
        raise RuntimeError("save then load did not restore the trainer bit for bit")
    ema_npz = TRAIN_DIR / "ema_learner.npz"
    save_params_npz(str(ema_npz), learner.ema_model.state_dict())
    served = load_params(cfg, params_npz=str(ema_npz), device="cuda", verbose=False)
    rounded = {k: v.half().float() for k, v in learner.ema_model.state_dict().items()}
    if not all(torch.equal(served.model.state_dict()[k], v) for k, v in rounded.items()):
        raise RuntimeError("the exported npz is not the EMA rounded to fp16")
    ref = build_gd(cfg, device="cuda")
    ref.model.load_state_dict(rounded)
    xs = torch.as_tensor(rng.standard_normal((2, gd.image_size, gd.image_size, 1)),
                         dtype=torch.float32, device="cuda")
    ts = torch.tensor([5, 180], device="cuda")
    cond = torch.as_tensor(lr_te[:2], device="cuda")
    if not torch.equal(served.apply_model(xs, cond, ts), ref.apply_model(xs, cond, ts)):
        raise RuntimeError("the exported EMA's UNet call differs from the fp16-rounded EMA's")
    log(f"training state: save/load on the card restores step {back.step}, params, Adam "
        f"state and EMA bit for bit ({learner.checkpoint_path('smoke')}, "
        f"{Path(learner.checkpoint_path('smoke')).stat().st_size} bytes); the exported npz "
        f"serves through factory.load_params as the fp16-rounded EMA, its UNet call bit-equal")

    phase_s = time.perf_counter() - t_phase
    log(f"training phase: {phase_s:.1f}s")
    return dict(counts=counts, checks=checks, busy_share=prof["busy_share"],
                perf=dict(phase_s=phase_s, script_s=script_s, peak_gib=peak_gib,
                          ckpt_bytes=ckpt_bytes, eval_mse=out["evals"], start_loss=start,
                          end_loss=end, shipped_loss=shipped_loss, **wall, **split,
                          profile_step_ms=prof["step_ms"],
                          profile_split={k: v["device_ms"] for k, v in prof["split"].items()}))


def _train_f32() -> dict:
    """The flagship (f32, batch 64, 28px): 2 batch steps on the card with
    their launches, then one step's gradient against the CPU's; the TF32
    flags read inside every backward (a hook on the final conv)."""
    cfg = flagship_config()
    gd = build_gd(cfg, device="cuda")
    tr = Trainer(gd, cfg.train)
    rng = np.random.default_rng(31)
    s = gd.image_size
    hr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    lr = rng.uniform(0, 2, (BATCH, s, s, 1)).astype(np.float32)
    seen = []
    hook = gd.model.final_conv.register_full_backward_hook(
        lambda *_: seen.append(tf32_flags()))
    try:
        before = read_counts()
        losses = [tr.train_batch_step(hr, lr, _seeded(40 + i)) for i in range(2)]
        check_counts({k: v - before[k] for k, v in read_counts().items()}, FLAGSHIP_PER_CALL, 2,
                     "training flagship steps")
        t = rng.integers(0, cfg.diffusion.timesteps, BATCH)
        noise = rng.standard_normal(hr.shape).astype(np.float32)
        card = _grads(gd, hr, lr, t, noise)
    finally:
        hook.remove()
    cpu = build_gd(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gd.model.state_dict().items()})
    got = _grad_agreement(f"flagship f32, card vs CPU (batch {BATCH})", card,
                          _grads(cpu, hr, lr, t, noise), TRAIN_F32_GRAD_REL, TRAIN_F32_GRAD_REL,
                          None)
    log(f"training f32: flagship batch steps, losses {[round(v, 5) for v in losses]}; TF32 "
        f"flags read inside the {len(seen)} backwards {sorted(set(seen))}")
    if len(seen) != 3 or set(seen) != {(False, False)}:
        raise RuntimeError(f"TF32 was on inside a backward: {seen}")
    return got


# ---------------------------------------------------------------------------
# the data readers and the MNIST and MVTec-style configurations on them
# ---------------------------------------------------------------------------

DATA_DIR = STAGE_A_DIR.parent / "datasets"
# seeded synthetic digits written as MNIST idx files, train and t10k (the
# real files are not in the repository); the MNIST test configurations at
# 4 images each (8 before the attribution and tensor-parallel phases came
# in); the MVTec-style configuration's 4 resident steps over its 192
# training textures at batch 16
DATA_DIGITS, DATA_MNIST_STEPS, DATA_MNIST_IMAGES, DATA_MNIST_BANK = 2048, 2, 4, 200
# mvtec_synthetic's test CLI: 4 textures (16 before the attribution and
# tensor-parallel phases came in; 39.8 s of the run)
DATA_MVTEC_STEPS, DATA_MVTEC_IMAGES, DATA_MVTEC_CHECK = 4, 4, 4
IDX_UINT8 = 0x08


def write_idx(path: str, arr: np.ndarray) -> None:
    """A uint8 IDX file of `arr`, gzipped where the name ends in .gz."""
    arr = np.ascontiguousarray(arr, np.uint8)
    head = struct.pack(">BBBB", 0, 0, IDX_UINT8, arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if path.endswith(".gz") else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


def _echoed(fn, *args):
    """(fn(*args), what it printed), the print shown after it."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
    finally:
        print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def _script_counts(label, before, per_call, calls) -> dict:
    got = {k: v - before[k] for k, v in read_counts().items()}
    check_counts(got, per_call, calls, label)
    return got


def datasets_phase() -> dict:
    """MNIST idx files written here, read by the port's reader; the train
    CLI on `mnist_train_config()`, the bank CLI on `mnist_gated_config()`,
    the test CLI on the three MNIST test configurations; the train and test
    CLIs on `mvtec_synthetic_config()` with its chain checked against the
    plain versions and one UNet call against the CPU; one test batch of
    `mvtec_denoise_config()`."""
    t_phase = time.perf_counter()
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    perf, checks = {}, {}
    reset_counts()
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        written = {}
        for split, seed in (("train", 11), ("t10k", 12)):
            imgs, labels = synthetic_digits(DATA_DIGITS, seed=seed)
            write_idx(f"{tmp}/{split}-images-idx3-ubyte", imgs)
            write_idx(f"{tmp}/{split}-labels-idx1-ubyte.gz", labels)
            written[split] = (imgs, labels.astype(np.uint8))
        # the images raw, the labels gzipped, found by read_idx from the bare name
        data = ["--mnist-path", f"{tmp}/train-images-idx3-ubyte",
                "--mnist-labels-path", f"{tmp}/train-labels-idx1-ubyte"]
        base = mnist_train_config()
        cfg = base.replace(data=dataclasses.replace(base.data, mnist_path=data[1],
                                                    mnist_labels_path=data[3]))
        got = load_mnist_arrays(cfg.data.mnist_path, cfg.data.mnist_labels_path)
        if not all(g.dtype == w.dtype and np.array_equal(g, w)
                   for g, w in zip(got, written["train"])):
            raise RuntimeError("load_mnist_arrays did not return the written idx arrays")
        split = int(0.7 * DATA_DIGITS)
        (hr_tr, _), _ = train_arrays(cfg)
        want = MNISTDataset(written["train"][0][:split], written["train"][1][:split], num=[8])
        if not np.array_equal(hr_tr, want.as_arrays()[0]):
            raise RuntimeError("the MNIST training set is not the idx files' digit 8")
        log(f"datasets: {DATA_DIGITS} + {DATA_DIGITS} seeded digits written as idx files "
            f"(images raw, labels .gz); load_mnist_arrays returns them exactly; the training "
            f"set {len(hr_tr)} digit-8 images of the first {split}")

        # MNIST (the flagship's UNet, FLAGSHIP_PER_CALL): train, bank, test
        npz = f"{tmp}/mnist_ema.npz"
        before = read_counts()
        t0 = time.perf_counter()
        out, said = _echoed(train_script.main, [
            "--config", "mnist_train", "--steps", str(DATA_MNIST_STEPS), "--step-mode", "epoch",
            "--eval-every", str(DATA_MNIST_STEPS), "--results", f"{tmp}/results", "--resume",
            "never", "--export-npz", npz, *data])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if "synthetic" in said or out["step"] != DATA_MNIST_STEPS:
            raise RuntimeError("the MNIST training run did not read the idx files")
        microbatches = -(-len(hr_tr) // cfg.train.batch_size)
        calls = DATA_MNIST_STEPS * microbatches + cfg.diffusion.timesteps * len(out["evals"])
        _script_counts("MNIST training script", before, FLAGSHIP_PER_CALL, calls)
        perf["mnist_train_step_s"] = out["phase_means_s"]["train_step"]
        log(f"datasets MNIST training: {DATA_MNIST_STEPS} epoch steps ({microbatches} "
            f"microbatches of {cfg.train.batch_size}, T={cfg.diffusion.timesteps}, f32) and "
            f"{len(out['evals'])} eval chain(s) in {train_s:.1f}s; a step "
            f"{perf['mnist_train_step_s'] * 1e3:.1f}ms; losses {out['losses']}; launches as "
            f"{calls} UNet calls")
        bank = f"{tmp}/memory_bank_mnist.npy"
        before = read_counts()
        t0 = time.perf_counter()
        res = bank_main(["--config", "mnist_gated", "--out", bank, "--n-images",
                         str(DATA_MNIST_BANK), *data])
        perf["mnist_bank_s"] = time.perf_counter() - t0
        _script_counts("MNIST bank", before, {}, 0)
        log(f"datasets MNIST bank (WRN50-2 at {mnist_gated_config().ood.input_size}px, seed 0): "
            f"{res['bank'].shape} in {perf['mnist_bank_s']:.1f}s")
        t10k = written["t10k"]
        for name, cfg_fn in (("mnist_8to5", mnist_8to5_config), ("mnist_usegt", mnist_usegt_config),
                             ("mnist_gated", mnist_gated_config)):
            tcfg = cfg_fn()
            extra = ["--memory-bank", bank] if tcfg.sampler.classifier else []
            before = read_counts()
            t0 = time.perf_counter()
            res = test_script.main(["--config", name, "--params-npz", npz, "--max-images",
                                    str(DATA_MNIST_IMAGES), *data, *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n, T = len(res["pred_all"]), tcfg.diffusion.timesteps
            # use_gt starts each chain at use_gt_timestep from the noised ground
            # truth; the gate (a WRN50-2, none of the eight kernels) adds a [2B]
            # retry call at each post-fusion step up to the image's acceptance
            steps = tcfg.sampler.use_gt_timestep if tcfg.sampler.use_gt else T
            t_fuse = min(tcfg.sampler.start_timestep, T - 1)
            retries = int(sum(t_fuse - ft for ft in res["fusion_time"] if ft < T))
            _script_counts(f"{name} test", before, FLAGSHIP_PER_CALL, n * steps + retries)
            want = MNISTDataset(*t10k, num=[tcfg.data.anomaly_name], max_file=DATA_MNIST_IMAGES)
            if not np.array_equal(res["hr_all"], want.as_arrays()[0]):
                raise RuntimeError(f"{name}: the test set is not the t10k idx files' digit "
                                   f"{tcfg.data.anomaly_name}")
            _check_images(f"{name} test", res["pred_all"], (n, 28, 28, 1), 0.0, 2.0)
            perf[f"{name}_img_per_s"] = 1.0 / float(res["mean_time"])
            log(f"datasets {name}: {n} t10k digit-{tcfg.data.anomaly_name} images, one chain "
                f"each ({steps} UNet calls of T={T}, {retries} retry calls in all, manual mask"
                f"{', classifier gate on the bank above' if extra else ''}): "
                f"{perf[f'{name}_img_per_s']:.2f} img/s (mean chain {float(res['mean_time']):.3f}s), "
                f"{wall:.1f}s wall; test loss {float(res['mean_mse']):.4f}; fusion times "
                f"{res['fusion_time'].tolist()}")

    # MVTec-style: synthetic textures, 64px, 3 channels, f32
    cfg = mvtec_synthetic_config()
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        gd_probe = build_gd(cfg, device="cuda")
        before = read_counts()
        seen = record_calls(gd_probe, 2, 2.0)
        mv_call = {k: v - before[k] for k, v in read_counts().items()}
        del gd_probe
        check_gn_sites(seen["gn"], mv_call, "mvtec_synthetic")
        if mv_call.get("flash_attention", 0) != 3 or len(seen["attn"]) != 3:
            raise RuntimeError(f"mvtec_synthetic: full attention launches {mv_call}, expected 3 "
                               f"at 16x16 (256 tokens)")
        npz = f"{tmp}/mvtec_ema.npz"
        (hr_tr, _), _ = train_arrays(cfg)
        before = read_counts()
        t0 = time.perf_counter()
        out = train_script.main([
            "--config", "mvtec_synthetic", "--steps", str(DATA_MVTEC_STEPS), "--step-mode",
            "resident", "--eval-every", str(DATA_MVTEC_STEPS), "--results", f"{tmp}/results",
            "--resume", "never", "--export-npz", npz])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        nb = len(hr_tr) // cfg.train.batch_size
        calls = DATA_MVTEC_STEPS * nb + cfg.diffusion.timesteps * len(out["evals"])
        _script_counts("mvtec_synthetic training", before, mv_call, calls)
        perf["mvtec_train_step_s"] = out["phase_means_s"]["train_step"]
        log(f"datasets mvtec_synthetic training: {DATA_MVTEC_STEPS} resident steps over "
            f"{len(hr_tr)} textures ({nb} microbatches of {cfg.train.batch_size}) and "
            f"{len(out['evals'])} eval chain(s) in {train_s:.1f}s; a step "
            f"{perf['mvtec_train_step_s'] * 1e3:.1f}ms; losses {out['losses']}; per UNet call "
            f"{ {k: v for k, v in mv_call.items() if v} }")
        before = read_counts()
        t0 = time.perf_counter()
        res = test_script.main(["--config", "mvtec_synthetic", "--params-npz", npz,
                                "--max-images", str(DATA_MVTEC_IMAGES)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(res["pred_all"])
        got = _script_counts("mvtec_synthetic test", before, mv_call, n * cfg.diffusion.timesteps)
        _check_images("mvtec_synthetic test", res["pred_all"], (n, 64, 64, 3), 0.0, 2.0)
        perf["mvtec_img_per_s"] = 1.0 / float(res["mean_time"])
        per_chain = {k: got[k] // n for k in ("groupnorm_film_silu", "gn_tiled_stats",
                                              "gn_tiled_apply", "flash_attention")}
        log(f"datasets mvtec_synthetic test: {n} defective textures, one branched chain each "
            f"(T={cfg.diffusion.timesteps}, manual {cfg.ood.manual_mask_cols}-column mask): "
            f"{perf['mvtec_img_per_s']:.2f} img/s (mean chain {float(res['mean_time']):.3f}s), "
            f"{wall:.1f}s wall; test loss {float(res['mean_mse']):.4f}, OOD-region "
            f"{float(res['mean_mse_ood_region']):.4f}; launches per chain {per_chain}")

        # the chain with kernels against the plain versions, one call against the CPU
        pipe = build_pipeline(cfg, npz, device="cuda", verbose=False)
        hr, lr, _ = test_arrays(cfg, DATA_MVTEC_CHECK)
        kern = pipe.translate(lr, hr=hr, noise=1)
        pipe.gd.model.use_plain_kernels(True)
        try:
            plain = pipe.translate(lr, hr=hr, noise=1)
        finally:
            pipe.gd.model.use_plain_kernels(False)
        err = float(np.abs(kern["pred"] - plain["pred"]).max())
        checks["mvtec_chain_max_abs_err"] = err
        log(f"datasets check: mvtec_synthetic chain (batch {DATA_MVTEC_CHECK}, branched "
            f"{bool(kern['branched'])}), kernels vs plain versions (same noise) max_abs_err "
            f"{err:.3g} (tol {CHAIN_TOL:g})")
        if not (bool(kern["branched"]) and err <= CHAIN_TOL):
            raise RuntimeError("the mvtec_synthetic chain disagrees with its plain-version chain")
        cpu = load_params(cfg, params_npz=npz, device="cpu", verbose=False)
        rng = np.random.default_rng(21)
        x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
        cond = rng.uniform(0, 2, (2, 64, 64, 3)).astype(np.float32)
        t = np.array([4, 77])
        got = pipe.gd.apply_model(torch.as_tensor(x, device="cuda"),
                                  torch.as_tensor(cond, device="cuda"),
                                  torch.as_tensor(t, device="cuda")).cpu().numpy()
        want = cpu.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                               torch.as_tensor(t)).numpy()
        err = float(np.abs(got - want).max())
        ok = bool(np.allclose(got, want, rtol=MRI_UNET_F32_TOL, atol=MRI_UNET_F32_TOL))
        checks["mvtec_unet_card_vs_cpu_max_abs_err"] = err
        log(f"datasets check: mvtec_synthetic UNet call card vs CPU (batch 2, f32) max_abs_err "
            f"{err:.3g} ({MRI_UNET_F32_TOL:g} abs+rel) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the mvtec_synthetic UNet on the card disagrees with the CPU's")

        before = read_counts()
        res = test_script.main(["--config", "mvtec_denoise", "--params-npz", npz,
                                "--max-images", "1"])
        _script_counts("mvtec_denoise test", before, mv_call, mvtec_denoise_config().diffusion
                       .timesteps)
        _check_images("mvtec_denoise test", res["pred_all"], (1, 64, 64, 3), 0.0, 2.0)
        log(f"datasets mvtec_denoise: one test batch (salt-and-pepper conditioning), test loss "
            f"{float(res['mean_mse']):.4f}, chain {float(res['mean_time']):.3f}s")

    counts = read_counts()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"datasets phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


# ---------------------------------------------------------------------------
# the denoiser variants: self-conditioning, learned and random Fourier features
# ---------------------------------------------------------------------------

# the trained model's chain: T=50 of the same weights (T=250 before the
# attribution and tensor-parallel phases came in)
SC_STEPS, SC_COINS, SC_CHAIN_T = 4, (True, False, True, False), 50


def _sc_trainer(cfg):
    gd = build_gd(cfg, device="cuda")
    return gd, Trainer(gd, cfg.train)


def self_cond_phase() -> dict:
    """`mri256_config()` with self-conditioning and learned Fourier
    features (bf16, batch 8): the pre-pass's and the grad pass's launches,
    none in a backward; 4 batch steps with the coin both ways, then the
    same with random features; gradients kernels vs plain modules; one
    branched chain of the trained model (T=50 of its weights) against its
    plain versions."""
    t_phase = time.perf_counter()
    base = mri256_config()
    cfg = base.replace(model=dataclasses.replace(base.model, self_condition=True,
                                                 learned_sinusoidal_cond=True))
    d, s = cfg.data, cfg.diffusion.image_size
    hr, lr, _ = synthetic_brain_translation(
        2 * cfg.train.batch_size, s, tumor=False, seed=42, mean_t1=d.mean_t1, std_t1=d.std_t1,
        mean_flair=d.mean_flair, std_flair=d.std_flair, translate_zero=d.translate_zero)
    rng = np.random.default_rng(41)
    bs = cfg.train.batch_size
    checks, perf = {}, {}
    reset_counts()

    # (a) launches of the pre-pass, the grad pass and the backward
    gd, tr = _sc_trainer(cfg)
    x, c = (torch.as_tensor(a[:bs], device="cuda") for a in (hr, lr))
    t = rng.integers(0, cfg.diffusion.timesteps, bs)
    noise = rng.standard_normal((bs, s, s, 1)).astype(np.float32)
    for coin in (True, False):
        before = read_counts()
        with full_float32():
            loss = gd.loss(x, c, ArrayDraws("cuda", [t], [noise], coins=[coin]))
            torch.cuda.synchronize()
            mid = read_counts()
            loss.backward()
        torch.cuda.synchronize()
        check_counts({k: v - before[k] for k, v in mid.items()}, MRI_PER_CALL, 2 if coin else 1,
                     f"self-conditioned loss, coin {'heads' if coin else 'tails'}")
        launched = {k: v - mid[k] for k, v in read_counts().items() if v != mid[k]}
        if launched:
            raise RuntimeError(f"a self-conditioned backward launched kernels: {launched}")
        gd.model.zero_grad(set_to_none=True)
    log("self_cond: the loss on heads launches every kernel twice a UNet call's count (the "
        "no-grad pre-pass and the grad pass), on tails once; the backward none")

    # (b) 4 batch steps, the coin both ways, learned then random features
    for label, flags in (("learned", {}), ("random", dict(random_fourier_features=True))):
        c2 = cfg.replace(model=dataclasses.replace(cfg.model, **flags))
        gd2, tr2 = (gd, tr) if not flags else _sc_trainer(c2)
        w0 = gd2.model.time_mlp.pos_emb.weights.detach().clone()
        before = read_counts()
        t0 = time.perf_counter()
        losses = []
        for i, coin in enumerate(SC_COINS):
            j = (bs * i) % len(hr)
            ti = rng.integers(0, cfg.diffusion.timesteps, bs)
            ni = rng.standard_normal((bs, s, s, 1)).astype(np.float32)
            losses.append(tr2.train_batch_step(hr[j:j + bs], lr[j:j + bs],
                                               ArrayDraws("cuda", [ti], [ni], coins=[coin])))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SC_STEPS
        check_counts({k: v - before[k] for k, v in read_counts().items()}, MRI_PER_CALL,
                     SC_STEPS + sum(SC_COINS), f"self_cond {label} steps")
        same = torch.equal(gd2.model.time_mlp.pos_emb.weights, w0)
        log(f"self_cond {label} Fourier features: {SC_STEPS} bf16 batch steps (coins "
            f"{list(SC_COINS)}) {step_s:.3f}s a step, losses {[round(v, 4) for v in losses]}; "
            f"pos_emb weights {'unchanged (bit-equal)' if same else 'moved'}")
        if not np.all(np.isfinite(losses)) or same != bool(flags):
            raise RuntimeError(f"self_cond {label}: losses {losses}, weights unchanged {same}")
        perf[f"{label}_step_s"] = step_s

    # (c) gradients with the kernels against the plain modules, both coins
    ref, _ = _sc_trainer(cfg)
    for coin in (True, False):
        with_k = _grads(ref, hr[:bs], lr[:bs], t, noise, coin)
        ref.model.use_plain_kernels(True)
        try:
            plain = _grads(ref, hr[:bs], lr[:bs], t, noise, coin)
        finally:
            ref.model.use_plain_kernels(False)
        checks[f"grad_{'heads' if coin else 'tails'}"] = _grad_agreement(
            f"self-conditioned 256px, coin {'heads' if coin else 'tails'}, kernels vs plain "
            f"modules on the card (batch {bs}, bf16)", with_k, plain, TRAIN_LOSS_REL,
            TRAIN_GRAD_REL, TRAIN_GRAD_COS)
    del ref

    # (d) one branched chain of the trained model at T=SC_CHAIN_T (its
    # weights in an engine of that schedule), zeros for x_self_cond
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, timesteps=SC_CHAIN_T,
                                                    sampling_timesteps=None))
    weights = gd.model.state_dict()
    gd = build_gd(cfg, device="cuda")
    gd.model.load_state_dict(weights)
    pipe = LocalDiffusionPipeline(cfg, gd)
    lo, hi = pipe.min_max_val
    lr4 = rng.uniform(0, hi, (MRI_BATCH, s, s, 1)).astype(np.float32)
    mask = disc_masks(MRI_BATCH, s)
    before = read_counts()
    res = pipe.translate(lr4, noise=1, mask=mask)
    check_counts({k: v - before[k] for k, v in read_counts().items()}, MRI_PER_CALL,
                 gd.num_timesteps, "self_cond chain")
    _check_images("self_cond chain", res["pred"], lr4.shape, lo, hi)
    counts = read_counts()
    gd.model.use_plain_kernels(True)
    try:
        plain = pipe.translate(lr4, noise=1, mask=mask)
    finally:
        gd.model.use_plain_kernels(False)
    a, p = res["pred"].ravel(), plain["pred"].ravel()
    rel = float(np.linalg.norm(a - p) / np.linalg.norm(p))
    corr = float(np.corrcoef(a, p)[0, 1])
    checks["chain"] = dict(rel_l2=rel, corr=corr)
    perf["chain_s"] = float(res["time"])
    log(f"self_cond check: the trained model's branched chain (T={gd.num_timesteps}, batch "
        f"{MRI_BATCH}, {float(res['time']):.2f}s, {MRI_BATCH / float(res['time']):.3f} img/s) "
        f"vs its plain versions: relative L2 {rel:.4g} (tol {MRI_CHAIN_REL:g}), correlation "
        f"{corr:.6f} (tol {MRI_CHAIN_CORR:g})")
    if not (bool(res["branched"]) and rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR):
        raise RuntimeError("the self-conditioned chain disagrees with its plain-version chain")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"self_cond phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


# ---------------------------------------------------------------------------
# serving, the sampler's API, the trained MNIST weights, the aux models
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
SHIPPED_DENOISER = RESULTS / "mri_synth256_ema.npz"
# the serving front end on `mri256_bf16_config()` (DDIM-50, bf16, the shipped
# denoiser and seg detector) at batch 4: per kind 4 requests (a half mask,
# branched; all ones, plain; no mask, the seg detector decides), each kind
# sent together after the last kind's answers, so each forms one batch
# requests of each kind: 2 (4 before the attribution and tensor-parallel
# phases came in)
SERVE_KINDS, SERVE_PER_KIND, SERVE_WAIT_MS = ("branched", "plain", "detector"), 2, 1000
CONFIG_JSON = STAGE_A_DIR.parent / "config" / "mri256_bf16.json"
SERVE_CLI_TIMEOUT_S = 300
# the sampler's API: `sample` against the direct sampler calls on
# `mri256_config()` at full width with T cut to 25 for time (its dispatch is
# the same at any T); `interpolate` at full width, batch 4, bf16, T=50 from
# t = T-1, against its plain-version chain at the 256px chain bars;
# `return_debug` on the trained flagship, card vs CPU at the flagship's bar
# interpolate's chain: T=50 of the T=250 configuration (250 before the
# attribution and tensor-parallel phases came in)
SAMPLE_T, INTERP_T, INTERP_BATCH, INTERP_LAM = 25, 50, 4, 0.3
# the exported MNIST checkpoints (tracked in git, `scripts/export_orbax_npz.py`)
MNIST_NPZ = {"mnist_x250": ROOT / "results_torch" / "mnist_x250_best10000.npz",
             "mnist_u150": ROOT / "results_torch" / "mnist_u150_best200.npz"}
MNIST_DIR = STAGE_A_DIR.parent / "mnist_trained"
# the test CLI's images on each checkpoint: 2 (8 before the attribution and
# tensor-parallel phases came in; the CPU's CLIs took 34.7 s of the run)
MNIST_TEST_IMAGES, MNIST_SERVE, MNIST_UNET_TOL = 2, 8, 1e-4
# the aux models: the seg detector trained at 256px for 2 epochs (64 brains at
# batch 4), the classifier for 2 epochs on the seeded t10k digits, and the
# volume CLIs on an 8-slice seeded MetaImage volume at 256px, batch 4
AUX_DIR = STAGE_A_DIR.parent / "aux"
AUX_SEG_EPOCHS, AUX_CLS_EPOCHS, AUX_SLICES, AUX_VOLUME_BATCH = 2, 2, 8, 4


class NumpyNoise:
    """A noise source drawing from a seeded numpy generator and copying to
    `device`: the same stream on the card and on the CPU (a torch generator
    on the card draws another stream than one on the CPU)."""

    def __init__(self, seed, device):
        self.rng = np.random.default_rng(seed)
        self.device = device

    def __call__(self, shape):
        return torch.as_tensor(self.rng.standard_normal(shape).astype(np.float32),
                               device=self.device)


@contextlib.contextmanager
def numpy_run_noise(device):
    """Within the block, `pipeline.run`'s batch i draws from
    `NumpyNoise([seed, i], device)`, so a CLI run on the card and one on the
    CPU sample with the same noise."""
    import localdiffusion_tpu_torch.pipeline as P

    real = P.batch_noise

    def batch_noise(noise, index):
        return NumpyNoise([0 if noise is None else int(noise), index], device), None

    P.batch_noise = batch_noise
    try:
        yield
    finally:
        P.batch_noise = real


def _http(url, body=None, timeout=600):
    """(status, parsed JSON) of a GET, or a POST of `body` (a dict)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve_cli(npz: Path) -> dict:
    """`python -m localdiffusion_tpu_torch.scripts.serve` as a user starts it
    (a new process, cold): the warm-up it prints, then one request without a
    mask, /healthz, and an interrupt; the process is stopped in any case."""
    import queue
    import signal
    import sys
    import threading

    proc = subprocess.Popen(
        [sys.executable, "-m", "localdiffusion_tpu_torch.scripts.serve", "--config",
         "mri256_bf16", "--params-npz", str(npz), "--port", "0",
         "--batch-size", str(MRI_SERVE_BATCH)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    t0 = time.perf_counter()
    said, url = [], None
    try:
        while url is None:
            try:
                ln = lines.get(timeout=1.0)
            except queue.Empty:
                if proc.poll() is not None:
                    raise RuntimeError(f"the serve CLI exited with {proc.returncode}: {said}")
                if time.perf_counter() - t0 > SERVE_CLI_TIMEOUT_S:
                    raise RuntimeError(f"the serve CLI did not bind in {SERVE_CLI_TIMEOUT_S}s: "
                                       f"{said}")
                continue
            said.append(ln.rstrip())
            if ln.startswith("serving on "):
                url = ln.split()[2]
        start_s = time.perf_counter() - t0
        warm = [float(ln.split()[1][:-1]) for ln in said if ln.startswith("warm-up ")]
        lr = test_arrays(mri256_bf16_config(), 1)[1][0]
        t1 = time.perf_counter()
        code, out = _http(url + "/v1/translate", {"image": lr[..., 0].tolist()})
        first_s = time.perf_counter() - t1
        health = _http(url + "/healthz")
        if code != 200 or health != (200, {"ok": True}) or len(warm) != 1:
            raise RuntimeError(f"the serve CLI answered {code} / {health}: {said}")
        pred = np.asarray(out["pred"], np.float32)
        if pred.shape != lr.shape or not np.all(np.isfinite(pred)):
            raise RuntimeError(f"the serve CLI's pred {pred.shape}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    log(f"serve CLI (cold process): bound after {start_s:.1f}s, warm-up {warm[0]:.2f}s; first "
        f"request {first_s * 1e3:.1f}ms round trip (server latency "
        f"{out['latency_s'] * 1e3:.1f}ms, branched {out['branched']}); /healthz ok; "
        f"exit {rc} on SIGINT")
    return dict(cli_start_s=start_s, cli_warmup_s=warm[0], cli_first_request_s=first_s,
                cli_first_latency_s=out["latency_s"])


def serve_phase() -> dict:
    """`scripts.serve` on `mri256_bf16_config()` with the shipped denoiser and
    seg detector: the CLI in a cold process, then `build_server` (warmed)
    in this one answering 12 requests over loopback HTTP with every count at
    0; each served pred bit for bit against `pipe.translate` of its padded
    batch with that batch's noise."""
    import threading
    from concurrent.futures import ThreadPoolExecutor as Pool

    from localdiffusion_tpu_torch.scripts import serve as serve_script

    t_phase = time.perf_counter()
    perf = _serve_cli(SHIPPED_DENOISER)
    # the in-process server reads its configuration from a .json dump
    CONFIG_JSON.parent.mkdir(parents=True, exist_ok=True)
    mri256_bf16_config().save_json(str(CONFIG_JSON))
    if load_config(str(CONFIG_JSON)) != mri256_bf16_config():
        raise RuntimeError(f"{CONFIG_JSON} does not load back as mri256_bf16_config()")
    args = serve_script.parse_args([
        "--config", str(CONFIG_JSON), "--params-npz", str(SHIPPED_DENOISER), "--port", "0",
        "--batch-size", str(MRI_SERVE_BATCH), "--max-wait-ms", str(SERVE_WAIT_MS)])
    t0 = time.perf_counter()
    (httpd, srv), said = _echoed(serve_script.build_server, args)
    perf["build_s"] = time.perf_counter() - t0
    perf["warmup_s"] = float([ln for ln in said.splitlines() if ln.startswith("warm-up ")][0]
                             .split()[1][:-1])
    pipe = srv.pipe
    calls = pipe.gd.diff_cfg.resolved_sampling_timesteps
    dispatches = []
    real = pipe.translate

    def recorded(lr, **kw):  # the sampler thread's dispatches, in order
        res = real(lr, **kw)
        dispatches.append((np.array(lr), kw, res))
        return res

    pipe.translate = recorded
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    _, lr, _ = test_arrays(pipe.config, len(SERVE_KINDS) * SERVE_PER_KIND)
    s = pipe.gd.image_size
    half = np.zeros((s, s), np.float32)
    half[:, : s // 2] = 1.0
    masks = {"branched": half, "plain": np.ones((s, s), np.float32), "detector": None}
    answers = []
    try:
        reset_counts()
        with Pool(SERVE_PER_KIND) as pool:
            for k, kind in enumerate(SERVE_KINDS):
                rows = range(k * SERVE_PER_KIND, (k + 1) * SERVE_PER_KIND)
                bodies = [dict(image=lr[i, ..., 0].tolist(),
                               **({} if masks[kind] is None else {"mask": masks[kind].tolist()}))
                          for i in rows]
                for i, (code, out) in zip(rows, pool.map(
                        lambda b: _http(url + "/v1/translate", b), bodies)):
                    answers.append((kind, i, code, out))
        counts = read_counts()
        stats = _http(url + "/stats")[1]
        health = _http(url + "/healthz")
        bad = _http(url + "/v1/translate", {"image": np.zeros((s, s, 3)).tolist()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("the HTTP server thread did not stop")
    if any(code != 200 for _, _, code, _ in answers):
        raise RuntimeError(f"serve: statuses {[a[2] for a in answers]}")
    if health != (200, {"ok": True}):
        raise RuntimeError(f"serve: /healthz {health}")
    if bad != (400, {"error": f"expected 1 channel(s), got {(s, s, 3)}"}):
        raise RuntimeError(f"serve: a 3-channel body got {bad}")
    n = len(SERVE_KINDS) * SERVE_PER_KIND
    if (stats["requests"] != n or stats["plain_dispatches"] < 1
            or stats["branched_dispatches"] < 1 or len(dispatches) != stats["batches"]):
        raise RuntimeError(f"serve: stats {stats}, {len(dispatches)} dispatches")
    flags = {kind: [out["branched"] for k, _, _, out in answers if k == kind]
             for kind in SERVE_KINDS}
    if flags["branched"] != [True] * SERVE_PER_KIND or flags["plain"] != [False] * SERVE_PER_KIND:
        raise RuntimeError(f"serve: branched flags {flags}")
    check_counts(counts, MRI_PER_CALL, calls * len(dispatches), "serve")

    # each dispatch again, outside the count, through a pipeline built from
    # the builder: the same pred bit for bit
    builder = build_pipeline(mri256_bf16_config(), str(SHIPPED_DENOISER), device="cuda",
                             verbose=False)
    for d_lr, kw, res in dispatches:
        again = builder.translate(d_lr, **kw)
        if not np.array_equal(again["pred"], res["pred"]):
            raise RuntimeError("serve: a dispatch's pred differs from the builder pipeline's")
    del builder
    for kind, i, _, out in answers:
        rows = [(res, j) for d_lr, _, res in dispatches for j in range(len(d_lr))
                if np.array_equal(d_lr[j], lr[i])]
        if not rows or not np.array_equal(np.asarray(out["pred"], np.float32)[None],
                                          rows[0][0]["pred"][rows[0][1]][None]):
            raise RuntimeError(f"serve: request {i} ({kind}) is not its batch's row")
        _check_images(f"serve request {i}", np.asarray(out["pred"], np.float32), (s, s, 1),
                      *pipe.min_max_val)
    lat = np.asarray([out["latency_s"] for *_, out in answers])
    perf.update(latency_median_s=float(np.median(lat)), latency_max_s=float(lat.max()),
                batches=stats["batches"], phase_s=time.perf_counter() - t_phase)
    log(f"serve (mri256_bf16, shipped denoiser and seg detector, batch {MRI_SERVE_BATCH}, "
        f"DDIM-{calls}): built and warmed in {perf['build_s']:.1f}s (warm-up "
        f"{perf['warmup_s']:.2f}s: the plain and the branched chain); {n} requests in "
        f"{stats['batches']} batches (plain {stats['plain_dispatches']}, branched "
        f"{stats['branched_dispatches']}, merged {stats['merged_dispatches']}); latency median "
        f"{perf['latency_median_s'] * 1e3:.1f}ms max {perf['latency_max_s'] * 1e3:.1f}ms; the "
        f"detector's flags {flags['detector']}; /healthz ok, 3 channels 400; configuration "
        f"from {CONFIG_JSON.relative_to(ROOT)} (equal to mri256_bf16_config()); every pred bit "
        f"for bit the builder pipeline's translate of its padded batch; launches {counts} "
        f"({len(dispatches)} chains x {calls} calls)")
    return dict(counts=counts, perf=perf, checks={"serve_bit_equal": True})


def sampler_api_phase() -> dict:
    """`sample` picks the direct sampler's chain (the all-ones bypass and
    the branched chain, bit for bit and the same launches); `interpolate`
    at full width against its plain versions; `return_debug` on the trained
    flagship, card vs CPU."""
    from localdiffusion_tpu_torch.diffusion import sampler as S

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    full = mri256_config()
    cut = full.replace(diffusion=dataclasses.replace(full.diffusion, timesteps=SAMPLE_T,
                                                     sampling_timesteps=None))
    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        torch.manual_seed(11)
        gd = build_gd(cut, device="cuda")
    mmv = min_max_val_for(cut)
    hr, lr, _ = test_arrays(full, INTERP_BATCH)
    cond = torch.as_tensor(lr, device="cuda")
    s = gd.image_size
    half = np.ones((INTERP_BATCH, s, s, 1), np.float32)
    half[:, :, : s // 2] = 0.0
    scfg = cut.sampler
    reset_counts()
    for label, mask, direct in (
            ("all-ones bypass", np.ones_like(half),
             lambda: S.ddpm_sample_plain(gd, cond, mmv, noise=5)),
            ("branched", half,
             lambda: S.ddpm_sample_branched(gd, cond, torch.as_tensor(half, device="cuda"),
                                            scfg, mmv, noise=5))):
        before = read_counts()
        got = S.sample(gd, cond, scfg, mmv, mask=mask, noise=5)
        mid = read_counts()
        want = direct()
        after = read_counts()
        used = {k: mid[k] - before[k] for k in mid}
        if used != {k: after[k] - mid[k] for k in mid} or not torch.equal(got, want):
            raise RuntimeError(f"sample ({label}) did not run the direct sampler's chain")
        check_counts(used, MRI_PER_CALL, SAMPLE_T, f"sample {label}")
        log(f"sampler_api: sample ({label}, mri256 at T={SAMPLE_T}, batch {INTERP_BATCH}) is "
            f"the direct call bit for bit, launches {used}")

    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        torch.manual_seed(11)
        gdf = build_gd(full.replace(diffusion=dataclasses.replace(
            full.diffusion, timesteps=INTERP_T, sampling_timesteps=None)), device="cuda")
    x1 = torch.as_tensor(hr, device="cuda")
    x2 = torch.flip(x1, dims=(0,))
    before = read_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern = S.interpolate(gdf, x1, x2, cond, mmv, lam=INTERP_LAM, noise=6)
    torch.cuda.synchronize()
    perf["interpolate_chain_s"] = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in read_counts().items()}
    check_counts(used, MRI_PER_CALL, gdf.num_timesteps - 1, "interpolate")
    gdf.model.use_plain_kernels(True)
    try:
        plain = S.interpolate(gdf, x1, x2, cond, mmv, lam=INTERP_LAM, noise=6)
    finally:
        gdf.model.use_plain_kernels(False)
    a, b = kern.float().cpu().numpy(), plain.float().cpu().numpy()
    rel, corr = _rel_l2(a, b), float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    checks.update(interpolate_rel_l2=rel, interpolate_corr=corr)
    log(f"sampler_api: interpolate (mri256, batch {INTERP_BATCH}, bf16, from "
        f"t={gdf.num_timesteps - 1}, lam {INTERP_LAM}) {perf['interpolate_chain_s']:.2f}s for "
        f"{gdf.num_timesteps - 1} steps; kernels vs plain versions (same noise) rel L2 "
        f"{rel:.3g} (<= {MRI_CHAIN_REL}) corr {corr:.5f} (>= {MRI_CHAIN_CORR}); launches {used}")
    if not (np.all(np.isfinite(a)) and rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR):
        raise RuntimeError("interpolate on the card disagrees with its plain-version chain")
    del gd, gdf

    cfg = flagship_config()
    gds = {dev: load_params(cfg, params_npz=str(MNIST_NPZ["mnist_x250"]), device=dev,
                            verbose=False) for dev in ("cuda", "cpu")}
    digits = MNISTDataset(*synthetic_digits(2, seed=21, digit=8)).as_arrays()[1]
    fmask = manual_mask((2, 28, 28, 1), cfg.ood.manual_mask_cols)
    before = read_counts()
    dbg = {}
    for dev, g in gds.items():
        _, dbg[dev] = S.ddpm_sample_branched(
            g, torch.as_tensor(digits, device=dev), torch.as_tensor(fmask, device=dev),
            cfg.sampler, (0.0, 2.0), noise=NumpyNoise(22, dev), return_debug=True)
    used = {k: v - before[k] for k, v in read_counts().items()}
    check_counts(used, FLAGSHIP_PER_CALL, g.num_timesteps, "return_debug chain")
    keys = ("pred_out", "pred_in", "pred_concat", "x_out", "x_in")
    errs = {k: float((dbg["cuda"][k].cpu() - dbg["cpu"][k]).abs().max()) for k in keys}
    same_t = torch.equal(dbg["cuda"]["fusion_time"].cpu(), dbg["cpu"]["fusion_time"])
    checks["return_debug_max_abs_err"] = max(errs.values())
    log(f"sampler_api: return_debug on the trained flagship (batch 2, f32), card vs CPU "
        f"max_abs_err { {k: f'{v:.3g}' for k, v in errs.items()} } (tol {CHAIN_TOL:g}), "
        f"fusion_time equal {same_t}")
    if (set(dbg["cuda"]) != set(keys) | {"fusion_time"} or not same_t
            or max(errs.values()) > CHAIN_TOL):
        raise RuntimeError("return_debug on the card disagrees with the CPU's")
    counts = read_counts()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"sampler_api phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


def _write_t10k(tmp: Path) -> list:
    """2,048 seeded digits as the t10k idx files; the CLI options that
    point a configuration at them (the train- name, t10k- derived)."""
    imgs, labels = synthetic_digits(DATA_DIGITS, seed=12)
    write_idx(str(tmp / "t10k-images-idx3-ubyte"), imgs)
    write_idx(str(tmp / "t10k-labels-idx1-ubyte"), labels)
    return ["--mnist-path", str(tmp / "train-images-idx3-ubyte"),
            "--mnist-labels-path", str(tmp / "train-labels-idx1-ubyte")]


def _cpu_test_cli(name: str, npz: Path, data: list) -> subprocess.Popen:
    """The test CLI of `mnist_trained_phase` on the CPU in a process of its
    own (no card, 3 threads), with `numpy_run_noise`: it runs beside the
    card's work and prints its mean MSE last."""
    import sys

    code = ("import sys, chip_smoke as C\n"
            "with C.numpy_run_noise('cpu'):\n"
            "    r = C.test_script.main(sys.argv[1:])\n"
            "print('MEAN_MSE', float(r['mean_mse']), len(r['pred_all']), flush=True)\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, "--config", "flagship", "--params-npz", str(npz),
         "--detector", "manual", "--max-images", str(MNIST_TEST_IMAGES), "--save-prefix",
         str(MNIST_DIR / f"{name}_cpu_"), "--device", "cpu", *data],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "3"})


def mnist_trained_phase() -> dict:
    """The exported MNIST checkpoints: one UNet call card vs CPU each, the
    test CLI on 2 seeded t10k digits on the card and (in processes of their
    own, beside it) on the CPU with the same noise, and a server answering 8
    requests from the mnist_u150 weights."""
    t_phase = time.perf_counter()
    perf, checks = {}, {}
    if MNIST_DIR.exists():
        shutil.rmtree(MNIST_DIR)
    MNIST_DIR.mkdir(parents=True)
    data = _write_t10k(MNIST_DIR)
    cpu_runs = {name: (_cpu_test_cli(name, npz, data), time.perf_counter())
                for name, npz in MNIST_NPZ.items()}
    cfg = flagship_config()
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    cond = rng.uniform(0, 2, (2, 28, 28, 1)).astype(np.float32)
    t = np.array([3, 41])
    reset_counts()
    try:
        for name, npz in MNIST_NPZ.items():
            log(f"mnist_trained {name}: {npz.relative_to(ROOT)} {npz.stat().st_size} bytes "
                f"sha256 {sha256(npz)[:16]}")
            card = load_params(cfg, params_npz=str(npz), device="cuda", verbose=False)
            cpu = load_params(cfg, params_npz=str(npz), device="cpu", verbose=False)
            got = card.apply_model(*(torch.as_tensor(a, device="cuda") for a in (x, cond, t))
                                   ).cpu().numpy()
            want = cpu.apply_model(*(torch.as_tensor(a) for a in (x, cond, t))).numpy()
            err = float(np.abs(got - want).max())
            checks[f"{name}_unet_max_abs_err"] = err
            ok = bool(np.allclose(got, want, rtol=MNIST_UNET_TOL, atol=MNIST_UNET_TOL))
            log(f"mnist_trained {name}: UNet call card vs CPU (batch 2, f32) max_abs_err "
                f"{err:.3g} ({MNIST_UNET_TOL:g} abs+rel), |out| max {np.abs(want).max():.3f} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok or np.abs(want).max() < 0.1:
                raise RuntimeError(f"{name}: the UNet on the card disagrees with the CPU's")
            before = read_counts()
            t0 = time.perf_counter()
            with numpy_run_noise("cuda"):
                res = test_script.main(["--config", "flagship", "--params-npz", str(npz),
                                        "--detector", "manual", "--max-images",
                                        str(MNIST_TEST_IMAGES), "--save-prefix",
                                        str(MNIST_DIR / f"{name}_cuda_"), *data])
            perf[f"{name}_test_cuda_s"] = time.perf_counter() - t0
            n = len(res["pred_all"])
            _script_counts(f"{name} test CLI", before, FLAGSHIP_PER_CALL,
                           n * cfg.diffusion.timesteps)
            _check_images(f"{name} test CLI", res["pred_all"], (n, 28, 28, 1), 0.0, 2.0)
            checks[f"{name}_test_mse"] = float(res["mean_mse"])

        pipe = build_pipeline(cfg, str(MNIST_NPZ["mnist_u150"]), device="cuda", verbose=False)
        lr = test_arrays(cfg.replace(data=dataclasses.replace(
            cfg.data, mnist_path=data[1], mnist_labels_path=data[3])), MNIST_SERVE)[1]
        before = read_counts()
        srv = InferenceServer(pipe, batch_size=MNIST_SERVE, max_wait_ms=1000)
        with srv:
            outs = [f.result(timeout=600) for f in [srv.submit(im) for im in lr]]
        stats = srv.snapshot_stats()
        used = _script_counts("mnist_u150 serving", before, FLAGSHIP_PER_CALL,
                              cfg.diffusion.timesteps * stats["batches"])
        for i, o in enumerate(outs):
            _check_images(f"mnist_u150 request {i}", o["pred"], (28, 28, 1), 0.0, 2.0)
        if stats["requests"] != MNIST_SERVE or not all(o["branched"] for o in outs):
            raise RuntimeError(f"mnist_u150 serving: stats {stats}")
        perf["u150_serve_latency_mean_s"] = stats["latency_mean_s"]
        log(f"mnist_trained: mnist_u150 served {MNIST_SERVE} requests (manual mask) in "
            f"{stats['batches']} batch(es), mean latency {stats['latency_mean_s'] * 1e3:.1f}ms; "
            f"launches {used}")

        for name, (proc, t0) in cpu_runs.items():
            said, _ = proc.communicate(timeout=600)
            perf[f"{name}_test_cpu_s"] = time.perf_counter() - t0
            print(said, end="", flush=True)
            last = said.strip().splitlines()[-1].split() if said.strip() else []
            if proc.returncode != 0 or last[:1] != ["MEAN_MSE"] or last[2] != str(
                    MNIST_TEST_IMAGES):
                raise RuntimeError(f"{name}: the test CLI on the CPU failed ({proc.returncode})")
            mse_card, mse_cpu = checks[f"{name}_test_mse"], float(last[1])
            err = abs(mse_card - mse_cpu)
            checks[f"{name}_test_mse_abs_err"] = err
            log(f"mnist_trained {name}: test CLI on {MNIST_TEST_IMAGES} t10k digit-3 images "
                f"(manual mask, T={cfg.diffusion.timesteps}), mean MSE card {mse_card:.5f} CPU "
                f"{mse_cpu:.5f} (|diff| {err:.3g}, tol {CHAIN_TOL:g}); wall card "
                f"{perf[f'{name}_test_cuda_s']:.1f}s, CPU (its own process, beside the card's "
                f"work) {perf[f'{name}_test_cpu_s']:.1f}s")
            if err > CHAIN_TOL:
                raise RuntimeError(f"{name}: the test CLI's MSE on the card is not the CPU's")
    finally:
        for proc, _ in cpu_runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    counts = read_counts()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"mnist_trained phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks,
                pred_all=MNIST_DIR / "mnist_x250_cuda_pred_all.npy", data=data)


def aux_phase(pred_all: Path, data: list) -> dict:
    """`train_seg` at 256px and its npz as the seg detector, `train_mnist_cls`
    on the seeded digits and `eval_translation` on the trained flagship's
    predictions, `convert_mha` and `translate_volume` on a seeded volume."""
    from localdiffusion_tpu_torch.data.mha import load_mha, save_mha
    from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_pair
    from localdiffusion_tpu_torch.scripts import (
        convert_mha,
        eval_translation,
        train_mnist_cls,
        train_seg,
        translate_volume,
    )

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    if AUX_DIR.exists():
        shutil.rmtree(AUX_DIR)
    AUX_DIR.mkdir(parents=True)
    reset_counts()
    seg_npz = AUX_DIR / "seg" / "best_dice.npz"
    t0 = time.perf_counter()
    seg = train_seg.main(["--epochs", str(AUX_SEG_EPOCHS), "--batch", "4", "--size", "256",
                          "--config", "mri256_bf16", "--out", str(seg_npz)])
    torch.cuda.synchronize()
    perf["train_seg_s"] = time.perf_counter() - t0
    cfg = mri256_bf16_config()
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, seg_model_path=str(seg_npz)))
    fe, _ = build_frontend(cfg, device="cuda", verbose=False)
    lr = test_arrays(cfg, 4)[1]
    mask, binary, probs = fe.detect(lr)
    if mask.shape != (4, 256, 256, 1) or not np.all(np.isfinite(probs)):
        raise RuntimeError("the trained seg detector's detect failed")
    log(f"aux train_seg: {AUX_SEG_EPOCHS} epochs at 256px, batch 4, in {perf['train_seg_s']:.1f}s; "
        f"val dice {[round(d, 4) for *_, d in seg['logs']]}; its npz "
        f"({seg_npz.stat().st_size} bytes) served by the seg detector: {int(binary.sum())} "
        f"masked pixels in 4 tumour brains")
    t0 = time.perf_counter()
    cls = train_mnist_cls.main(["--epochs", str(AUX_CLS_EPOCHS), "--out",
                                str(AUX_DIR / "cls" / "best.npz"),
                                "--mnist-path", data[1].replace("train-", "t10k-"),
                                "--mnist-labels-path", data[3].replace("train-", "t10k-")])
    torch.cuda.synchronize()
    perf["train_mnist_cls_s"] = time.perf_counter() - t0
    ev, said = _echoed(eval_translation.main, ["--pred", str(pred_all), "--cls", cls["out"]])
    if sum(ev["hist"].values()) != MNIST_TEST_IMAGES:
        raise RuntimeError(f"eval_translation classified {ev['hist']}")
    checks["eval_translation_target_share"] = ev["frac_target"]
    log(f"aux train_mnist_cls: {AUX_CLS_EPOCHS} epochs in {perf['train_mnist_cls_s']:.1f}s, "
        f"test acc {[round(a, 4) for *_, a in cls['logs']]}; eval_translation of the trained "
        f"flagship's {MNIST_TEST_IMAGES} translations (8 to 3, seeded digits): target share "
        f"{ev['frac_target']:.3f}, source share {ev['frac_source']:.3f}, {ev['hist']}")
    _script_counts("aux training", {k: 0 for k in COUNTERS}, {}, 0)

    t1, flair, sg = synthetic_brain_pair(AUX_SLICES, size=256, tumor=True, seed=31)
    vols = {"t1": (t1[..., 0], False), "flair": (flair[..., 0], True),
            "seg": (sg[..., 0], False)}
    for name, (v, compressed) in vols.items():
        save_mha(str(AUX_DIR / f"vol_{name}.mha"), v.astype(np.float32), compressed=compressed)
    written = convert_mha.main([str(AUX_DIR / "vol_*.mha"), "--out-dir", str(AUX_DIR / "npy")])
    for path in written:
        got = np.load(path)
        want, _ = load_mha(str(AUX_DIR / (Path(path).stem + ".mha")))
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise RuntimeError(f"convert_mha: {path} is not the volume load_mha reads")
    before = read_counts()
    t0 = time.perf_counter()
    out = str(AUX_DIR / "pred_volume.npy")
    res = translate_volume.main([
        "--config", "mri256_bf16", "--t1", str(AUX_DIR / "vol_t1.mha"), "--flair",
        str(AUX_DIR / "npy" / "vol_flair.npy"), "--seg", str(AUX_DIR / "vol_seg.mha"),
        "--params-npz", str(SHIPPED_DENOISER), "--batch", str(AUX_VOLUME_BATCH), "--out", out])
    torch.cuda.synchronize()
    perf["translate_volume_s"] = time.perf_counter() - t0
    batches = -(-AUX_SLICES // AUX_VOLUME_BATCH)
    _script_counts("translate_volume", before, MRI_PER_CALL,
                   batches * cfg.diffusion.resolved_sampling_timesteps)
    pred = np.load(out)
    if pred.shape != (AUX_SLICES, 256, 256) or np.load(out.replace(".npy", "_masks.npy")
                                                       ).shape != pred.shape:
        raise RuntimeError(f"translate_volume wrote {pred.shape}")
    _check_images("translate_volume", pred[..., None], (AUX_SLICES, 256, 256, 1),
                  *min_max_val_for(cfg))
    checks["volume_mse"] = float(res["mse"])
    log(f"aux volumes: convert_mha of 3 seeded {AUX_SLICES}-slice volumes (one zlib) bit for bit "
        f"load_mha's; translate_volume (mri256_bf16, shipped denoiser and seg detector, batch "
        f"{AUX_VOLUME_BATCH}) in {perf['translate_volume_s']:.1f}s: volume MSE "
        f"{float(res['mse']):.5f}, OOD-region {float(res.get('mean_mse_ood_region', np.nan)):.5f}, "
        f"{res['branched_batches']} of {batches} batches branched")
    counts = read_counts()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"aux phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


# ---------------------------------------------------------------------------
# the parallel and I/O layer: patch-parallel sampling, data-parallel and FSDP
# training, the streaming loader, the reference converter, the feature
# shoot-out and the native data kernels
# ---------------------------------------------------------------------------

PARALLEL_DIR = STAGE_A_DIR.parent / "parallel"
# the bf16 patch call: `mri256_bf16_config()` (DDIM-50, bf16) on the shipped
# denoiser, a 384px image in 4 patches of 256px with overlap 128: an [8] UNet
# batch at 256px, the 256px call's launches, all eight kernels.  (9 patches
# of 128px from a 256px image launch no tiled GN pass: at 128px every Block
# past the fused ResnetBlocks has rows under the single-pass gate.)
BF16_IMAGE, BF16_PATCH, BF16_OVERLAP = 384, 256, 128
# the distributed step: two ranks on the one card over gloo (NCCL refuses two
# ranks on one device), one 256px bf16 batch step of the global batch of 8,
# replicated then FSDP, against the one-process step at the training bars
DIST_WORLD, DIST_TIMEOUT_S = 2, 300
# mesh serving: the two ranks as (data, patch) meshes, one batch of requests
# a mesh, and the bar on the served images against one process's (a rank's
# rows run at another batch size)
MESH_SERVE_MESHES, MESH_SERVE_REL, MESH_SERVE_SEED = ((2, 1), (1, 2)), 1e-2, 3
STREAM_SHARDS, STREAM_ROWS, STREAM_BATCH = 3, 16, 8
FEATURE_REFITS, FEATURE_NORMALS, FEATURE_TESTS = 2, 16, 8


@contextlib.contextmanager
def unet_rows(model):
    """The batch size of every UNet call inside the block, by a forward
    pre-hook."""
    rows = []
    h = model.register_forward_pre_hook(lambda _m, args: rows.append(int(args[0].shape[0])))
    try:
        yield rows
    finally:
        h.remove()


def _gn_per_call(model) -> int:
    """Single-pass GN launches in one f32 UNet call whose rows all fit the
    gate: two Blocks in each unfused ResnetBlock."""
    return 2 * sum(isinstance(m, ResnetBlock) for m in model.modules())


def patch_phase() -> dict:
    """The patch demo through its entry point, its chains card vs CPU and
    kernels vs plain, the exact stitch, the bf16 patch call on all eight
    kernels, and the bucketed route against the unbucketed one."""
    from localdiffusion_tpu_torch.diffusion import sampler as S
    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel import patch as P
    from localdiffusion_tpu_torch.scripts import patch_demo

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    reset_counts()
    noise = (NumpyNoise(30, "cuda"), NumpyNoise(31, "cuda"))
    demo = patch_demo.main(["--image-size", "256", "--patch", "64", "--overlap", "8",
                            "--params-npz", str(SHIPPED_DENOISER)], noise=noise)
    counts = read_counts()
    gd = demo["gd"]
    per_call = _gn_per_call(gd.model)
    n_calls = 2 * gd.diff_cfg.resolved_sampling_timesteps
    check_counts(counts, {"groupnorm_film_silu": per_call}, n_calls, "patch demo")
    out = demo["out"].cpu().numpy()
    _check_images("patch demo", out, (1, 256, 256, 1), 0.0, 12.0)
    perf.update(demo_first_s=demo["first_s"], demo_steady_s=demo["steady_s"], demo_mse=demo["mse"],
                demo_patches=demo["num_patches"])
    log(f"patch: the demo (mri64_config(), the shipped denoiser, 256px in "
        f"{demo['num_patches']} patches of 64px, overlap 8, DDIM-50, f32, a [50] UNet batch) "
        f"first call {demo['first_s']:.2f}s, steady state {demo['steady_s']:.3f}s, MSE vs gt "
        f"{demo['mse']:.4f}; launches {counts} ({per_call} single-pass GN a call x {n_calls})")

    # the demo's whole call (all 25 patch chains, the [50] batch) again on
    # the card through the plain versions, with the steady-state call's noise
    cfg = mri64_config()
    gd.model.use_plain_kernels(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_out = P.patch_parallel_sample(gd, demo["lr"], demo["mask"], cfg.sampler,
                                            patch_demo.MIN_MAX_VAL, 64, 8,
                                            noise=NumpyNoise(31, "cuda"))
        torch.cuda.synchronize()
        perf["demo_plain_s"] = time.perf_counter() - t0
    finally:
        gd.model.use_plain_kernels(False)
    err_plain = float((demo["out"] - plain_out).abs().max())

    # the tumour's patch chain card vs CPU (the same numpy noise; the CPU
    # cannot run all 25 in the time)
    grid = P.plan_patches(256, 256, 64, 8)
    mask_p = P._extract_patches_np(demo["mask"], grid)
    idx = [int(np.argmax(mask_p.reshape(len(mask_p), -1).sum(1)))]
    outs = {}
    for dev in ("cuda", "cpu"):
        g = gd if dev == "cuda" else load_params(cfg, params_npz=str(SHIPPED_DENOISER),
                                                  device="cpu", verbose=False)
        gp = P._patch_engine(g, 64)
        cond_p = P.extract_patches(torch.as_tensor(demo["lr"], device=dev), grid)[idx]
        m_p = torch.as_tensor(mask_p[idx], device=dev)
        t0 = time.perf_counter()
        outs[dev] = S.ddim_sample_branched(
            gp, cond_p, m_p, cfg.sampler, patch_demo.MIN_MAX_VAL,
            noise=multihost.RowsNoise(NumpyNoise(32, dev), len(mask_p), idx)).cpu().numpy()
        perf[f"patch_chain_{dev}_s"] = time.perf_counter() - t0
    err_cpu = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    checks.update(demo_card_vs_cpu_max_abs_err=err_cpu, demo_kernels_vs_plain_max_abs_err=err_plain)
    log(f"patch: the demo's whole call (25 patch chains) kernels vs plain on the card "
        f"max_abs_err {err_plain:.3g} (plain {perf['demo_plain_s']:.2f}s); the tumour's patch "
        f"chain (patch {idx[0]}) card vs CPU max_abs_err {err_cpu:.3g} (tol {CHAIN_TOL:g}); CPU "
        f"{perf['patch_chain_cpu_s']:.1f}s")
    if max(err_cpu, err_plain) > CHAIN_TOL:
        raise RuntimeError("the patch chains on the card disagree")

    # stitching with overlap 0 is the image, exactly
    img = torch.as_tensor(demo["hr"], device="cuda")
    g0 = P.plan_patches(256, 256, 64, 0)
    if not torch.equal(P.stitch_patches(P.extract_patches(img, g0), g0, 1, 0), img):
        raise RuntimeError("stitching the tiles of overlap 0 does not give the image back")
    checks["stitch_overlap0_exact"] = True

    # the bf16 patch call: all eight kernels
    bcfg = mri256_bf16_config()
    bgd = load_params(bcfg, params_npz=str(SHIPPED_DENOISER), device="cuda", verbose=False)
    hr, lr, seg = synthetic_brain_translation(1, BF16_IMAGE, tumor=True, seed=3,
                                              mean_t1=bcfg.data.mean_t1,
                                              std_t1=bcfg.data.std_t1,
                                              mean_flair=bcfg.data.mean_flair,
                                              std_flair=bcfg.data.std_flair)
    mask = (seg > 0).astype(np.float32)
    mmv = min_max_val_for(bcfg)
    before = read_counts()
    with unet_rows(bgd.model) as rows:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern = P.patch_parallel_sample(bgd, lr, mask, bcfg.sampler, mmv, BF16_PATCH, BF16_OVERLAP,
                                       noise=NumpyNoise(33, "cuda"))
        torch.cuda.synchronize()
        perf["bf16_patch_call_s"] = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in read_counts().items()}
    check_counts(used, MRI_PER_CALL, len(rows), "bf16 patch call")
    bgd.model.use_plain_kernels(True)
    try:
        plain = P.patch_parallel_sample(bgd, lr, mask, bcfg.sampler, mmv, BF16_PATCH, BF16_OVERLAP,
                                        noise=NumpyNoise(33, "cuda"))
    finally:
        bgd.model.use_plain_kernels(False)
    a, b = kern.float().cpu().numpy(), plain.float().cpu().numpy()
    rel, corr = _rel_l2(a, b), float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    checks.update(bf16_patch_rel_l2=rel, bf16_patch_corr=corr)
    log(f"patch: bf16 call (mri256_bf16_config(), the shipped denoiser, {BF16_IMAGE}px in 4 "
        f"patches of {BF16_PATCH}px, overlap {BF16_OVERLAP}, DDIM-50; UNet rows "
        f"{sorted(set(rows))} x "
        f"{len(rows)} calls) {perf['bf16_patch_call_s']:.2f}s; kernels vs plain rel L2 {rel:.4g} "
        f"(<= {MRI_CHAIN_REL}) corr {corr:.6f} (>= {MRI_CHAIN_CORR}); launches {used}")
    if not (np.all(np.isfinite(a)) and rel <= MRI_CHAIN_REL and corr >= MRI_CHAIN_CORR):
        raise RuntimeError("the bf16 patch call disagrees with its plain versions")

    # the bucketed route against the unbucketed one, each row the same noise
    few = np.zeros((1, 256, 256, 1), np.float32)
    few[:, 10:30, 10:30] = 1.0  # inside the first patch alone
    few[:, 100:110, 180:190] = 1.0  # and one more
    flat = P._extract_patches_np(few, grid)
    ood = np.nonzero((flat >= 1.0).reshape(len(flat), -1).any(1))[0]
    plain_rows = np.setdiff1d(np.arange(len(flat)), ood)
    with unet_rows(gd.model) as rows_u:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unb = P.patch_parallel_sample(gd, demo["lr"], few, cfg.sampler, patch_demo.MIN_MAX_VAL,
                                      64, 8, noise=NumpyNoise(34, "cuda"))
        torch.cuda.synchronize()
        perf["unbucketed_s"] = time.perf_counter() - t0
    with unet_rows(gd.model) as rows_b:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buck = P.patch_parallel_sample_bucketed(
            gd, demo["lr"], few, cfg.sampler, patch_demo.MIN_MAX_VAL, 64, 8,
            noise=multihost.RowsNoise(NumpyNoise(34, "cuda"), len(flat), plain_rows),
            branched_noise=multihost.RowsNoise(NumpyNoise(34, "cuda"), len(flat), ood))
        torch.cuda.synchronize()
        perf["bucketed_s"] = time.perf_counter() - t0
    err = float((buck - unb).abs().max())
    steps = gd.diff_cfg.resolved_sampling_timesteps
    # a branched patch's rows over its chain (two a step until the fusion,
    # one after), read off the unbucketed call; a plain patch one a step
    per_branched = sum(rows_u) // len(flat)
    want_rows = len(plain_rows) * steps + len(ood) * per_branched
    checks.update(bucketed_max_abs_err=err, bucketed_rows=sum(rows_b), unbucketed_rows=sum(rows_u))
    log(f"patch: bucketed ({len(ood)} branched + {len(plain_rows)} plain patches) "
        f"{perf['bucketed_s']:.2f}s, {sum(rows_b)} UNet rows, against the unbucketed "
        f"{perf['unbucketed_s']:.2f}s, {sum(rows_u)} rows (expected {want_rows}: a plain patch "
        f"one row a step, not two); "
        f"max_abs_err {err:.3g} (tol {CHAIN_TOL:g})")
    if (sum(rows_b) != want_rows or sum(rows_u) != len(flat) * per_branched
            or per_branched <= steps or err > CHAIN_TOL):
        raise RuntimeError("the bucketed route disagrees with the unbucketed one")
    counts = read_counts()
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"patch phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


DIST_SEED = 41


def _dist_trainer(mesh=None, fsdp=False):
    """A seeded `mri256_config()` trainer on this rank's card, and the
    global batch of 8 test brains (every rank holds it whole)."""
    cfg = mri256_config()
    tr = Trainer(build_gd(cfg, device="cuda"), cfg.train, mesh=mesh, fsdp=fsdp)
    hr, lr, _ = test_arrays(cfg, cfg.train.batch_size)
    return tr, hr, lr


def _dist_params(tr) -> dict:
    from localdiffusion_tpu_torch.parallel import fsdp as F

    return {k: v.float().cpu().numpy() for k, v in F.gather_tree(tr.model).items()}


def _dist_worker(rank, world, port, q):
    """A rank of the distributed phase: joins a gloo group on the card, then
    one batch step replicated and one with FSDP, each from the seeded
    weights; (rank, result) on `q`."""
    import traceback

    from localdiffusion_tpu_torch.parallel import fsdp as F
    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh

    try:
        multihost.init_distributed(f"localhost:{port}", world, rank, device="cuda",
                                   backend="gloo")
        mesh = make_mesh(data=world, device="cuda")
        multihost.warmup_collectives()
        out = {"device": str(multihost.rank_device("cuda")),
               "backend": str(torch.distributed.get_backend())}
        for kind in ("replicated", "fsdp"):
            tr, hr, lr = _dist_trainer(mesh, fsdp=kind == "fsdp")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = tr.train_batch_step(hr, lr, _seeded(DIST_SEED))
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            res = dict(loss=loss, counts=read_counts(), step_s=step_s,
                       info=F.shard_info(tr.state_tensors()))
            params = _dist_params(tr)  # collective
            if rank == 0:
                res["params"] = params
            out[kind] = res
            del tr
        q.put((rank, out))
    except BaseException:
        q.put((rank, "error: " + traceback.format_exc()))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _agreement(got: dict, want: dict) -> tuple:
    g = np.concatenate([got[k].ravel() for k in want]).astype(np.float64)
    w = np.concatenate([want[k].ravel() for k in want]).astype(np.float64)
    return (float(np.linalg.norm(g - w) / np.linalg.norm(w)),
            float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))))


def distributed_phase() -> dict:
    """Two ranks on the one card (gloo) take one 256px bf16 batch step,
    replicated and then FSDP, each held against the one-process step on the
    same global batch and draws; then a one-rank NCCL `scripts.train
    --fsdp` run of 2 steps, its checkpoint written by the primary and
    loaded back."""
    import multiprocessing
    import queue as queue_mod

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    tr, hr, lr = _dist_trainer()
    # one process, the same step: the reference; its updates are the step's
    before = {k: v.detach().float().cpu().numpy() for k, v in tr.model.state_dict().items()}
    ref_loss = tr.train_batch_step(hr, lr, _seeded(DIST_SEED))
    ref = {k: v.detach().float().cpu().numpy() for k, v in tr.model.state_dict().items()}
    del tr
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dist_worker, args=(r, DIST_WORLD, port, q))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    res = {}
    try:
        for _ in range(DIST_WORLD):
            rank, got = q.get(timeout=DIST_TIMEOUT_S)
            if isinstance(got, str):
                raise RuntimeError(f"distributed rank {rank} failed:\n{got}")
            res[rank] = got
    except queue_mod.Empty:
        raise RuntimeError(f"a distributed rank gave no answer in {DIST_TIMEOUT_S}s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    perf["two_ranks_s"] = time.perf_counter() - t0
    counts = {k: 0 for k in COUNTERS}
    for kind in ("replicated", "fsdp"):
        got = res[0][kind]
        rel, cos = _agreement(got["params"], ref)
        # the step's update alone, against the one-process update
        du = {k: got["params"][k] - before[k] for k in ref}
        dw = {k: ref[k] - before[k] for k in ref}
        rel_u, cos_u = _agreement(du, dw)
        losses = [res[r][kind]["loss"] for r in res]
        for r in res:
            for k, v in res[r][kind]["counts"].items():
                counts[k] += v
            check_counts(res[r][kind]["counts"], MRI_PER_CALL, 1, f"{kind} rank {r} step")
        checks[kind] = dict(params_rel_l2=rel, update_rel_l2=rel_u, update_cos=cos_u,
                            loss=losses[0], ref_loss=ref_loss,
                            memory_scaling=[res[r][kind]["info"]["memory_scaling"] for r in res])
        perf[f"{kind}_step_s"] = max(res[r][kind]["step_s"] for r in res)
        log(f"distributed {kind}: {DIST_WORLD} ranks on {res[0]['device']} over "
            f"{res[0]['backend']}, one 256px bf16 batch step of 8 (4 rows a rank) "
            f"{perf[f'{kind}_step_s']:.3f}s; loss {losses} vs one process {ref_loss:.6f}; "
            f"parameters rel L2 {rel:.3g}, the update rel L2 {rel_u:.4g} (<= {TRAIN_GRAD_REL}) "
            f"cosine {cos_u:.6f} (>= {TRAIN_GRAD_COS}); state bytes a rank / whole "
            f"{checks[kind]['memory_scaling']}")
        loss_ok = abs(losses[0] - ref_loss) <= TRAIN_LOSS_REL * abs(ref_loss)
        if not (len(set(losses)) == 1 and loss_ok and rel_u <= TRAIN_GRAD_REL
                and cos_u >= TRAIN_GRAD_COS):
            raise RuntimeError(f"the {kind} step on two ranks disagrees with one process")
    scaling = checks["fsdp"]["memory_scaling"]
    if not 1.9 < min(scaling) <= max(scaling) < 2.1:
        raise RuntimeError("FSDP did not halve the training state a rank holds")

    # a one-rank NCCL run of the CLI with --fsdp: written by the primary, loaded back
    out_dir = PARALLEL_DIR / "train_fsdp"
    shutil.rmtree(out_dir, ignore_errors=True)
    reset_counts()
    common = ["--config", "mri256", "--step-mode", "batch", "--results", str(out_dir),
              "--num-processes", "1", "--process-id", "0", "--fsdp"]
    t0 = time.perf_counter()
    first = train_script.main(common + ["--steps", "2", "--eval-every", "2", "--coordinator",
                                        f"localhost:{_free_port()}"])
    perf["cli_fsdp_s"] = time.perf_counter() - t0
    cli_counts = read_counts()
    # loaded back in this process, unsharded: the one-process layout
    cfg = mri256_config()
    back = Trainer(build_gd(cfg, device="cuda"), cfg.train)
    back.results_dir = first["results_dir"]
    back.load("latest")
    state = torch.load(Path(first["results_dir"]) / "model-latest.pt", map_location="cpu",
                       weights_only=True)
    same = all(torch.equal(v.cpu(), state["params"][k])
               for k, v in back.model.state_dict().items())
    checks["cli"] = dict(steps=first["step"], loaded_step=back.step, world=first["world"],
                         evals=first["evals"], loaded_equal=same)
    log(f"distributed: scripts.train --coordinator --num-processes 1 --process-id 0 --fsdp "
        f"(NCCL) 2 batch steps and the eval chain {perf['cli_fsdp_s']:.2f}s, losses "
        f"{[round(v, 4) for v in first['losses']]}, eval MSE {first['evals']}; model-latest.pt "
        f"written by the primary, loaded back at step {back.step} bit for bit {same}; launches "
        f"{cli_counts}")
    if (first["step"], back.step, first["world"]) != (2, 2, 1) or not same:
        raise RuntimeError(f"the FSDP CLI run did not save its state: {checks['cli']}")
    for k, v in cli_counts.items():
        counts[k] += v
    if any(v < 1 for v in counts.values()):
        raise RuntimeError(f"a kernel never launched in the distributed phase: {counts}")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"distributed phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


def stream_phase() -> dict:
    """`StreamLoader` over .npy shards through `device_prefetch`: the device
    batches bit for bit the host's, an epoch step fed through the prefetch
    equal to one fed without it, and the copies on a side stream in a
    `profile_trace` trace."""
    from localdiffusion_tpu_torch.data.stream import StreamLoader, device_prefetch, npy_shard

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    cfg = mri256_config()
    d = cfg.data
    hr, lr, _ = synthetic_brain_translation(STREAM_SHARDS * STREAM_ROWS, 256, tumor=False, seed=8,
                                            mean_t1=d.mean_t1, std_t1=d.std_t1,
                                            mean_flair=d.mean_flair, std_flair=d.std_flair)
    out_dir = PARALLEL_DIR / "stream"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    shards = []
    for i in range(STREAM_SHARDS):
        rows = slice(i * STREAM_ROWS, (i + 1) * STREAM_ROWS)
        paths = [str(out_dir / f"{n}{i}.npy") for n in ("hr", "lr")]
        np.save(paths[0], hr[rows])
        np.save(paths[1], lr[rows])
        shards.append(npy_shard(*paths))
    loader = StreamLoader(shards, [STREAM_ROWS] * STREAM_SHARDS, batch_size=STREAM_BATCH, seed=7)
    host = list(loader.epoch_batches(0))
    t0 = time.perf_counter()
    dev = list(device_prefetch(loader.epoch_batches(0), size=2, device="cuda"))
    torch.cuda.synchronize()
    perf["prefetch_epoch_s"] = time.perf_counter() - t0
    same = len(host) == len(dev) and all(
        torch.equal(d.cpu(), torch.as_tensor(h)) and d.device.type == "cuda"
        for hb, db in zip(host, dev) for h, d in zip(hb, db))
    checks["device_equals_host"] = bool(same)
    if not same:
        raise RuntimeError("device_prefetch changed a batch")

    losses, reset = [], read_counts()
    for fed in ("prefetch", "host"):
        tr = Trainer(build_gd(cfg, device="cuda"), cfg.train)
        batches = (device_prefetch(loader.epoch_batches(1), device="cuda") if fed == "prefetch"
                   else loader.epoch_batches(1))
        losses.append(tr.train_epoch_step(batches, _seeded(5)))
        del tr
    counts = {k: v - reset[k] for k, v in read_counts().items()}
    check_counts(counts, MRI_PER_CALL, 2 * len(loader), "stream epoch steps")
    checks["epoch_losses"] = losses
    log(f"stream: {STREAM_SHARDS} .npy shards of {STREAM_ROWS} 256px brains, batch "
        f"{STREAM_BATCH}; device_prefetch's {len(dev)} batches bit for bit the host's "
        f"({perf['prefetch_epoch_s']:.3f}s an epoch); an epoch step fed through it {losses[0]!r}, "
        f"without it {losses[1]!r}")
    if losses[0] != losses[1]:
        raise RuntimeError("the epoch step fed through device_prefetch took another loss")

    # the copies run on the side stream: the trace's host-to-device copies are
    # on another stream than the consumer's kernels (`device_prefetch` of four
    # 64 x 256 x 256 float32 batches, traced in this aged process)
    trace_dir = out_dir / "trace"
    big = [(np.random.default_rng(i).standard_normal((64, 256, 256, 1)).astype(np.float32),)
           for i in range(4)]
    with profile_trace(str(trace_dir)):
        for (x,) in device_prefetch(iter(big), size=2, device="cuda"):
            (x * 2.0).sum().item()
        torch.cuda.synchronize()
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    copies = {e["args"].get("stream") for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")}
    kernels = {e["args"].get("stream") for e in events if e.get("cat") == "kernel"}
    checks.update(copy_streams=sorted(copies), kernel_streams=sorted(kernels))
    log(f"stream: profile_trace ({trace_dir / 'trace.json'}): host-to-device copies on streams "
        f"{sorted(copies)}, the consumer's kernels on {sorted(kernels)}")
    if not copies or not kernels or copies & kernels:
        raise RuntimeError("the prefetch's copies did not run off the consumer's stream")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"stream phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


def reference_ckpt_phase() -> dict:
    """A synthetic reference checkpoint of the 256px layout (12.1M
    parameters, seeded) through the converter's CLI; its EMA npz loaded on
    the card and on the CPU, one UNet call each."""
    from localdiffusion_tpu_torch.scripts import convert_reference_ckpt
    from localdiffusion_tpu_torch.utils.params_io import params_to_jax
    from localdiffusion_tpu_torch.utils.reference_ckpt import reference_state_dict

    t_phase = time.perf_counter()
    cfg = mri256_config()
    out_dir = PARALLEL_DIR / "reference"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    trees = []
    for seed in (1, 2):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            unet = UNet(cfg.model)
        trees.append(reference_state_dict(params_to_jax(unet.state_dict()), cfg.model))
    n_params = sum(v.size for v in trees[0].values())
    ckpt = out_dir / "model-1.pt"
    torch.save({"step": 1, "model": {f"model.{k}": torch.as_tensor(v) for k, v in trees[0].items()},
                "ema": {f"ema_model.model.{k}": torch.as_tensor(v) for k, v in trees[1].items()},
                "opt": {}, "scaler": None}, ckpt)
    reset_counts()
    t0 = time.perf_counter()
    res = convert_reference_ckpt.main([str(ckpt), "--out", str(out_dir / "ref"), "--dim", "32",
                                       "--dim-mults", "1,2,4,8", "--mode", "mri"])
    convert_s = time.perf_counter() - t0
    npz = out_dir / "ref-ema.npz"
    agree = _unet_card_vs_cpu("converted reference EMA", cfg, npz, np.random.default_rng(4),
                              f32=False)
    counts = read_counts()
    check_counts(counts, MRI_PER_CALL, 1, "reference_ckpt call")
    log(f"reference_ckpt: a seeded reference checkpoint of the 256px layout ({n_params} "
        f"parameters, {ckpt.stat().st_size} bytes) converted in {convert_s:.2f}s "
        f"({len(res['params'])} tensors, step {res['step']}); its EMA npz card vs CPU "
        f"{agree}; launches {counts}")
    perf = dict(convert_s=convert_s, phase_s=time.perf_counter() - t_phase)
    return dict(counts=counts, perf=perf, checks=dict(card_vs_cpu=agree, params=n_params))


def features_phase() -> dict:
    """`eval_patchcore_features` with 2 refits on the denoiser (the shipped
    npz) and the WRN50-2 (seeded) sources at 256px; the IoUs printed."""
    from localdiffusion_tpu_torch.scripts import eval_patchcore_features

    t_phase = time.perf_counter()
    reset_counts()
    out = PARALLEL_DIR / "features.json"
    res = eval_patchcore_features.main([
        "--config", "mri256", "--sources", "denoiser,wrn", "--refits", str(FEATURE_REFITS),
        "--normals", str(FEATURE_NORMALS), "--tests", str(FEATURE_TESTS),
        "--feature-npz", str(SHIPPED_DENOISER), "--out", str(out)])
    counts = read_counts()
    ious = {src: {k: r["agg"][k]["mean"] for k in ("iou", "iou_dilated")} for src, r in res.items()}
    for src, r in res.items():
        vals = [x["iou"] for x in r["refits"]]
        if len(vals) != FEATURE_REFITS or not all(0.0 <= v <= 1.0 for v in vals):
            raise RuntimeError(f"eval_patchcore_features {src}: IoUs {vals}")
    perf = dict(phase_s=time.perf_counter() - t_phase)
    log(f"features: eval_patchcore_features (mri256, {FEATURE_REFITS} refits of "
        f"{FEATURE_NORMALS} normal brains, {FEATURE_TESTS} tumour brains) mean IoU {ious}; "
        f"{perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=dict(ious=ious))


def native_phase() -> dict:
    """The native data kernels build with g++ and match the numpy route."""
    from localdiffusion_tpu_torch import native

    t0 = time.perf_counter()
    if not native.have_native():
        raise RuntimeError(f"the native data kernels did not build: {native.build_error()}")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (512, 28, 28), dtype=np.uint8)
    idx = rng.permutation(512)[:256]
    gather = native.gather_normalize(imgs, idx, 2.0 / 255.0)
    gather_np = native.gather_normalize(imgs, idx, 2.0 / 255.0, use_native=False)
    errs = {}
    for h_only in (True, False):
        t1 = time.perf_counter()
        got = native.degrade_batch(imgs, h_only, 2.0 / 255.0)
        t_native = time.perf_counter() - t1
        t1 = time.perf_counter()
        want = native.degrade_batch(imgs, h_only, 2.0 / 255.0, use_native=False)
        t_numpy = time.perf_counter() - t1
        errs[f"degrade_{'h_only' if h_only else 'full'}"] = float(np.abs(got - want).max())
        errs[f"degrade_{'h_only' if h_only else 'full'}_s"] = (t_native, t_numpy)
    exact = bool(np.array_equal(gather, gather_np))
    log(f"native: {native.library_path().name} built in {build_s:.2f}s; gather_normalize of "
        f"256 of 512 28px images bit for bit the numpy route {exact}; degrade_batch max_abs_err "
        f"and (native, numpy) seconds {errs}")
    if not exact or max(v for k, v in errs.items() if not k.endswith("_s")) > 1e-4:
        raise RuntimeError("the native data kernels disagree with the numpy route")
    return dict(counts={k: 0 for k in COUNTERS}, perf=dict(phase_s=time.perf_counter() - t0),
                checks=dict(gather_exact=exact, **{k: v for k, v in errs.items()
                                                   if not k.endswith("_s")}))


def _mesh_serve(pipe) -> tuple:
    """The server of `pipe` on the first rank (or in one process): one batch
    of MRI_SERVE_BATCH tumour brains without masks; (results, served s).
    On another rank of a mesh: its follower loop."""
    _, lr, _ = test_arrays(pipe.config, MRI_SERVE_BATCH)
    srv = InferenceServer(pipe, batch_size=MRI_SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                          base_seed=MESH_SERVE_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if getattr(pipe, "mesh", None) is not None and torch.distributed.get_rank() != 0:
        followed = srv.follow()
        torch.cuda.synchronize()
        return dict(followed=followed), time.perf_counter() - t0
    srv.start()
    try:
        outs = [f.result(timeout=DIST_TIMEOUT_S) for f in [srv.submit(x) for x in lr]]
    finally:
        srv.stop()
    torch.cuda.synchronize()
    served = time.perf_counter() - t0
    stats = srv.snapshot_stats()
    res = dict(pred=np.stack([o["pred"] for o in outs]), mask=np.stack([o["mask"] for o in outs]),
               branched=[bool(o["branched"]) for o in outs],
               dispatches=sum(stats[f"{k}_dispatches"] for k in ("plain", "branched", "merged")))
    return res, served


def _mesh_serve_worker(rank, world, port, q):
    """A rank of the mesh_serve phase: joins a gloo group on the card, then
    on each mesh builds the pipeline over it and serves (the first rank) or
    follows; (rank, result) on `q`."""
    import traceback

    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh

    try:
        multihost.init_distributed(f"localhost:{port}", world, rank, device="cuda",
                                   backend="gloo")
        multihost.warmup_collectives()
        out = {"device": str(multihost.rank_device("cuda")),
               "backend": str(torch.distributed.get_backend())}
        for data, patch in MESH_SERVE_MESHES:
            mesh = make_mesh(data=data, patch=patch, device="cuda")
            t0 = time.perf_counter()
            pipe = build_pipeline(mri256_bf16_config(), str(SHIPPED_DENOISER), device="cuda",
                                  verbose=False, mesh=mesh)
            build_s = time.perf_counter() - t0
            reset_counts()
            res, served_s = _mesh_serve(pipe)
            out[f"{data}x{patch}"] = dict(res, counts=read_counts(), build_s=build_s,
                                          served_s=served_s)
            del pipe
        q.put((rank, out))
    except BaseException:
        q.put((rank, "error: " + traceback.format_exc()))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def mesh_serve_phase() -> dict:
    """`InferenceServer` over a mesh pipeline on two ranks of the one card
    (gloo), on `mri256_bf16_config()` with the shipped weights, first on a
    data = 2 x patch = 1 mesh, then data = 1 x patch = 2; each rank held
    against the one-process server on the same requests."""
    import multiprocessing
    import queue as queue_mod

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    pipe = build_pipeline(mri256_bf16_config(), str(SHIPPED_DENOISER), device="cuda",
                          verbose=False)
    reset_counts()
    one, served_s = _mesh_serve(pipe)
    one_counts = read_counts()
    perf["one_process_served_s"] = served_s
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_mesh_serve_worker, args=(r, DIST_WORLD, port, q))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    res = {}
    try:
        for _ in range(DIST_WORLD):
            rank, got = q.get(timeout=DIST_TIMEOUT_S)
            if isinstance(got, str):
                raise RuntimeError(f"mesh_serve rank {rank} failed:\n{got}")
            res[rank] = got
    except queue_mod.Empty:
        raise RuntimeError(f"a mesh_serve rank gave no answer in {DIST_TIMEOUT_S}s") from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    perf["two_ranks_s"] = time.perf_counter() - t0
    counts = {k: 0 for k in COUNTERS}
    lo, hi = min_max_val_for(mri256_bf16_config())
    for data, patch in MESH_SERVE_MESHES:
        name = f"{data}x{patch}"
        got = res[0][name]
        _check_images(f"mesh_serve {name}", got["pred"], one["pred"].shape, lo, hi)
        rel = _rel_l2(got["pred"], one["pred"])
        err = float(np.abs(got["pred"] - one["pred"]).max())
        masks_equal = bool(np.array_equal(got["mask"], one["mask"]))
        checks[name] = dict(rel_l2=rel, max_abs_err=err, masks_equal=masks_equal,
                            branched=got["branched"], followed=res[1][name]["followed"])
        for r in res:
            for k, v in res[r][name]["counts"].items():
                counts[k] += v
            log(f"mesh_serve {name} rank {r} ({res[r]['device']}, {res[r]['backend']}): built "
                f"{res[r][name]['build_s']:.2f}s, "
                + (f"the batch of {MRI_SERVE_BATCH} served {res[r][name]['served_s']:.2f}s"
                   if r == 0 else
                   f"followed {res[r][name]['followed']} dispatches in "
                   f"{res[r][name]['served_s']:.2f}s")
                + f"; launches {res[r][name]['counts']} (one process {one_counts})")
            if res[r][name]["counts"] != one_counts:
                raise RuntimeError(f"mesh_serve {name} rank {r}: launches "
                                   f"{res[r][name]['counts']}, one process {one_counts}")
        # each data rank's rows again in this process at the rank's batch
        # size, with the noise drawn for the whole batch cut to those rows:
        # what is left of the difference is the batch size's rounding
        same = []
        for r in range(data):
            rows = slice(*row_range(MRI_SERVE_BATCH, r, data))
            alone = pipe.translate(test_arrays(pipe.config, MRI_SERVE_BATCH)[1][rows],
                                   noise=RowsNoise(GeneratorNoise(batch_seed(MESH_SERVE_SEED, 0),
                                                                  "cuda"), MRI_SERVE_BATCH, rows),
                                   mask=got["mask"][rows])
            same.append(bool(np.array_equal(alone["pred"], got["pred"][rows])))
        checks[name]["rows_at_rank_batch_bit_equal"] = same
        perf[f"{name}_served_s"] = got["served_s"]
        log(f"mesh_serve {name} (data={data} x patch={patch}, mri256_bf16, shipped denoiser and "
            f"seg detector, DDIM-50 bf16, {MRI_SERVE_BATCH} requests, Stage A on rank 0): "
            f"served images vs one process rel L2 {rel:.4g} (<= {MESH_SERVE_REL:g}) max |diff| "
            f"{err:.4g}; each data rank's rows in one process at the rank's batch size bit for "
            f"bit {same}; masks bit for bit {masks_equal}; branched {got['branched']} (one "
            f"process {one['branched']}); served {got['served_s']:.2f}s (one process "
            f"{served_s:.2f}s)")
        if (rel > MESH_SERVE_REL or not masks_equal or got["branched"] != one["branched"]
                or res[1][name]["followed"] != got["dispatches"] or not all(same)):
            raise RuntimeError(f"mesh_serve {name} disagrees with one process: {checks[name]}")
    del pipe
    if any(v < 1 for v in counts.values()):
        raise RuntimeError(f"a kernel never launched in the mesh_serve phase: {counts}")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh_serve phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


# ---------------------------------------------------------------------------
# the linear-attention attribution (scripts.bench_linatt_attrib)
# ---------------------------------------------------------------------------

ATTRIB_DIR = STAGE_A_DIR.parent / "linatt_attrib"
# the attribution kernels: the kv and q kernels' kLin instantiation and the
# bare copy, with the JAX script's functions they replace
ATTRIB_COUNTERS = {"linatt_attrib_kv": LA.kv_linear_exp, "linatt_attrib_q": LA.q_linear_exp,
                   "copy_probe": CP.copy_tiles}
ATTRIB_SOURCES = {
    "linatt_attrib_kv": ("localdiffusion_tpu_torch/csrc/linear_attention.cu",
                         "scripts/bench_linatt_attrib.py:68"),
    "linatt_attrib_q": ("localdiffusion_tpu_torch/csrc/linear_attention.cu",
                        "scripts/bench_linatt_attrib.py:112"),
    "copy_probe": ("localdiffusion_tpu_torch/csrc/copy_probe.cu",
                   "scripts/bench_linatt_attrib.py:206"),
}


@plain_in_float32
def linatt_attrib_phase() -> dict:
    """The attribution script (`scripts.bench_linatt_attrib`, the port's
    main path of the JAX script) at its shape, [8, 256, 256, 32] bf16, with
    every count at 0 before it and read after; then each attribution kernel
    against its plain version on the same inputs (the script's `compare`:
    l, the Gram and the q pass given W̃ each on its own, the copies bit for
    bit), timed beside its plain version, its bound and, for the copy, the
    library's `Tensor.copy_`."""
    from localdiffusion_tpu_torch.scripts import _measure as MS
    from localdiffusion_tpu_torch.scripts import bench_linatt_attrib as A

    t_phase = time.perf_counter()
    reset_counts()
    for fn in ATTRIB_COUNTERS.values():
        fn.launches = 0
    rec = A.main(["--out-dir", str(ATTRIB_DIR), "--no-check"])  # compared below
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {k: fn.launches for k, fn in ATTRIB_COUNTERS.items()}
    perf = dict(script_s=time.perf_counter() - t_phase,
                rows={r["name"]: r["ms"] for r in rec["rows"]}, derived=rec["derived"])
    log(f"linatt_attrib: the script ran in {perf['script_s']:.2f}s; attribution launches "
        f"{launches}, main-path launches {counts}; rows (device ms a call) "
        + "; ".join(f"{n} {ms:.4f}" for n, ms in perf["rows"].items())
        + f"; derived {json.dumps(rec['derived'])}")
    if any(v < 1 for v in launches.values()):
        raise RuntimeError(f"an attribution kernel never launched in the script: {launches}")

    inp = A.inputs()
    ops = A.operands(inp)
    xr, g_in, wk, wq, nb = ops["xr"], inp["g_in"], ops["wk"], ops["wq"], ops["nb"]
    b_out, g_out, zero = inp["b_out"], inp["g_out"], ops["zero"]
    errs = A.compare(inp, ops)
    got = LA.kv_linear_exp(xr, g_in, wk, nb)
    want = LA.kv_linear_reference(xr, g_in, wk, nb)
    g_err = (got[2] - want[2]).abs().max().item()
    b, n, c = xr.shape
    xb = xr.numel() * 2
    tensor_ms = 1e3 * 4 * b * n * c * 128 / BF16_OPS_PER_S  # two [N, C] x [C, 128] products
    fma_ms = 1e3 * 2 * b * n * 128 / FP32_OPS_PER_S  # one a*0.5 + 1 a token and column
    floors = {
        "linatt_attrib_kv": {"bytes": 1e3 * (xb + c * 128 * 2 + 4 * b * (2 * 128 + c * 128))
                             / HBM_BYTES_PER_S, "tensor": tensor_ms, "fp32": fma_ms},
        "linatt_attrib_q": {"bytes": 1e3 * (2 * xb + c * 128 * 2 + b * 128 * c * 2)
                            / HBM_BYTES_PER_S, "tensor": tensor_ms, "fp32": fma_ms},
        "copy_probe": {"bytes": 1e3 * 2 * xb / HBM_BYTES_PER_S},
    }
    out_buf = torch.empty_like(xr)
    timing = {
        "linatt_attrib_kv": (lambda: LA.kv_linear_exp(xr, g_in, wk, nb),
                             lambda: LA.kv_linear_reference(xr, g_in, wk, nb), None, g_err),
        "linatt_attrib_q": (lambda: LA.q_linear_exp(xr, g_in, wq, zero, b_out, g_out),
                            lambda: LA.q_pass_reference(xr, g_in, wq, zero, b_out, g_out,
                                                        exp=LA.lin_exp),
                            None, errs["q"]["max_abs_err"]),  # its well-conditioned tokens
        # the JAX script's middle grid, T = 2048 s2d tokens: 64 programs
        "copy_probe": (lambda: CP.copy_tiles(xr, A.copy_tiles_of(2048, n)),
                       lambda: xr.clone(), lambda: out_buf.copy_(xr), 0.0),
    }
    kernels = {}
    for name, (fn, plain, library, err) in timing.items():
        ms = MS.graph_ms(fn, 10, 5)
        plain_ms = MS.eager_ms(plain, 3)
        lib_ms = MS.graph_ms(library, 10, 5) if library is not None else None
        fl = floors[name]
        kernels[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=max(fl.values()),
                             bound_by="bytes" if max(fl, key=fl.get) == "bytes" else "operations",
                             floors=fl, max_abs_err=err, launches=launches[name])
        log(f"linatt_attrib {name} at [8, 65536, 32] bf16: kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us (eager), library "
            f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}, bound "
            f"{max(fl.values()) * 1e3:.1f} us ("
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in fl.items())
            + f"); max_abs_err {err:.4g}")
    for t in A.JAX_TILES:
        fn = lambda t=t: CP.copy_tiles(xr, A.copy_tiles_of(t, n))  # noqa: E731
        kernels["copy_probe"][f"T{t}_ms"] = MS.graph_ms(fn, 10, 5)
    log(f"linatt_attrib checks: {json.dumps(errs)}")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"linatt_attrib phase: {perf['phase_s']:.1f}s")
    return dict(counts=counts, perf=perf, checks=errs, kernels=kernels)


# ---------------------------------------------------------------------------
# tensor parallelism over the 'model' axis
# ---------------------------------------------------------------------------

TP_BATCH = 4
TP_CHAIN_STEPS = 10
TP_SEED = 51
# a 'model' rank against one process: bf16 one UNet call (rel L2, corr) and
# the chain as PERF.md section 2's bars; float32 with TF32 off 1e-4 (the
# ranks' collectives add only float32 summation order), one call (a float32
# rank's call takes ~1.7 s over gloo, so its chain is left out for time)
TP_REL = {"bfloat16": dict(call=5e-2, chain=0.1), "float32": dict(call=1e-4)}
TP_CHAIN_DTYPES = ("bfloat16",)
TP_CORR = 0.999
TP_MIN_SCALING = 1.8


def _tp_config(dtype: str):
    """`mri256_bf16_config()` as a 10-step DDIM chain in `dtype`."""
    base = mri256_bf16_config()
    return base.replace(
        diffusion=dataclasses.replace(base.diffusion, sampling_timesteps=TP_CHAIN_STEPS),
        train=dataclasses.replace(base.train, compute_dtype=dtype))


def _tp_run(gd, cfg, chain: bool = True) -> dict:
    """One UNet call at TP_BATCH rows (its launches counted) and, with
    `chain`, the branched 10-step DDIM chain on tumour brains with disc
    masks."""
    from localdiffusion_tpu_torch.diffusion import sampler as S

    s = gd.image_size
    rng = np.random.default_rng(TP_SEED)
    _, lr, _ = test_arrays(cfg, TP_BATCH)
    x = torch.as_tensor(rng.standard_normal((TP_BATCH, s, s, 1)), dtype=torch.float32,
                        device="cuda")
    cond = torch.as_tensor(lr, device="cuda")
    t = torch.full((TP_BATCH,), 100, device="cuda")
    gd.apply_model(x, cond, t)  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    call = gd.apply_model(x, cond, t)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = read_counts()
    out = dict(call=call.float().cpu().numpy(), counts=counts, call_s=call_s)
    if chain:
        mask = torch.as_tensor(disc_masks(TP_BATCH, s), device="cuda")
        t0 = time.perf_counter()
        img = S.ddim_sample_branched(gd, cond, mask, cfg.sampler, min_max_val_for(cfg),
                                     noise=TP_SEED)
        torch.cuda.synchronize()
        out.update(chain=img.float().cpu().numpy(), chain_s=time.perf_counter() - t0)
    return out


def _tp_worker(rank, world, port, q):
    """A rank of the tensor_parallel phase: joins a gloo group on the card,
    builds the shipped denoiser, cuts it to its 'model' shards and runs
    `_tp_run` in bf16 and in float32; (rank, result) on `q`."""
    import traceback

    from localdiffusion_tpu_torch.parallel import multihost
    from localdiffusion_tpu_torch.parallel.mesh import make_mesh
    from localdiffusion_tpu_torch.parallel.tensor_parallel import shard_tensor_parallel, tp_info

    try:
        multihost.init_distributed(f"localhost:{port}", world, rank, device="cuda",
                                   backend="gloo")
        multihost.warmup_collectives()
        mesh = make_mesh(model=world, device="cuda")
        out = {"mesh": list(mesh.mesh_dim_names)}
        for dtype in ("bfloat16", "float32"):
            cfg = _tp_config(dtype)
            gd = load_params(cfg, params_npz=str(SHIPPED_DENOISER), device="cuda",
                             verbose=False)
            shard_tensor_parallel(gd.model, mesh)
            torch.cuda.synchronize()
            out[dtype] = dict(_tp_run(gd, cfg, chain=dtype in TP_CHAIN_DTYPES),
                              info=tp_info(gd.model))
            del gd
        q.put((rank, out))
    except BaseException:
        q.put((rank, "error: " + traceback.format_exc()))
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def tensor_parallel_phase() -> dict:
    """Two ranks on the one card (gloo) with `make_mesh(model=2)`, each
    holding half of the shipped 256px denoiser (`shard_tensor_parallel`):
    one UNet call at batch 4 of `mri256_bf16_config()` in bf16 and in
    float32 with TF32 off, and a 10-step branched DDIM chain in bf16, each
    held against one process; each rank launches per call what one process
    does and holds about half the parameter bytes."""
    import multiprocessing
    import queue as queue_mod

    t_phase = time.perf_counter()
    perf, checks = {}, {}
    one = {}
    for dtype in ("bfloat16", "float32"):
        cfg = _tp_config(dtype)
        gd = load_params(cfg, params_npz=str(SHIPPED_DENOISER), device="cuda", verbose=False)
        one[dtype] = _tp_run(gd, cfg, chain=dtype in TP_CHAIN_DTYPES)
        del gd
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_tp_worker, args=(r, DIST_WORLD, port, q))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    res = {}
    try:
        for _ in range(DIST_WORLD):
            rank, got = q.get(timeout=DIST_TIMEOUT_S)
            if isinstance(got, str):
                raise RuntimeError(f"tensor_parallel rank {rank} failed:\n{got}")
            res[rank] = got
    except queue_mod.Empty:
        raise RuntimeError(f"a tensor_parallel rank gave no answer in {DIST_TIMEOUT_S}s") \
            from None
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    perf["two_ranks_s"] = time.perf_counter() - t0
    counts = {k: 0 for k in COUNTERS}
    for dtype in ("bfloat16", "float32"):
        want = one[dtype]
        bars = TP_REL[dtype]
        for r in sorted(res):
            got = res[r][dtype]
            c = dict(call_rel_l2=_rel_l2(got["call"], want["call"]),
                     call_corr=_corr(got["call"], want["call"]),
                     memory_scaling=got["info"]["memory_scaling"],
                     per_device_bytes=got["info"]["per_device_bytes"],
                     global_bytes=got["info"]["global_bytes"],
                     launches_equal=got["counts"] == want["counts"])
            if "chain" in want:
                c.update(chain_rel_l2=_rel_l2(got["chain"], want["chain"]),
                         chain_corr=_corr(got["chain"], want["chain"]))
            checks[f"{dtype}_rank{r}"] = c
            perf[f"{dtype}_rank{r}"] = dict(call_s=got["call_s"], chain_s=got.get("chain_s"))
            for k, v in got["counts"].items():
                counts[k] += v
            log(f"tensor_parallel {dtype} rank {r} of model=2 (mesh {res[r]['mesh']}): UNet "
                f"call at batch {TP_BATCH} vs one process rel L2 {c['call_rel_l2']:.4g} "
                f"(<= {bars['call']:g}) corr {c['call_corr']:.6f}; "
                + (f"{TP_CHAIN_STEPS}-step branched DDIM chain rel L2 {c['chain_rel_l2']:.4g} "
                   f"(<= {bars['chain']:g}), {got['chain_s']:.2f}s (one process "
                   f"{want['chain_s']:.2f}s); " if "chain" in want else "")
                + f"parameter bytes {c['per_device_bytes']} of {c['global_bytes']} "
                f"(x{c['memory_scaling']:.4f}); launches a call {got['counts']} (one process "
                f"{want['counts']}); call {got['call_s'] * 1e3:.1f}ms (one process "
                f"{want['call_s'] * 1e3:.1f}ms)")
            if (c["call_rel_l2"] > bars["call"] or c.get("chain_rel_l2", 0.0) > bars.get("chain", 1.0)
                    or (dtype == "bfloat16" and c["call_corr"] < TP_CORR)
                    or c["memory_scaling"] < TP_MIN_SCALING or not c["launches_equal"]):
                raise RuntimeError(f"tensor_parallel {dtype} rank {r} disagrees: {c}")
        perf[f"{dtype}_one_process"] = dict(call_s=want["call_s"], chain_s=want.get("chain_s"))
    if any(counts[k] < 1 for k in COUNTERS):
        raise RuntimeError(f"a kernel never launched in the tensor_parallel phase: {counts}")
    perf["phase_s"] = time.perf_counter() - t_phase
    log(f"tensor_parallel phase: {perf['phase_s']:.1f}s; launches {counts}")
    return dict(counts=counts, perf=perf, checks=checks)


DRIFTS = []  # (process age s, the card's clock offset s) at each reading
# the least process age of the aged trace: a run on a fast card waits for it
AGED_TRACE_AGE_S = 800


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def read_drift(after: str) -> None:
    """The offset of the card's timestamps from the host clock as the
    profiler maps them (`read_device_clock`: a marker kernel against its
    launch, in a `profile_trace` session), logged with the process's age."""
    t0 = time.perf_counter()
    offset = read_device_clock()
    age = process_age_s()
    DRIFTS.append((round(age, 1), offset))
    log(f"clock offset after {after}: "
        f"{'none kept' if offset is None else f'{offset * 1e3:.4f}ms'} (a kernel against its "
        f"launch) at {age:.1f}s of process age, read in {time.perf_counter() - t0:.2f}s")


def _traced_block(x) -> float:
    """4 bf16 products of 8192 x 8192 (cuBLAS) and 4 elementwise passes
    over x; the host's ms."""
    t0 = time.perf_counter()
    for _ in range(4):
        x @ x
    for _ in range(4):
        x.mul_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def aged_trace_phase() -> dict:
    """`profile_trace` of a block of a few milliseconds (`_traced_block`)
    in this aged process: every kernel the block launched must be in the
    trace.  The same block under a bare `torch.profiler` session
    first, for comparison (not a check)."""
    from torch.profiler import ProfilerActivity, profile

    from localdiffusion_tpu_torch.utils.logging import lost_kernels

    t_phase = time.perf_counter()
    wait = AGED_TRACE_AGE_S - process_age_s()
    if wait > 0:
        log(f"aged trace: waiting {wait:.1f}s for {AGED_TRACE_AGE_S}s of process age")
        time.sleep(wait)
    x = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    _traced_block(x)
    out = PARALLEL_DIR / "aged_trace"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bare:
        _traced_block(x)
    bare.export_chrome_trace(str(out / "bare.json"))
    bare_lost = lost_kernels(json.loads((out / "bare.json").read_text())["traceEvents"])
    age = process_age_s()
    with profile_trace(str(out)) as prof:
        block_ms = _traced_block(x)
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    gaps = launch_gaps_us(events)
    checks = dict(age_s=age, block_ms=block_ms, launched=prof.launched_kernels,
                  lost=prof.lost_kernels, session_s=prof.session_s,
                  offset_ms=float(np.median(gaps)) / 1e3 if gaps else None,
                  bare_lost_of_launched=bare_lost, offsets=DRIFTS)
    log(f"aged trace: at {age:.1f}s of process age, profile_trace ({prof.session_s:.2f}s "
        f"session) of a {block_ms:.2f}ms block (4 bf16 8192^3 products, 4 elementwise passes) "
        f"lost "
        f"{prof.lost_kernels} of the {prof.launched_kernels} kernels it launched, their offset "
        f"from their launches {checks['offset_ms']}ms; a bare torch.profiler session of the "
        f"same block just before lost {bare_lost[0]} of {bare_lost[1]}; (age s, offset s) at "
        f"each reading {DRIFTS}")
    if not prof.launched_kernels or prof.lost_kernels:
        raise RuntimeError(f"profile_trace lost {prof.lost_kernels} of "
                           f"{prof.launched_kernels} kernels of its block at {age:.1f}s of age")
    return dict(counts={k: 0 for k in COUNTERS}, perf=dict(phase_s=time.perf_counter() - t_phase),
                checks=checks)


def compiled_phase() -> dict:
    """Stage B as compiled programs: each configuration's compiled chain
    (`translate` on the card replays the step bodies' CUDA graphs) was
    held against its eager twin in its phase (`compiled_twin`): the
    flagship (f32, branched DDPM T=50, batch 64), the 256px chain (bf16,
    branched T=250, batch 4; its T=50 cut profiled compiled and eager),
    the stem (f32, plain DDIM-50), the seg configuration (bf16, branched
    DDIM-50) and the gated 256px chain.  Here every one must be there,
    bit for bit; their walls, busy shares, capture seconds, graphs, nodes
    and peak memory are printed together."""
    missing = [k for k in COMPILED_LABELS if k not in COMPILED]
    if missing:
        raise RuntimeError(f"compiled: no compiled check of {missing}")
    for label in COMPILED_LABELS:
        r = COMPILED[label]
        progs = r["programs"]
        log(f"compiled summary {label}: compiled {r['compiled_s'] * 1e3:.1f}ms, eager "
            f"{r['eager_s'] * 1e3:.1f}ms, x{r['eager_s'] / r['compiled_s']:.3f}; "
            + (f"busy share compiled {r['busy_share']:.4f}, eager {r['eager_busy_share']:.4f} "
               f"(T={r['profiled_steps']} profiled); " if "busy_share" in r else "")
            + f"{sum(v['graphs'] for v in progs.values())} graphs in {len(progs)} programs, "
            f"capture {sum(v['capture_s'] for v in progs.values()):.3f}s, instantiate "
            f"{sum(v['instantiate_s'] for v in progs.values()):.3f}s; peak reserved compiled "
            f"{r['memory']['compiled']['peak_reserved'] / 2**30:.3f} GiB, eager "
            f"{r['memory']['eager']['peak_reserved'] / 2**30:.3f} GiB")
    return dict(counts={k: 0 for k in COUNTERS}, perf=COMPILED,
                checks={k: dict(bit_equal=v["bit_equal"], launches_equal=v["launches_equal"])
                        for k, v in COMPILED.items()})


def _row(t: dict, warm: bool = False) -> dict:
    """A GN part's numbers under the kernels line's keys (and the replayed
    time of a tiled pass, `warm_ms`)."""
    return dict(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], max_abs_err=t["max_abs_err"],
                **({"warm_ms": t["warm_ms"]} if warm else {}))


def main() -> None:
    tally_unet_passes()
    phase_device()
    phase_build()
    with tf32_on_at_entry("flagship"):
        flag = flagship()
    mri = mri256()
    stage_a = stage_a256()
    gated = gated256(stage_a.pop("gd"), stage_a.pop("bank_path"))
    seg_wrn = seg_wrn256()
    with tf32_on_at_entry("stem"):
        stem = stem256()
    with tf32_on_at_entry("shipped"):
        shipped = shipped256()
    training = training256()
    read_drift("training")
    with tf32_on_at_entry("datasets"):
        datasets = datasets_phase()
    self_cond = self_cond_phase()
    serve = serve_phase()
    with tf32_on_at_entry("sampler_api"):
        sampler_api = sampler_api_phase()
    with tf32_on_at_entry("mnist_trained"):
        mnist = mnist_trained_phase()
    with tf32_on_at_entry("aux"):
        aux = aux_phase(mnist.pop("pred_all"), mnist.pop("data"))
    with tf32_on_at_entry("patch"):
        patch = patch_phase()
    distributed = distributed_phase()
    stream = stream_phase()
    reference = reference_ckpt_phase()
    features = features_phase()
    native_res = native_phase()
    mesh_serve = mesh_serve_phase()
    with tf32_on_at_entry("linatt_attrib"):
        attrib = linatt_attrib_phase()
    tensor_par = tensor_parallel_phase()
    compiled = compiled_phase()
    aged = aged_trace_phase()

    phases = {"flagship": flag, "256px": mri, "stage_a": stage_a, "gated": gated,
              "seg_wrn": seg_wrn, "stem": stem, "shipped": shipped, "training": training,
              "datasets": datasets, "self_cond": self_cond, "serve": serve,
              "sampler_api": sampler_api, "mnist_trained": mnist, "aux": aux, "patch": patch,
              "distributed": distributed, "stream": stream, "reference_ckpt": reference,
              "features": features, "native": native_res, "mesh_serve": mesh_serve,
              "linatt_attrib": attrib, "tensor_parallel": tensor_par, "compiled": compiled,
              "aged_trace": aged}
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
    for k in kernels:
        k.update(train_launches=launches[k["name"]]["training"], backward=BACKWARD[k["name"]])
    if any(k["launches"] < 1 or k["train_launches"] < 1 for k in kernels):
        raise RuntimeError(f"a kernel never launched on the main paths: {launches}")
    for name, t in attrib["kernels"].items():
        source, replaces = ATTRIB_SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=t["launches"], max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            per="one launch at [8, 65536, 32] bf16 (the 256px stage-0 site), launches from "
                "scripts.bench_linatt_attrib's run; library: Tensor.copy_ for the copy, none "
                "computes the kv or q pass",
            floors=t["floors"], **{k: v for k, v in t.items() if k.startswith("T")}))
    if any(t["launches"] < 1 for t in attrib["kernels"].values()):
        raise RuntimeError(f"an attribution kernel never launched: {attrib['kernels']}")
    log("end to end: " + "; ".join(f"{label} {json.dumps(ph['perf'])}"
                                   for label, ph in phases.items())
        + "; busy share " + " ".join(f"{label} {ph['busy_share']:.4f}"
                                     for label, ph in phases.items() if "busy_share" in ph)
        + f"; stem checks {json.dumps(stem['checks'])}; Stage A checks "
        + json.dumps(stage_a["checks"]) + f"; gated checks {json.dumps(gated['checks'])}"
        + f"; seg/WRN checks {json.dumps(seg_wrn['checks'])}"
        + f"; shipped checks {json.dumps(shipped['checks'])}"
        + f"; training checks {json.dumps(training['checks'])}"
        + f"; datasets checks {json.dumps(datasets['checks'])}"
        + f"; self_cond checks {json.dumps(self_cond['checks'])}"
        + "".join(f"; {label} checks {json.dumps(phases[label]['checks'])}"
                  for label in ("serve", "sampler_api", "mnist_trained", "aux", "patch",
                                "distributed", "stream", "reference_ckpt", "features",
                                "native", "mesh_serve", "linatt_attrib", "tensor_parallel",
                                "compiled", "aged_trace")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
