"""Sparse-mask bucketing on the card: bucketed against unbucketed patch
sampling of 256px images in 128px patches with a small OOD region.

    python -m localdiffusion_tpu_torch.scripts.bench_sparse [--size 256]
        [--patch 128] [--timesteps 50] [--repeats 3] [--batch 8]
        [--out-dir results_torch]

The port of `scripts/bench_sparse.py`.  Each image of the batch is tiled
into (size / patch)² patches; its OOD region (48×48 px at rows and columns
8-56) lies in the top-left patch.  Unbucketed
(`parallel.patch.patch_parallel_sample`), every patch runs the branched
chain, two UNet rows a step; bucketed (`patch_parallel_sample_bucketed`),
the OOD-free patches run the plain chain, one row a step, and the OOD
patch the branched one.  The model is the JAX script's (dim 32, mults
1/2/4/8, full attention in the last stage, the deep condition encoder,
pred_x0, T = `--timesteps`, fused at t = 2) in bf16 with seeded random
weights (torch seed 0), in the standard layout.  Seconds are host-clock
walls over `--repeats` runs after one warm run, each ended by a
synchronize.  The JAX script's bar, bucketed ≥ 1.5x faster, is reported
(`meets_jax_bar`), not judged: the port runs its buckets as two chains in
turn from Python, and the host bounds them.  The result goes to
`<out-dir>/bench_sparse.json` with the card's name and power limit.  The
card is required.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from localdiffusion_tpu_torch.config import DiffusionConfig, ModelConfig, SamplerConfig
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.parallel.patch import (
    patch_parallel_sample,
    patch_parallel_sample_bucketed,
)
from localdiffusion_tpu_torch.scripts import _measure as M

MIN_MAX_VAL = (0.0, 2.0)
JAX_BAR = 1.5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--patch", type=int, default=128)
    ap.add_argument("--timesteps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    return ap.parse_args(argv)


def engine(size: int, timesteps: int, device, dtype=torch.bfloat16) -> GaussianDiffusion:
    """The JAX script's model at patch size `size`, seeded weights."""
    torch.manual_seed(0)
    mcfg = ModelConfig(dim=32, init_dim=32, dim_mults=(1, 2, 4, 8),
                       full_attn=(False, False, False, True), channels=1,
                       cond_encoder_depth="deep")
    return GaussianDiffusion(mcfg, DiffusionConfig(image_size=size, timesteps=timesteps,
                                                   objective="pred_x0"),
                             device=device, dtype=dtype)


def inputs(batch: int, size: int) -> tuple:
    """(cond, mask) as numpy: cond uniform in [0, 2) (seed 0), the OOD
    region rows and columns 8-56 of each image."""
    rng = np.random.default_rng(0)
    cond = rng.uniform(0, 2, (batch, size, size, 1)).astype(np.float32)
    mask = np.zeros((batch, size, size, 1), np.float32)
    mask[:, 8:56, 8:56] = 1.0
    return cond, mask


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, repeats: int, device) -> tuple:
    """(seconds a run, the warm run's output)."""
    out = fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / repeats, out


def record(args, dt_u, dt_b, out_u, out_b, card) -> dict:
    speed = dt_u / dt_b
    return {"script": "bench_sparse", "card": card, "metric": "sparse_bucketing_speedup",
            "value": speed, "unit": "x", "unbucketed_s": dt_u, "bucketed_s": dt_b,
            "patches": (args.size // args.patch) ** 2 * args.batch, "ood_patches": args.batch,
            "out_mean_abs_diff": float(np.mean(np.abs(out_u - out_b))),
            "size": args.size, "patch": args.patch, "timesteps": args.timesteps,
            "batch": args.batch, "dtype": "bfloat16", "jax_bar": JAX_BAR,
            "meets_jax_bar": bool(speed >= JAX_BAR),
            "timing": "host-clock seconds a run, ended by torch.cuda.synchronize"}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    device = torch.device("cuda")
    gd = engine(args.patch, args.timesteps, device)
    cond, mask = inputs(args.batch, args.size)
    scfg = SamplerConfig(start_timestep=2)
    dt_u, out_u = timed(lambda: patch_parallel_sample(
        gd, cond, mask, scfg, MIN_MAX_VAL, patch=args.patch, overlap=0, noise=10),
        args.repeats, device)
    dt_b, out_b = timed(lambda: patch_parallel_sample_bucketed(
        gd, cond, mask, scfg, MIN_MAX_VAL, patch=args.patch, overlap=0, noise=10,
        branched_noise=11), args.repeats, device)
    rec = record(args, dt_u, dt_b, out_u.float().cpu().numpy(), out_b.float().cpu().numpy(),
                 card)
    print({k: v for k, v in rec.items() if k != "card"}, flush=True)
    M.write_json("bench_sparse", rec, args.out_dir)
    return rec


if __name__ == "__main__":
    main()
