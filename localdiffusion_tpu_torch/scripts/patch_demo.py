"""Patch-parallel local diffusion on one large image.

    python -m localdiffusion_tpu_torch.scripts.patch_demo --image-size 256 --patch 64 --overlap 8
        [--params-npz results/mri_synth256_ema.npz | --seeded-weights] [--device cuda|cpu]

The port of `scripts/patch_demo.py`: a synthetic tumour brain at
`--image-size` (seed 3, the mask seg > 0) is tiled into overlapping patches,
every patch runs the branched chain of `mri64_config()` (DDIM-50 of T=250,
float32) as one [B·P] batch, and the patches are stitched with a feather
over the overlap (`parallel.patch`).  It prints the patch count, the first
call's and the steady state's seconds and the MSE against the ground
truth.  The weights are the trained 256px denoiser's
(`results/mri_synth256_ema.npz`, whose UNet `mri64_config()` shares);
`--seeded-weights` runs the configuration's seeded random weights instead,
never as a silent fallback.  On the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from localdiffusion_tpu_torch.config import mri64_config
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd, resolve_device
from localdiffusion_tpu_torch.factory import load_params
from localdiffusion_tpu_torch.parallel.patch import patch_parallel_sample, plan_patches

MIN_MAX_VAL = (0.0, 12.0)
PARAMS_NPZ = "results/mri_synth256_ema.npz"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--overlap", type=int, default=8)
    ap.add_argument("--params-npz", default=PARAMS_NPZ,
                    help="the denoiser's weights (a slim npz snapshot)")
    ap.add_argument("--seeded-weights", action="store_true",
                    help="run the configuration's seeded random weights instead")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, noise=(0, 1)) -> dict:
    """Returns the images and numbers it prints; `noise` gives the two
    calls' noise (seeds, or the samplers' noise sources)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = mri64_config()
    if args.seeded_weights:
        gd = build_gd(cfg, device=device)
        print("seeded random weights")
    else:
        gd = load_params(cfg, params_npz=args.params_npz, device=device)

    d = cfg.data
    hr, lr, seg = synthetic_brain_translation(
        1, args.image_size, tumor=True, seed=3, mean_t1=d.mean_t1, std_t1=d.std_t1,
        mean_flair=d.mean_flair, std_flair=d.std_flair)
    mask = (seg > 0).astype(np.float32)
    grid = plan_patches(args.image_size, args.image_size, args.patch, args.overlap)
    print(f"{grid.num_patches} patches of {args.patch}px (overlap {args.overlap})")

    def call(n):
        out = patch_parallel_sample(gd, lr, mask, cfg.sampler, MIN_MAX_VAL, patch=args.patch,
                                    overlap=args.overlap, noise=n)
        _sync(device)
        return out

    t0 = time.perf_counter()
    first = call(noise[0])
    first_s = time.perf_counter() - t0
    print(f"first call: {first_s:.2f}s")
    t0 = time.perf_counter()
    out = call(noise[1])
    steady_s = time.perf_counter() - t0
    print(f"steady-state: {steady_s:.3f}s for one {args.image_size}px image "
          f"({grid.num_patches} patch chains)")
    mse = float(np.mean((out.cpu().numpy() - hr) ** 2))
    print(f"mse vs gt: {mse:.4f}")
    return dict(first=first, out=out, hr=hr, lr=lr, mask=mask, num_patches=grid.num_patches,
                first_s=first_s, steady_s=steady_s, mse=mse, gd=gd)


if __name__ == "__main__":
    main()
