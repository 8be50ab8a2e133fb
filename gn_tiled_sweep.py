#!/usr/bin/env python3
"""Time the tiled GroupNorm pair's plan choices on one NVIDIA GPU.

    python3 gn_tiled_sweep.py

At each tiled site of the main paths (256px bf16 [8,32,32,256]; s2d stem
f32 [8,128,128,32] and [8,64,64,64]; with and without FiLM), the stats
pass at clusters of 8 and 16 blocks a row and the apply pass at tiles of
16, 32 and 64 KiB of x, each checked against the plan's output (sums
within `GN_PARTIALS_TOL` per row, the apply bit for bit) and timed as
`chip_smoke.py` times the tiled passes, in µs a launch: with L2 flushed
before each call (`us`, `chip_smoke.cold_ms`) and with x left in L2 by
the call before (`warm_us`, a CUDA-graph replay).  Prints the card's name
and power limit, then one JSON object.  `gn_tiled_plan`
(`localdiffusion_tpu_torch/ops/groupnorm.py`) takes its k and its tile
from this measurement; run it again after a change to either kernel.
"""

import json
import subprocess

import torch

import chip_smoke as cs
from localdiffusion_tpu_torch.ops import groupnorm as G

SITES = [((8, 32, 32, 256), torch.bfloat16), ((8, 128, 128, 32), torch.float32),
         ((8, 64, 64, 64), torch.float32)]
KS = (8, 16)
TILE_BYTES = (16 * 1024, 32 * 1024, 64 * 1024)


def times(fn) -> dict:
    return dict(us=1e3 * cs.cold_ms(fn), warm_us=1e3 * cs.cuda_ms(fn, 20, 10)[1])


def site(shape, dtype, film) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, g, bt, s, h = cs._gn_inputs(shape, film, dtype, gen)
    _, hh, ww, c = shape
    hw, pixel_bytes = hh * ww, c * x.element_size()
    sums = G.gn_tiled_stats(x)
    want = G.gn_tiled_apply(x, sums, g, bt, s, h, groups=8)
    out = dict(shape=list(shape), dtype=str(dtype)[6:], film=film,
               plan=G.gn_tiled_plan(hh, ww, c, dtype), stats={}, apply={})
    for k in KS:
        kp = dict(k=min(k, hw), pixels=-(-hw // min(k, hw)))
        got = G._launch_stats(x, kp)
        torch.cuda.synchronize()
        rel = ((got - sums).flatten(1).norm(dim=1) / sums.flatten(1).norm(dim=1)).max().item()
        if rel > cs.GN_PARTIALS_TOL:
            raise RuntimeError(f"stats pass at k={k} disagrees at {shape}: {rel:.3g}")
        out["stats"][k] = times(lambda: G._launch_stats(x, kp))
    for nbytes in TILE_BYTES:
        tp = dict(apply_pixels=max(1, min(hw, nbytes // pixel_bytes)))
        got = G._launch_apply(x, sums, g, bt, s, h, 8, 1e-5, tp)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"apply pass at {nbytes} B tiles differs at {shape}")
        out["apply"][nbytes // 1024] = times(
            lambda: G._launch_apply(x, sums, g, bt, s, h, 8, 1e-5, tp))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_tiled_sweep needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    rows = [site(shape, dtype, film) for shape, dtype in SITES for film in (False, True)]
    print(json.dumps({"sites": rows}), flush=True)


if __name__ == "__main__":
    main()
