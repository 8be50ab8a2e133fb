"""The achievable bytes/s of the bandwidth-class operations at the 256px
stage-0 shape on the card.

    python -m localdiffusion_tpu_torch.scripts.bench_roofline [--batch 8]
        [--hw 256] [--c 32] [--iters 20] [--reps 5] [--out-dir results_torch]

The port of `scripts/bench_roofline.py`.  The JAX script measures what the
TPU sustains op by op at the exact-s2d stage-0 geometry, [8, 128, 128, 128]
bf16; the port measures the same bytes in the standard layout, [8, 256,
256, 32] bf16 (NHWC; 33.5 MB), the 256px chain's stage 0 at its [2B]
branched batch.  Rows, each with the bytes it must move (each input read
once, each output written once) and the rate that gives:

  * copy (`Tensor.copy_`, r + w) and an elementwise scale (r + w);
  * two-operand elementwise, (x + y)·s − y·s (2r + w);
  * `F.group_norm` (8 groups) on the NCHW view of the channels_last
    tensor, the library's whole operation (r + w);
  * the tiled GroupNorm pair of the port (`ops.groupnorm`, this shape's
    route past the row gate): its stats pass alone (r), its apply pass with
    FiLM alone (r + w), and both (2r + w);
  * the compute points: a 3×3 conv 32→32 (cuDNN, channels_last) and a
    4096² bf16 matmul (cuBLAS), with their TFLOP/s.

Each time is device milliseconds of one call, by CUDA events over
CUDA-graph replays (`_measure.graph_ms`); x stays in the 50 MB L2 between
calls where it fits (the rows say so beside the device-memory rate the
card's data sheet gives, 3.35 TB/s).  The result goes to
`<out-dir>/bench_roofline.json` with the card's name and power limit.  The
card is required.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.scripts import _measure as M

GROUPS = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=256)
    ap.add_argument("--c", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20, help="calls captured in a graph")
    ap.add_argument("--reps", type=int, default=5, help="replays of the graph")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    return ap.parse_args(argv)


def cases(b: int, hw: int, c: int, device="cuda") -> list:
    """(name, fn, bytes, flops) of each row."""
    rng = np.random.default_rng(0)
    shape = (b, hw, hw, c)
    nbytes = b * hw * hw * c * 2
    x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=device)
    y = torch.as_tensor(rng.standard_normal(shape), dtype=torch.bfloat16, device=device)
    out = torch.empty_like(x)
    s = 1.0000305
    gamma = torch.ones(c, device=device)
    beta = torch.zeros(c, device=device)
    sc = torch.zeros(b, c, device=device)
    sh = torch.zeros(b, c, device=device)
    sums = G.gn_tiled_stats(x)
    nchw = x.permute(0, 3, 1, 2)  # channels_last view
    w = torch.as_tensor(rng.standard_normal((c, c, 3, 3)) * 0.01, dtype=torch.bfloat16,
                        device=device).contiguous(memory_format=torch.channels_last)
    m = 4096
    a0 = torch.as_tensor(rng.standard_normal((m, m)) * 0.01, dtype=torch.bfloat16,
                         device=device)
    return [
        ("copy (r+w)", lambda: out.copy_(x), 2 * nbytes, 0.0),
        ("elementwise_scale (r+w)", lambda: x * s, 2 * nbytes, 0.0),
        ("add_two_tensors (2r+w)", lambda: (x + y) * s - y * s, 3 * nbytes, 0.0),
        ("F.group_norm (r+w)", lambda: F.group_norm(nchw, GROUPS), 2 * nbytes, 0.0),
        ("gn_tiled_stats (r)", lambda: G.gn_tiled_stats(x), nbytes, 0.0),
        ("gn_tiled_apply_film_silu (r+w)",
         lambda: G.gn_tiled_apply(x, sums, gamma, beta, sc, sh, GROUPS), 2 * nbytes, 0.0),
        ("gn_tiled_pair (2r+w)",
         lambda: G.groupnorm_film_silu(x, gamma, beta, sc, sh, GROUPS), 3 * nbytes, 0.0),
        ("conv3x3 cudnn (r+w)", lambda: F.conv2d(nchw, w, padding=1), 2 * nbytes,
         2.0 * b * hw * hw * 9 * c * c),
        ("matmul_4096 cublas (peak ref)", lambda: a0 @ a0, 3 * m * m * 2, 2.0 * m ** 3),
    ]


def measure(args) -> list:
    rows = []
    for name, fn, nbytes, flops in cases(args.batch, args.hw, args.c):
        ms = M.graph_ms(fn, args.iters, args.reps)
        r = {"op": name, "ms": ms, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
             "hbm_share": nbytes / ms / 1e-3 / M.HBM_BYTES_PER_S}
        if flops:
            r["tflop_per_s"] = flops / ms / 1e9
        rows.append(r)
        print(r, flush=True)
    return rows


def record(args, rows, card) -> dict:
    return {"script": "bench_roofline", "card": card,
            "shape": [args.batch, args.hw, args.hw, args.c], "dtype": "bfloat16",
            "hbm_bytes_per_s": M.HBM_BYTES_PER_S,
            "timing": f"device ms of one call: CUDA events over {args.reps} replays of a CUDA "
                      f"graph of {args.iters} calls (x left in L2 by the call before where it "
                      "fits)",
            "rows": rows}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    rec = record(args, measure(args), card)
    M.write_json("bench_roofline", rec, args.out_dir)
    return rec


if __name__ == "__main__":
    main()
