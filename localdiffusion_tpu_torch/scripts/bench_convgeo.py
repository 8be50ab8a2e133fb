"""3×3 conv efficiency by channel and spatial geometry on the card, in
cuDNN and in the port's hand-written `conv3x3_stats`.

    python -m localdiffusion_tpu_torch.scripts.bench_convgeo [--iters 10]
        [--reps 5] [--out-dir results_torch]

The port of `scripts/bench_convgeo.py`, at its six geometries (batch,
side, C → C, bf16, NHWC):

  c32_256    3×3  32→ 32 @256²   the 256px chain's stage 0
  c64_128    3×3  64→ 64 @128²   stage 1
  c128_128   3×3 128→128 @128²   the s2d-stem's stage 0
  c256_64    3×3 256→256 @ 64²   an s2d stage-1 candidate
  c512_64    3×3 512→512 @ 64²   its up-path concat width
  flag28     3×3  32→ 32 @ 28²   the flagship's hot shape (batch 128)

Each in cuDNN (`F.conv2d` on channels_last, bf16) and, where the fused
ResnetBlock's gate admits the output width (`ops.resnet_block.DIM_OUTS`:
32, 64, 128), in `conv3x3_stats` (pass 1: the conv, its bias and the
per-tile sums the GroupNorm needs; the sums are extra output cuDNN does
not write).  Each time is device milliseconds of one call, by CUDA events
over CUDA-graph replays (`_measure.graph_ms`), with its TFLOP/s and share
of the bf16 tensor peak (989 TFLOP/s, the data sheet's).  The JAX script's
s2d decision ratio, (4 / rate(c256_64)) / (1 / rate(c64_128)), is
reported for cuDNN.  The result goes to `<out-dir>/bench_convgeo.json`
with the card's name and power limit.  The card is required.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.scripts import _measure as M

CASES = {
    "c32_256": (8, 256, 32),
    "c64_128": (8, 128, 64),
    "c128_128": (8, 128, 128),
    "c256_64": (8, 64, 256),
    "c512_64": (8, 64, 512),
    "flag28": (128, 28, 32),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10, help="calls captured in a graph")
    ap.add_argument("--reps", type=int, default=5, help="replays of the graph")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    return ap.parse_args(argv)


def flops(b: int, hw: int, c: int) -> float:
    return 2.0 * b * hw * hw * c * c * 9


def operands(b: int, hw: int, c: int, device="cuda") -> tuple:
    """(x NHWC bf16, w OIHW bf16 channels_last, bias f32), numpy seed 0."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((b, hw, hw, c)), dtype=torch.bfloat16,
                        device=device)
    w = torch.as_tensor(rng.standard_normal((c, c, 3, 3)) * 0.02, dtype=torch.bfloat16,
                        device=device).contiguous(memory_format=torch.channels_last)
    bias = torch.zeros(c, device=device)
    return x, w, bias


def kernel_admits(c: int) -> bool:
    return c in RB.DIM_OUTS


def measure(args) -> dict:
    out = {}
    for name, (b, hw, c) in CASES.items():
        x, w, bias = operands(b, hw, c)
        nchw = x.permute(0, 3, 1, 2)
        f = flops(b, hw, c)
        ms = M.graph_ms(lambda: F.conv2d(nchw, w, bias.to(torch.bfloat16), padding=1),
                        args.iters, args.reps)
        row = {"batch": b, "hw": hw, "c": c, "cudnn_ms": ms,
               "cudnn_tflops": f / ms / 1e9, "cudnn_peak_share": f / ms / 1e-3 / M.BF16_OPS_PER_S}
        if kernel_admits(c):
            wp = RB.pack_conv3x3(w)
            kms = M.graph_ms(lambda: RB.conv3x3_stats(x, wp, bias), args.iters, args.reps)
            row.update(kernel_ms=kms, kernel_tflops=f / kms / 1e9,
                       kernel_peak_share=f / kms / 1e-3 / M.BF16_OPS_PER_S)
        else:
            row["kernel"] = f"not admitted (Cout {c} not in DIM_OUTS {RB.DIM_OUTS})"
        out[name] = row
        print(name, row, flush=True)
    return out


def record(args, cases, card) -> dict:
    rec = {"script": "bench_convgeo", "card": card, "metric": "conv_geometry_microbench",
           "dtype": "bfloat16", "timing": f"device ms of one call: CUDA events over "
           f"{args.reps} replays of a CUDA graph of {args.iters} calls", "cases": cases}
    if "c64_128" in cases and "c256_64" in cases:
        rec["s2d_stage1_conv_cost_ratio"] = ((4 / cases["c256_64"]["cudnn_tflops"])
                                             / (1 / cases["c64_128"]["cudnn_tflops"]))
    return rec


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    rec = record(args, measure(args), card)
    M.write_json("bench_convgeo", rec, args.out_dir)
    return rec


if __name__ == "__main__":
    main()
