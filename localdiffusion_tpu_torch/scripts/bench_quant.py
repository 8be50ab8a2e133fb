"""int8 against bf16 products on the card at the 256px pipeline's shapes:
a measurement of the library, not a kernel of the port.

    python -m localdiffusion_tpu_torch.scripts.bench_quant [--iters 10]
        [--reps 5] [--out-dir results_torch]

The port of `scripts/bench_quant.py`: the raw rate of quantized products,
whatever the model's quality under quantization (which needs a
calibration study).  Rows:

  * a [8192, 2048] × [2048, 2048] matmul in bf16 (cuBLAS) and in int8
    (`torch._int_mm`, int32 sums), with the int8 speedup;
  * the 3×3 conv of stage 0, 32 → 32 at 256² batch 8, in bf16 (cuDNN),
    and in int8 as its implicit GEMM: the 9 taps' [B·H·W, 9·32] im2col
    matrix times [9·32, 32] through `torch._int_mm` (PyTorch has no int8
    convolution on the card), with and without the im2col's own time;
  * the s2d-stem's conv, 128 → 128 at 128², in bf16.

Each time is device milliseconds of one call, by CUDA events over
CUDA-graph replays (`_measure.graph_ms`), with its rate and share of the
data sheet's dense peaks (989 TFLOP/s bf16, 1,979 TOP/s int8).  The result
goes to `<out-dir>/bench_quant.json` with the card's name and power limit.
The card is required.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.scripts import _measure as M


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10, help="calls captured in a graph")
    ap.add_argument("--reps", type=int, default=5, help="replays of the graph")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    return ap.parse_args(argv)


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """NHWC x [B, H, W, C] → [B·H·W, 9·C], the taps (ky, kx) in order
    around each pixel, zero padded."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]
    return torch.cat(taps, dim=-1).reshape(b * h * w, 9 * c)


def measure(args, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    g = lambda fn: M.graph_ms(fn, args.iters, args.reps)  # noqa: E731
    res = {}
    m, k, n = 8192, 2048, 2048
    a_f = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.bfloat16, device=device)
    b_f = torch.as_tensor(rng.standard_normal((k, n)), dtype=torch.bfloat16, device=device)
    a_i = torch.as_tensor(rng.integers(-127, 127, (m, k)), dtype=torch.int8, device=device)
    b_i = torch.as_tensor(rng.integers(-127, 127, (k, n)), dtype=torch.int8, device=device)
    fl = 2.0 * m * k * n
    bf, i8 = g(lambda: a_f @ b_f), g(lambda: torch._int_mm(a_i, b_i))
    res.update(matmul_bf16_ms=bf, matmul_int8_ms=i8, matmul_bf16_tflops=fl / bf / 1e9,
               matmul_int8_tops=fl / i8 / 1e9, matmul_int8_speedup=bf / i8)

    b, hw, c = 8, 256, 32
    x = torch.as_tensor(rng.standard_normal((b, hw, hw, c)), dtype=torch.bfloat16,
                        device=device)
    wk = torch.as_tensor(rng.standard_normal((c, c, 3, 3)) * 0.05, dtype=torch.bfloat16,
                         device=device).contiguous(memory_format=torch.channels_last)
    xi = torch.as_tensor(rng.integers(-127, 127, (b, hw, hw, c)), dtype=torch.int8,
                         device=device)
    wi = torch.as_tensor(rng.integers(-127, 127, (9 * c, c)), dtype=torch.int8, device=device)
    cols = im2col3x3(xi)
    cfl = 2.0 * b * hw * hw * c * c * 9
    nchw = x.permute(0, 3, 1, 2)
    cbf = g(lambda: F.conv2d(nchw, wk, padding=1))
    ci8 = g(lambda: torch._int_mm(cols, wi))
    ci8_all = g(lambda: torch._int_mm(im2col3x3(xi), wi))
    res.update(conv32_bf16_ms=cbf, conv32_bf16_tflops=cfl / cbf / 1e9,
               conv32_int8_gemm_ms=ci8, conv32_int8_tops=cfl / ci8 / 1e9,
               conv32_int8_with_im2col_ms=ci8_all, conv32_int8_speedup=cbf / ci8,
               conv32_int8_speedup_with_im2col=cbf / ci8_all)

    x128 = torch.as_tensor(rng.standard_normal((8, 128, 128, 128)), dtype=torch.bfloat16,
                           device=device).permute(0, 3, 1, 2)
    k128 = torch.as_tensor(rng.standard_normal((128, 128, 3, 3)) * 0.02,
                           dtype=torch.bfloat16,
                           device=device).contiguous(memory_format=torch.channels_last)
    c128 = g(lambda: F.conv2d(x128, k128, padding=1))
    res.update(conv128_bf16_ms=c128,
               conv128_bf16_tflops=2.0 * 8 * 128 * 128 * 128 * 128 * 9 / c128 / 1e9)
    return res


def record(args, res, card) -> dict:
    return {"script": "bench_quant", "card": card, "metric": "quantization_microbench",
            "timing": f"device ms of one call: CUDA events over {args.reps} replays of a CUDA "
                      f"graph of {args.iters} calls",
            "peaks": {"bf16_tflops": M.BF16_OPS_PER_S / 1e12,
                      "int8_tops": M.INT8_OPS_PER_S / 1e12}, **res}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    rec = record(args, measure(args), card)
    print({k: v for k, v in rec.items() if k != "card"}, flush=True)
    M.write_json("bench_quant", rec, args.out_dir)
    return rec


if __name__ == "__main__":
    main()
