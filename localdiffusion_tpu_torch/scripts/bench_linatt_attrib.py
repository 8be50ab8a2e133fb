"""Linear-attention time attribution on the card: each pass alone, each
with its exponentials made linear, and a bare copy at three grids.

    python -m localdiffusion_tpu_torch.scripts.bench_linatt_attrib [--batch 8]
        [--size 256] [--no-check] [--out-dir results_torch]

The port of `scripts/bench_linatt_attrib.py`.  The JAX script times its
Pallas passes at the 256px stage-0 shape in the s2d layout, [8, 128, 128,
128] bf16 (4 phases of 32 channels); the port runs the same work and bytes
in the standard layout, x [8, 256, 256, 32] bf16 with 4 heads of 32, the
256px chain's stage-0 linear-attention site.  The inputs are the JAX
script's draws (numpy seed 0, in its order), x moved from the phase-major
s2d layout to pixels.  Rows, as the JAX script's:

  * the shipping function (kv, the fold, q) and the same called twice in a
    row (the second on the first's output);
  * an elementwise pass, x·1.0001;
  * a bare copy (`ops.copy_probe`) with 64, 8 and 512 programs, the JAX
    grids' T = 2048, 16384 and 256 tokens of 4 pixels, each program the
    same bytes as there;
  * both passes with every exponential a·0.5 + 1 (`kv_linear_exp`,
    `q_linear_exp`, the kernels' `kLin` instantiation), the kv pass alone
    with and without them, and the q pass alone on a zero W̃ with and
    without them.

Each time is device milliseconds of one call, by CUDA events over
CUDA-graph replays (`_measure.graph_ms`).  Before timing, the variants and
the copy are checked against their plain versions (`compare`): l, the Gram
and the q pass given W̃ each on its own, since after the max subtraction
a ≤ 0, a·0.5 + 1 goes negative and l and the fold can cancel; and in the
q pass a head's sum can cancel too, so its bar holds on every token whose
heads are well conditioned (`q_agreement`).  The result
goes to `<out-dir>/linatt_attrib.json`, with the card's name and power
limit.  The card is required.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from localdiffusion_tpu_torch.ops import copy_probe as CP
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.scripts import _measure as M

NPH, HEADS, DIM_HEAD = 4, 4, 32
JAX_TILES = (2048, 16384, 256)  # the JAX script's copy grids, s2d tokens a program
# the variants against their plain versions, each row on its own: m one bf16
# step (a max of bf16 k whose float32 sum rounded the other way); l and G
# relative L2 over a row, since a max one step apart moves every later
# lin(k − m) of its column by half the step
KV_LIN_TOL = dict(m=2**-7, l=2e-2, g=2e-2)
# q given W̃: the q pass's bar on every well-conditioned token (each head's
# Σ|lin| / |Σ lin| ≤ Q_LIN_COND, `q_linear_conditioning`); where a head's
# sum cancels, a bf16 step of q moves the token's output by its condition,
# so of all tokens at most Q_LIN_OUTSIDE may fall outside the bar
Q_LIN_TOL = dict(atol=0.04, rtol=0.05)
Q_LIN_COND = 2.0
Q_LIN_OUTSIDE = 0.02
ROW_NAMES = (
    "full two-pass (shipping)", "full two-pass called 2x", "elementwise (x*1.0001)",
    "copy T=2048 (64 programs)", "copy T=16384 (8 programs)", "copy T=256 (512 programs)",
    "both passes, exp->linear", "kv pass only", "kv pass only, exp->linear",
    "q pass only (zero wtil)", "q pass only, exp->linear",
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256, help="image side in pixels")
    ap.add_argument("--iters", type=int, default=10, help="calls captured in a graph")
    ap.add_argument("--reps", type=int, default=5, help="replays of the graph")
    ap.add_argument("--no-check", action="store_true", help="skip the plain-version checks")
    ap.add_argument("--out-dir", default=None, help="default results_torch/")
    return ap.parse_args(argv)


def s2d_to_pixels(x: np.ndarray, f: int = 2) -> np.ndarray:
    """[B, H/f, W/f, f²·C] phase-major (channel (a·f + b)·C + c holds
    pixel (f·i + a, f·j + b)) → [B, H, W, C]."""
    b, h, w, fc = x.shape
    c = fc // (f * f)
    return x.reshape(b, h, w, f, f, c).transpose(0, 1, 3, 2, 4, 5).reshape(b, h * f, w * f, c)


def inputs(batch: int = 8, size: int = 256, device="cuda") -> dict:
    """The JAX script's draws (numpy seed 0, its order and shapes) in the
    port's layout: x [B, size, size, 32] bf16 and the site's parameters."""
    rng = np.random.default_rng(0)
    c = 32
    hidden = HEADS * DIM_HEAD
    xs = rng.normal(size=(batch, size // 2, size // 2, NPH * c))
    g_in = rng.normal(size=(c,))
    w_qkv = rng.normal(size=(c, 3 * hidden)) * 0.1
    w_out = rng.normal(size=(hidden, c)) * 0.1
    b_out = rng.normal(size=(c,))
    g_out = rng.normal(size=(c,))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    x = torch.as_tensor(s2d_to_pixels(xs), dtype=torch.float32).to(torch.bfloat16)
    return dict(x=x.to(device).contiguous(), g_in=f32(g_in), w_qkv=f32(w_qkv),
                w_out=f32(w_out), b_out=f32(b_out), g_out=f32(g_out))


def operands(inp: dict) -> dict:
    """The passes' operands: rows xr [B, N, C], Wq, Wk, Wv, blocks a row,
    the shipping W̃ and a zero W̃."""
    x = inp["x"]
    b, h, w, c = x.shape
    xr = x.reshape(b, h * w, c)
    wq, wk, wv = LA.split_qkv(inp["w_qkv"])
    nb = LA.blocks_per_row(h * w)
    _, l, gram = LA.linear_attention_kv(xr, inp["g_in"], wk, nb)
    return dict(xr=xr, wq=wq, wk=wk, wv=wv, nb=nb, wtil=LA.fold(l, gram, wv, inp["w_out"]),
                zero=torch.zeros((b, LA.HIDDEN, c), dtype=torch.bfloat16, device=x.device))


def copy_tiles_of(jax_tile: int, n: int) -> int:
    """Pixels a copy program takes: a JAX tile of s2d tokens, 4 pixels each
    (at most the row's n, at a smaller size than the script's)."""
    return min(jax_tile * NPH, n)


def row_errors(got, want) -> dict:
    """The kv variant's (m, l, G) against the plain version's, row by row:
    m relative, l relative L2 over a row's 128 columns, G relative
    Frobenius over a row's C×128."""
    (m, l, g), (pm, pl, pg) = got, want
    return dict(m=((m - pm).abs() / pm.abs().clamp_min(1e-6)).max().item(),
                l=((l - pl).norm(dim=1) / pl.norm(dim=1)).max().item(),
                g=((g - pg).norm(dim=(1, 2)) / pg.norm(dim=(1, 2))).max().item())


def q_agreement(got, want, cond) -> dict:
    """The q variant's output [B, N, C] against its plain version's, token
    by token: the bar on the well-conditioned tokens (cond ≤ Q_LIN_COND),
    and the share of all tokens outside it.  A head whose sum is exactly 0
    gives a non-finite token (counted; its condition is infinite); the
    errors are over the finite tokens."""
    got, want = got.float(), want.float()
    inside = torch.isclose(got, want, **Q_LIN_TOL).all(dim=-1)
    finite = torch.isfinite(got).all(dim=-1) & torch.isfinite(want).all(dim=-1)
    well = cond <= Q_LIN_COND  # a non-finite token here fails the bar
    d = (got - want)[finite]
    outside = (~inside).float().mean().item()
    return dict(max_abs_err=(got - want)[well & finite].abs().max().item()
                if (well & finite).any() else 0.0,
                finite_max_abs_err=d.abs().max().item(),
                rel_l2=(d.norm() / want[finite].norm()).item(),
                well_share=well.float().mean().item(), outside_share=outside,
                nonfinite_tokens=int((~finite).sum().item()),
                ok=bool(inside[well].all()) and outside <= Q_LIN_OUTSIDE)


def compare(inp: dict, ops: dict) -> dict:
    """Each variant and the copy against its plain version on the same
    inputs; raises where one disagrees.  Returns the errors."""
    xr, g_in = ops["xr"], inp["g_in"]
    b_out, g_out = inp["b_out"], inp["g_out"]
    got = LA.kv_linear_exp(xr, g_in, ops["wk"], ops["nb"])
    torch.cuda.synchronize()
    kv = row_errors(got, LA.kv_linear_reference(xr, g_in, ops["wk"], ops["nb"]))
    wtil = LA.fold(got[1], got[2], ops["wv"], inp["w_out"])
    q = LA.q_linear_exp(xr, g_in, ops["wq"], wtil, b_out, g_out)
    torch.cuda.synchronize()
    q_want = LA.q_pass_reference(xr, g_in, ops["wq"], wtil, b_out, g_out, exp=LA.lin_exp)
    q_err = q_agreement(q, q_want, LA.q_linear_conditioning(xr, g_in, ops["wq"]))
    copies = {}
    for t in JAX_TILES:
        out = CP.copy_tiles(xr, copy_tiles_of(t, xr.shape[1]))
        torch.cuda.synchronize()
        copies[str(t)] = bool(torch.equal(out, xr))
    res = dict(kv=kv, kv_tol=KV_LIN_TOL, q=q_err,
               q_tol=dict(Q_LIN_TOL, cond=Q_LIN_COND, outside=Q_LIN_OUTSIDE), copy_exact=copies)
    bad = [k for k, tol in KV_LIN_TOL.items() if not kv[k] <= tol]
    if bad or not q_err["ok"] or not all(copies.values()):
        raise RuntimeError(f"attribution kernels disagree with their plain versions: {res}")
    return res


def row_fns(inp: dict, ops: dict) -> list:
    """(name, fn) for each row of `ROW_NAMES`, in order."""
    x, xr, g_in = inp["x"], ops["xr"], inp["g_in"]
    params = (g_in, inp["w_qkv"], inp["w_out"], inp["b_out"], inp["g_out"])
    b_out, g_out = inp["b_out"], inp["g_out"]
    wq, wk, wv, nb = ops["wq"], ops["wk"], ops["wv"], ops["nb"]

    def full():
        return LA.linear_attention(x, *params)

    def twice():
        return LA.linear_attention(LA.linear_attention(x, *params), *params)

    def both_linear():
        _, l, gram = LA.kv_linear_exp(xr, g_in, wk, nb)
        return LA.q_linear_exp(xr, g_in, wq, LA.fold(l, gram, wv, inp["w_out"]), b_out, g_out)

    fns = [full, twice, lambda: x * 1.0001]
    fns += [lambda t=t: CP.copy_tiles(xr, copy_tiles_of(t, xr.shape[1])) for t in JAX_TILES]
    fns += [both_linear,
            lambda: LA.linear_attention_kv(xr, g_in, wk, nb),
            lambda: LA.kv_linear_exp(xr, g_in, wk, nb),
            lambda: LA.linear_attention_q(xr, g_in, wq, ops["zero"], b_out, g_out),
            lambda: LA.q_linear_exp(xr, g_in, wq, ops["zero"], b_out, g_out)]
    return list(zip(ROW_NAMES, fns))


def derived(ms: dict) -> dict:
    """What the rows say: each pass's share that its exponentials cost
    (1 − linear / exp), and the copy's per-program floor."""
    kv, kv_lin = ms["kv pass only"], ms["kv pass only, exp->linear"]
    q, q_lin = ms["q pass only (zero wtil)"], ms["q pass only, exp->linear"]
    full, both = ms["full two-pass (shipping)"], ms["both passes, exp->linear"]
    return {"kv_exp_share": 1 - kv_lin / kv, "q_exp_share": 1 - q_lin / q,
            "two_pass_exp_share": 1 - both / full,
            "second_call_ms": ms["full two-pass called 2x"] - full,
            "fold_and_gaps_ms": full - kv - q}


def record(args, ms: dict, checks, card: dict) -> dict:
    """The JSON the script writes."""
    return {"script": "bench_linatt_attrib", "card": card,
            "shape": [args.batch, args.size, args.size, 32], "heads": HEADS,
            "dim_head": DIM_HEAD, "dtype": "bfloat16",
            "timing": f"device ms of one call: CUDA events over {args.reps} replays of a "
                      f"CUDA graph of {args.iters} calls",
            "rows": [{"name": n, "ms": ms[n]} for n in ROW_NAMES if n in ms],
            "derived": derived(ms), "checks": checks}


def main(argv=None) -> dict:
    args = parse_args(argv)
    card = M.card_record()
    inp = inputs(args.batch, args.size)
    ops = operands(inp)
    checks = None if args.no_check else compare(inp, ops)
    if checks:
        print(f"checks: {checks}", flush=True)
    ms = {}
    for name, fn in row_fns(inp, ops):
        ms[name] = M.graph_ms(fn, args.iters, args.reps)
        print(f"{name:34s} {ms[name]:8.4f} ms", flush=True)
    rec = record(args, ms, checks, card)
    print(f"derived: {rec['derived']}", flush=True)
    M.write_json("linatt_attrib", rec, args.out_dir)
    return rec


if __name__ == "__main__":
    main()
