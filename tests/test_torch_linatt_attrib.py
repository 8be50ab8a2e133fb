"""The linear-attention attribution on the CPU: the plain versions of the
exp→linear variants (`ops.linear_attention.kv_linear_reference`,
`q_pass_reference(exp=lin_exp)`) against the JAX script's
`_variant_forward(use_exp=False)` (`scripts/bench_linatt_attrib.py`), its
two Pallas kernels run in interpret mode by wrapping `pl.pallas_call` here,
at a small s2d size ([2, 32, 32, 128], 4 phases of 32 channels, the script's
draws) mapped to the standard layout ([2, 64, 64, 32]); and the port
script's layout map, its copy's plain version and its rows.

The JAX kv kernel walks a row in tiles of T s2d tokens (`_row_tile`, set to
64 by its own `LOCALDIFF_LINATT_T`, so the row takes 16 tiles and the
online rescale runs); a tile of T s2d tokens is 4·T consecutive pixels
(2 s2d rows of the 32-wide image), so the port's recurrence runs one block
(nb = 1) of 256-pixel tiles.  l and G are compared each on its own (after
the max subtraction a ≤ 0, so a·0.5 + 1 goes negative and l and G can
cancel), relative L2 over a row within 2e-2: the JAX kernel normalises
with bf16-rounded squares (±0.2% on the norm, `_rms_in`), which moves xn
and k by a bf16 step here and there, and with a linear map a max one step
apart moves every later term of its column.  The q pass is compared given
JAX's own W̃, on the output with the residual added, as the JAX kernel
writes it, through the script's `q_agreement`: the q pass's bar (atol 0.04
/ rtol 0.05) on every token whose heads' sums do not cancel (Σ|lin| /
|Σ lin| ≤ 2), and at most 2% of all tokens outside it (where a head's sum
cancels, the JAX kernel's bf16-rounded squares in its norms move the
token's output by the cancellation's factor).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch.ops import copy_probe as CP
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.scripts import bench_linatt_attrib as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SIZE = 2, 64  # s2d [2, 32, 32, 128]
JAX_T = 64  # s2d tokens a JAX kv tile
REL = 2e-2


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_linatt_attrib", os.path.join(ROOT, "scripts", "bench_linatt_attrib.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """The JAX variant's two pallas_calls in interpret mode: (kv outputs
    (l [B, 1, 128], gram [B, 512, 128]), the q call's W̃ [B, 4, 128, 128],
    its output [B, 32, 32, 128]) and the inputs."""
    from jax.experimental import pallas as pl

    mod = _jax_script()
    calls = []
    orig = pl.pallas_call

    def interpreted(*args, **kw):
        fn = orig(*args, **dict(kw, interpret=True))

        def run(*a):
            out = fn(*a)
            calls.append((a, out))
            return out
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", interpreted)
    mp.setenv("LOCALDIFF_LINATT_T", str(JAX_T))
    try:
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(B, SIZE // 2, SIZE // 2, 128))
        rest = [rng.normal(size=(32,)), rng.normal(size=(32, 384)) * 0.1,
                rng.normal(size=(128, 32)) * 0.1, rng.normal(size=(32,)), rng.normal(size=(32,))]
        x = jnp.asarray(xs, jnp.bfloat16)
        g_in, w_qkv, w_out, b_out, g_out = (jnp.asarray(a, jnp.float32) for a in rest)
        out = mod._variant_forward(x, g_in, w_qkv, w_out, b_out, g_out, use_exp=False)
    finally:
        mp.undo()
    (_, (l, gram)), (q_args, q_out) = calls
    return dict(l=np.asarray(l), gram=np.asarray(gram), wtil=np.asarray(q_args[-1]),
                out=np.asarray(out, np.float32), q_out=np.asarray(q_out, np.float32))


def _rel_rows(got, want):
    d = (got - want).reshape(got.shape[0], -1)
    return float((np.linalg.norm(d, axis=1) / np.linalg.norm(want.reshape(got.shape[0], -1),
                                                              axis=1)).max())


def test_inputs_are_the_script_draws_in_pixels():
    inp = A.inputs(B, SIZE, device="cpu")
    xs = np.random.default_rng(0).normal(size=(B, SIZE // 2, SIZE // 2, 128))
    x = inp["x"].float().numpy()
    want = torch.as_tensor(xs, dtype=torch.float32).to(torch.bfloat16).float().numpy()
    # pixel (2i + a, 2j + b) holds phase a·2 + b of s2d token (i, j)
    for a in range(2):
        for b in range(2):
            p = a * 2 + b
            np.testing.assert_array_equal(x[:, a::2, b::2], want[..., p * 32:(p + 1) * 32])
    assert inp["w_qkv"].shape == (32, 384) and inp["g_in"].dtype == torch.float32


def test_kv_linear_reference_matches_the_jax_kv_kernel(jax_run):
    inp = A.inputs(B, SIZE, device="cpu")
    xr = inp["x"].reshape(B, SIZE * SIZE, 32)
    _, wk, _ = LA.split_qkv(inp["w_qkv"])
    _, l, gram = LA.kv_linear_reference(xr, inp["g_in"], wk, nb=1, tile=4 * JAX_T)
    jl = jax_run["l"][:, 0]
    jg = sum(jax_run["gram"][:, p * 128 + p * 32:p * 128 + (p + 1) * 32] for p in range(4))
    assert (jl < 0).any() or (jg < 0).any()  # the linear map went negative somewhere
    assert _rel_rows(l.numpy(), jl) <= REL
    assert _rel_rows(gram.numpy(), jg) <= REL


def test_q_pass_linear_matches_the_jax_q_kernel(jax_run):
    inp = A.inputs(B, SIZE, device="cpu")
    xr = inp["x"].reshape(B, SIZE * SIZE, 32)
    wq, _, _ = LA.split_qkv(inp["w_qkv"])
    wt = jax_run["wtil"]
    for p in range(4):  # every phase's block holds the same [128, C] W̃
        np.testing.assert_array_equal(wt[:, p, :, p * 32:(p + 1) * 32], wt[:, 0, :, :32])
    wtil = torch.as_tensor(wt[:, 0, :, :32].astype(np.float32)).to(torch.bfloat16)
    out = LA.q_pass_reference(xr, inp["g_in"], wq, wtil.contiguous(), inp["b_out"],
                              inp["g_out"], exp=LA.lin_exp)
    got = (out.float() + xr.float()).to(torch.bfloat16)
    want = A.s2d_to_pixels(jax_run["q_out"].reshape(B, SIZE // 2, SIZE // 2, 128))
    want = torch.as_tensor(want.reshape(B, SIZE * SIZE, 32))
    agree = A.q_agreement(got, want, LA.q_linear_conditioning(xr, inp["g_in"], wq))
    assert agree["ok"], agree
    assert 0.5 < agree["well_share"] < 1.0  # both kinds of token are there


def test_lin_exp_and_the_linear_merge():
    a = torch.tensor([0.0, -1.0, -4.0, -float("inf")])
    torch.testing.assert_close(LA.lin_exp(a), torch.tensor([1.0, 0.5, -1.0, 0.0]))
    # one block of every tile, against the blocks merged: the same up to the
    # linear map's composition, exact where the max never moves
    x = torch.full((1, 128, 32), 0.5).to(torch.bfloat16)
    g = torch.ones(32)
    wk = torch.full((32, 128), 0.01).to(torch.bfloat16)
    one = LA.kv_linear_reference(x, g, wk, nb=1)
    two = LA.kv_linear_reference(x, g, wk, nb=2)
    for u, v in zip(one, two):
        torch.testing.assert_close(u, v)


@pytest.mark.parametrize("tile", [2048, 16384, 256])
def test_copy_plain_version_and_grids(tile):
    x = torch.randn(2, 4096, 32).to(torch.bfloat16)
    t = A.copy_tiles_of(tile, x.shape[1])
    out = CP.copy_tiles(x, t)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert CP.programs((8, 65536, 32), A.copy_tiles_of(tile, 65536)) == {
        2048: 64, 16384: 8, 256: 512}[tile]


def test_script_rows_and_record_on_plain_versions():
    """The rows run on the CPU through the plain versions (a smoke of the
    wiring; the script itself times only on the card), and the record
    holds every row and the derived shares."""
    inp = A.inputs(1, 64, device="cpu")
    ops = A.operands(inp)
    fns = A.row_fns(inp, ops)
    assert [n for n, _ in fns] == list(A.ROW_NAMES)
    for _, fn in fns:
        fn()
    args = A.parse_args(["--batch", "1", "--size", "64"])
    rec = A.record(args, {n: 1.0 + i for i, n in enumerate(A.ROW_NAMES)}, None,
                   {"device": "test"})
    assert [r["name"] for r in rec["rows"]] == list(A.ROW_NAMES)
    assert set(rec["derived"]) == {"kv_exp_share", "q_exp_share", "two_pass_exp_share",
                                   "second_call_ms", "fold_and_gaps_ms"}
    assert rec["shape"] == [1, 64, 64, 32]
