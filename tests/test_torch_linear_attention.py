"""Port parity: the streaming linear attention against the JAX package's.

Three things are held against JAX on the same numpy inputs, in bf16, at
the JAX tests' bar (atol 0.04 / rtol 0.05 plus correlation > 0.999,
`tests/test_pallas_linear_attention.py`; bf16 roundings fall at other
points in the fused and unfused forms):

  * the plain version, `linear_attention_reference` (the unfused math),
    against `linear_attention_folded_reference`;
  * `linear_attention_two_pass` on the CPU — the CUDA kernels' algorithm
    (per-block partials merged per row by the log-sum-exp rule, fold,
    pass 2) run through their plain versions — against
    `linear_attention_fused` in interpret mode;
  * the `LinearAttention` module against the JAX module, on both sides of
    the 4096-pixel gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.models.blocks import LinearAttention as JaxLinearAttention
from localdiffusion_tpu.ops.pallas_linear_attention import (
    linear_attention_folded_reference,
    linear_attention_fused,
    supports_normal_layout,
)
from localdiffusion_tpu_torch.models.blocks import LinearAttention
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from test_torch_support import perturbed

HEADS, DIM_HEAD, HIDDEN = 4, 32, 128
BAR = dict(atol=0.04, rtol=0.05)


def _params(c, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(g_in=r(c) * 0.2 + 1.0, w_qkv=r(c, 3 * HIDDEN) * 0.1,
                w_out=r(HIDDEN, c) * 0.1, b_out=r(c) * 0.05, g_out=r(c) * 0.2 + 1.0)


def _x(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_torch(p):
    return [torch.as_tensor(p[k]) for k in ("g_in", "w_qkv", "w_out", "b_out", "g_out")]


def _to_jax(p):
    return [jnp.asarray(p[k]) for k in ("g_in", "w_qkv", "w_out", "b_out", "g_out")]


def _assert_bar(got, want):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **BAR)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


# the JAX tests' small shapes (1, 8, 16, c), and a width whose token count
# (96) leaves the last 64-token block ragged
SHAPES = [(1, 8, 16, 32), (1, 8, 16, 64), (1, 8, 16, 128), (2, 8, 12, 32)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape):
    c = shape[-1]
    p = _params(c, seed=c)
    x = _x(shape)
    want = linear_attention_folded_reference(
        jnp.asarray(x).astype(jnp.bfloat16), *_to_jax(p), HEADS, DIM_HEAD, 1,
        add_residual=False)
    got = LA.linear_attention(torch.as_tensor(x).bfloat16(), *_to_torch(p))
    assert got.dtype == torch.bfloat16
    _assert_bar(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_algorithm_matches_the_pallas_kernels(shape):
    b, h, w, c = shape
    p = _params(c, seed=c + 1)
    x = _x(shape, seed=c)
    want = linear_attention_fused(jnp.asarray(x).astype(jnp.bfloat16), *_to_jax(p),
                                  HEADS, DIM_HEAD, False, True)  # interpret
    ranges = LA.block_ranges(h * w, LA.blocks_per_row(h * w))
    assert sum(e > s for s, e in ranges) >= 2  # the partials really are merged
    got = LA.linear_attention_two_pass(torch.as_tensor(x).bfloat16(), *_to_torch(p))
    _assert_bar(got, want)


def test_merged_partials_equal_one_block():
    """Splitting a row into blocks and merging them by the log-sum-exp rule
    gives one block's l and G, up to the bf16 rounding of exp(k − m), which
    each block takes against its own max (rtol 1e-2)."""
    c, n = 32, 320
    p = _params(c, seed=4)
    x = torch.as_tensor(_x((2, n, c), seed=5)).bfloat16()
    wq, wk, _ = LA.split_qkv(torch.as_tensor(p["w_qkv"]))
    g_in = torch.as_tensor(p["g_in"])
    m1, l1, g1 = LA.kv_reference(x, g_in, wk, 1)
    m5, l5, g5 = LA.kv_partials_reference(x, g_in, wk, 5)  # one 64-token tile a block
    assert m5.shape == (2, 5, HIDDEN) and g5.shape == (2, 5, c, HIDDEN)
    m2, l2, g2 = LA.merge_kv(m5, l5, g5)
    # both relative to the row's max, so directly comparable
    torch.testing.assert_close(m2, m1, rtol=0, atol=0)
    torch.testing.assert_close(l2, l1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g2, g1, rtol=1e-2, atol=1e-2 * float(g1.abs().max()))


def test_block_size_comes_from_the_token_count_alone():
    """The kv kernel's blocks per row follow the token count alone,
    whatever the batch: 32 at 256², 16 at 128² and 64², multiples of 8;
    the tiles are split as evenly as whole tiles
    allow (2,048 tokens a block at 256², 1,024 at 128², 256 at 64²)."""
    assert [LA.blocks_per_row(s * s) for s in (256, 128, 64)] == [32, 16, 16]
    assert all(LA.blocks_per_row(s * s) % LA.BLOCK_STEP == 0 for s in (256, 128, 64))
    for s, per in ((256, 2048), (128, 1024), (64, 256)):
        ranges = LA.block_ranges(s * s, LA.blocks_per_row(s * s))
        assert all(e - b == per for b, e in ranges)
    # 72x76 = 5,472 tokens, 85.5 tiles: 86 tiles over 16 blocks, the last cut
    ranges = LA.block_ranges(72 * 76, 16)
    assert ranges[0] == (0, 320) and ranges[-1] == (5120, 5472)
    assert LA.block_ranges(96, 16)[-1] == (64, 96)


@pytest.mark.parametrize("n,nb", [(4096, 16), (16384, 32), (65536, 32), (5472, 16),
                                  (5184, 16), (96, 16), (320, 8)])
def test_block_ranges_tile_the_row(n, nb):
    """The blocks' ranges cover [0, n) in order, without overlap, each a
    whole number of 64-token tiles except the one that ends at n, and their
    sizes differ by at most one tile."""
    ranges = LA.block_ranges(n, nb)
    assert len(ranges) == nb and ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s % LA.TILE == 0 and (e % LA.TILE == 0 or e == n) for s, e in ranges)
    tiles = [-(-(e - s) // LA.TILE) for s, e in ranges]
    assert max(tiles) - min(tiles) <= 1


def test_kv_plain_version_row_alone_equals_row_in_a_batch():
    """The kv plain version's merged (m, l, G) of row 0 alone equals, bit
    for bit, row 0's inside a batch of 4 (the split follows n alone, the
    merge sums in float64)."""
    c, n = 64, 4096
    p = _params(c, seed=7)
    x = torch.as_tensor(_x((4, n, c), seed=3)).bfloat16()
    _, wk, _ = LA.split_qkv(torch.as_tensor(p["w_qkv"]))
    g_in = torch.as_tensor(p["g_in"])
    nb = LA.blocks_per_row(n)
    whole = LA.linear_attention_kv(x, g_in, wk, nb)
    alone = LA.linear_attention_kv(x[:1].clone(), g_in, wk, nb)
    for a, w in zip(alone, whole):
        assert torch.equal(a, w[:1])


def test_row_alone_equals_row_in_a_batch():
    """Through the kernels' algorithm (`linear_attention_two_pass` on the
    CPU: per-block partials merged per row, fold, pass 2), row 0 alone
    gives, bit for bit, what it gives inside a batch of 8 at
    [8, 64, 64, 64].  With the block size taken from the batch it differed
    by rel. L2 1.1e-3."""
    shape = (8, 64, 64, 64)
    p = _params(shape[-1], seed=6)
    x = torch.as_tensor(_x(shape, seed=8)).bfloat16()
    whole = LA.linear_attention_two_pass(x, *_to_torch(p))
    alone = LA.linear_attention_two_pass(x[:1].clone(), *_to_torch(p))
    assert torch.equal(alone, whole[:1])


@pytest.mark.parametrize("h,w,c,dtype", [
    (64, 64, 32, "bfloat16"),  # at the gate: the kernels' side
    (32, 32, 32, "bfloat16"),  # below it
    (64, 64, 64, "float32"),  # outside it by type
])
def test_module_matches_jax_module(h, w, c, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = _x((1, h, w, c), seed=h + c)
    jmod = JaxLinearAttention(HEADS, DIM_HEAD, jdt)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, c))), seed=1)
    want = jmod.apply(params, jnp.asarray(x).astype(jdt))
    tmod = LinearAttention(c, HEADS, DIM_HEAD, tdt)
    tmod.load_state_dict(params_from_jax(params, tmod))
    assert LA.supports((1, h, w, c), HEADS, DIM_HEAD, tdt) == (
        h * w >= 4096 and dtype == "bfloat16")
    xt = torch.as_tensor(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tmod(xt.contiguous(memory_format=torch.channels_last)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    _assert_bar(got, want)


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 32), (2, 64, 64, 64), (2, 64, 64, 128), (2, 64, 64, 16),
    (2, 64, 62, 32), (2, 63, 64, 128), (2, 32, 32, 32), (8, 256, 256, 32),
])
def test_gate_is_the_jax_gate(shape):
    b, h, w, c = shape
    jax_gate = c in (32, 64, 128) and supports_normal_layout(shape, HEADS, DIM_HEAD)
    want = jax_gate and h * w >= 4096
    assert LA.supports(shape, HEADS, DIM_HEAD, torch.bfloat16) == want
    assert not LA.supports(shape, HEADS, DIM_HEAD, torch.float32)
    assert not LA.supports(shape, 2, DIM_HEAD, torch.bfloat16)


def test_kernel_wrappers_check_their_inputs():
    c = 32
    x = torch.zeros(1, 128, c, dtype=torch.bfloat16)
    g = torch.ones(c)
    wk = torch.zeros(c, HIDDEN, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        LA.linear_attention_kv(x.float(), g, wk, 16)
    with pytest.raises(ValueError, match="not in"):
        LA.linear_attention_kv(torch.zeros(1, 128, 48, dtype=torch.bfloat16), g, wk, 16)
    for nb in (12, 0, 72):
        with pytest.raises(ValueError, match="multiple"):
            LA.linear_attention_kv(x, g, wk, nb)
    with pytest.raises(ValueError, match="shape"):
        LA.linear_attention_q(x, g, wk, torch.zeros(2, HIDDEN, c, dtype=torch.bfloat16),
                              g, g)
