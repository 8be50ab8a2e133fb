"""Port parity: the streaming linear attention against the JAX package's.

Three things are held against JAX on the same numpy inputs, in bf16, at
the JAX tests' bar (atol 0.04 / rtol 0.05 plus correlation > 0.999,
`tests/test_pallas_linear_attention.py`; bf16 roundings fall at other
points in the fused and unfused forms):

  * the plain version, `linear_attention_reference` (the unfused math),
    against `linear_attention_folded_reference`;
  * `linear_attention_two_pass` on the CPU — the CUDA kernels' algorithm
    (per-block partials, log-sum-exp merge, fold, pass 2) run through their
    plain versions — against `linear_attention_fused` in interpret mode;
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
    per_block = LA.tokens_per_block(h * w)
    assert -(-h * w // per_block) >= 2  # the partials really are merged
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
    l1, g1 = LA.merge_kv(*LA.linear_attention_kv(x, g_in, wk, 384))
    m5, l5, g5 = LA.linear_attention_kv(x, g_in, wk, 64)
    assert m5.shape == (2, 5, HIDDEN) and g5.shape == (2, 5, c, HIDDEN)
    l2, g2 = LA.merge_kv(m5, l5, g5)
    # both relative to the row's max, so directly comparable
    torch.testing.assert_close(l2, l1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g2, g1, rtol=1e-2, atol=1e-2 * float(g1.abs().max()))


def test_block_size_comes_from_the_token_count_alone():
    """About 64 blocks a row in whole 64-token sub-tiles, whatever the
    batch: 1,024 tokens at 256², 256 at 128², 64 at 64²."""
    assert [LA.tokens_per_block(s * s) for s in (256, 128, 64)] == [1024, 256, 64]
    assert LA.tokens_per_block(96) == 64 and LA.tokens_per_block(72 * 72) == 128


def test_row_alone_equals_row_in_a_batch():
    """Through the kernels' algorithm (`linear_attention_two_pass` on the
    CPU: per-block partials, merge, fold, pass 2), row 0 alone gives, bit
    for bit, what it gives inside a batch of 8 at [8, 64, 64, 64].  With
    the block size taken from the batch it differed by rel. L2 1.1e-3."""
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
        LA.linear_attention_kv(x.float(), g, wk, 64)
    with pytest.raises(ValueError, match="not in"):
        LA.linear_attention_kv(torch.zeros(1, 128, 48, dtype=torch.bfloat16), g, wk, 64)
    with pytest.raises(ValueError, match="multiple"):
        LA.linear_attention_kv(x, g, wk, 96)
    with pytest.raises(ValueError, match="shape"):
        LA.linear_attention_q(x, g, wk, torch.zeros(2, HIDDEN, c, dtype=torch.bfloat16),
                              g, g, 64)
