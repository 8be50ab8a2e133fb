"""The port's CUDA kernels against their plain PyTorch versions, on the card:
GroupNorm+FiLM+SiLU at the flagship's and the 256px chain's shapes, full
attention and the two linear-attention passes at the 256px chain's shapes,
and the inputs each wrapper refuses.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)

# the flagship's five Block shapes at batch 64 (a branched [2B] pair)
FLAGSHIP_SHAPES = [(128, 28, 28, 32), (128, 14, 14, 32), (128, 14, 14, 64),
                   (128, 7, 7, 64), (128, 7, 7, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, film, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    b, _, _, c = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = (r(*shape) * 1.5 + 0.3).to(dtype)
    scale, shift = (r(b, c), r(b, c)) if film else (None, None)
    return x, r(c), r(c), scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES)
def test_groupnorm_kernel_matches_plain_version(cuda_device, shape, film, dtype):
    """f32: 2e-5 (summation order only); bf16: 2e-2 relative, one rounding
    step of the bf16 output (the kernel and the plain version round the same
    f32 value)."""
    x, g, b, s, h = _inputs(shape, film, dtype, cuda_device)
    before = groupnorm_film_silu.launches
    got = groupnorm_film_silu(x, g, b, s, h, groups=8)
    torch.cuda.synchronize()
    assert groupnorm_film_silu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_groupnorm_kernel_rejects_what_it_cannot_take(cuda_device):
    x, g, b, s, h = _inputs((2, 4, 4, 32), True, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="divisible"):
        groupnorm_film_silu(x, g, b, s, h, groups=6)
    with pytest.raises(ValueError, match="on cpu"):
        groupnorm_film_silu(x, g.cpu(), b, s, h)
    with pytest.raises(TypeError):
        groupnorm_film_silu(x.half(), g, b, s, h)


# ---------------------------------------------------------------------------
# the 256px MRI chain's kernels
# ---------------------------------------------------------------------------
# full attention at the three 32x32 sites of a batch-4 branched chain, and
# token counts that leave the last query and key tiles ragged
ATTN_SHAPES = [(8, 1024, 4, 32), (2, 300, 2, 32), (1, 257, 3, 32)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# the six linear-attention sites of a 256px UNet call at batch 8, and one
# with a ragged last block
LINATT_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 32), (8, 64, 64, 64),
                 (8, 64, 64, 128), (8, 128, 128, 64), (2, 72, 72, 32)]
# the 256px Block shapes (batch 8), bf16
MRI_GN_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 32), (8, 128, 128, 64),
                 (8, 64, 64, 64), (8, 64, 64, 128), (8, 32, 32, 128), (8, 32, 32, 256)]


def _qkv_views(shape, dtype, device, seed=0):
    """q, k, v as `Attention` cuts them: strided views of one channels_last
    qkv projection."""
    b, n, h, d = shape
    side = int(n**0.5)
    gen = torch.Generator(device=device).manual_seed(seed)
    if side * side == n:
        qkv = torch.randn(b, 3 * h * d, side, side, generator=gen, device=device)
        qkv = qkv.to(dtype).contiguous(memory_format=torch.channels_last)
        return [t.permute(0, 3, 1, 2) for t in qkv.reshape(b, 3, h, d, n).unbind(1)]
    return [torch.randn(shape, generator=gen, device=device).to(dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_kernel_matches_plain_version(cuda_device, shape, dtype):
    """f32: 2e-5 (summation order).  bf16: 1e-2.  Both round the
    probabilities to bf16 before P·V, the kernel the unnormalised exp(s − m)
    against a running max with 1/l applied after the product, the plain
    version the normalised softmax; with the output's rounding step a sound
    kernel reads 3.9e-3 at [8, 1024, 4, 32]."""
    q, k, v = _qkv_views(shape, dtype, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    want = xla_attention(q, k, v)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_cannot_take(cuda_device):
    q, k, v = _qkv_views((1, 256, 2, 32), torch.float32, cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(t[..., :24] for t in (q, k, v)))
    strided = torch.randn(1, 256, 2, 32, 2, device=cuda_device)[..., 0]
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(strided, strided, strided)


def _linatt_inputs(shape, device, seed=0):
    b, h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = (r(*shape) * 1.5).to(torch.bfloat16)
    params = (r(c) * 0.2 + 1.0, r(c, 3 * LA.HIDDEN) * 0.1, r(LA.HIDDEN, c) * 0.1,
              r(c) * 0.05, r(c) * 0.2 + 1.0)
    return x, params


def _kv_errors(got, want):
    """The kv kernel's partials against the plain version's, block by block:
    m relative (both are the max of bf16-rounded k, at most one rounding
    step apart); then, with the kernel's partials put on the plain
    version's max, l as relative L2 over its 128 columns and G as relative
    Frobenius over its C×128 (a norm over the block: one token whose k
    rounds a step apart moves one column, a fault moves the block)."""
    (m, l, g), (pm, pl, pg) = got, want
    r = torch.exp(m - pm)
    l, g = l * r, g * r[:, :, None, :]
    return dict(
        m=((m - pm).abs() / pm.abs().clamp_min(1e-6)).max().item(),
        l=((l - pl).norm(dim=2) / pl.norm(dim=2)).max().item(),
        g=((g - pg).norm(dim=(2, 3)) / pg.norm(dim=(2, 3))).max().item(),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LINATT_SHAPES)
def test_linear_attention_kernels_match_plain_versions(cuda_device, shape):
    """Each pass against its plain version on the same inputs (kv, per
    block: m within 2^-7 relative, l within 1e-3 and G within 5e-3 relative
    norm; q: the JAX bar atol 0.04 / rtol 0.05), and the two-pass function
    against the unfused plain version at the JAX bar plus correlation
    > 0.999."""
    b, h, w, c = shape
    x, (g_in, w_qkv, w_out, b_out, g_out) = _linatt_inputs(shape, cuda_device)
    xr = x.reshape(b, h * w, c)
    wq, wk, wv = LA.split_qkv(w_qkv)
    per = LA.tokens_per_block(b, h * w)
    m, l, gram = LA.linear_attention_kv(xr, g_in, wk, per)
    err = _kv_errors((m, l, gram), LA.kv_partials_reference(xr, g_in, wk, per))
    assert err["m"] <= 2**-7 and err["l"] <= 1e-3 and err["g"] <= 5e-3, err
    wtil = LA.fold(*LA.merge_kv(m, l, gram), wv, w_out)
    got = LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out, per)
    want = LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out)
    torch.testing.assert_close(got.float(), want.float(), atol=0.04, rtol=0.05)

    before = (LA.linear_attention_kv.launches, LA.linear_attention_q.launches)
    full = LA.linear_attention(x, g_in, w_qkv, w_out, b_out, g_out)
    torch.cuda.synchronize()
    assert (LA.linear_attention_kv.launches, LA.linear_attention_q.launches) == (
        before[0] + 1, before[1] + 1)
    ref = LA.linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out)
    torch.testing.assert_close(full.float(), ref.float(), atol=0.04, rtol=0.05)
    corr = torch.corrcoef(torch.stack([full.float().ravel(), ref.float().ravel()]))[0, 1]
    assert corr > 0.999


@pytest.mark.cuda
def test_linear_attention_rejects_what_it_cannot_take(cuda_device):
    x, params = _linatt_inputs((2, 64, 64, 32), cuda_device)
    with pytest.raises(ValueError, match="do not take"):
        LA.linear_attention(x.float(), *params)  # f32: outside the gate
    with pytest.raises(ValueError, match="do not take"):
        LA.linear_attention(x[:, :32], *params)  # below 4096 pixels
    with pytest.raises(ValueError, match="contiguous"):
        LA.linear_attention(x.transpose(1, 2), *params)
    wq, wk, _ = LA.split_qkv(params[1])
    with pytest.raises(TypeError):
        LA.linear_attention_kv(x.reshape(2, -1, 32), params[0], wk.float(), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", MRI_GN_SHAPES)
def test_groupnorm_kernel_at_the_256px_shapes(cuda_device, shape, film):
    """bf16 at the 256px Blocks, where a group holds up to 262,144 elements:
    2e-2, one output rounding step."""
    x, g, b, s, h = _inputs(shape, film, torch.bfloat16, cuda_device)
    got = groupnorm_film_silu(x, g, b, s, h, groups=8)
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
