"""The port's CUDA kernels against their plain PyTorch versions, on the card:
GroupNorm+FiLM+SiLU at the flagship's and the 256px chain's shapes (the
single-pass kernel, and past the row gate the tiled stats/apply pair at the
s2d-stem and 256px chains' large blocks), full attention (on strided,
contiguous and unaligned inputs, ragged token counts), the two
linear-attention passes and the fused ResnetBlock's conv3x3_stats (each of
its shared-memory plans, persistent grids with more and fewer tiles than
blocks) and epilogue at the 256px chain's shapes, the inputs each wrapper
refuses, and a row alone against the same row in a batch.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from localdiffusion_tpu_torch.models.blocks import ResnetBlock
from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
    groupnorm_film_silu_single_pass,
)

# the flagship's five Block shapes at batch 64 (a branched [2B] pair)
FLAGSHIP_SHAPES = [(128, 28, 28, 32), (128, 14, 14, 32), (128, 14, 14, 64),
                   (128, 7, 7, 64), (128, 7, 7, 128)]


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for float32 convolutions and products (the
    plain versions then compute in float32, as chip_smoke.py runs them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


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
# token counts that leave the last query and key tiles ragged (the bf16
# kernel takes 128 query rows and 128 keys a tile, the f32 kernel 32 and 64)
ATTN_SHAPES = [(8, 1024, 4, 32), (2, 300, 2, 32), (1, 257, 3, 32), (1, 1000, 2, 32)]
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


def _qkv_layout(shape, dtype, device, layout, seed=0):
    """q, k, v [B, N, H, D] as `layout` says: "views", strided views of one
    [B, N, 3, H, D] projection (token stride 3·H·D, head stride D, as the
    UNet's Attention cuts them); "contiguous", three tensors of their own;
    "offset", contiguous tensors whose data starts one element past a
    16-byte boundary (the kernels then read element by element)."""
    b, n, h, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    if layout == "views":
        qkv = torch.randn(b, n, 3, h, d, generator=gen, device=device).to(dtype)
        return list(qkv.unbind(2))
    numel = b * n * h * d
    out = []
    for _ in range(3):
        flat = torch.randn(numel + 1, generator=gen, device=device).to(dtype)
        t = flat[1:] if layout == "offset" else flat[:numel]
        out.append(t.view(shape))
    if layout == "offset":
        assert all(t.data_ptr() % 16 for t in out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["views", "contiguous", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1024, 4, 32), (1, 1000, 2, 32), (2, 300, 2, 32),
                                   (8, 256, 4, 32)])
def test_attention_kernel_layouts(cuda_device, shape, dtype, layout):
    """The kernel against its plain version on the strided qkv views, on
    contiguous tensors and on tensors off a 16-byte boundary, at token
    counts that leave the last query and key tiles ragged; the bars of
    `test_attention_kernel_matches_plain_version`."""
    q, k, v = _qkv_layout(shape, dtype, cuda_device, layout)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == shape and got.is_contiguous()
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
    per = LA.tokens_per_block(h * w)
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
    """The single-pass kernel, launched directly (most of these shapes are
    past the row gate, where the dispatcher takes the tiled pair), in bf16
    at the 256px Blocks, where a group holds up to 262,144 elements: 2e-2,
    one output rounding step."""
    x, g, b, s, h = _inputs(shape, film, torch.bfloat16, cuda_device)
    before = groupnorm_film_silu.launches
    got = groupnorm_film_silu_single_pass(x, g, b, s, h, groups=8)
    torch.cuda.synchronize()
    assert groupnorm_film_silu.launches == before + 1
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_linear_attention_row_alone_equals_row_in_batch(cuda_device):
    """The kernels' blocks come from the token count alone: row 0 by itself
    gives, bit for bit, what it gives inside a batch of 8."""
    x, params = _linatt_inputs((8, 128, 128, 32), cuda_device)
    whole = LA.linear_attention(x, *params)
    alone = LA.linear_attention(x[:1].clone(), *params)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1])


# ---------------------------------------------------------------------------
# the fused ResnetBlock
# ---------------------------------------------------------------------------
# the 13 fused blocks' (NHWC input, dim_out) at the 256px chain's sites, at
# batch 2, and ragged cases: H, W not multiples of the 8x16 tile, Cin not a
# multiple of the 32-channel chunk
RB_SHAPES = [((2, 256, 256, 32), 32), ((2, 128, 128, 32), 32), ((2, 64, 64, 64), 64),
             ((2, 64, 64, 192), 128), ((2, 128, 128, 96), 64), ((2, 256, 256, 64), 32),
             ((1, 20, 36, 48), 64), ((3, 12, 40, 8), 128), ((2, 40, 24, 40), 64),
             ((1, 24, 40, 40), 128)]


def bf16_steps(got, want):
    """|got − want| in bf16 steps, element by element (largest): the step at
    max(|got|, |want|), or at 1/256 of want's largest |value| where both are
    smaller (near 0 float32 sums in another order move a value by more than
    its own step)."""
    got, want = got.float(), want.float()
    floor = want.abs().max() / 256
    _, e = torch.frexp(torch.maximum(torch.maximum(got.abs(), want.abs()), floor))
    return ((got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)).max().item()


def stats_errors(h, s, ss, plain):
    """The kernel's sums against (tiles) the per-tile sums of its own h, and
    (s, ss) the plain version's per-(row, channel) sums with the part that
    the one-step differences between the two h explain taken out; each a
    relative norm per row (largest row)."""
    ph, ps, pss = plain
    ts, tss = RB.tile_sums(h)
    own = torch.cat([ts, tss], 1)
    tiles = ((torch.cat([s, ss], 1) - own).norm(dim=(1, 2)) / own.norm(dim=(1, 2))).max()
    hk, hp = h.double(), ph.double()
    out = dict(tiles=tiles.item())
    for key, got, want, moved in (("s", s, ps, hk - hp), ("ss", ss, pss, hk**2 - hp**2)):
        diff = got.double().sum(1) - want.double().sum(1) - moved.sum(dim=(1, 2))
        out[key] = (diff.norm(dim=1) / want.double().sum(1).norm(dim=1)).max().item()
    return out


def _rb_block(cin, dim_out, device, seed=0):
    """A bf16 ResnetBlock with seeded non-trivial parameters, on device."""
    torch.manual_seed(seed)
    mod = ResnetBlock(cin, dim_out, 8, 64, torch.bfloat16)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    return mod.to(device)


def _rb_inputs(shape, dim_out, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = (r(*shape) * 0.5).to(torch.bfloat16)
    return x, (r(shape[0], dim_out) * 0.3, r(shape[0], dim_out) * 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim_out", RB_SHAPES)
def test_resnet_block_passes_match_plain_versions(cuda_device, shape, dim_out):
    """Each pass against its plain version on the same inputs: h1 and h2
    within one bf16 step, the sums within 1e-5 relative norm, the epilogue
    within one bf16 step of its terms (atol 2^-6, rtol 2^-7); then the whole
    fused block against the plain three passes at the JAX bar (atol 0.05 /
    rtol 0.06, correlation > 0.999) and relative L2 ≤ 2e-3.  The bars and
    the sound readings are chip_smoke.py's (`RB_TOL`)."""
    x, ss = _rb_inputs(shape, dim_out, cuda_device)
    mod = _rb_block(shape[-1], dim_out, cuda_device)
    b1, b2 = mod.block1, mod.block2
    n = shape[1] * shape[2] * (dim_out // 8)
    w1, w2 = RB.pack_conv3x3(b1.proj.weight.detach()), RB.pack_conv3x3(b2.proj.weight.detach())
    bias1, bias2 = b1.proj.bias.detach(), b2.proj.bias.detach()
    before = (RB.conv3x3_stats.launches, RB.epilogue.launches)
    h1, s1, ss1 = RB.conv3x3_stats(x, w1, bias1)
    plain1 = RB.conv_stats_reference(x, w1, bias1)
    a1, c1 = RB.gn_affine(s1, ss1, b1.norm.weight.detach(), b1.norm.bias.detach(), *ss, 8, n)
    h2, s2, ss2 = RB.conv3x3_stats(h1, w2, bias2, a1, c1)
    plain2 = RB.conv_stats_reference(h1, w2, bias2, a1, c1)
    a2, c2 = RB.gn_affine(s2, ss2, b2.norm.weight.detach(), b2.norm.bias.detach(), None, None,
                          8, n)
    wr = br = None
    if mod.res_conv is not None:
        wr = mod.res_conv.weight.detach()[:, :, 0, 0].to(torch.bfloat16).contiguous()
        br = mod.res_conv.bias.detach()
    out = RB.epilogue(h2, x, a2, c2, wr, br)
    torch.cuda.synchronize()
    assert (RB.conv3x3_stats.launches, RB.epilogue.launches) == (before[0] + 2, before[1] + 1)
    for (h, s, ss_, plain) in ((h1, s1, ss1, plain1), (h2, s2, ss2, plain2)):
        assert bf16_steps(h, plain[0]) <= 1.0
        err = stats_errors(h, s, ss_, plain)
        assert max(err.values()) <= 1e-5, err
    want = RB.epilogue_reference(h2, x, a2, c2, wr, br)
    torch.testing.assert_close(out.float(), want.float(), atol=2**-6, rtol=2**-7)

    with torch.no_grad():
        got = RB.resnet_block_fused(x, mod, ss)
        ref = RB.resnet_block_fused_plain(x, mod, ss)
    torch.testing.assert_close(got.float(), ref.float(), atol=0.05, rtol=0.06)
    corr = torch.corrcoef(torch.stack([got.float().ravel(), ref.float().ravel()]))[0, 1]
    assert corr > 0.999
    assert (got.float() - ref.float()).norm() <= 2e-3 * ref.float().norm()


@pytest.mark.cuda
def test_resnet_block_row_alone_equals_row_in_batch(cuda_device):
    """The tile grid comes from H and W alone: row 0 by itself gives, bit
    for bit, what it gives inside a batch of 8 (with FiLM and a res_conv)."""
    x, ss = _rb_inputs((8, 128, 128, 96), 64, cuda_device, seed=3)
    mod = _rb_block(96, 64, cuda_device, seed=3)
    with torch.no_grad():
        whole = RB.resnet_block_fused(x, mod, ss)
        alone = RB.resnet_block_fused(x[:1].clone(), mod, tuple(t[:1].clone() for t in ss))
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1])


def _conv_pass_inputs(shape, cout, device, seed=0):
    """x, w, bias and a pass-2 affine (a, b) for conv3x3_stats."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sz: torch.randn(*sz, generator=gen, device=device)
    b, _, _, cin = shape
    x = (r(*shape) * 0.5).to(torch.bfloat16)
    w = (r(9, cout, cin) * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
    return x, w, r(cout) * 0.1, r(b, cin) * 0.5 + 1.0, r(b, cin) * 0.3


def _check_conv_pass(x, w, bias, a=None, b=None):
    """One conv3x3_stats launch against its plain version: h within one bf16
    step, the sums within 1e-5 relative norm per row (`RB_TOL`)."""
    before = RB.conv3x3_stats.launches
    got = RB.conv3x3_stats(x, w, bias, a, b)
    torch.cuda.synchronize()
    assert RB.conv3x3_stats.launches == before + 1
    plain = RB.conv_stats_reference(x, w, bias, a, b)
    assert got[0].shape == plain[0].shape and got[1].shape == plain[1].shape
    assert bf16_steps(got[0], plain[0]) <= 1.0
    err = stats_errors(*got, plain)
    assert max(err.values()) <= 1e-5, err
    return got


# conv3x3_stats' shared-memory plans and grids: 64 output channels a block
# with the weights resident (128 -> 128), 32 with the weights resident
# (192 -> 128 in pass 1; any Cout 32) and streamed with the input (192 ->
# 128 with the prologue, 384 -> 128), more tiles than blocks (4 x 16 x 16
# tiles) and fewer (one tile; four)
CONV_PLANS = [((2, 64, 64, 128), 128), ((2, 64, 64, 192), 128), ((1, 16, 32, 384), 128),
              ((4, 128, 128, 32), 64), ((1, 8, 16, 32), 32), ((2, 16, 32, 64), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("shape,cout", CONV_PLANS)
def test_conv3x3_stats_plans_and_grids(cuda_device, shape, cout, prologue):
    x, w, bias, a, b = _conv_pass_inputs(shape, cout, cuda_device)
    if prologue:
        _check_conv_pass(x, w, bias, a, b)
    else:
        _check_conv_pass(x, w, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [((8, 64, 64, 192), 128), ((8, 256, 256, 32), 32),
                                        ((8, 40, 24, 40), 64)])
def test_conv3x3_stats_row_alone_equals_row_in_batch(cuda_device, shape, cout):
    """Each tile's sums come from its own block in a fixed order, whatever
    grid the batch gives: row 0 alone equals row 0 of the batch, bit for
    bit, in both passes."""
    x, w, bias, a, b = _conv_pass_inputs(shape, cout, cuda_device, seed=5)
    for args in ((), (a, b)):
        whole = RB.conv3x3_stats(x, w, bias, *args)
        alone = RB.conv3x3_stats(x[:1].clone(), w, bias, *(t[:1].clone() for t in args))
        torch.cuda.synchronize()
        for got, want in zip(alone, whole):
            assert torch.equal(got, want[:1])


@pytest.mark.cuda
def test_resnet_block_module_launches_the_kernels(cuda_device):
    """Inside the gate the module launches conv3x3_stats twice and the
    epilogue once, and no GroupNorm kernel; outside it, the GroupNorm
    kernel twice."""
    from localdiffusion_tpu_torch.ops.groupnorm import groupnorm_film_silu

    mod = _rb_block(64, 32, cuda_device)
    t = torch.randn(2, 64, device=cuda_device).bfloat16()
    for side, convs, epis, gns in ((64, 2, 1, 0), (32, 0, 0, 2)):
        x = torch.randn(2, 64, side, side, device=cuda_device).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        before = (RB.conv3x3_stats.launches, RB.epilogue.launches, groupnorm_film_silu.launches)
        with torch.no_grad():
            out = mod(x, t)
        torch.cuda.synchronize()
        after = (RB.conv3x3_stats.launches, RB.epilogue.launches, groupnorm_film_silu.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (convs, epis, gns)
        assert out.shape == (2, 32, side, side) and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_resnet_block_kernels_reject_what_they_cannot_take(cuda_device):
    x, ss = _rb_inputs((1, 8, 16, 32), 32, cuda_device)
    w = torch.zeros(9, 32, 32, dtype=torch.bfloat16, device=cuda_device)
    bias = torch.zeros(32, device=cuda_device)
    with pytest.raises(TypeError):
        RB.conv3x3_stats(x.float(), w, bias)
    with pytest.raises(ValueError, match="on cpu"):
        RB.conv3x3_stats(x, w, bias.cpu())
    with pytest.raises(ValueError, match="multiple of 8"):
        RB.conv3x3_stats(x[..., :12].contiguous(), w[:, :, :12].contiguous(), bias)
    with pytest.raises(ValueError, match="C out"):
        RB.conv3x3_stats(x, w[:, :24].contiguous(), bias[:24].contiguous())
    off = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        RB.conv3x3_stats(off[:x.numel()].view(x.shape), w, bias)
    a = torch.zeros(1, 32, device=cuda_device)
    with pytest.raises(ValueError, match="C out"):
        RB.epilogue(x[..., :16].contiguous(), x[..., :16].contiguous(), a[:, :16].contiguous(),
                    a[:, :16].contiguous())
    mod = _rb_block(32, 32, cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        RB.resnet_block_fused(torch.zeros(1, 64, 62, 32, dtype=torch.bfloat16,
                                          device=cuda_device), mod, ss)


# ---------------------------------------------------------------------------
# the tiled GroupNorm pair (past the row gate)
# ---------------------------------------------------------------------------
# the large blocks of a branched s2d-stem UNet call at batch 8 (f32: 128x128
# at C=32, 64x64 at C=64) and of the 256px bf16 chain (32x32 at C=256), a
# ragged last tile, and more channels than a block has threads
TILED_SHAPES = [(8, 128, 128, 32), (8, 64, 64, 64), (8, 32, 32, 256), (2, 40, 45, 96),
                (1, 24, 24, 512)]


def _bf16_steps(got, want):
    """|got - want| in bf16 steps at max(|got|, |want|), largest."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()).clamp_min(1e-30))
    return ((got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_groupnorm_matches_plain_version(cuda_device, shape, film, dtype):
    """Past the gate the dispatcher launches the stats pass and the apply
    pass once each, and no single-pass kernel.  Against the plain tiled
    version: f32 3e-5 (the JAX bar for its tiled kernel; the sums run in
    another order), bf16 one output step (both round the same float32
    value once)."""
    assert G.large_block(shape)
    x, g, b, s, h = _inputs(shape, film, dtype, cuda_device)
    before = (G.groupnorm_film_silu.launches, G.gn_tiled_stats.launches,
              G.gn_tiled_apply.launches)
    got = groupnorm_film_silu(x, g, b, s, h, groups=8)
    torch.cuda.synchronize()
    after = (G.groupnorm_film_silu.launches, G.gn_tiled_stats.launches,
             G.gn_tiled_apply.launches)
    assert tuple(a - c for a, c in zip(after, before)) == (0, 1, 1)
    assert got.dtype == dtype and got.shape == x.shape
    want = G.groupnorm_film_silu_plain(x, g, b, s, h, groups=8)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    else:
        assert _bf16_steps(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_stats_partials_match_plain_per_row(cuda_device, shape, dtype):
    """The stats pass's per-tile partials against the plain partials at the
    same tiles: relative norm per row <= 1e-5 (float32 sums in another
    order read ~1e-7), a bar that one dropped tile of a row fails."""
    x = _inputs(shape, False, dtype, cuda_device)[0]
    got = G.gn_tiled_stats(x)
    torch.cuda.synchronize()
    want = G.tiled_partials_reference(x, G.stats_tile(shape[1] * shape[2], shape[3]))
    assert got.shape == want.shape and got.dtype == torch.float32

    def worst(p):
        return ((p - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()

    assert worst(got) <= 1e-5
    dropped = got.clone()
    dropped[:, got.shape[1] // 2] = 0
    assert worst(dropped) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128, 128, 32), (8, 32, 32, 256)])
def test_tiled_groupnorm_row_alone_equals_row_in_batch(cuda_device, shape, dtype):
    """The tiles come from h·w and c alone and the fold runs in a fixed
    order: row 0 alone equals row 0 of the batch of 8, bit for bit."""
    x, g, b, s, h = _inputs(shape, True, dtype, cuda_device)
    whole = groupnorm_film_silu(x, g, b, s, h, groups=8)
    alone = groupnorm_film_silu(x[:1].clone(), g, b, s[:1].clone(), h[:1].clone(), groups=8)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1])


@pytest.mark.cuda
def test_tiled_groupnorm_rejects_what_it_cannot_take(cuda_device):
    x, g, b, s, h = _inputs((2, 32, 32, 256), True, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="over the kernel"):
        groupnorm_film_silu(x, torch.ones(256, device=cuda_device),
                            torch.zeros(256, device=cuda_device), s, h, groups=128)
    with pytest.raises(ValueError, match="on cpu"):
        groupnorm_film_silu(x, g.cpu(), b, s, h)
    with pytest.raises(ValueError, match="contiguous"):
        G.gn_tiled_stats(x.transpose(1, 2))
    with pytest.raises(TypeError):
        G.gn_tiled_stats(x.half())
    partials = G.gn_tiled_stats(x)
    with pytest.raises(ValueError, match="partials"):
        G.gn_tiled_apply(x, partials[:1].contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="partials"):
        G.gn_tiled_apply(x, partials.cpu(), g, b, s, h)
