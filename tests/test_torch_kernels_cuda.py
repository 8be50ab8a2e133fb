"""The port's CUDA kernels against their plain PyTorch versions, on the card:
GroupNorm+FiLM+SiLU at the flagship's and the 256px chain's shapes (the
single-pass kernel, and past the row gate the tiled stats/apply pair at the
s2d-stem and 256px chains' large blocks), full attention (on strided,
contiguous and unaligned inputs, ragged token counts), the two
linear-attention passes (the kv kernel's launch plans and its in-kernel
merge, the q kernel's persistent grid, repeated and graph-replayed
launches; their attribution variants with every exponential a·0.5 + 1
and the bare copy kernel of the attribution script) and the fused
ResnetBlock's conv3x3_stats (each of
its shared-memory plans, persistent grids with more and fewer tiles than
blocks) and epilogue at the 256px chain's shapes (its persistent grids,
ragged last items), the single-pass GroupNorm's cluster plans (every
cluster size, resident and streamed slices), the inputs each wrapper
refuses, and a row alone against the same row in a batch.  Then the
classifier gate of the gated 256px configuration (its UNet at a 64px
input, where the fused blocks and linear attention engage): its scores
on the card against the CPU's, and a gate that always accepts, whose
chain equals the ungated chain bit for bit.  Last, the precision policy:
the shipped s2d-stem checkpoint's UNet call, entered with both TF32 flags
on, against the CPU at the stem's float32 bar.  Then training: each
kernel's autograd Function at the 256px shapes, its gradients with the
kernel's forward against the plain forward's autograd, and a row alone
against the same row in a batch.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from localdiffusion_tpu_torch.config import min_max_val_for, mri256_gated_config, stem256_config
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.factory import load_params
from localdiffusion_tpu_torch.models.blocks import ResnetBlock
from localdiffusion_tpu_torch.ops import copy_probe as CP
from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.attention import flash_attention, xla_attention
from localdiffusion_tpu_torch.ood.bank import classifier_calibration_pairs
from localdiffusion_tpu_torch.ood.classifier import ClassifierPatchCore
from localdiffusion_tpu_torch.ood.features import DenoiserFeatureSource
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.scripts import bench_linatt_attrib
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
# the six linear-attention sites of a 256px UNet call at batch 8, one whose
# blocks take uneven shares of tiles (72x72: 81 tiles over 16 blocks), and
# one whose token count leaves the last 64-token tile ragged (72x76: 5,472)
LINATT_SHAPES = [(8, 256, 256, 32), (8, 128, 128, 32), (8, 64, 64, 64),
                 (8, 64, 64, 128), (8, 128, 128, 64), (2, 72, 72, 32), (1, 72, 76, 32)]
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
    """The kv kernel's merged rows against the plain version's, row by row:
    m relative (both are the max of bf16-rounded k, at most one rounding
    step apart); then, with the kernel's l and G put on the plain version's
    max, l as relative L2 over its 128 columns and G as relative Frobenius
    over its C×128 (a norm over the row: one token whose k rounds a step
    apart moves one column, a fault moves the row)."""
    (m, l, g), (pm, pl, pg) = got, want
    r = torch.exp(m - pm)
    l, g = l * r, g * r[:, None, :]
    return dict(
        m=((m - pm).abs() / pm.abs().clamp_min(1e-6)).max().item(),
        l=((l - pl).norm(dim=1) / pl.norm(dim=1)).max().item(),
        g=((g - pg).norm(dim=(1, 2)) / pg.norm(dim=(1, 2))).max().item(),
    )


def _kv_ok(err):
    return err["m"] <= 2**-7 and err["l"] <= 1e-3 and err["g"] <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LINATT_SHAPES)
def test_linear_attention_kernels_match_plain_versions(cuda_device, shape):
    """Each pass against its plain version on the same inputs (kv, the
    merged row: m within 2^-7 relative, l within 1e-3 and G within 5e-3
    relative norm; q: the JAX bar atol 0.04 / rtol 0.05), and the two-pass
    function against the unfused plain version at the JAX bar plus
    correlation > 0.999."""
    b, h, w, c = shape
    x, (g_in, w_qkv, w_out, b_out, g_out) = _linatt_inputs(shape, cuda_device)
    xr = x.reshape(b, h * w, c)
    wq, wk, wv = LA.split_qkv(w_qkv)
    nb = LA.blocks_per_row(h * w)
    m, l, gram = LA.linear_attention_kv(xr, g_in, wk, nb)
    assert m.shape == l.shape == (b, LA.HIDDEN) and gram.shape == (b, c, LA.HIDDEN)
    err = _kv_errors((m, l, gram), LA.kv_reference(xr, g_in, wk, nb))
    assert _kv_ok(err), err
    wtil = LA.fold(l, gram, wv, w_out)
    got = LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out)
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


# the attribution variants (kLin) at the kv plans below and the attribution
# script's shape: l and G relative L2 over a row (a max one bf16 step apart
# moves every later a * 0.5 + 1 of its column), q given W~ at the q pass's
# bar on its well-conditioned tokens (the script's `q_agreement`)
LIN_KV_TOL = dict(m=2**-7, l=2e-2, g=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,nb", [(2, 256, 32, 16), (1, 5472, 32, 16), (2, 4096, 128, 64),
                                      (8, 65536, 32, 32)])
def test_linear_exp_variants_match_plain_versions(cuda_device, b, n, c, nb):
    """`kv_linear_exp` against `kv_linear_reference` (the kernel's tile
    recurrence, the merge with a * 0.5 + 1 weights) row by row, and
    `q_linear_exp` against `q_pass_reference(exp=lin_exp)` given the same
    W~, each counted once a launch; the main path's kernels unmoved."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + c + 7)
    x = (torch.randn(b, n, c, generator=gen, device=cuda_device) * 1.5).to(torch.bfloat16)
    g_in = torch.randn(c, generator=gen, device=cuda_device)
    w_qkv = torch.randn(c, 3 * LA.HIDDEN, generator=gen, device=cuda_device) * 0.1
    w_out = torch.randn(LA.HIDDEN, c, generator=gen, device=cuda_device) * 0.1
    b_out = torch.randn(c, generator=gen, device=cuda_device)
    g_out = torch.randn(c, generator=gen, device=cuda_device)
    wq, wk, wv = LA.split_qkv(w_qkv)
    before = (LA.kv_linear_exp.launches, LA.q_linear_exp.launches,
              LA.linear_attention_kv.launches)
    got = LA.kv_linear_exp(x, g_in, wk, nb)
    err = _kv_errors(got, LA.kv_linear_reference(x, g_in, wk, nb))
    assert all(err[k] <= tol for k, tol in LIN_KV_TOL.items()), err
    wtil = LA.fold(got[1], got[2], wv, w_out)
    q = LA.q_linear_exp(x, g_in, wq, wtil, b_out, g_out)
    want = LA.q_pass_reference(x, g_in, wq, wtil, b_out, g_out, exp=LA.lin_exp)
    agree = bench_linatt_attrib.q_agreement(q, want, LA.q_linear_conditioning(x, g_in, wq))
    assert agree["ok"], agree
    assert (LA.kv_linear_exp.launches, LA.q_linear_exp.launches,
            LA.linear_attention_kv.launches) == (before[0] + 1, before[1] + 1, before[2])
    # the exponential instantiation still gives the main path's answer
    err = _kv_errors(LA.linear_attention_kv(x, g_in, wk, nb), LA.kv_reference(x, g_in, wk, nb))
    assert _kv_ok(err), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,tile", [(8, 65536, 32, 8192), (8, 65536, 32, 65536),
                                        (8, 65536, 32, 1024), (2, 1000, 32, 40), (1, 64, 8, 2)])
def test_copy_probe_copies_bit_for_bit(cuda_device, b, n, c, tile):
    """The copy kernel at the attribution script's three grids (64, 8 and
    512 programs) and at small tiles equals its plain version, x.clone(),
    bit for bit; one count a launch."""
    x = torch.randn(b, n, c, device=cuda_device).to(torch.bfloat16)
    before = CP.copy_tiles.launches
    out = CP.copy_tiles(x, tile)
    torch.cuda.synchronize()
    assert torch.equal(out, x.clone()) and out.data_ptr() != x.data_ptr()
    assert CP.copy_tiles.launches == before + 1
    with pytest.raises(ValueError):
        CP.copy_tiles(x, 3 if n % 3 else 7)


# the kv kernel's launch plans, (B, N, C, nb): blocks without tokens and
# blocks of one tile (256 tokens over 16 blocks), one cluster a row (8
# blocks), a row that spans many clusters with several tiles a block, a
# ragged last tile (5,472 tokens), and the widest channels at the most
# blocks a row
KV_PLANS = [(2, 256, 32, 16), (3, 4096, 64, 8), (2, 65536, 32, 32), (1, 5472, 32, 16),
            (2, 4096, 128, 64), (4, 16384, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,nb", KV_PLANS)
def test_kv_kernel_launch_plans(cuda_device, b, n, c, nb):
    """Each plan's merged rows against the plain version's at the bars
    above, and a second launch equal to the first bit for bit (the per-row
    counters were left at zero, the merge runs in block order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + c)
    x = (torch.randn(b, n, c, generator=gen, device=cuda_device) * 1.5).to(torch.bfloat16)
    g_in = torch.randn(c, generator=gen, device=cuda_device) * 0.2 + 1.0
    wk = (torch.randn(c, LA.HIDDEN, generator=gen, device=cuda_device) * 0.1).to(torch.bfloat16)
    first = LA.linear_attention_kv(x, g_in, wk, nb)
    err = _kv_errors(first, LA.kv_reference(x, g_in, wk, nb))
    assert _kv_ok(err), err
    again = LA.linear_attention_kv(x, g_in, wk, nb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, f) for a, f in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5, 200])
def test_q_kernel_at_any_grid(cuda_device, b):
    """The q kernel's persistent grid gives rows many blocks (batch 1), a
    few (5) or one each (200 rows of 4,096 tokens, more rows than the card
    holds blocks), against the plain version at the JAX bar."""
    shape = (b, 64, 64, 32)
    x, (g_in, w_qkv, w_out, b_out, g_out) = _linatt_inputs(shape, cuda_device, seed=b)
    xr = x.reshape(b, 4096, 32)
    wq, wk, wv = LA.split_qkv(w_qkv)
    _, l, gram = LA.linear_attention_kv(xr, g_in, wk, LA.blocks_per_row(4096))
    wtil = LA.fold(l, gram, wv, w_out)
    got = LA.linear_attention_q(xr, g_in, wq, wtil, b_out, g_out)
    want = LA.q_pass_reference(xr, g_in, wq, wtil, b_out, g_out)
    torch.testing.assert_close(got.float(), want.float(), atol=0.04, rtol=0.05)


@pytest.mark.cuda
def test_linear_attention_repeated_launches_are_equal(cuda_device):
    """Launches in a row, with another batch's launch between them and in a
    CUDA graph's replays, give equal results: the kv kernel leaves its
    per-row counters at zero."""
    x, params = _linatt_inputs((4, 64, 64, 64), cuda_device)
    first = LA.linear_attention(x, *params)
    LA.linear_attention(x[:3].contiguous(), *params)
    second = LA.linear_attention(x, *params)
    static = x.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        LA.linear_attention(static, *params)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = LA.linear_attention(static, *params)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(second, first) and torch.equal(out, first)


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
    xr = x.reshape(2, -1, 32)
    with pytest.raises(TypeError):
        LA.linear_attention_kv(xr, params[0], wk.float(), 16)
    with pytest.raises(ValueError, match="multiple"):
        LA.linear_attention_kv(xr, params[0], wk, 12)
    # data off a 16-byte boundary (the kernels copy 16 bytes at a time)
    off = torch.empty(xr.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    off = off.view_as(xr).copy_(xr)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        LA.linear_attention_kv(off, params[0], wk, 16)
    wtil = torch.zeros(2, LA.HIDDEN, 32, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        LA.linear_attention_q(off, params[0], wq, wtil, params[3], params[4])


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


# the single-pass kernel's plans (`gn_plan`) at the sites of the three
# configurations: the flagship's five at batch 128 (k = 8, 2, 4, 1, 2 in
# f32), the stem's 64x64x32 ... 16x16x128 and the 256px chain's 32x32x128
# at batch 8 (k = 16, 16, 8, 16), and a row past the resident limit (the
# streamed branch)
GN_PLAN_SHAPES = [(128, 28, 28, 32), (128, 14, 14, 32), (128, 14, 14, 64), (128, 7, 7, 64),
                  (128, 7, 7, 128), (8, 64, 64, 32), (8, 32, 32, 64), (8, 16, 16, 128),
                  (8, 32, 32, 128), (8, 256, 256, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_PLAN_SHAPES)
def test_single_pass_groupnorm_row_alone_equals_row_in_batch(cuda_device, shape, dtype):
    """The plan comes from h, w, c, the groups and the dtype alone and fixes
    the order of every sum: row 0 by itself, and rows 0-3 as a batch of 4,
    give bit for bit what they give inside the whole batch (with FiLM), and
    the batch is within `GN_TOL` of the plain version."""
    x, g, b, s, h = _inputs(shape, True, dtype, cuda_device)
    whole = groupnorm_film_silu_single_pass(x, g, b, s, h, groups=8)
    alone = groupnorm_film_silu_single_pass(x[:1].clone(), g, b, s[:1].clone(), h[:1].clone(),
                                            groups=8)
    four = groupnorm_film_silu_single_pass(x[:4].clone(), g, b, s[:4].clone(), h[:4].clone(),
                                           groups=8)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1]) and torch.equal(four, whole[:4])
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    torch.testing.assert_close(whole.float(), want.float(), rtol=tol, atol=tol)


def single_pass_digests() -> dict:
    """SHA-256 (first 16 hex digits) of the single-pass kernel's output at
    each `GN_PLAN_SHAPES` site (batch 2, FiLM) in both dtypes, on inputs
    made with numpy from seed 0: the kernel's results, bit for bit."""
    import hashlib

    import numpy as np

    out = {}
    for shape in GN_PLAN_SHAPES:
        shape = (2,) + shape[1:]
        c = shape[3]
        rng = np.random.default_rng(0)
        x, g, b, s, h = (torch.as_tensor(a).cuda() for a in (
            rng.standard_normal(shape, dtype=np.float32) * 1.5 + 0.3,
            rng.standard_normal(c, dtype=np.float32), rng.standard_normal(c, dtype=np.float32),
            rng.standard_normal((2, c), dtype=np.float32),
            rng.standard_normal((2, c), dtype=np.float32)))
        for dtype in (torch.float32, torch.bfloat16):
            y = groupnorm_film_silu_single_pass(x.to(dtype), g, b, s, h, groups=8)
            digest = hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16]
            out[f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"] = digest
    return out


# `single_pass_digests()` of the single-pass kernel as it was built before
# its 16-byte and cluster-launch helpers moved into
# csrc/groupnorm_common.cuh, on an NVIDIA H100 80GB HBM3 with nvcc 12.9
# (V12.9.86).  They pin the single pass's arithmetic while code it shares
# is reworked.  Two changes move them with no fault in the program: another
# compiler, and a change meant to alter the single pass's results (its
# division, its sum order); take them again then, from a build of the
# source as it stood before that change
SINGLE_PASS_DIGESTS = {
    "2x28x28x32 float32": "2461bbdcc576bd52", "2x28x28x32 bfloat16": "2e184c83de9288bd",
    "2x14x14x32 float32": "fc3c70fe45cef6b4", "2x14x14x32 bfloat16": "76aec31999b38556",
    "2x14x14x64 float32": "d02fa6e6f7400289", "2x14x14x64 bfloat16": "4399eeca7039a0ff",
    "2x7x7x64 float32": "9466e88528f5c396", "2x7x7x64 bfloat16": "c556d14aaef5c084",
    "2x7x7x128 float32": "2856dc2e52bcc969", "2x7x7x128 bfloat16": "a557383e8dceaedd",
    "2x64x64x32 float32": "773d0eaad8793d4c", "2x64x64x32 bfloat16": "9a06727dbb7e1c34",
    "2x32x32x64 float32": "60c3ebc161ab0921", "2x32x32x64 bfloat16": "0ef1f761665292f1",
    "2x16x16x128 float32": "27bfdef5b2e57d7a", "2x16x16x128 bfloat16": "c5dcecf78d61730d",
    "2x32x32x128 float32": "81c2327cebc28922", "2x32x32x128 bfloat16": "4152325bbc8e5b33",
    "2x256x256x32 float32": "358136434535013d", "2x256x256x32 bfloat16": "031227a18de53f8b",
}


@pytest.mark.cuda
def test_single_pass_groupnorm_is_bit_unchanged(cuda_device):
    """The single-pass kernel gives, bit for bit, what it gave before its
    helpers moved into the header it shares with the tiled pair."""
    assert single_pass_digests() == SINGLE_PASS_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_pass_groupnorm_cluster_sizes(cuda_device, dtype, k):
    """Every cluster size the plans use (16 a non-portable cluster), with
    the last block's slice ragged (475 pixels), resident and streamed: each
    within `GN_TOL` of the plain version, and the streamed branch equal to
    the resident one bit for bit (the same sums in the same order)."""
    shape = (3, 25, 19, 64)
    x, g, b, s, h = _inputs(shape, True, dtype, cuda_device)
    esize, pixels = x.element_size(), -(-25 * 19 // k)
    got = {}
    for resident in (True, False):
        plan = dict(k=k, pixels=pixels, resident=resident,
                    smem=G.gn_smem(pixels, 64, 8, esize, resident))
        got[resident] = G._launch(x, g, b, s, h, 8, 1e-5, plan)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    torch.testing.assert_close(got[True].float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got[True], got[False])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 128, 32), (8, 64, 64, 128)])
def test_linear_attention_row_alone_equals_row_in_batch(cuda_device, shape):
    """The kernels' blocks come from the token count alone and the kv merge
    runs in block order: row 0 by itself (batch 1), and rows 0-3 as a batch
    of 4, give, bit for bit, what they give inside a batch of 8."""
    x, params = _linatt_inputs(shape, cuda_device)
    whole = LA.linear_attention(x, *params)
    alone = LA.linear_attention(x[:1].clone(), *params)
    four = LA.linear_attention(x[:4].clone(), *params)
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1]) and torch.equal(four, whole[:4])


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


def _epi_inputs(shape, c, device, seed=0):
    """h2, x, a, b and, where Cin ≠ C, a res_conv (w_res, b_res) for the
    epilogue, seeded."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sz: torch.randn(*sz, generator=gen, device=device)
    bsz, hh, ww, cin = shape
    x = (r(*shape) * 0.5).to(torch.bfloat16)
    h2 = (r(bsz, hh, ww, c) * 2.0).to(torch.bfloat16)
    a, b = r(bsz, c) * 0.5 + 1.0, r(bsz, c) * 0.3
    wr = br = None
    if cin != c:
        wr = (r(c, cin) * cin**-0.5).to(torch.bfloat16)
        br = r(c) * 0.1
    return h2, x, a, b, wr, br


# the epilogue at the six shapes of the 256px chain's 13 fused blocks (batch
# 8; the last three with the res_conv), and ragged ones: 720 and 480 pixels
# (the last 64-pixel item of a row holds 16 and 32), Cin 48 and 8 (K
# rounded up to 32 with zeros)
EPI_SITES = [((8, 256, 256, 32), 32), ((8, 128, 128, 32), 32), ((8, 64, 64, 64), 64),
             ((8, 64, 64, 192), 128), ((8, 128, 128, 96), 64), ((8, 256, 256, 64), 32),
             ((3, 20, 36, 48), 64), ((2, 12, 40, 8), 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c", EPI_SITES)
def test_epilogue_row_alone_equals_row_in_batch(cuda_device, shape, c):
    """A pixel's output depends on nothing but its own inputs, whatever run
    of items its block walks: row 0 alone gives bit for bit what it gives
    in the batch, and the batch is within one bf16 step of its terms of
    the plain version (atol 2^-6, rtol 2^-7, `RB_TOL`)."""
    h2, x, a, b, wr, br = _epi_inputs(shape, c, cuda_device)
    before = RB.epilogue.launches
    whole = RB.epilogue(h2, x, a, b, wr, br)
    alone = RB.epilogue(h2[:1].clone(), x[:1].clone(), a[:1].clone(), b[:1].clone(), wr, br)
    torch.cuda.synchronize()
    assert RB.epilogue.launches == before + 2
    assert torch.equal(alone, whole[:1])
    want = RB.epilogue_reference(h2, x, a, b, wr, br)
    torch.testing.assert_close(whole.float(), want.float(), atol=2**-6, rtol=2**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3, 1000])
@pytest.mark.parametrize("shape,c", [((3, 20, 36, 48), 64), ((2, 30, 30, 32), 32),
                                     ((2, 12, 40, 96), 128), ((1, 10, 30, 256), 32)])
def test_epilogue_plans(cuda_device, shape, c, blocks):
    """Persistent grids of 1, 3 and 1000 blocks (each warpgroup or thread
    walking many items, or fewer items than blocks), ragged last items, Cin
    up to the kernel's 256: the output equals the default grid's bit for
    bit."""
    h2, x, a, b, wr, br = _epi_inputs(shape, c, cuda_device, seed=7)
    got = RB._launch_epilogue(h2, x, a, b, wr, br, dict(blocks=blocks))
    want = RB.epilogue(h2, x, a, b, wr, br)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
# row that the plan's slices and tiles leave ragged (1,935 pixels: 8 slices
# of 242, tiles of 85), and more channels than a block has threads
TILED_SHAPES = [(8, 128, 128, 32), (8, 64, 64, 64), (8, 32, 32, 256), (2, 43, 45, 96),
                (1, 24, 24, 512)]


def _bf16_steps(got, want):
    """|got - want| in bf16 steps at max(|got|, |want|), largest."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()).clamp_min(1e-30))
    return ((got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)).max().item()


def _rel_per_row(got, want):
    """Largest relative norm of got − want over the rows of [B, ...]."""
    return ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_groupnorm_matches_plain_version(cuda_device, shape, film, dtype):
    """Past the gate the dispatcher launches the stats pass and the apply
    pass once each, and no single-pass kernel.  Against the plain tiled
    version: f32 3e-5 (the JAX bar for its tiled kernel; the sums run in
    another order), bf16 one output step (both round the same float32
    value once: the row sums, summed in float64 on both sides, round to
    the same floats).  Besides, the output equals, bit for bit, the plain
    apply on the kernel's own row sums (the apply keeps the plain
    version's rounding points), and those sums are within 1e-5 relative
    norm per row of the plain sums."""
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
    sums = G.gn_tiled_stats(x)
    assert torch.equal(got, G.tiled_apply_reference(x, sums, g, b, s, h, groups=8))
    assert _rel_per_row(sums, G.tiled_stats_reference(x)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_tiled_stats_partials_match_plain_per_row(cuda_device, shape, dtype):
    """The stats pass's row sums [B, 2, C] against the plain version's:
    relative norm per row <= 1e-5 (both sum in float64 and round once, so
    a sound kernel reads 0 but for a rare tie), a bar that the sums with
    one block's slice dropped fail."""
    x = _inputs(shape, False, dtype, cuda_device)[0]
    got = G.gn_tiled_stats(x)
    torch.cuda.synchronize()
    want = G.tiled_stats_reference(x)
    assert got.shape == want.shape == (shape[0], 2, shape[3]) and got.dtype == torch.float32
    assert _rel_per_row(got, want) <= 1e-5
    plan = G.gn_tiled_plan(*shape[1:], dtype)
    j = plan["k"] // 2
    dropped = x.reshape(shape[0], -1, shape[3]).clone()
    dropped[:, j * plan["pixels"]:(j + 1) * plan["pixels"]] = 0
    assert _rel_per_row(G.tiled_stats_reference(dropped.view(shape)), want) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_pair_cluster_sizes(cuda_device, dtype, k):
    """Every cluster size the plan can choose (k = min(16, h·w); 16 a
    non-portable cluster), with ragged and empty last slices (1,800 pixels
    at k = 16: 113 a block), and apply tiles of 1, 7 and the plan's
    pixels: the sums within 1e-5 relative norm per row of the plain sums of
    the same slices, the apply on them within the pair's bar of its plain
    version, every tile giving the same output bit for bit, and so the
    apply launched as the stats pass's programmatic dependent."""
    shape = (3, 40, 45, 96)
    x, g, b, s, h = _inputs(shape, True, dtype, cuda_device)
    pixels = -(-40 * 45 // k)
    plan = dict(k=k, pixels=pixels)
    sums = G._launch_stats(x, plan)
    outs = [G._launch_apply(x, sums, g, b, s, h, 8, 1e-5, dict(apply_pixels=t))
            for t in (1, 7, G.gn_tiled_plan(40, 45, 96, dtype)["apply_pixels"])]
    # the apply as the stats pass's programmatic dependent, as the dispatcher
    # launches it: the same sums and output
    again = G._launch_stats(x, plan)
    outs.append(G._launch_apply(x, again, g, b, s, h, 8, 1e-5, dict(apply_pixels=7),
                                after_stats=True))
    torch.cuda.synchronize()
    assert torch.equal(again, sums)
    assert _rel_per_row(sums, G._slice_sums(x, pixels)) <= 1e-5
    want = G.tiled_apply_reference(x, sums, g, b, s, h, groups=8)
    if dtype == torch.float32:
        torch.testing.assert_close(outs[0], want, rtol=3e-5, atol=3e-5)
    else:
        assert _bf16_steps(outs[0], want) <= 1.0
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


RCP_CHECK = r"""
#include <cstdio>
#include "groupnorm_common.cuh"
// every float z in [1, 2^128): gn::rcp_rn_fast(z) against __frcp_rn(z),
// mismatches below 2^126 in bad[0], above it in bad[1]
__global__ void check(unsigned long long* bad) {
  const unsigned lo = 0x3f800000u, n = 0x7f800000u - lo;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float z = __uint_as_float(lo + i);
    if (__float_as_uint(gn::rcp_rn_fast(z)) != __float_as_uint(__frcp_rn(z)))
      atomicAdd(bad + (z >= 0x1p126f), 1ull);
  }
}
int main() {
  unsigned long long* d;
  unsigned long long h[2];
  cudaMalloc(&d, sizeof h);
  cudaMemset(d, 0, sizeof h);
  check<<<132 * 16, 256>>>(d);
  if (cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost) != cudaSuccess) return 1;
  printf("%llu %llu\n", h[0], h[1]);
  return 0;
}
"""


@pytest.mark.cuda
def test_fast_reciprocal_is_frcp_rn_on_its_range(cuda_device, tmp_path):
    """The apply pass's SiLU takes `rcp_rn_fast` (no slow-path branch) for
    1 + e^-y below 2^126 and __frcp_rn above: the two agree bit for bit on
    every float of [1, 2^126), so the output is __frcp_rn's, the plain
    version's reciprocal.  Above 2^126 (a subnormal 1/z) they differ, which
    is why the kernel leaves that range to __frcp_rn."""
    import subprocess

    from localdiffusion_tpu_torch.ops import _build

    src, exe = tmp_path / "rcp_check.cu", tmp_path / "rcp_check"
    src.write_text(RCP_CHECK)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-I", str(_build.CSRC), "-o", str(exe), str(src)], check=True)
    below, above = map(int, subprocess.run([str(exe)], capture_output=True, text=True,
                                           check=True).stdout.split())
    assert below == 0 and above > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128, 128, 32), (8, 32, 32, 256)])
def test_tiled_groupnorm_row_alone_equals_row_in_batch(cuda_device, shape, dtype):
    """The plan comes from h, w, c and the dtype alone and the folds run in
    a fixed order: row 0 alone equals row 0 of the batch of 8, bit for bit,
    in the row sums and in the output."""
    x, g, b, s, h = _inputs(shape, True, dtype, cuda_device)
    whole = groupnorm_film_silu(x, g, b, s, h, groups=8)
    alone = groupnorm_film_silu(x[:1].clone(), g, b, s[:1].clone(), h[:1].clone(), groups=8)
    sums, sums_alone = G.gn_tiled_stats(x), G.gn_tiled_stats(x[:1].clone())
    torch.cuda.synchronize()
    assert torch.equal(alone, whole[:1]) and torch.equal(sums_alone, sums[:1])


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
    sums = G.gn_tiled_stats(x)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums[:1].contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums.cpu(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):  # per-tile partials, [B, tiles, 2, C]
        G.gn_tiled_apply(x, sums[:, None].contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums.transpose(1, 2).contiguous(), g, b, s, h)
    # the kernels read 16-byte chunks: C·esize a multiple of 16, x aligned
    odd = torch.zeros(1, 128, 128, 12, dtype=torch.bfloat16, device=cuda_device)
    assert G.large_block(odd.shape)
    with pytest.raises(ValueError, match="16-byte chunks"):
        G.gn_tiled_stats(odd)
    with pytest.raises(ValueError, match="16-byte chunks"):
        groupnorm_film_silu(odd, torch.ones(12, device=cuda_device),
                            torch.zeros(12, device=cuda_device), groups=4)
    off = torch.zeros(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        G.gn_tiled_stats(off)
    with pytest.raises(ValueError, match="16-byte boundary"):
        G.gn_tiled_apply(off, sums, g, b, s, h)


# ---------------------------------------------------------------------------
# the classifier gate (the gated 256px configuration at a 64px input)
# ---------------------------------------------------------------------------

def _gated64(dtype: str, device):
    """`mri256_gated_config()` at 64px and T=8 in `dtype`, its engine on
    `device` with weights drawn on the CPU from seed 0."""
    base = mri256_gated_config()
    cfg = base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=64, timesteps=8),
        ood=dataclasses.replace(base.ood, input_size=64, memory_bank_path=None),
        train=dataclasses.replace(base.train, compute_dtype=dtype))
    torch.manual_seed(0)
    cpu = build_gd(cfg, device="cpu")
    gd = build_gd(cfg, device=device)
    gd.model.load_state_dict(cpu.model.state_dict())
    return cfg, cpu, gd


def _flair(cfg, n, seed, tumor=False):
    d = cfg.data
    return synthetic_brain_translation(n, 64, tumor=tumor, seed=seed, mean_t1=d.mean_t1,
                                       std_t1=d.std_t1, mean_flair=d.mean_flair,
                                       std_flair=d.std_flair)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_classifier_gate_on_the_card_matches_the_cpu(cuda_device, dtype, tol):
    """The same bank (built on the CPU) and weights: the card's scores
    within `tol` relative L2 of the CPU's (f32: summation order, TF32 off;
    bf16: independent rounding through the taps), as a [B] float32 tensor
    on the card, and the gate's value is sign · (score − threshold)."""
    cfg, cpu, gd = _gated64(dtype, cuda_device)
    src = lambda g: DenoiserFeatureSource(g, t=cfg.ood.feature_t)
    pc_cpu = PatchCore(cfg.ood, source=src(cpu))
    bank = pc_cpu.build_memory_bank([_flair(cfg, 4, 11)[0]], sampling_ratio=0.05)
    pc_card = PatchCore(cfg.ood, source=src(gd), memory_bank=bank)
    x = np.concatenate([img for img, _ in classifier_calibration_pairs(cfg, n=3)])
    want = ClassifierPatchCore(pc_cpu).score_raw(x).numpy()
    cls = ClassifierPatchCore(pc_card, threshold=float(np.median(want)))
    got = cls.score_raw(torch.as_tensor(x, device=cuda_device))
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == (6,)
    got = got.cpu().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= tol
    gate = cls.as_sampler_gate("suppress")(torch.as_tensor(x, device=cuda_device), 4)
    np.testing.assert_allclose(gate.cpu().numpy(), -(got - np.float32(cls.threshold)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_gated_always_accept_equals_ungated_on_the_card(cuda_device):
    """bf16 with the kernels: a gate that always accepts latches at the
    first post-fusion step (t = 4), and the image equals the ungated
    chain's with the same seed bit for bit; the retry drew from its own
    stream, the main stream is the same."""
    cfg, _, gd = _gated64("bfloat16", cuda_device)
    lr = torch.as_tensor(_flair(cfg, 2, 7, tumor=True)[1], device=cuda_device)
    mask = torch.zeros(2, 64, 64, 1, device=cuda_device)
    mask[0, 16:40, 12:36] = 1.0
    mask[1, 28:52, 24:48] = 1.0
    calls = []
    accept = lambda xs, t: calls.append(t) or torch.ones(xs.shape[0], device=xs.device)
    mmv = min_max_val_for(cfg)
    gated, ft = TS.ddpm_sample_branched(gd, lr, mask, cfg.sampler, mmv, noise=3,
                                        classifier_fn=accept, return_fusion_time=True)
    ungated = TS.ddpm_sample_branched(
        gd, lr, mask, dataclasses.replace(cfg.sampler, classifier=False), mmv, noise=3)
    torch.cuda.synchronize()
    assert calls == [4] and ft.tolist() == [4, 4]
    assert torch.equal(gated, ungated)


@pytest.mark.cuda
def test_stem_unet_with_tf32_on_matches_the_cpu(cuda_device):
    """The shipped s2d-stem denoiser (f32, 256px, batch 2) entered with
    both TF32 flags on: its every call turns them off for itself, so the
    card holds the CPU's float32 within 1e-3 abs+rel, and the flags are on
    again after."""
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "mri_stem256_ema.npz")
    cfg = stem256_config()
    card = load_params(cfg, params_npz=npz, device=cuda_device, verbose=False)
    cpu = load_params(cfg, params_npz=npz, device="cpu", verbose=False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256, 256, 1)).astype(np.float32)
    cond = rng.uniform(0, 14, (2, 256, 256, 1)).astype(np.float32)
    t = np.array([9, 201])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    got = card.apply_model(torch.as_tensor(x, device=cuda_device),
                           torch.as_tensor(cond, device=cuda_device),
                           torch.as_tensor(t, device=cuda_device)).cpu().numpy()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    want = cpu.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the kernels' autograd Functions (training)
# ---------------------------------------------------------------------------
# Each Function's backward is autograd through the plain reference on the
# saved inputs, so with the kernel's forward its gradients are the plain
# forward's autograd on the same inputs, within 1e-3 relative L2: cuDNN
# may split the same convolution's backward otherwise from call to call,
# which moves a bf16 value by a rounding step (105 of 12.6 million at the
# res_conv block's x; 1 of 9,216 in a conv weight's float32 gradient,
# which the conv reads in bf16; NVIDIA H100 80GB HBM3, 700 W).  A row alone against the same row in a batch:
# PyTorch may reduce another batch in another order, which moves a bf16
# gradient by a rounding step here and there: relative L2 <= 2e-3.

def _grads_of(fn, inputs, cot):
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, cot)


def _assert_same_grads(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).norm() / w.float().norm()) <= 1e-3


def _row0_alone(fn, batched_inputs, row_inputs, cot):
    """Row 0's gradients (of the batched inputs) from a batch of B and from
    row 0 alone."""
    _, whole = _grads_of(fn, batched_inputs, cot)
    _, alone = _grads_of(fn, [t[:1].clone() for t in row_inputs]
                         + [t for t in batched_inputs[len(row_inputs):]], cot[:1].clone())
    for g, a in zip(whole[:len(row_inputs)], alone[:len(row_inputs)]):
        rel = float((g[:1].float() - a.float()).norm() / a.float().norm())
        assert rel <= 2e-3, rel


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 32, 128), (8, 32, 32, 256)], ids=["single", "tiled"])
def test_groupnorm_function_gradient_is_the_plain_autograd(cuda_device, shape):
    x, g, b, s, h = _inputs(shape, True, torch.bfloat16, cuda_device)
    cot = torch.randn(shape, device=cuda_device).to(torch.bfloat16)
    counter = G.gn_tiled_apply if G.large_block(shape) else groupnorm_film_silu
    before = counter.launches
    out, got = _grads_of(lambda *a: groupnorm_film_silu(*a, groups=8), (x, g, b, s, h), cot)
    assert counter.launches == before + 1  # the forward is the kernel's
    assert type(out.grad_fn).__name__ == "GroupNormFilmSiLUFnBackward"
    _, want = _grads_of(lambda *a: groupnorm_film_silu_reference(*a, groups=8), (x, g, b, s, h),
                        cot)
    _assert_same_grads(got, want)
    fn = lambda xx, ss, hh, gg, bb: groupnorm_film_silu(xx, gg, bb, ss, hh, groups=8)
    _row0_alone(fn, [x, s, h, g, b], [x, s, h], cot)


@pytest.mark.cuda
def test_attention_function_gradient_is_the_plain_autograd(cuda_device):
    b, n, heads, d = 8, 1024, 4, 32
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, 3 * heads * d, 32, 32, generator=gen, device=cuda_device)
    qkv = qkv.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cot = torch.randn(b, n, heads, d, generator=gen, device=cuda_device).to(torch.bfloat16)

    def views(t):
        return [u.permute(0, 3, 1, 2) for u in t.reshape(t.shape[0], 3, heads, d, n).unbind(1)]

    before = flash_attention.launches
    out, got = _grads_of(lambda t: flash_attention(*views(t)), [qkv], cot)
    assert flash_attention.launches == before + 1
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    _, want = _grads_of(lambda t: xla_attention(*views(t)), [qkv], cot)
    _assert_same_grads(got, want)
    _row0_alone(lambda t: flash_attention(*views(t)), [qkv], [qkv], cot)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 256, 256, 32), (8, 128, 128, 64), (8, 64, 64, 128)])
def test_linear_attention_function_gradient_is_the_plain_autograd(cuda_device, shape):
    x, params = _linatt_inputs(shape, cuda_device)
    cot = (torch.randn(shape, device=cuda_device) * 0.1).to(torch.bfloat16)
    before = LA.linear_attention_kv.launches, LA.linear_attention_q.launches
    out, got = _grads_of(LA.linear_attention, [x, *params], cot)
    assert (LA.linear_attention_kv.launches, LA.linear_attention_q.launches) == (
        before[0] + 1, before[1] + 1)
    assert type(out.grad_fn).__name__ == "LinearAttentionFnBackward"
    _, want = _grads_of(LA.linear_attention_reference, [x, *params], cot)
    _assert_same_grads(got, want)
    _row0_alone(LA.linear_attention, [x, *params], [x], cot)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dim_out", [((8, 256, 256, 32), 32), ((8, 128, 128, 96), 64)],
                         ids=["identity", "res_conv"])
def test_fused_block_function_gradient_is_the_plain_autograd(cuda_device, shape, dim_out):
    mod = _rb_block(shape[-1], dim_out, cuda_device)
    x, ss = _rb_inputs(shape, dim_out, cuda_device)
    cot = (torch.randn(shape[:3] + (dim_out,), device=cuda_device) * 0.1).to(torch.bfloat16)
    named = [(n, p) for n, p in mod.named_parameters() if not n.startswith("mlp.")]
    names, params = [n for n, _ in named], [p for _, p in named]  # the FiLM comes as ss
    before = RB.conv3x3_stats.launches, RB.epilogue.launches
    leaves = [t.detach().requires_grad_(True) for t in (x, *ss)]
    out = RB.resnet_block_fused(leaves[0], mod, (leaves[1], leaves[2]))
    assert (RB.conv3x3_stats.launches, RB.epilogue.launches) == (before[0] + 2, before[1] + 1)
    assert type(out.grad_fn).__name__ == "ResnetBlockFnBackward"
    got = torch.autograd.grad(out, leaves + params, cot)
    ref = RB.resnet_block_reference(leaves[0], mod, (leaves[1], leaves[2]))
    want = torch.autograd.grad(ref, leaves + params, cot)
    assert all(float(g.abs().max()) > 0 for g in got), names  # every parameter reached
    _assert_same_grads(got, want)
    row = [t[:1].clone().requires_grad_(True) for t in (x, *ss)]
    alone = torch.autograd.grad(RB.resnet_block_fused(row[0], mod, (row[1], row[2])), row,
                                cot[:1].clone())
    for g, a in zip(got[:3], alone):
        assert float((g[:1].float() - a.float()).norm() / a.float().norm()) <= 2e-3


# ---------------------------------------------------------------------------
# the self-conditioned denoiser (learned Fourier time features)
# ---------------------------------------------------------------------------

COUNTED = (G.groupnorm_film_silu, G.gn_tiled_stats, G.gn_tiled_apply, flash_attention,
           LA.linear_attention_kv, LA.linear_attention_q, RB.conv3x3_stats, RB.epilogue)


@pytest.mark.cuda
def test_self_conditioned_bf16_unet_kernels_match_plain_versions(cuda_device):
    """`mri256_config()` with self-conditioning and learned Fourier
    features, bf16, batch 2 at 256px, `x_self_cond` given: one UNet call
    with the kernels (each of the eight launched) against the plain
    versions on the card at the one-UNet-call bars (relative L2 <= 5e-2,
    correlation >= 0.999); then a loss with the coin on heads launches
    each kernel twice a call's count (the pre-pass and the grad pass) and
    its backward none."""
    from localdiffusion_tpu_torch.config import mri256_config
    from localdiffusion_tpu_torch.diffusion.gaussian import ArrayDraws

    base = mri256_config()
    cfg = base.replace(model=dataclasses.replace(base.model, self_condition=True,
                                                 learned_sinusoidal_cond=True))
    gd = build_gd(cfg, device=cuda_device)
    rng = np.random.default_rng(5)
    x, sc = (torch.as_tensor(rng.standard_normal((2, 256, 256, 1)), dtype=torch.float32,
                             device=cuda_device) for _ in range(2))
    cond = torch.as_tensor(rng.uniform(0, 14, (2, 256, 256, 1)), dtype=torch.float32,
                           device=cuda_device)
    t = torch.tensor([7, 180], device=cuda_device)
    before = [k.launches for k in COUNTED]
    with torch.no_grad():
        got = gd.model(x, cond, t, x_self_cond=sc).float().cpu()
    call = [k.launches - b for k, b in zip(COUNTED, before)]
    assert all(n > 0 for n in call), call
    gd.model.use_plain_kernels(True)
    try:
        with torch.no_grad():
            want = gd.model(x, cond, t, x_self_cond=sc).float().cpu()
    finally:
        gd.model.use_plain_kernels(False)
    rel = float((got - want).norm() / want.norm())
    corr = float(np.corrcoef(got.numpy().ravel(), want.numpy().ravel())[0, 1])
    assert rel <= 5e-2 and corr >= 0.999, (rel, corr)
    before = [k.launches for k in COUNTED]
    draws = ArrayDraws(cuda_device, [t.cpu().numpy()], [np.zeros((2, 256, 256, 1), np.float32)],
                       coins=[True])
    loss = gd.loss(x.clamp(0, 2), cond, draws)
    assert [k.launches - b for k, b in zip(COUNTED, before)] == [2 * n for n in call]
    mid = [k.launches for k in COUNTED]
    loss.backward()
    assert [k.launches for k in COUNTED] == mid
    assert float(gd.model.time_mlp.pos_emb.weights.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# Stage B as compiled programs (diffusion.compiled): captured chains
# ---------------------------------------------------------------------------

def _chain_inputs(cfg, b, device):
    lr = torch.as_tensor(_flair(cfg, b, 7, tumor=True)[1], device=device)
    mask = torch.zeros(b, 64, 64, 1, device=device)
    mask[:, 16:40, 12:36] = 1.0
    return lr, mask


def _counts():
    fns = (G.groupnorm_film_silu, G.gn_tiled_stats, G.gn_tiled_apply, flash_attention,
           LA.linear_attention_kv, LA.linear_attention_q, RB.conv3x3_stats, RB.epilogue)
    return {fn.__name__: fn.launches for fn in fns}


@pytest.mark.cuda
def test_compiled_chains_equal_the_eager_chains(cuda_device):
    """bf16 with the kernels at 64px, T=8: the branched DDPM chain (fused
    at 5) and a DDIM-4 chain, plain and branched (fused at the pair (3,
    1)), through `GraphSteps` (two chains: the first captures, the second
    replays every step) equal the eager chains bit for bit and launch what
    they launch."""
    from localdiffusion_tpu_torch.diffusion.compiled import GraphSteps

    cfg, _, gd = _gated64("bfloat16", cuda_device)
    lr, mask = _chain_inputs(cfg, 2, cuda_device)
    mmv = min_max_val_for(cfg)
    scfg = dataclasses.replace(cfg.sampler, classifier=False)
    ddim = build_gd(cfg.replace(diffusion=dataclasses.replace(cfg.diffusion,
                                                              sampling_timesteps=4)),
                    device=cuda_device)
    ddim.model.load_state_dict(gd.model.state_dict())
    ddim_scfg = dataclasses.replace(scfg, start_timestep=1)  # times [7, 5, 3, 1, -1]
    runs = {
        "ddpm_branched": lambda st: TS.ddpm_sample_branched(gd, lr, mask, scfg, mmv, noise=3,
                                                            steps=st),
        "ddim_plain": lambda st: TS.ddim_sample_plain(ddim, lr, mmv, noise=3, steps=st),
        "ddim_branched": lambda st: TS.ddim_sample_branched(ddim, lr, mask, ddim_scfg, mmv,
                                                            noise=3, steps=st),
    }
    for name, run in runs.items():
        before = _counts()
        want = run(None)
        torch.cuda.synchronize()
        eager = {k: v - before[k] for k, v in _counts().items()}
        program = GraphSteps(cuda_device)
        for _ in range(2):
            before = _counts()
            got = run(program)
            torch.cuda.synchronize()
            assert torch.equal(got, want), name
            assert {k: v - before[k] for k, v in _counts().items()} == eager, name
        assert program.summary()["graphs"] >= 2 and program.replays > 0


@pytest.mark.cuda
def test_a_replay_after_a_larger_eager_batch_is_unchanged(cuda_device):
    """A chain captured at batch 4, an eager UNet call at batch 128 (which
    grows the kv kernel's row counters past the captured buffer), then the
    chain replayed: still the eager chain, bit for bit."""
    from localdiffusion_tpu_torch.diffusion.compiled import GraphSteps

    cfg, _, gd = _gated64("bfloat16", cuda_device)
    lr, mask = _chain_inputs(cfg, 4, cuda_device)
    mmv = min_max_val_for(cfg)
    scfg = dataclasses.replace(cfg.sampler, classifier=False)
    run = lambda st: TS.ddpm_sample_branched(gd, lr, mask, scfg, mmv, noise=5, steps=st)
    want = run(None)
    program = GraphSteps(cuda_device)
    assert torch.equal(run(program), want)
    dev = lr.device  # the counters are kept by the tensors' device, cuda:0
    captured = LA._row_counters(dev, 1)
    x = torch.randn(128, 64, 64, 1, device=dev)
    t = torch.full((128,), 3, device=dev)
    gd.apply_model(x, lr[:1].expand(128, -1, -1, -1).contiguous(), t)
    assert LA._row_counters(dev, 1).numel() >= 128 > captured.numel()
    assert torch.equal(run(program), want)
    torch.cuda.synchronize()
    assert not captured.any() and not LA._row_counters(dev, 1).any()


@pytest.mark.cuda
def test_a_rebound_parameter_forces_a_recapture(cuda_device):
    """`translate` on the card replays its programs; a rebound parameter
    moves the weights' fingerprint, the next chain captures anew, and its
    output is the eager chain's under the new weights."""
    from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline

    cfg, _, gd = _gated64("bfloat16", cuda_device)
    pipe = LocalDiffusionPipeline(cfg, gd)
    assert pipe.compiles
    lr, mask = _chain_inputs(cfg, 2, cuda_device)
    lr_np, mask_np = lr.cpu().numpy(), mask.cpu().numpy()
    mmv = min_max_val_for(cfg)
    eager = lambda: TS.ddpm_sample_branched(gd, lr, mask, cfg.sampler, mmv, noise=4)
    first = pipe.translate(lr_np, noise=4, mask=mask_np)["pred"]
    np.testing.assert_array_equal(first, eager().cpu().numpy())
    again = pipe.translate(lr_np, noise=4, mask=mask_np)["pred"]
    np.testing.assert_array_equal(again, first)
    (program,) = pipe.programs.summary()["programs"].values()
    assert program["replays"] > 0 and pipe.programs.recaptures == 0
    w = gd.model.init_conv.weight
    gd.model.init_conv.weight = torch.nn.Parameter(w.detach() * 1.5)
    moved = pipe.translate(lr_np, noise=4, mask=mask_np)["pred"]
    assert pipe.programs.recaptures == 1
    np.testing.assert_array_equal(moved, eager().cpu().numpy())
    assert not np.array_equal(moved, first)


@pytest.mark.cuda
def test_compiled_patchcore_score_equals_the_eager_one(cuda_device):
    """PatchCore's score on the card without a clock is a compiled program
    (one graph per input shape and bank): equal to the eager score bit for
    bit and launching what it launches; under a `StageClock` it runs
    eagerly and marks its stages."""
    from localdiffusion_tpu_torch.ood.patchcore import StageClock

    cfg, _, gd = _gated64("bfloat16", cuda_device)
    pc = PatchCore(cfg.ood, source=DenoiserFeatureSource(gd, t=cfg.ood.feature_t))
    pc.build_memory_bank([_flair(cfg, 4, 11)[0]], sampling_ratio=0.05)
    x = torch.as_tensor(_flair(cfg, 3, 5, tumor=True)[1], device=cuda_device)
    before = _counts()
    want = pc._score_eager(x, None)
    torch.cuda.synchronize()
    eager = {k: v - before[k] for k, v in _counts().items()}
    for _ in range(3):
        before = _counts()
        got = pc._score(x, None)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert {k: v - before[k] for k, v in _counts().items()} == eager
    (program,) = pc._programs.summary()["programs"].values()
    assert program["graphs"] == 1 and program["replays"] == 2
    clock = StageClock("cuda")
    out = pc(x, clock=clock)
    torch.cuda.synchronize()
    assert set(clock.split()) == {"features", "nn", "map"}
    assert torch.equal(out["pred_score"], want[1])


@pytest.mark.cuda
def test_a_server_without_warmup_serves_the_eager_chains(cuda_device):
    """`InferenceServer` without warm-up, `overlap_detect` on, over a
    compiled pipeline whose Stage A is PatchCore on the denoiser's taps:
    each program's first dispatch warms up and captures on the sampling
    thread while Stage A detects on the other, and both launch the kv
    kernel, whose counter buffer every launch on the device shares.  Each
    served image is its batch's eager chain's, bit for bit, and the
    counters end at zero."""
    from localdiffusion_tpu_torch.ood.frontend import OODFrontend
    from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_seed
    from localdiffusion_tpu_torch.serving import InferenceServer

    cfg, _, gd = _gated64("bfloat16", cuda_device)
    cfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler, classifier=False))
    pc = PatchCore(cfg.ood, source=DenoiserFeatureSource(gd, t=cfg.ood.feature_t))
    pc.build_memory_bank([_flair(cfg, 4, 11)[0]], sampling_ratio=0.05)
    pipe = LocalDiffusionPipeline(cfg, gd, frontend=OODFrontend(cfg, patchcore=pc))
    assert pipe.compiles
    lr = _flair(cfg, 8, 13, tumor=True)[1]
    half = np.ones((64, 64, 1), np.float32)
    half[:, :32] = 0.5
    # two requests a batch: the first detected, the second bringing a
    # mask, so every batch runs Stage A and the branched chain
    srv = InferenceServer(pipe, batch_size=2, max_wait_ms=50, overlap_detect=True)
    futs = [srv.submit(lr[i], None if i % 2 == 0 else half) for i in range(8)]
    with srv:
        served = [f.result(timeout=600)["pred"] for f in futs]
    stats = srv.snapshot_stats()
    assert stats["branched_dispatches"] + stats["merged_dispatches"] == 4
    pipe.compiles = False
    for i in range(4):
        rows = lr[2 * i:2 * i + 2]
        detected = pipe.detect(np.stack([rows[0], rows[0]]))[0][0]
        want = pipe.translate(rows, noise=batch_seed(0, i), mask=np.stack([detected, half]))
        for j in range(2):
            np.testing.assert_array_equal(served[2 * i + j], want["pred"][j])
    torch.cuda.synchronize()
    assert not LA._row_counters(torch.zeros(1, device=cuda_device).device, 1).any()


@pytest.mark.cuda
def test_a_warmup_step_runs_on_the_callers_stream(cuda_device):
    """A body's first step (its warm-up) runs on the caller's current
    stream, where the other serving thread's kernels run too, and only its
    capture on the program's side stream: the kv kernel's counters, one
    buffer a device, must never see two launches at once."""
    from localdiffusion_tpu_torch.diffusion.compiled import GraphSteps

    streams = []

    def body(s):
        streams.append(torch.cuda.current_stream())
        return s["x"] * 2

    program = GraphSteps(cuda_device)
    x = torch.arange(4.0, device=cuda_device)
    program.begin()
    first = program("double", body, 0, x=x)
    again = program("double", body, 1, x=x + 1)
    assert streams == [torch.cuda.current_stream(), program.stream]
    assert torch.equal(first, x * 2) and torch.equal(again, (x + 1) * 2)
