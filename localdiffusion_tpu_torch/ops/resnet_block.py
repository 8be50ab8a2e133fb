"""Fused ResnetBlock in three passes: the two CUDA kernels, the GroupNorm
folds between them, and the plain versions.

Port of the normal-layout entry of `localdiffusion_tpu/ops/pallas_resnet_block.py`
(`resnet_block_wfold_fused`: `_conv_stats_kernel` twice, `_epilogue_kernel`
once).  The block computed is the denoiser's ResnetBlock on NHWC bf16 rows:

  pass 1, `conv3x3_stats`: h1 = bf16(conv3x3(x) + b1), and per tile of
      pixels the per-channel sum and sum of squares of the rounded h1;
  fold (PyTorch), `gn_affine`: the tiles' sums pooled, the GroupNorm
      statistics and FiLM folded into one per-(row, channel) affine a1, b1;
  pass 2, `conv3x3_stats` with its prologue: bf16(silu(h1·a1 + b1)) made as
      the input tile is read (the zero padding stays zero after the
      activation), then h2 = bf16(conv3x3(·) + b2) and its sums;
  fold: a2, b2 (GroupNorm without FiLM);
  pass 3, `epilogue`: bf16(bf16(silu(h2·a2 + b2)) + res), res = x or the
      1×1 `res_conv` rounded to bf16.

The kernels are `csrc/resnet_block.cu` (see the source for the design).  The
W-fold of the TPU kernel (r = 128/dim_out pixels in its 128 lanes) is a lane
layout and is not carried over: the kernels compute the plain 3×3 conv on
NHWC.  The fused block rounds at the Pallas kernel's points, not at the
unfused block's: the conv weights are rounded to bf16 and the float32 biases
are added to the float32 sums before h and the residual are rounded, the
statistics come from the rounded h, and the variance is the one-pass
max(E[h²] − mean², 0).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes its plain version (`conv_stats_reference`,
`epilogue_reference`).  The tile grid depends on H and W alone, never on
the batch, so a row's result does not depend on the rows beside it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.ops import _build

LANES = 128
MIN_HW = 4096  # the JAX ResnetBlock fuses at this many pixels (h·w)
TILE_H, TILE_W = 8, 16  # pixels of one conv tile (csrc: kTileH, kTileW)
DIM_OUTS = (32, 64, 128)


def supports_normal(x_shape, dim_out: int, groups: int) -> bool:
    """W-fold entry: normal-layout [B, H, W, C], r = 128/dim_out W pixels
    folded into lanes.  Verbatim the JAX package's gate
    (`pallas_resnet_block.supports_normal`)."""
    b, h, w, cin = x_shape
    if dim_out not in (32, 64, 128):
        return False
    r = LANES // dim_out
    return (
        dim_out % groups == 0
        and w % r == 0
        and (w // r) >= 8
        and h >= 2
        and r * cin <= 512  # VMEM guard (xbuf + two conv kernels)
        and (h * (w // r)) % 8 == 0
    )


def fuses(x_shape, dim_out: int, groups: int, dtype) -> bool:
    """Whether the JAX ResnetBlock takes its fused kernel for an NHWC input
    of this shape: bf16 compute, h·w ≥ `MIN_HW` and `supports_normal`."""
    _, h, w, _ = x_shape
    return (dtype == torch.bfloat16 and h * w >= MIN_HW
            and supports_normal(x_shape, dim_out, groups))


def num_tiles(h: int, w: int) -> int:
    return -(-h // TILE_H) * -(-w // TILE_W)


# the epilogue kernels' launch plans (csrc/resnet_block.cu)
EPI_THREADS = 256
EPI_ROWS = 64  # pixels of one res_conv item: one warpgroup's M
EPI_MAX_CIN = 256  # the res_conv kernel holds x in registers: 32·8 channels at most
EPI_IDENTITY_BLOCKS_PER_SM = 5  # __launch_bounds__ of the identity kernel
# its grid: at least two waves of the blocks the SMs hold, and at most two
# pieces a thread (more blocks read better on the card than longer walks)
EPI_IDENTITY_WAVES = 2
EPI_IDENTITY_PER_THREAD = 2
# Hopper: an SM's shared memory (228 KB) and what each block reserves of it
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024


def epilogue_split(c: int) -> int:
    """Warpgroups sharing one res_conv item, each taking c / split output
    channels: 2 at c = 128 (csrc: SPLIT)."""
    return 2 if c == 128 else 1


def epilogue_res_blocks(c: int, cin: int) -> int:
    """Blocks an SM the res_conv kernel is built for at c output and cin
    input channels (csrc: epi_res_blocks, its __launch_bounds__)."""
    nw, nk = c // epilogue_split(c), -(-cin // 32)
    return 3 if nw == 32 and nk <= 2 else (2 if nk <= 6 else 1)


def epilogue_smem(c: int, cin: int, res: bool) -> int:
    """Dynamic shared memory of one epilogue block: with the res_conv the
    weights, cin rounded up to 32 × c bf16, resident for the block; the
    identity kernel takes none."""
    return 32 * -(-cin // 32) * c * 2 if res else 0


def epilogue_plan(rows: int, hw: int, c: int, cin: int, res: bool, sms: int) -> dict:
    """The epilogue's grid on `sms` SMs.  res_conv: items of 64 pixels of
    one row (`tiles` a row), two a block at a time (one at c = 128, whose
    two warpgroups share it), one persistent wave of the blocks an SM holds
    (its registers and shared memory), `per` items at most a warpgroup.
    Identity: the 16-byte pieces of the output, at most
    `EPI_IDENTITY_PER_THREAD` (`per`) a thread, in at least
    `EPI_IDENTITY_WAVES` waves.  A pixel's output does not depend on the
    plan."""
    smem = epilogue_smem(c, cin, res)
    if res:
        per_sm = min(epilogue_res_blocks(c, cin), SMEM_PER_SM // (smem + SMEM_RESERVED))
        tiles = -(-hw // EPI_ROWS)
        items = rows * tiles
        units = EPI_THREADS // 128 // epilogue_split(c)
        most = sms * per_sm
    else:
        per_sm, tiles = EPI_IDENTITY_BLOCKS_PER_SM, 0
        items, units = rows * hw * c // 8, EPI_THREADS
        most = max(EPI_IDENTITY_WAVES * sms * per_sm,
                   -(-items // (units * EPI_IDENTITY_PER_THREAD)))
    blocks = min(-(-items // units), most)
    return dict(smem=smem, blocks_per_sm=per_sm, tiles=tiles, items=items, blocks=blocks,
                per=-(-items // (blocks * units)))


def gn_affine(s, ss, gamma, beta, scale, shift, groups: int, n: int, eps: float = 1e-5):
    """The tiles' per-channel sums s, ss [B, tiles, C] → the per-(row,
    channel) affine a, b [B, C] of GroupNorm ⊕ FiLM, float32: `_gn_affine`
    of the JAX kernel at ff = 1.  Pools over tiles and group channels, then
    mean = Σ/n, var = max(Σ²/n − mean², 0), a = rsqrt(var + eps)·γ,
    b = β − mean·a; with FiLM a·(scale + 1) and b·(scale + 1) + shift.  n is
    the number of values in a group, h·w·(C / groups).  The pooling sums in
    float64, so it gives the same float32 whatever the batch beside the row
    (PyTorch may reduce in another order for another shape).  Written on
    [B, groups, C / groups] views in few operations, in place where it can:
    on the card each is a launch, and the host's time per launch bounds the
    chain."""
    bsz, tiles, c = s.shape
    cg = c // groups
    pool = lambda t: t.reshape(bsz, tiles, groups, cg).sum(dim=(1, 3), dtype=torch.float64)
    mean = pool(s).float().div_(n)  # [B, G]
    var = torch.addcmul(pool(ss).float().div_(n), mean, mean, value=-1.0).clamp_(min=0.0)
    a = var.add_(eps).rsqrt_()[:, :, None] * gamma.float().reshape(groups, cg)  # [B, G, cg]
    b = torch.addcmul(beta.float().reshape(groups, cg), mean[:, :, None], a, value=-1.0)
    if scale is not None:
        sc = scale.float().reshape(bsz, groups, cg) + 1.0
        a = a * sc
        b = torch.addcmul(shift.float().reshape(bsz, groups, cg), b, sc)
    return a.reshape(bsz, c), b.reshape(bsz, c)


def pack_conv3x3(weight):
    """A [Cout, Cin, 3, 3] conv weight as the kernel reads it: bf16
    [9, Cout, Cin] (tap ky·3 + kx, the contracted Cin contiguous), in one
    copy."""
    cout, cin = weight.shape[:2]
    out = torch.empty((9, cout, cin), dtype=torch.bfloat16, device=weight.device)
    out.view(3, 3, cout, cin).copy_(weight.permute(2, 3, 0, 1))
    return out


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def tile_sums(h):
    """Per tile (TILE_H × TILE_W pixels, row-major over the image, ragged
    edges included) and channel, the float32 sum and sum of squares of h
    [B, H, W, C]: two [B, tiles, C]."""
    b, hh, ww, c = h.shape
    ty, tx = -(-hh // TILE_H), -(-ww // TILE_W)
    hf = F.pad(h.float(), (0, 0, 0, tx * TILE_W - ww, 0, ty * TILE_H - hh))
    hf = hf.reshape(b, ty, TILE_H, tx, TILE_W, c)
    s = hf.sum(dim=(2, 4)).reshape(b, ty * tx, c)
    ss = (hf * hf).sum(dim=(2, 4)).reshape(b, ty * tx, c)
    return s, ss


def conv_stats_reference(x, w, bias, a=None, b=None):
    """Plain pass 1, or pass 2 with a and b.  x: [B, H, W, Cin] bf16; w:
    [9, Cout, Cin] bf16 (`pack_conv3x3`); bias: [Cout] float32; a, b:
    [B, Cin] float32 or None.  With a and b the input is silu(x·a + b)
    rounded to bf16, and the conv's zero padding lies outside it.  Returns
    h = bf16(conv3x3(x) + bias) [B, H, W, Cout] (float32 sums of the bf16
    operands, the float32 bias added before the rounding) and its tiles'
    sums s, ss [B, tiles, Cout] float32."""
    xf = x.float()
    if a is not None:
        y = xf * a[:, None, None, :] + b[:, None, None, :]
        xf = (y * torch.sigmoid(y)).to(torch.bfloat16).float()
    cout, cin = w.shape[1], w.shape[2]
    wk = w.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1)
    h = F.conv2d(xf.permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    h = (h + bias.float()).to(torch.bfloat16).contiguous()
    return (h, *tile_sums(h))


def epilogue_reference(h2, x, a, b, w_res=None, b_res=None):
    """Plain pass 3.  h2: [B, H, W, C] bf16; x: [B, H, W, Cin] bf16, the
    block's input; a, b: [B, C] float32; w_res: [C, Cin] bf16 with b_res [C]
    float32, or None for the identity (Cin = C).  Returns
    bf16(bf16(silu(h2·a + b)) + res), res = x or bf16(x·w_resᵀ + b_res)."""
    y = h2.float() * a[:, None, None, :] + b[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(torch.bfloat16).float()
    if w_res is None:
        res = x.float()
    else:
        res = (x.float() @ w_res.float().t() + b_res.float()).to(torch.bfloat16).float()
    return (y + res).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    return _build.load("resnet_block")


def _check_param(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_nhwc(x, name="x"):
    if x.ndim != 4:
        raise ValueError(f"{name} must be [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC)")


def _runs_kernel(x) -> bool:
    """True on a CUDA tensor, False on a CPU tensor (the plain version);
    any other device raises."""
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    return x.is_cuda


def _kernel_channels(name, cout, cin):
    if cout not in DIM_OUTS or cin % 8:
        raise ValueError(f"the {name} kernel takes C out in {DIM_OUTS} and C in a "
                         f"multiple of 8, got {cout} and {cin}")


def conv3x3_stats(x, w, bias, a=None, b=None):
    """Pass 1 (a, b None) or pass 2 (the affine+SiLU prologue); arguments and
    results as `conv_stats_reference`.  A CUDA tensor runs the kernel (Cout
    in 32/64/128, Cin a multiple of 8, x, w, a and b on 16-byte boundaries,
    or it raises); a CPU tensor runs the plain version."""
    _check_nhwc(x)
    bsz, hh, ww, cin = x.shape
    if w.ndim != 3 or w.shape[0] != 9:
        raise ValueError(f"w must be [9, Cout, {cin}], got shape {tuple(w.shape)}")
    cout = w.shape[1]
    _check_param("w", w, (9, cout, cin), torch.bfloat16, x.device)
    _check_param("bias", bias, (cout,), torch.float32, x.device)
    if (a is None) != (b is None):
        raise ValueError("a and b are given together or not at all")
    if a is not None:
        _check_param("a", a, (bsz, cin), torch.float32, x.device)
        _check_param("b", b, (bsz, cin), torch.float32, x.device)
    if not _runs_kernel(x):
        return conv_stats_reference(x, w, bias, a, b)
    _kernel_channels("conv3x3_stats", cout, cin)
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the conv3x3_stats kernel reads {name} in 16-byte pieces: it "
                             f"must start on a 16-byte boundary")
    h = torch.empty((bsz, hh, ww, cout), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((bsz, num_tiles(hh, ww), 2, cout), dtype=torch.float32,
                       device=x.device)
    fn = _lib().conv3x3_stats
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 a.data_ptr() if a is not None else None,
                 b.data_ptr() if b is not None else None,
                 h.data_ptr(), part.data_ptr(), bsz, hh, ww, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_stats launch failed: CUDA error {err}")
    _build.count_launch(conv3x3_stats)
    return h, part[:, :, 0], part[:, :, 1]


conv3x3_stats.launches = 0


def epilogue(h2, x, a, b, w_res=None, b_res=None):
    """Pass 3; arguments and result as `epilogue_reference`.  A CUDA tensor
    runs the kernel (C in 32/64/128, Cin a multiple of 8 and with a res_conv
    at most 256, every tensor on a 16-byte boundary, or it raises) with
    `epilogue_plan`'s grid; a CPU tensor runs the plain version."""
    _check_nhwc(h2, "h2")
    _check_nhwc(x)
    bsz, hh, ww, c = h2.shape
    cin = x.shape[3]
    if tuple(x.shape[:3]) != (bsz, hh, ww):
        raise ValueError(f"x {tuple(x.shape)} and h2 {tuple(h2.shape)} differ in B, H, W")
    if h2.device != x.device:
        raise ValueError(f"h2 is on {h2.device}, x on {x.device}")
    for name, t in (("a", a), ("b", b)):
        _check_param(name, t, (bsz, c), torch.float32, x.device)
    if (w_res is None) != (b_res is None):
        raise ValueError("w_res and b_res are given together or not at all")
    if w_res is None:
        if cin != c:
            raise ValueError(f"an identity residual needs Cin = C, got {cin} and {c}")
    else:
        _check_param("w_res", w_res, (c, cin), torch.bfloat16, x.device)
        _check_param("b_res", b_res, (c,), torch.float32, x.device)
    if not _runs_kernel(x):
        return epilogue_reference(h2, x, a, b, w_res, b_res)
    return _launch_epilogue(h2, x, a, b, w_res, b_res)


def _launch_epilogue(h2, x, a, b, w_res, b_res, plan=None):
    """The epilogue kernel with `epilogue_plan`'s grid, or with `plan`
    (its `blocks`) where a test asks for another."""
    bsz, hh, ww, c = h2.shape
    cin = x.shape[3]
    _kernel_channels("epilogue", c, cin)
    for name, t in (("h2", h2), ("x", x), ("a", a), ("b", b), ("w_res", w_res), ("b_res", b_res)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the epilogue kernel reads {name} in 16-byte pieces: it must "
                             f"start on a 16-byte boundary")
    if w_res is not None and cin > EPI_MAX_CIN:
        raise ValueError(f"the epilogue kernel takes C in at most {EPI_MAX_CIN} with a res_conv, "
                         f"got {cin}")
    plan = plan or epilogue_plan(bsz, hh * ww, c, cin, w_res is not None,
                                 torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty_like(h2)
    fn = _lib().epilogue
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp] + [ci] * 5 + [vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(h2.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
                 w_res.data_ptr() if w_res is not None else None,
                 b_res.data_ptr() if b_res is not None else None,
                 out.data_ptr(), bsz, hh * ww, cin, c, plan["blocks"], stream)
    if err != 0:
        raise RuntimeError(f"epilogue launch failed: CUDA error {err}")
    _build.count_launch(epilogue)
    return out


epilogue.launches = 0


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------

def _three_pass(x, block, scale_shift, conv, epi):
    """Pass 1, fold, pass 2, fold, pass 3 with the given pass functions.
    `block` is the port's ResnetBlock module: its float32 parameters are laid
    out for the kernels on each call."""
    b1, b2 = block.block1, block.block2
    bsz, hh, ww, _ = x.shape
    dim_out, groups = b1.proj.out_channels, b1.norm.groups
    n = hh * ww * (dim_out // groups)
    sc, sh = scale_shift if scale_shift is not None else (None, None)
    h1, s1, ss1 = conv(x, pack_conv3x3(b1.proj.weight), b1.proj.bias.float().contiguous())
    a1, c1 = gn_affine(s1, ss1, b1.norm.weight, b1.norm.bias, sc, sh, groups, n)
    h2, s2, ss2 = conv(h1, pack_conv3x3(b2.proj.weight), b2.proj.bias.float().contiguous(),
                       a1, c1)
    a2, c2 = gn_affine(s2, ss2, b2.norm.weight, b2.norm.bias, None, None, groups, n)
    w_res = b_res = None
    if block.res_conv is not None:
        w_res = block.res_conv.weight[:, :, 0, 0].to(torch.bfloat16).contiguous()
        b_res = block.res_conv.bias.float().contiguous()
    return epi(h2, x, a2, c2, w_res, b_res)


def resnet_block_fused(x, block, scale_shift=None):
    """The fused ResnetBlock on x [B, H, W, Cin] bf16, contiguous NHWC.

    block: the port's `models.blocks.ResnetBlock` (parameters `block1.proj`,
    `block1.norm`, `block2.*`, `res_conv`); scale_shift: (scale, shift),
    each [B, dim_out] float32, or None.  Returns [B, H, W, dim_out] bf16.  A
    CUDA tensor must be inside `supports_normal` and launches
    `conv3x3_stats` twice and `epilogue` once; a CPU tensor runs their plain
    versions."""
    dim_out, groups = block.block1.proj.out_channels, block.block1.norm.groups
    if x.is_cuda and not supports_normal(x.shape, dim_out, groups):
        raise ValueError(f"the fused block does not take {tuple(x.shape)} with "
                         f"dim_out={dim_out} groups={groups}")
    return _three_pass(x, block, scale_shift, conv3x3_stats, epilogue)


def resnet_block_fused_plain(x, block, scale_shift=None):
    """The same three passes through the kernels' plain versions, on any
    device: what `resnet_block_fused` computes, for comparing a chain with
    and without the kernels."""
    return _three_pass(x, block, scale_shift, conv_stats_reference, epilogue_reference)


def resnet_block_reference(x, block, scale_shift=None):
    """The unfused block as the JAX package's `_reference_normal` computes it
    (for tests): convs in bf16 with float32 sums and a bf16 bias, the
    GroupNorm one-pass in float32 then SiLU rounded to bf16, the bf16 1×1
    res_conv, and the sum in bf16.  Arguments as `resnet_block_fused`."""
    groups = block.block1.norm.groups

    def conv(v, conv_mod, pad):
        y = F.conv2d(v.float().permute(0, 3, 1, 2), conv_mod.weight.to(torch.bfloat16).float(),
                     padding=pad).permute(0, 2, 3, 1).to(torch.bfloat16)
        return y + conv_mod.bias.to(torch.bfloat16)

    def gn(h, norm, scale, shift):
        bsz, hh, ww, c = h.shape
        cg = c // groups
        hf = h.float()
        s = hf.sum(dim=(1, 2)).reshape(bsz, groups, cg).sum(-1)
        ss = (hf * hf).sum(dim=(1, 2)).reshape(bsz, groups, cg).sum(-1)
        n = hh * ww * cg
        mean = s / n
        inv = torch.rsqrt(torch.clamp(ss / n - mean * mean, min=0.0) + 1e-5)
        mean_c = mean.repeat_interleave(cg, dim=1)[:, None, None, :]
        a_c = (inv.repeat_interleave(cg, dim=1) * norm.weight.float())[:, None, None, :]
        y = (hf - mean_c) * a_c + norm.bias.float()
        if scale is not None:
            y = y * (scale.float()[:, None, None, :] + 1.0) + shift.float()[:, None, None, :]
        return (y * torch.sigmoid(y)).to(torch.bfloat16)

    sc, sh = scale_shift if scale_shift is not None else (None, None)
    b1, b2 = block.block1, block.block2
    h = gn(conv(x, b1.proj, 1), b1.norm, sc, sh)
    h = gn(conv(h, b2.proj, 1), b2.norm, None, None)
    return h + (x if block.res_conv is None else conv(x, block.res_conv, 0))
