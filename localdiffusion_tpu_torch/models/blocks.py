"""Denoiser building blocks.  Port of `localdiffusion_tpu/models/blocks.py`.

Modules take and return NCHW tensors (PyTorch's convolution layout); the
UNet converts at its NHWC public boundary.  Module and parameter names
follow the JAX parameter tree so `utils.params_io.params_from_jax` maps it
leaf by leaf.

Every module takes a compute `dtype` with flax's meaning: parameters stay
float32; each Conv or Dense casts its input and its weights to `dtype` and
returns `dtype`; softmaxes, norm statistics and the GroupNorm kernel's
arithmetic run in float32 and cast back.  The casts are written out where
the JAX modules make them (not `torch.autocast`, which keeps another set
of ops in float32).

Trained, each kernel-bearing module's wrapper records its
`torch.autograd.Function` (`ops.autograd`: the backward recomputes through
the plain reference) whenever autograd records the call; the casts here
are differentiable as written, and `use_kernel = False` still takes the
plain versions, for comparing a train step with and without the kernels.

On a tensor-parallel model (`parallel.tensor_parallel`) each `Conv2d` and
`Linear` computes from its shards (`_tp`: the sharded leaves), and the
fused ResnetBlock gathers its leaves over 'model' for its kernels; a model
that was never sharded takes none of these branches.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.ops.attention import full_attention, xla_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_plain,
)
from localdiffusion_tpu_torch.ops.linear_attention import (
    linear_attention,
    linear_attention_reference,
    supports as linear_attention_supports,
)
from localdiffusion_tpu_torch.ops.resnet_block import (
    fuses as resnet_block_fuses,
    resnet_block_fused,
    resnet_block_fused_plain,
)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype` (flax `nn.Conv(dtype=...)`):
    input, weight and bias cast to it, output of it; parameters stay
    float32."""

    _tp = None  # tensor parallel: {leaf: sharded dim} (parallel.tensor_parallel)
    _tp_full = 0

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self._tp and not self._tp_full:
            from localdiffusion_tpu_torch.parallel.tensor_parallel import conv_forward

            return conv_forward(self, x)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """`nn.Linear` computing in `compute_dtype` (flax `nn.Dense(dtype=...)`)."""

    _tp = None
    _tp_full = 0

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self._tp and not self._tp_full:
            from localdiffusion_tpu_torch.parallel.tensor_parallel import linear_forward

            return linear_forward(self, x)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class RMSNorm(nn.Module):
    """l2-normalize over channels, scale by g·√C (norm clamped at 1e-12),
    in float32, cast to `dtype`."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.g = nn.Parameter(torch.ones(channels))
        self.dtype = dtype

    def forward(self, x):
        c = x.shape[1]
        x32 = x.float()
        norm = torch.sqrt((x32 * x32).sum(dim=1, keepdim=True))
        normed = x32 / norm.clamp_min(1e-12)
        return (normed * self.g.view(1, c, 1, 1) * math.sqrt(c)).to(self.dtype)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal timestep embedding; frequencies computed in host float64."""

    def __init__(self, dim: int, theta: int = 10000):
        super().__init__()
        half_dim = dim // 2
        scale = math.log(theta) / (half_dim - 1)
        freqs = np.exp(np.arange(half_dim) * -scale).astype(np.float32)
        self.register_buffer("freqs", torch.from_numpy(freqs), persistent=False)

    def forward(self, t):
        emb = t.float()[:, None] * self.freqs[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Random (frozen) or learned Fourier time features (reference
    ddpm.py:151-166): w of dim/2 entries drawn N(0, 1), then [t,
    sin(2π·t·w), cos(2π·t·w)] of width dim + 1, in float32.  Random
    features keep w a parameter that takes no gradient (`requires_grad`
    off), so the state dict, the JAX key `time_mlp/pos_emb/weights` and the
    npz round trip are the learned variant's; the JAX module's
    `stop_gradient` gives it a zero gradient, which Adam leaves unmoved."""

    def __init__(self, dim: int, is_random: bool = False):
        super().__init__()
        if dim % 2:
            raise ValueError(f"learned_sinusoidal_dim {dim} must be even")
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not is_random)

    def forward(self, t):
        tb = t.float()[:, None]
        freqs = tb * self.weights[None, :] * (2.0 * math.pi)
        return torch.cat([tb, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class TimeMlp(nn.Module):
    """(sinusoidal | random or learned Fourier features, float32) → Linear
    → exact GELU → Linear, in `dtype`."""

    def __init__(self, dim: int, time_dim: int, theta: int = 10000,
                 dtype=torch.float32, learned_sinusoidal_cond: bool = False,
                 random_fourier_features: bool = False, learned_sinusoidal_dim: int = 16):
        super().__init__()
        if learned_sinusoidal_cond or random_fourier_features:
            self.pos_emb = RandomOrLearnedSinusoidalPosEmb(
                learned_sinusoidal_dim, is_random=random_fourier_features)
            dim = learned_sinusoidal_dim + 1
        else:
            self.pos_emb = SinusoidalPosEmb(dim, theta)
        self.fc1 = Linear(dim, time_dim, compute_dtype=dtype)
        self.fc2 = Linear(time_dim, time_dim, compute_dtype=dtype)

    def forward(self, t):
        return self.fc2(F.gelu(self.fc1(self.pos_emb(t)), approximate="none"))


class GroupNormFilmSiLU(nn.Module):
    """GroupNorm + FiLM + SiLU through the fused kernels' wrapper (float32
    arithmetic, output in the input's type): the single-pass kernel, or past
    the JAX row gate the tiled pair.

    `use_kernel = False` routes to the plain version whatever the device: an
    explicit switch for comparing a chain with and without the kernels.
    """

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.use_kernel = True

    def forward(self, x, scale_shift=None):
        # NCHW → NHWC; a channels_last input makes this a free view
        xh = x.permute(0, 2, 3, 1).contiguous()
        scale = shift = None
        if scale_shift is not None:
            scale, shift = (t.float().contiguous() for t in scale_shift)
        fn = groupnorm_film_silu if self.use_kernel else groupnorm_film_silu_plain
        y = fn(xh, self.weight, self.bias, scale, shift, self.groups)
        return y.permute(0, 3, 1, 2)


class Block(nn.Module):
    """conv3×3 → GroupNorm → (FiLM) → SiLU."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.proj = Conv2d(dim_in, dim_out, 3, padding=1, compute_dtype=dtype)
        self.norm = GroupNormFilmSiLU(dim_out, groups)

    def forward(self, x, scale_shift=None):
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    """Two Blocks + 1×1 residual, FiLM-conditioned on the time embedding.

    Where the JAX module takes its fused kernel (`ops.resnet_block.fuses`:
    bf16 compute, h·w ≥ 4096 and `supports_normal`), the block goes to the
    fused three-pass wrapper, fed from the same parameters; elsewhere it
    runs the two Blocks.  `use_kernel = False` takes the fused block's plain
    version inside that gate (for comparing a chain with and without the
    kernels).
    """

    _tensor_parallel = False

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 time_dim: int | None = None, dtype=torch.float32):
        super().__init__()
        self.mlp = Linear(time_dim, dim_out * 2, compute_dtype=dtype) if time_dim else None
        self.block1 = Block(dim_in, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = (Conv2d(dim_in, dim_out, 1, compute_dtype=dtype)
                         if dim_in != dim_out else None)
        self.use_kernel = True

    def forward(self, x, time_emb=None):
        film = None
        if self.mlp is not None and time_emb is not None:
            film = self.mlp(F.silu(time_emb))  # [B, 2C]: scale, shift
        nhwc_shape = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
        if resnet_block_fuses(nhwc_shape, self.block1.proj.out_channels,
                              self.block1.norm.groups, self.block1.proj.compute_dtype):
            # NHWC view; the UNet's channels_last tensors make it free.  The
            # FiLM terms are the bf16 Dense output cast to float32, as in JAX.
            xh = x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
            ss = None if film is None else film.float().chunk(2, dim=-1)
            fn = resnet_block_fused if self.use_kernel else resnet_block_fused_plain
            if self._tensor_parallel:  # the kernels at full width, from gathered leaves
                from localdiffusion_tpu_torch.parallel.tensor_parallel import full_width

                with full_width(self.block1, self.block2, self.res_conv):
                    return fn(xh, self, ss).permute(0, 3, 1, 2)
            return fn(xh, self, ss).permute(0, 3, 1, 2)
        scale_shift = None if film is None else film.chunk(2, dim=-1)
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class Downsample(nn.Module):
    """Space-to-depth ×2, channels ordered (c p1 p2), then a 1×1 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim_in * 4, dim_out, 1, compute_dtype=dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return self.conv(x.reshape(b, c * 4, h // 2, w // 2))


class Upsample(nn.Module):
    """Nearest ×2 upsample then a 3×3 conv."""

    def __init__(self, dim_in: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(dim_in, dim_out, 3, padding=1, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class LinearAttention(nn.Module):
    """Softmax-feature linear attention with RMSNorm in and out: q softmaxed
    over the head dimension then scaled, k softmaxed over tokens.

    Inside the kernels' gate (`ops.linear_attention.supports`: 4 heads of
    32, C ∈ {32, 64, 128}, bf16, h·w ≥ 4096) it goes to the kernels'
    wrapper, as the JAX module goes to its Pallas kernels; outside it runs
    the unfused math on whatever device it is on, as the JAX module does.
    `use_kernel = False` takes the unfused math everywhere (for comparing a
    chain with and without the kernels).
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim, dtype)
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, compute_dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, compute_dtype=dtype)
        self.out_norm = RMSNorm(dim, dtype)
        self.use_kernel = True

    def forward(self, x):
        # NHWC view; the UNet's channels_last tensors make it free
        xh = x.permute(0, 2, 3, 1).to(self.to_qkv.compute_dtype)
        params = (self.norm.g, self.to_qkv.weight[:, :, 0, 0].t(),
                  self.to_out.weight[:, :, 0, 0].t(), self.to_out.bias, self.out_norm.g)
        if self.use_kernel and linear_attention_supports(
                xh.shape, self.heads, self.dim_head, xh.dtype):
            out = linear_attention(xh.contiguous(), *params, self.heads, self.dim_head)
        else:
            out = linear_attention_reference(xh, *params, self.heads, self.dim_head)
        return out.permute(0, 3, 1, 2)


class Attention(nn.Module):
    """Full softmax attention over the flattened H×W tokens.  `use_kernel =
    False` takes the plain attention at every size."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim, dtype)
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, compute_dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, compute_dtype=dtype)
        self.use_kernel = True

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        qkv = self.to_qkv(self.norm(x)).reshape(b, 3, self.heads, self.dim_head, n)
        q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.unbind(1))  # [b, n, H, d] views
        attend = full_attention if self.use_kernel else xla_attention
        out = attend(q, k, v)  # [b, n, H, d]
        out = out.permute(0, 2, 3, 1).reshape(b, self.heads * self.dim_head, h, w)
        return self.to_out(out)
