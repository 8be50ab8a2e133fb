"""Denoiser building blocks.  Port of `localdiffusion_tpu/models/blocks.py`.

Modules take and return NCHW tensors (PyTorch's convolution layout); the
UNet converts at its NHWC public boundary.  Module and parameter names
follow the JAX parameter tree so `utils.params_io.params_from_jax` maps it
leaf by leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.ops.attention import full_attention
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)

# LinearAttention's fused kernel engages at this many pixels in the JAX
# package (`ops/pallas_linear_attention.py`); ported in a later slice.
FUSED_LINEAR_ATTENTION_MIN_HW = 4096


class RMSNorm(nn.Module):
    """l2-normalize over channels, scale by g·√C (norm clamped at 1e-12)."""

    def __init__(self, channels: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        c = x.shape[1]
        x32 = x.float()
        norm = torch.sqrt((x32 * x32).sum(dim=1, keepdim=True))
        normed = x32 / norm.clamp_min(1e-12)
        return (normed * self.g.view(1, c, 1, 1) * math.sqrt(c)).to(x.dtype)


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


class TimeMlp(nn.Module):
    """sinusoidal → Linear → exact GELU → Linear."""

    def __init__(self, dim: int, time_dim: int, theta: int = 10000):
        super().__init__()
        self.pos_emb = SinusoidalPosEmb(dim, theta)
        self.fc1 = nn.Linear(dim, time_dim)
        self.fc2 = nn.Linear(time_dim, time_dim)

    def forward(self, t):
        return self.fc2(F.gelu(self.fc1(self.pos_emb(t)), approximate="none"))


class GroupNormFilmSiLU(nn.Module):
    """GroupNorm + FiLM + SiLU through the fused kernel's wrapper.

    `use_kernel = False` routes to the plain version whatever the device: an
    explicit switch for comparing a chain with and without the kernel.
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
        fn = groupnorm_film_silu if self.use_kernel else groupnorm_film_silu_reference
        y = fn(xh, self.weight, self.bias, scale, shift, self.groups)
        return y.permute(0, 3, 1, 2)


class Block(nn.Module):
    """conv3×3 → GroupNorm → (FiLM) → SiLU."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv2d(dim_in, dim_out, 3, padding=1)
        self.norm = GroupNormFilmSiLU(dim_out, groups)

    def forward(self, x, scale_shift=None):
        return self.norm(self.proj(x), scale_shift)


class ResnetBlock(nn.Module):
    """Two Blocks + 1×1 residual, FiLM-conditioned on the time embedding."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 time_dim: int | None = None):
        super().__init__()
        self.mlp = nn.Linear(time_dim, dim_out * 2) if time_dim else None
        self.block1 = Block(dim_in, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            scale_shift = self.mlp(F.silu(time_emb)).chunk(2, dim=-1)  # [B, C] each
        h = self.block1(x, scale_shift)
        h = self.block2(h)
        return h + (self.res_conv(x) if self.res_conv is not None else x)


class Downsample(nn.Module):
    """Space-to-depth ×2, channels ordered (c p1 p2), then a 1×1 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv2d(dim_in * 4, dim_out, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return self.conv(x.reshape(b, c * 4, h // 2, w // 2))


class Upsample(nn.Module):
    """Nearest ×2 upsample then a 3×3 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv2d(dim_in, dim_out, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class LinearAttention(nn.Module):
    """Softmax-feature linear attention with RMSNorm in and out: q softmaxed
    over the head dimension then scaled, k softmaxed over tokens."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)
        self.out_norm = RMSNorm(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        if x.is_cuda and h * w >= FUSED_LINEAR_ATTENTION_MIN_HW:
            raise NotImplementedError("fused linear attention kernel: next slice")
        n = h * w
        qkv = self.to_qkv(self.norm(x)).reshape(b, 3, self.heads, self.dim_head, n)
        q, k, v = qkv.unbind(1)  # [b, H, d, n]
        q = torch.softmax(q.float(), dim=2).to(x.dtype) * self.dim_head**-0.5
        k = torch.softmax(k.float(), dim=3).to(x.dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        out = out.reshape(b, self.heads * self.dim_head, h, w)
        return self.out_norm(self.to_out(out))


class Attention(nn.Module):
    """Full softmax attention over the flattened H×W tokens."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        qkv = self.to_qkv(self.norm(x)).reshape(b, 3, self.heads, self.dim_head, n)
        q, k, v = (t.permute(0, 3, 1, 2) for t in qkv.unbind(1))  # [b, n, H, d]
        out = full_attention(q, k, v)  # [b, n, H, d]
        out = out.permute(0, 2, 3, 1).reshape(b, self.heads * self.dim_head, h, w)
        return self.to_out(out)
