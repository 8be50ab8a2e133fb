"""Conditional denoiser UNet.  Port of `localdiffusion_tpu/models/unet.py`.

Public tensors are NHWC, as in the JAX package: `forward(x, cond, t)` takes
x and cond as [B, H, W, C] and returns [B, H, W, C_out], and `encode_cond`
returns NHWC features.  Inside, the network runs NCHW tensors in the
channels_last memory format: the transposes at the boundary are views, and
each GroupNorm, LinearAttention and fused ResnetBlock hands its input to an
NHWC kernel without a copy.

`dtype` is the compute type (the JAX UNet's `dtype`): the input is cast to
it, every layer computes in it, and the final 1×1 conv runs in float32, so
the output is float32 whichever the compute type; parameters stay float32.

`stem_space_to_depth` f > 1 (the s2d-stem configuration) folds f×f pixel
blocks into channels before `init_conv` and unfolds the final conv's
`out_dim·f²` channels after it, so the network runs at 1/f of the input's
resolution.  The JAX UNet orders a folded pixel's channels c·f² + i·f + j
for row offset i and column offset j, which is what `F.pixel_unshuffle`
and `F.pixel_shuffle` do on NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.config import ModelConfig
from localdiffusion_tpu_torch.models.blocks import (
    Attention,
    Conv2d,
    Downsample,
    LinearAttention,
    ResnetBlock,
    TimeMlp,
    Upsample,
)
from localdiffusion_tpu_torch.models.cond_encoder import CondEncoder


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class UNet(nn.Module):
    """Denoiser: model(x_t, cond, t) → prediction (x₀ / ε / v per objective).

    init conv7×7 → per stage [Res, Res, attn(+res), down] → mid Res/attn/Res
    → concat(cond features) + fusion Res → ups with skip concats → final
    Res + 1×1.
    """

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        if cfg.learned_sinusoidal_cond or cfg.random_fourier_features:
            raise NotImplementedError("learned/random Fourier time features: later slice")
        if cfg.self_condition:
            raise NotImplementedError("self-conditioning: later slice")
        self.cfg = cfg
        self.dtype = dtype
        dim = cfg.dim
        init_dim = cfg.resolved_init_dim
        dims = [init_dim] + [dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.in_out = in_out
        time_dim = dim * 4
        groups = cfg.resnet_block_groups

        def res(di, do):
            return ResnetBlock(di, do, groups, time_dim, dtype)

        def attn(full, d):
            cls = Attention if full else LinearAttention
            return cls(d, cfg.attn_heads, cfg.attn_dim_head, dtype)

        def conv3(di, do):
            return Conv2d(di, do, 3, padding=1, compute_dtype=dtype)

        f2 = cfg.stem_space_to_depth ** 2
        self.init_conv = Conv2d(cfg.channels * f2, init_dim, 7, padding=3, compute_dtype=dtype)
        self.time_mlp = TimeMlp(dim, time_dim, cfg.time_emb_theta, dtype)
        n = len(in_out)
        for i, (di, do) in enumerate(in_out):
            self.add_module(f"down{i}_block1", res(di, di))
            self.add_module(f"down{i}_block2", res(di, di))
            self.add_module(f"down{i}_attn", attn(cfg.full_attn[i], di))
            self.add_module(
                f"down{i}_down",
                Downsample(di, do, dtype) if i < n - 1 else conv3(di, do),
            )
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = attn(True, mid)
        self.mid_block2 = res(mid, mid)
        enc_out = cfg.cond_base_dim * 2 ** (cfg.cond_num_blocks - 1)
        self.cond_model = CondEncoder(
            cfg.resolved_cond_channels, cfg.cond_num_blocks, cfg.cond_base_dim,
            cfg.cond_group_num, dtype,
        )
        self.conv_fusion = res(mid + enc_out, mid)
        for j, (di, do) in enumerate(reversed(in_out)):
            self.add_module(f"up{j}_block1", res(do + di, do))
            self.add_module(f"up{j}_block2", res(do + di, do))
            self.add_module(f"up{j}_attn", attn(cfg.full_attn[n - 1 - j], do))
            self.add_module(
                f"up{j}_up",
                Upsample(do, di, dtype) if j < n - 1 else conv3(do, di),
            )
        self.final_res_block = res(init_dim * 2, dim)
        self.final_conv = nn.Conv2d(dim, cfg.resolved_out_dim * f2, 1)

    def use_plain_kernels(self, plain: bool = True) -> "UNet":
        """Route every module that has a kernel (GroupNorm, full and linear
        attention, the fused ResnetBlock) to its plain version (True) or to
        the kernel's wrapper (False).  For comparing a chain against the kernels; never set by
        default."""
        for m in self.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = not plain
        return self

    def encode_cond(self, cond):
        """Condition-encoder features of an NHWC image, as NHWC in the
        compute type.  The image is constant across a sampling chain, so a
        sampler calls this once."""
        return _nhwc(self.cond_model(_nchw(cond).to(self.dtype)))

    def _stem(self, x):
        """NHWC input → init_conv output (NCHW, channels_last, compute type)."""
        f = self.cfg.stem_space_to_depth
        factor = self.cfg.downsample_factor * f
        if x.shape[1] % factor or x.shape[2] % factor:
            raise ValueError(f"input dims {tuple(x.shape[1:3])} must be divisible by {factor}")
        x = _nchw(x.to(self.dtype))
        if f > 1:
            x = F.pixel_unshuffle(x, f)
        return self.init_conv(x.contiguous(memory_format=torch.channels_last))

    def down_taps(self, x, time, names):
        """The outputs of the named down-path ResnetBlocks
        (`down{i}_block{j}`, j 1 or 2) for NHWC x at timestep `time`, as
        {name: NHWC tensor in the compute type}.  It runs the init conv, the
        time MLP and the down stages, and stops after the deepest tap: the
        rest of the network does not reach a tap, and the condition enters
        only after the down path."""
        n = len(self.in_out)
        valid = {f"down{i}_block{j}" for i in range(n) for j in (1, 2)}
        wanted = set(names)
        if not wanted <= valid:
            raise ValueError(f"taps {sorted(wanted - valid)} are not down-path blocks "
                             f"({sorted(valid)})")
        x = self._stem(x)
        t = self.time_mlp(time)
        out = {}
        for i in range(n):
            for j in (1, 2):
                name = f"down{i}_block{j}"
                x = getattr(self, name)(x, t)
                if name in wanted:
                    out[name] = _nhwc(x)
            if len(out) == len(wanted):
                break
            x = getattr(self, f"down{i}_attn")(x) + x
            x = getattr(self, f"down{i}_down")(x)
        return out

    def forward(self, x, cond, time, cond_feat=None):
        f = self.cfg.stem_space_to_depth
        x = self._stem(x)
        r = x
        t = self.time_mlp(time)

        skips = []
        n = len(self.in_out)
        for i in range(n):
            x = getattr(self, f"down{i}_block1")(x, t)
            skips.append(x)
            x = getattr(self, f"down{i}_block2")(x, t)
            x = getattr(self, f"down{i}_attn")(x) + x
            skips.append(x)
            x = getattr(self, f"down{i}_down")(x)

        x = self.mid_block1(x, t)
        x = self.mid_attn(x) + x
        x = self.mid_block2(x, t)

        feat = self.encode_cond(cond) if cond_feat is None else cond_feat
        x = torch.cat([x, _nchw(feat).to(self.dtype)], dim=1)
        x = self.conv_fusion(x, t)

        for j in range(n):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up{j}_block1")(x, t)
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"up{j}_block2")(x, t)
            x = getattr(self, f"up{j}_attn")(x) + x
            x = getattr(self, f"up{j}_up")(x)

        x = torch.cat([x, r], dim=1)
        x = self.final_res_block(x, t)
        out = self.final_conv(x.float())
        if f > 1:
            out = F.pixel_shuffle(out, f)
        return _nhwc(out)
