"""Conditional denoiser UNet.  Port of `localdiffusion_tpu/models/unet.py`.

Public tensors are NHWC, as in the JAX package: `forward(x, cond, t)` takes
x and cond as [B, H, W, C] and returns [B, H, W, C_out], and `encode_cond`
returns NHWC features.  Inside, the network runs NCHW tensors in the
channels_last memory format: the transposes at the boundary are views, and
each GroupNorm hands its input to the NHWC kernel without a copy.
"""

from __future__ import annotations

import torch
from torch import nn

from localdiffusion_tpu_torch.config import ModelConfig
from localdiffusion_tpu_torch.models.blocks import (
    Attention,
    Downsample,
    GroupNormFilmSiLU,
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

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.learned_sinusoidal_cond or cfg.random_fourier_features:
            raise NotImplementedError("learned/random Fourier time features: later slice")
        if cfg.stem_space_to_depth != 1:
            raise NotImplementedError("stem_space_to_depth: later slice")
        if cfg.self_condition:
            raise NotImplementedError("self-conditioning: later slice")
        self.cfg = cfg
        dim = cfg.dim
        init_dim = cfg.resolved_init_dim
        dims = [init_dim] + [dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.in_out = in_out
        time_dim = dim * 4
        groups = cfg.resnet_block_groups

        def res(di, do):
            return ResnetBlock(di, do, groups, time_dim)

        def attn(full, d):
            cls = Attention if full else LinearAttention
            return cls(d, cfg.attn_heads, cfg.attn_dim_head)

        self.init_conv = nn.Conv2d(cfg.channels, init_dim, 7, padding=3)
        self.time_mlp = TimeMlp(dim, time_dim, cfg.time_emb_theta)
        n = len(in_out)
        for i, (di, do) in enumerate(in_out):
            self.add_module(f"down{i}_block1", res(di, di))
            self.add_module(f"down{i}_block2", res(di, di))
            self.add_module(f"down{i}_attn", attn(cfg.full_attn[i], di))
            self.add_module(
                f"down{i}_down",
                Downsample(di, do) if i < n - 1 else nn.Conv2d(di, do, 3, padding=1),
            )
        mid = dims[-1]
        self.mid_block1 = res(mid, mid)
        self.mid_attn = attn(True, mid)
        self.mid_block2 = res(mid, mid)
        enc_out = cfg.cond_base_dim * 2 ** (cfg.cond_num_blocks - 1)
        self.cond_model = CondEncoder(
            cfg.resolved_cond_channels, cfg.cond_num_blocks, cfg.cond_base_dim,
            cfg.cond_group_num,
        )
        self.conv_fusion = res(mid + enc_out, mid)
        for j, (di, do) in enumerate(reversed(in_out)):
            self.add_module(f"up{j}_block1", res(do + di, do))
            self.add_module(f"up{j}_block2", res(do + di, do))
            self.add_module(f"up{j}_attn", attn(cfg.full_attn[n - 1 - j], do))
            self.add_module(
                f"up{j}_up",
                Upsample(do, di) if j < n - 1 else nn.Conv2d(do, di, 3, padding=1),
            )
        self.final_res_block = res(init_dim * 2, dim)
        self.final_conv = nn.Conv2d(dim, cfg.resolved_out_dim, 1)

    def use_plain_groupnorm(self, plain: bool = True) -> "UNet":
        """Route every Block's GroupNorm to the plain version (True) or the
        kernel's wrapper (False).  For comparing a chain against the kernel;
        never set by default."""
        for m in self.modules():
            if isinstance(m, GroupNormFilmSiLU):
                m.use_kernel = not plain
        return self

    def encode_cond(self, cond):
        """Condition-encoder features of an NHWC image, as NHWC.  The image is
        constant across a sampling chain, so a sampler calls this once."""
        return _nhwc(self.cond_model(_nchw(cond).float()))

    def forward(self, x, cond, time, cond_feat=None):
        cfg = self.cfg
        f = cfg.downsample_factor
        if x.shape[1] % f or x.shape[2] % f:
            raise ValueError(f"input dims {tuple(x.shape[1:3])} must be divisible by {f}")
        x = self.init_conv(_nchw(x.float()).contiguous(memory_format=torch.channels_last))
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
        x = torch.cat([x, _nchw(feat)], dim=1)
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
        return _nhwc(self.final_conv(x.float()))
