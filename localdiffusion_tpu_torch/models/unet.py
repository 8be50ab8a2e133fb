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

With `self_condition` the forward takes `x_self_cond`, the previous x₀
estimate, as extra input channels (zeros when None: the samplers pass
none, as in the JAX package); `learned_sinusoidal_cond` and
`random_fourier_features` switch the time MLP to Fourier features of
`learned_sinusoidal_dim` (`blocks.RandomOrLearnedSinusoidalPosEmb`).

`stem_space_to_depth` f > 1 (the s2d-stem configuration) folds f×f pixel
blocks into channels before `init_conv` and unfolds the final conv's
`out_dim·f²` channels after it, so the network runs at 1/f of the input's
resolution.  The JAX UNet orders a folded pixel's channels c·f² + i·f + j
for row offset i and column offset j, which is what `F.pixel_unshuffle`
and `F.pixel_shuffle` do on NCHW.

Inside a `utils.logging.profile_trace` session each stage module runs in a
`record_function` scope of its JAX module path (`init_conv`, `time_mlp`,
`down0_block1`, …, `cond_model`, `conv_fusion`, …, `final_conv`), which
`scripts.profile_attr` groups the card's time by; outside one no scope is
entered.
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
from localdiffusion_tpu_torch.utils.logging import stage_scope


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
        in_channels = cfg.channels * (2 if cfg.self_condition else 1)
        self.init_conv = Conv2d(in_channels * f2, init_dim, 7, padding=3, compute_dtype=dtype)
        self.time_mlp = TimeMlp(dim, time_dim, cfg.time_emb_theta, dtype,
                                cfg.learned_sinusoidal_cond, cfg.random_fourier_features,
                                cfg.learned_sinusoidal_dim)
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
        self.final_conv = Conv2d(dim, cfg.resolved_out_dim * f2, 1, compute_dtype=torch.float32)

    def _run(self, name: str, *args):
        """Stage `name` on `args`, in its profiler scope."""
        with stage_scope(name):
            return getattr(self, name)(*args)

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
        return _nhwc(self._run("cond_model", _nchw(cond).to(self.dtype)))

    def _stem(self, x, x_self_cond=None):
        """NHWC input → init_conv output (NCHW, channels_last, compute type).
        With self-conditioning the previous x₀ estimate (zeros when None)
        goes before x on the channel axis, ahead of the s2d fold, as in the
        JAX UNet."""
        f = self.cfg.stem_space_to_depth
        factor = self.cfg.downsample_factor * f
        if x.shape[1] % factor or x.shape[2] % factor:
            raise ValueError(f"input dims {tuple(x.shape[1:3])} must be divisible by {factor}")
        x = x.to(self.dtype)
        if self.cfg.self_condition:
            sc = torch.zeros_like(x) if x_self_cond is None else x_self_cond.to(self.dtype)
            x = torch.cat([sc, x], dim=-1)
        x = _nchw(x)
        if f > 1:
            x = F.pixel_unshuffle(x, f)
        return self._run("init_conv", x.contiguous(memory_format=torch.channels_last))

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
        t = self._run("time_mlp", time)
        out = {}
        for i in range(n):
            for j in (1, 2):
                name = f"down{i}_block{j}"
                x = self._run(name, x, t)
                if name in wanted:
                    out[name] = _nhwc(x)
            if len(out) == len(wanted):
                break
            x = self._run(f"down{i}_attn", x) + x
            x = self._run(f"down{i}_down", x)
        return out

    def forward(self, x, cond, time, cond_feat=None, x_self_cond=None):
        f = self.cfg.stem_space_to_depth
        x = self._stem(x, x_self_cond)
        r = x
        t = self._run("time_mlp", time)

        skips = []
        n = len(self.in_out)
        for i in range(n):
            x = self._run(f"down{i}_block1", x, t)
            skips.append(x)
            x = self._run(f"down{i}_block2", x, t)
            x = self._run(f"down{i}_attn", x) + x
            skips.append(x)
            x = self._run(f"down{i}_down", x)

        x = self._run("mid_block1", x, t)
        x = self._run("mid_attn", x) + x
        x = self._run("mid_block2", x, t)

        feat = self.encode_cond(cond) if cond_feat is None else cond_feat
        x = torch.cat([x, _nchw(feat).to(self.dtype)], dim=1)
        x = self._run("conv_fusion", x, t)

        for j in range(n):
            x = torch.cat([x, skips.pop()], dim=1)
            x = self._run(f"up{j}_block1", x, t)
            x = torch.cat([x, skips.pop()], dim=1)
            x = self._run(f"up{j}_block2", x, t)
            x = self._run(f"up{j}_attn", x) + x
            x = self._run(f"up{j}_up", x)

        x = torch.cat([x, r], dim=1)
        x = self._run("final_res_block", x, t)
        out = self._run("final_conv", x.float())
        if f > 1:
            out = F.pixel_shuffle(out, f)
        return _nhwc(out)
