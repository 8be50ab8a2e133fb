"""Condition encoder.  Port of `localdiffusion_tpu/models/cond_encoder.py`.

A residual conv tower over the conditioning image (NCHW inside).  Its
GroupNorms are plain GroupNorm with eps 1e-5, not the fused kernel (the JAX
package runs flax's nn.GroupNorm there too).  With a compute `dtype` the
convolutions run in it, and each GroupNorm takes its statistics and
arithmetic in float32 and casts back, as flax's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.models.blocks import Conv2d


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` in float32 whose output is cast to `compute_dtype`."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 compute_dtype=torch.float32):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def _groups(group_num: int, channels: int) -> int:
    g = min(group_num, channels)
    while channels % g != 0:
        g -= 1
    return max(g, 1)


class BasicBlock(nn.Module):
    """conv3×3-GN-ReLU → conv3×3-GN, residual (conv3×3-GN when the width
    changes), ReLU."""

    def __init__(self, in_dim: int, mid_dim: int, out_dim: int, group_num: int = 16,
                 dtype=torch.float32):
        super().__init__()

        def conv(ci, co):
            return Conv2d(ci, co, 3, padding=1, compute_dtype=dtype)

        def gn(c):
            return GroupNorm(_groups(group_num, c), c, eps=1e-5, compute_dtype=dtype)

        self.conv1 = conv(in_dim, mid_dim)
        self.gn1 = gn(mid_dim)
        self.conv2 = conv(mid_dim, out_dim)
        self.gn2 = gn(out_dim)
        if in_dim != out_dim:
            self.id_conv = conv(in_dim, out_dim)
            self.id_gn = gn(out_dim)
        else:
            self.id_conv = self.id_gn = None

    def forward(self, x):
        h = F.relu(self.gn1(self.conv1(x)))
        h = self.gn2(self.conv2(h))
        idn = self.id_gn(self.id_conv(x)) if self.id_conv is not None else x
        return F.relu(h + idn)


class CondEncoder(nn.Module):
    """num_blocks BasicBlocks with a 2× max-pool between consecutive ones;
    output [B, base·2^(num_blocks-1), H/2^(num_blocks-1), W/2^(num_blocks-1)]."""

    def __init__(self, in_channels: int, num_blocks: int = 4, base_dim: int = 32,
                 group_num: int = 16, dtype=torch.float32):
        super().__init__()
        b = base_dim
        outs = [b] + [b * (2**k) for k in range(1, num_blocks)]
        mids = [b] + outs[:-1]
        ins = [in_channels] + outs[:-1]
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block{i + 1}", BasicBlock(ins[i], mids[i], outs[i], group_num, dtype)
            )

    def forward(self, cond):
        x = cond
        for i in range(self.num_blocks):
            if i > 0:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"block{i + 1}")(x)
        return x
