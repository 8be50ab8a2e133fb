"""Condition encoder.  Port of `localdiffusion_tpu/models/cond_encoder.py`.

A residual conv tower over the conditioning image (NCHW inside).  Its
GroupNorms are plain GroupNorm with eps 1e-5, not the fused kernel (the JAX
package runs flax's nn.GroupNorm there too), so they stay `nn.GroupNorm`.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def _groups(group_num: int, channels: int) -> int:
    g = min(group_num, channels)
    while channels % g != 0:
        g -= 1
    return max(g, 1)


class BasicBlock(nn.Module):
    """conv3×3-GN-ReLU → conv3×3-GN, residual (conv3×3-GN when the width
    changes), ReLU."""

    def __init__(self, in_dim: int, mid_dim: int, out_dim: int, group_num: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, mid_dim, 3, padding=1)
        self.gn1 = nn.GroupNorm(_groups(group_num, mid_dim), mid_dim, eps=1e-5)
        self.conv2 = nn.Conv2d(mid_dim, out_dim, 3, padding=1)
        self.gn2 = nn.GroupNorm(_groups(group_num, out_dim), out_dim, eps=1e-5)
        if in_dim != out_dim:
            self.id_conv = nn.Conv2d(in_dim, out_dim, 3, padding=1)
            self.id_gn = nn.GroupNorm(_groups(group_num, out_dim), out_dim, eps=1e-5)
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
                 group_num: int = 16):
        super().__init__()
        b = base_dim
        outs = [b] + [b * (2**k) for k in range(1, num_blocks)]
        mids = [b] + outs[:-1]
        ins = [in_channels] + outs[:-1]
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block{i + 1}", BasicBlock(ins[i], mids[i], outs[i], group_num)
            )

    def forward(self, cond):
        x = cond
        for i in range(self.num_blocks):
            if i > 0:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"block{i + 1}")(x)
        return x
