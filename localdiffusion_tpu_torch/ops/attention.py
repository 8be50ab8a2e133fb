"""Full softmax attention.  Port of `localdiffusion_tpu/ops/attention.py`.

Layout: q, k, v are [B, N, H, D] (batch, tokens, heads, head_dim).  At
N >= 256 tokens the JAX package runs its Pallas flash-attention kernel
(`ops/pallas_attention.py::_attn_kernel`); the port's kernel for it comes in
a later slice, so a CUDA tensor there raises instead of running the plain
version.  The 28px flagship never reaches the gate (49 tokens).
"""

from __future__ import annotations

import torch

FLASH_MIN_TOKENS = 256


def xla_attention(q, k, v, scale=None):
    """Plain softmax(QKᵀ·scale)·V with float32 scores."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, D]
    sim = torch.einsum("bhid,bhjd->bhij", qh.float(), kh.float()) * scale
    attn = torch.softmax(sim, dim=-1).to(vh.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn.float(), vh.float())
    return out.to(q.dtype).transpose(1, 2)


def full_attention(q, k, v, scale=None):
    """Full attention; N >= 256 on a CUDA tensor needs the flash kernel."""
    if q.shape[1] >= FLASH_MIN_TOKENS and q.is_cuda:
        raise NotImplementedError("flash attention kernel: next slice")
    return xla_attention(q, k, v, scale)
