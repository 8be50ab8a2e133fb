"""Full softmax attention: the CUDA kernel and its plain version.

Port of `localdiffusion_tpu/ops/attention.py` and of the Pallas kernel it
dispatches to (`ops/pallas_attention.py::_attn_kernel`, through
`flash_attention`).  Layout: q, k, v are [B, N, H, D] (batch, tokens,
heads, head_dim).  At N >= 256 tokens `full_attention` goes to
`flash_attention`, whose kernel is `csrc/flash_attention.cu`: one block per
(batch·head, tile of query rows), K/V tiles streamed through shared memory
with an online softmax in float32.  On a CUDA tensor the wrapper launches
the kernel or raises; on a CPU tensor it computes the plain version,
`xla_attention`.  There is no fallback between the two.  Where autograd
records the call, `flash_attention` goes through `FlashAttentionFn`, whose
backward recomputes through `xla_attention` (the JAX package's
`_flash_bwd`).
"""

from __future__ import annotations

import ctypes

import torch

from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops.autograd import needs_graph, recompute_grads, refuse_graph

FLASH_MIN_TOKENS = 256
HEAD_DIM = 32  # the kernel's one instantiation (the configs' attn_dim_head)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def xla_attention(q, k, v, scale=None):
    """Plain softmax(QKᵀ·scale)·V with float32 scores."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, N, D]
    sim = torch.einsum("bhid,bhjd->bhij", qh.float(), kh.float()) * scale
    attn = torch.softmax(sim, dim=-1).to(vh.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn.float(), vh.float())
    return out.to(q.dtype).transpose(1, 2)


def _check(q, k, v):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, N, H, D], got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")


def _launch(q, k, v, scale):
    b, n, h, d = q.shape
    refuse_graph("flash_attention", q, k, v)
    if d != HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel is built for {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride along head_dim")
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci] + [cl] * 9 + [ctypes.c_float, ci, vp]
    fn.restype = ci
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1), t.stride(2))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, h, d, *strides, float(scale), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    _build.count_launch(flash_attention)
    return out


def _flash_attention(q, k, v, scale):
    if q.is_cuda:
        return _launch(q, k, v, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")
    return xla_attention(q, k, v, scale)


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward saves q, k and v as
    given (the strided views of the qkv projection), and the backward is
    autograd through `xla_attention` on them (`_flash_bwd`).  Its gradients
    have the views' shapes, so autograd adds them into the projection's."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _flash_attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        fn = lambda q, k, v: xla_attention(q, k, v, ctx.scale)
        return recompute_grads(fn, ctx.saved_tensors, ctx.needs_input_grad[:3], grad) + (None,)


def flash_attention(q, k, v, scale=None):
    """softmax(QKᵀ·scale)·V (scale defaults to D^-½).

    q, k, v: [B, N, H, D] of one shape, float32 or bfloat16, any strides with
    a unit stride along D (the views `Attention` cuts from its qkv
    projection are taken as they are).  Returns [B, N, H, D] of q's type
    (contiguous from the kernel).  A CUDA tensor runs the kernel; a CPU
    tensor runs the plain version.  Where autograd records the call, it
    goes through `FlashAttentionFn`.
    """
    _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if needs_graph(q, k, v):
        return FlashAttentionFn.apply(q, k, v, scale)
    return _flash_attention(q, k, v, scale)


flash_attention.launches = 0


def full_attention(q, k, v, scale=None):
    """Full attention: the flash kernel's wrapper at N >= 256 tokens (as the
    JAX package dispatches its Pallas kernel), the plain version below."""
    if q.shape[1] >= FLASH_MIN_TOKENS:
        return flash_attention(q, k, v, scale)
    return xla_attention(q, k, v, scale)
