"""Streaming linear attention: the two CUDA kernels, the fold between them,
and the plain versions.

Port of `localdiffusion_tpu/ops/pallas_linear_attention.py`
(`linear_attention_fused`: `_kv_kernel`, the XLA fold, `_q_kernel`).  The
kernels are `csrc/linear_attention.cu` (see the source for the design):

  * `linear_attention_kv` — pass 1, per block of `per_block` tokens of a
    row: RMSNorm → k projection → per-column max m, exp-sum l and Gram
    G = Σ xnᵀ·exp(k − m), written as partials;
  * `merge_kv` + `fold` — PyTorch on [B, C, 128] numbers, as the JAX package
    does this step in XLA: the partials merged by the log-sum-exp rule, then
    ctxᵀ = Wvᵀ·G / l under the cross-head mask, folded with the output
    projection into one [128, C] weight per row;
  * `linear_attention_q` — pass 2: RMSNorm → q projection → per-head
    softmax → ·W̃ + b → RMSNorm out.

`linear_attention` chains them for a CUDA tensor inside the JAX package's
gate (`supports`: 4 heads of 32, C ∈ {32, 64, 128}, bf16, h·w ≥ 4096) and
raises outside it; a CPU tensor gets the plain version,
`linear_attention_reference`, the unfused math of the JAX package's
`LinearAttention`.  Each kernel wrapper also has its own plain version
(`kv_partials_reference`, `q_pass_reference`) for CPU tensors, so
`linear_attention_two_pass` runs the kernels' algorithm end to end on the
CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD
CHANNELS = (32, 64, 128)
MIN_HW = 4096  # the JAX package engages its kernel at this many pixels
SUBTILE = 64  # tokens per sub-tile inside a kernel block (csrc: kTok)
BLOCKS_PER_ROW = 64  # two blocks per SM of an H100 (132 SMs) at batch 4


def supports(x_shape, heads: int, dim_head: int, dtype) -> bool:
    """Whether the kernels take an NHWC [B, H, W, C] tensor: the JAX
    package's gate (`supports_normal_layout` at h·w ≥ 4096, bf16)."""
    b, h, w, c = x_shape
    if heads != HEADS or dim_head != DIM_HEAD or c not in CHANNELS:
        return False
    if dtype != torch.bfloat16 or h * w < MIN_HW:
        return False
    r = 128 // c  # tokens per 128-lane row of the TPU kernel
    return w % r == 0 and (h * (w // r)) % 8 == 0


def tokens_per_block(n: int) -> int:
    """Tokens each kernel block takes, from the row's token count alone (as
    the JAX package takes its tile from h·w alone): about `BLOCKS_PER_ROW`
    blocks a row, in whole sub-tiles.  Each block rounds exp(k − m) against
    its own max, so a block size that followed the batch would make a
    row's output depend on the rows beside it."""
    per = -(-n // BLOCKS_PER_ROW)
    return -(-per // SUBTILE) * SUBTILE


def _rms(x, g, dtype):
    """l2-normalise over the last axis, scale by g·√C (norm clamped at
    1e-12), in float32, cast to `dtype`."""
    x32 = x.float()
    norm = torch.sqrt((x32 * x32).sum(dim=-1, keepdim=True))
    return (x32 / norm.clamp_min(1e-12) * g.float() * math.sqrt(x.shape[-1])).to(dtype)


def linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out,
                               heads=HEADS, dim_head=DIM_HEAD):
    """The unfused LinearAttention (without the residual), computing in
    x's type as the JAX module computes in its `dtype`.

    x: [B, H, W, C]; g_in, b_out, g_out: [C]; w_qkv: [C, 3·hidden];
    w_out: [hidden, C].  Returns [B, H, W, C].
    """
    dt = x.dtype
    b, h, w, c = x.shape
    n = h * w
    xn = _rms(x.reshape(b, n, c), g_in, dt)
    # tokens last ([b, H, d, n] views), so the softmax over all tokens runs
    # along the last axis
    qkv = (xn @ w_qkv.to(dt)).transpose(1, 2).reshape(b, 3, heads, dim_head, n)
    q, k, v = qkv.unbind(1)
    # the scale is a weakly typed scalar in JAX: it takes the array's type
    scale = torch.tensor(dim_head**-0.5, dtype=dt)
    q = torch.softmax(q.float(), dim=2).to(dt) * scale
    k = torch.softmax(k.float(), dim=3).to(dt)
    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(b, heads * dim_head, n)
    out = (out.transpose(1, 2) @ w_out.to(dt)) + b_out.to(dt)  # conv, then its bias
    return _rms(out, g_out, dt).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# pass 1
# ---------------------------------------------------------------------------

def kv_partials_reference(x, g_in, wk, per_block):
    """Plain pass 1: x [B, N, C] bf16, wk [C, 128] bf16 → per block of
    `per_block` tokens m, l [B, nb, 128] and G [B, nb, C, 128], float32."""
    b, n, c = x.shape
    nb = -(-n // per_block)
    xn = _rms(x, g_in, torch.bfloat16).float()
    k = (xn @ wk.float()).to(torch.bfloat16).float()
    pad = nb * per_block - n
    if pad:
        xn = torch.cat([xn, xn.new_zeros(b, pad, c)], dim=1)
        k = torch.cat([k, k.new_full((b, pad, k.shape[-1]), -math.inf)], dim=1)
    k = k.reshape(b, nb, per_block, -1)
    m = k.amax(dim=2)
    e = torch.exp(k - m[:, :, None])
    gram = torch.einsum("btnc,btnd->btcd", xn.reshape(b, nb, per_block, c),
                        e.to(torch.bfloat16).float())
    return m, e.sum(dim=2), gram


def _check_rows(x, name="x"):
    if x.ndim != 3:
        raise ValueError(f"{name} must be [B, N, C], got shape {tuple(x.shape)}")
    if x.shape[-1] not in CHANNELS:
        raise ValueError(f"C={x.shape[-1]} not in the kernels' {CHANNELS}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_param(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    from localdiffusion_tpu_torch.ops import _build

    return _build.load("linear_attention")


def linear_attention_kv(x, g_in, wk, per_block):
    """Pass 1 (the kv kernel).  x: [B, N, C] bf16 contiguous; g_in: [C]
    float32; wk: [C, 128] bf16.  Returns m, l [B, nb, 128] and
    G [B, nb, C, 128] float32, nb = ceil(N / per_block), each block's numbers
    relative to its own max.  A CUDA tensor runs the kernel; a CPU tensor
    runs the plain version."""
    _check_rows(x)
    b, n, c = x.shape
    _check_param("g_in", g_in, (c,), torch.float32, x.device)
    _check_param("wk", wk, (c, HIDDEN), torch.bfloat16, x.device)
    if per_block <= 0 or per_block % SUBTILE:
        raise ValueError(f"per_block {per_block} is not a multiple of {SUBTILE}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return kv_partials_reference(x, g_in, wk, per_block)
    nb = -(-n // per_block)
    m = torch.empty((b, nb, HIDDEN), dtype=torch.float32, device=x.device)
    l = torch.empty_like(m)
    gram = torch.empty((b, nb, c, HIDDEN), dtype=torch.float32, device=x.device)
    fn = _lib().linear_attention_kv
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g_in.data_ptr(), wk.data_ptr(), m.data_ptr(),
                 l.data_ptr(), gram.data_ptr(), b, n, c, per_block, stream)
    if err != 0:
        raise RuntimeError(f"linear_attention_kv launch failed: CUDA error {err}")
    linear_attention_kv.launches += 1
    return m, l, gram


linear_attention_kv.launches = 0


# ---------------------------------------------------------------------------
# between the passes
# ---------------------------------------------------------------------------

def merge_kv(m, l, gram):
    """The blocks' partials of a row as one: each block's l and G rescaled
    by exp(m_block − m_row) and summed.  Returns l [B, 128], G [B, C, 128].
    The sums run in float64, so the float32 result does not depend on the
    rows beside it (PyTorch may reduce in another order for another
    batch)."""
    w = torch.exp(m - m.amax(dim=1, keepdim=True))  # [B, nb, 128]
    return ((l * w).sum(dim=1, dtype=torch.float64).float(),
            (gram * w[:, :, None, :]).sum(dim=1, dtype=torch.float64).float())


def fold(l, gram, wv, w_out, heads=HEADS, dim_head=DIM_HEAD):
    """The per-row weight of pass 2, W̃ [B, hidden, C] bf16, as the JAX
    package folds it (`pallas_linear_attention.py:352-360`): ctxᵀ = Wvᵀ·G,
    divided by l per column, the cross-head entries zeroed, rounded to bf16,
    then contracted with the (bf16) output projection.  The contractions run
    in float64 and round to float32, so a row's W̃ does not depend on the
    batch (a batched product may sum in another order for another batch)."""
    hidden = heads * dim_head
    ctxt = torch.einsum("ce,bcd->bed", wv.double(), gram.double()).float()  # [B, e, d]
    head = torch.arange(hidden, device=gram.device) // dim_head
    same_head = (head[:, None] == head[None, :]).to(torch.bfloat16)
    ctxn = (ctxt / l[:, None, :]).to(torch.bfloat16) * same_head
    wtil = torch.einsum("bed,ec->bdc", ctxn.double(),
                        w_out.to(torch.bfloat16).double()).float()
    return wtil.to(torch.bfloat16).contiguous()


# ---------------------------------------------------------------------------
# pass 2
# ---------------------------------------------------------------------------

def _scale(dim_head):
    """dim_head^-½ as the bf16 number the JAX kernel multiplies by."""
    return float(torch.tensor(dim_head**-0.5, dtype=torch.bfloat16))


def q_pass_reference(x, g_in, wq, wtil, b_out, g_out, dim_head=DIM_HEAD):
    """Plain pass 2: x [B, N, C] bf16, wq [C, 128] bf16, wtil [B, 128, C]
    bf16 → out [B, N, C] bf16 (without the residual)."""
    b, n, c = x.shape
    xn = _rms(x, g_in, torch.bfloat16).float()
    q = (xn @ wq.float()).to(torch.bfloat16).float()
    q = q.reshape(b, n, -1, dim_head)
    qs = torch.softmax(q, dim=-1).to(torch.bfloat16).float() * _scale(dim_head)
    qs = qs.to(torch.bfloat16).float().reshape(b, n, -1)
    out = torch.einsum("bnd,bdc->bnc", qs, wtil.float()) + b_out.float()
    return _rms(out.to(torch.bfloat16), g_out, torch.bfloat16)


def linear_attention_q(x, g_in, wq, wtil, b_out, g_out, per_block):
    """Pass 2 (the q kernel).  x: [B, N, C] bf16 contiguous; g_in, b_out,
    g_out: [C] float32; wq: [C, 128] bf16; wtil: [B, 128, C] bf16.  Returns
    [B, N, C] bf16.  A CUDA tensor runs the kernel; a CPU tensor runs the
    plain version."""
    _check_rows(x)
    b, n, c = x.shape
    for name, t in (("g_in", g_in), ("b_out", b_out), ("g_out", g_out)):
        _check_param(name, t, (c,), torch.float32, x.device)
    _check_param("wq", wq, (c, HIDDEN), torch.bfloat16, x.device)
    _check_param("wtil", wtil, (b, HIDDEN, c), torch.bfloat16, x.device)
    if per_block <= 0 or per_block % SUBTILE:
        raise ValueError(f"per_block {per_block} is not a multiple of {SUBTILE}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return q_pass_reference(x, g_in, wq, wtil, b_out, g_out)
    out = torch.empty_like(x)
    fn = _lib().linear_attention_q
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g_in.data_ptr(), wq.data_ptr(), wtil.data_ptr(),
                 b_out.data_ptr(), g_out.data_ptr(), out.data_ptr(), b, n, c,
                 per_block, _scale(DIM_HEAD), stream)
    if err != 0:
        raise RuntimeError(f"linear_attention_q launch failed: CUDA error {err}")
    linear_attention_q.launches += 1
    return out


linear_attention_q.launches = 0


# ---------------------------------------------------------------------------
# the whole function
# ---------------------------------------------------------------------------

def split_qkv(w_qkv, hidden=HIDDEN):
    """Wq, Wk as contiguous bf16 [C, hidden] (the kernels' operands), Wv as
    it is, from the [C, 3·hidden] projection."""
    wq, wk, wv = (w_qkv[:, i * hidden:(i + 1) * hidden] for i in range(3))
    return (wq.to(torch.bfloat16).contiguous(), wk.to(torch.bfloat16).contiguous(), wv)


def linear_attention_two_pass(x, g_in, w_qkv, w_out, b_out, g_out):
    """Pass 1, the fold and pass 2 on x [B, H, W, C] bf16 (contiguous):
    the kernels on a CUDA tensor, their plain versions on a CPU tensor.
    Returns [B, H, W, C] bf16 (without the residual)."""
    b, h, w, c = x.shape
    xr = x.reshape(b, h * w, c)
    per_block = tokens_per_block(h * w)
    wq, wk, wv = split_qkv(w_qkv)
    g_in = g_in.float().contiguous()
    m, l, gram = linear_attention_kv(xr, g_in, wk, per_block)
    wtil = fold(*merge_kv(m, l, gram), wv, w_out)
    out = linear_attention_q(xr, g_in, wq, wtil, b_out.float().contiguous(),
                             g_out.float().contiguous(), per_block)
    return out.reshape(b, h, w, c)


def linear_attention(x, g_in, w_qkv, w_out, b_out, g_out, heads=HEADS,
                     dim_head=DIM_HEAD):
    """LinearAttention without the residual, x [B, H, W, C].

    A CUDA tensor must be contiguous and inside `supports`, and runs the two
    kernels; a CPU tensor runs the plain version,
    `linear_attention_reference`.
    """
    if x.is_cuda:
        if not supports(x.shape, heads, dim_head, x.dtype):
            raise ValueError(
                f"linear attention kernels do not take {tuple(x.shape)} {x.dtype} "
                f"with heads={heads} dim_head={dim_head}"
            )
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        return linear_attention_two_pass(x, g_in, w_qkv, w_out, b_out, g_out)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out, heads, dim_head)
