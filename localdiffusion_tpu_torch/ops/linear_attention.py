"""Streaming linear attention: the two CUDA kernels, the fold between them,
and the plain versions.

Port of `localdiffusion_tpu/ops/pallas_linear_attention.py`
(`linear_attention_fused`: `_kv_kernel`, the XLA fold, `_q_kernel`).  The
kernels are `csrc/linear_attention.cu` (see the source for the design):

  * `linear_attention_kv` — pass 1: RMSNorm → k projection → per column
    the row's max m, exp-sum l and Gram G = Σ xnᵀ·exp(k − m), one merged
    (m, l, G) per row as the TPU kernel returns it.  Inside, each of
    `blocks_per_row(N)` blocks takes a share of the row's 64-token tiles
    and writes its partial to a scratch buffer; the thread-block cluster
    (`CLUSTER` blocks) holding the row's last block merges them by the
    log-sum-exp rule in block order (a per-row counter, left at zero);
  * `fold` — PyTorch on [B, C, 128] numbers, as the JAX package does this
    step in XLA: ctxᵀ = Wvᵀ·G / l under the cross-head mask, folded with
    the output projection into one [128, C] weight per row;
  * `linear_attention_q` — pass 2: RMSNorm → q projection → per-head
    softmax → ·W̃ + b → RMSNorm out.

The attribution variants (`scripts.bench_linatt_attrib`, the port of
`scripts/bench_linatt_attrib.py`'s `kv_kernel` and `q_kernel` with
`use_exp=False`) are the same two kernels with every exponential, the
rescales and the merge's weights included, replaced by a·0.5 + 1 of the
same argument: `kv_linear_exp` and `q_linear_exp`, with the plain versions
`kv_linear_reference` (the kernel's tile-by-tile online recurrence: with
a linear map the result depends on the tiling) and `q_pass_reference(...,
exp=lin_exp)`.

`linear_attention` chains them for a CUDA tensor inside the JAX package's
gate (`supports`: 4 heads of 32, C ∈ {32, 64, 128}, bf16, h·w ≥ 4096) and
raises outside it; a CPU tensor gets the plain version,
`linear_attention_reference`, the unfused math of the JAX package's
`LinearAttention`.  Each kernel wrapper also has its own plain version for
CPU tensors (`kv_reference`: the blocks' partials, `kv_partials_reference`,
merged by `merge_kv`; `q_pass_reference`), so `linear_attention_two_pass`
runs the kernels' algorithm end to end on the CPU.

Where autograd records the call, `linear_attention` goes through
`LinearAttentionFn`, one Function over kv, the fold and q, whose backward
recomputes through `linear_attention_reference` (the JAX package's `_bwd`
through `linear_attention_folded_reference`); the kernels' own wrappers
refuse such a call.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops.autograd import needs_graph, recompute_grads, refuse_graph

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD
CHANNELS = (32, 64, 128)
MIN_HW = 4096  # the JAX package engages its kernel at this many pixels
TILE = 64  # tokens per tile inside a kernel block (csrc: kTok)
CLUSTER = 2  # kv blocks that merge a row together (csrc: kCluster)
BLOCK_STEP = 8  # kv blocks per row are a multiple of this (csrc: kBlockStep)
MAX_BLOCKS = 64  # kv blocks per row at most (csrc: kMaxBlocks)


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


def blocks_per_row(n: int) -> int:
    """The kv kernel's blocks per row, from the row's token count alone (as
    the JAX package takes its tile from h·w alone): 16 below 32,768 tokens,
    32 from there (the fastest of 8, 16 and 32 at the 256px chain's sites
    at batch 8 on an H100).  Each block rounds exp(k − m) against its own
    running max, so a split that followed the batch would make a row's
    output depend on the rows beside it."""
    return 32 if n >= 32768 else 16


def block_ranges(n: int, nb: int, tile: int = TILE) -> list:
    """The token range [start, end) of each of a row's `nb` kv blocks: the
    row's ceil(n / tile) tiles split as evenly as whole tiles allow (block p
    takes tiles p·T // nb up to (p + 1)·T // nb), the last tile cut at n.
    A block may be empty when the row has fewer tiles than blocks."""
    tiles = -(-n // tile)
    return [(min(n, tile * (p * tiles // nb)), min(n, tile * ((p + 1) * tiles // nb)))
            for p in range(nb)]


def lin_exp(a):
    """The attribution variant's exponential: a·0.5 + 1, and 0 at a = −inf
    (an empty block, or no max yet), where exp gives 0."""
    return torch.where(torch.isneginf(a), torch.zeros_like(a), a * 0.5 + 1.0)


def _lin_weight(a, b):
    """lin_exp(a − b), and 0 wherever a = −inf (the kernel's `weight`):
    a token past n or a block without a max yet, whatever b is."""
    return torch.where(torch.isneginf(a), torch.zeros_like(a), (a - b) * 0.5 + 1.0)


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

def kv_partials_reference(x, g_in, wk, nb):
    """The kv blocks' partials: x [B, N, C] bf16, wk [C, 128] bf16 → for
    each of the `nb` blocks of `block_ranges` m, l [B, nb, 128] and
    G [B, nb, C, 128], float32, relative to the block's own max (an empty
    block: m = −inf, l = G = 0)."""
    b, n, c = x.shape
    xn = _rms(x, g_in, torch.bfloat16).float()
    k = (xn @ wk.float()).to(torch.bfloat16).float()
    m = torch.full((b, nb, HIDDEN), -math.inf, dtype=torch.float32, device=x.device)
    l = torch.zeros((b, nb, HIDDEN), dtype=torch.float32, device=x.device)
    gram = torch.zeros((b, nb, c, HIDDEN), dtype=torch.float32, device=x.device)
    for p, (s, e) in enumerate(block_ranges(n, nb)):
        if s == e:
            continue
        m[:, p] = k[:, s:e].amax(dim=1)
        ex = torch.exp(k[:, s:e] - m[:, p, None])
        l[:, p] = ex.sum(dim=1)
        gram[:, p] = torch.einsum("bnc,bnd->bcd", xn[:, s:e], ex.to(torch.bfloat16).float())
    return m, l, gram


def merge_kv(m, l, gram, exp=torch.exp):
    """The blocks' partials of a row as one, by the log-sum-exp rule: each
    block's l and G rescaled by exp(m_block − m_row) and summed (`exp`:
    the attribution variant passes `lin_exp`).  Returns
    m, l [B, 128] and G [B, C, 128].  The sums run in float64, so the
    float32 result does not depend on the rows beside it (PyTorch may reduce
    in another order for another batch)."""
    mrow = m.amax(dim=1)
    w = exp(m - mrow[:, None])  # [B, nb, 128]
    return (mrow, (l * w).sum(dim=1, dtype=torch.float64).float(),
            (gram * w[:, :, None, :]).sum(dim=1, dtype=torch.float64).float())


def kv_reference(x, g_in, wk, nb):
    """Plain pass 1: the kv kernel's function, its blocks' partials merged.
    x [B, N, C] bf16, wk [C, 128] bf16 → m, l [B, 128], G [B, C, 128]
    float32, l and G relative to m."""
    return merge_kv(*kv_partials_reference(x, g_in, wk, nb))


def kv_linear_reference(x, g_in, wk, nb, tile=TILE):
    """Plain pass 1 of the attribution variant (`kv_linear_exp`): every
    exponential a·0.5 + 1 (`lin_exp`).  A linear map does not compose as
    exp does (lin(a − b)·lin(b − c) ≠ lin(a − c)), so the result depends on
    where the running max is rescaled: this runs the kernel's recurrence,
    each of the `nb` blocks of `block_ranges(n, nb, tile)` walking its tiles
    of `tile` tokens in order (the max over the tile, the rescale
    lin(m_old − m_new) of l and G, then the tile's lin(k − m_new)), and
    merges the blocks' partials with `merge_kv(..., exp=lin_exp)`.  The
    JAX script's single pass over tiles of T tokens is nb = 1, tile = T.
    x [B, N, C] bf16, wk [C, 128] bf16 → m, l [B, 128], G [B, C, 128]
    float32.  The blocks step together, one tile each per step (a block
    past its last tile holds still)."""
    b, n, c = x.shape
    xn = _rms(x, g_in, torch.bfloat16).float()
    k = (xn @ wk.float()).to(torch.bfloat16).float()
    ranges = block_ranges(n, nb, tile)
    steps = max(-(-(e - s) // tile) for s, e in ranges)
    dev = x.device
    m = torch.full((b, nb, HIDDEN), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nb, HIDDEN), dtype=torch.float32, device=dev)
    gram = torch.zeros((b, nb, c, HIDDEN), dtype=torch.float32, device=dev)
    # token index of (block, step, position), n (a padding token: k = −inf,
    # xn = 0) where the block has none
    pos = torch.arange(tile, device=dev)
    k = torch.cat([k, k.new_full((b, 1, HIDDEN), -math.inf)], 1)
    xn = torch.cat([xn, xn.new_zeros((b, 1, c))], 1)
    for i in range(steps):
        idx = torch.stack([torch.where(s + i * tile + pos < e, s + i * tile + pos, n)
                           for s, e in ranges])  # [nb, tile]
        kt, xt = k[:, idx], xn[:, idx]  # [B, nb, T, 128], [B, nb, T, C]
        m_new = torch.maximum(m, kt.amax(dim=2))
        f = _lin_weight(m, m_new)
        et = _lin_weight(kt, m_new[:, :, None])
        l = l * f + et.sum(dim=2)
        gram = gram * f[:, :, None] + torch.einsum(
            "bptc,bptd->bpcd", xt, et.to(torch.bfloat16).float())
        m = m_new
    return merge_kv(m, l, gram, exp=lin_exp)


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


def _check_aligned(**tensors):
    """The kernels copy and store bf16 data 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def _lib():
    return _build.load("linear_attention")


_counters: dict = {}
_retired: list = []
_counters_lock = threading.Lock()


def _row_counters(device, b):
    """The kv kernel's per-row counters on `device`, at least `b` of them:
    zero when made, and every launch leaves them at zero, so one buffer
    serves every launch on the device's stream (and a CUDA graph's replay).
    A larger batch grows it into a new buffer; the old one is kept alive
    (`_retired`) for the life of the process, since a captured graph
    launches on the buffer it captured and a freed one would be reused with
    other contents.  Under a lock: the serving threads may both look for
    the buffer, and one may grow it, at once."""
    with _counters_lock:
        cnt = _counters.get(device)
        if cnt is None or cnt.numel() < b:
            if cnt is not None:
                _retired.append(cnt)
            cnt = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
            _counters[device] = cnt
        return cnt


def _kv(counted, symbol, plain, x, g_in, wk, nb):
    """Pass 1 through the C function `symbol` (counted on `counted`), or
    `plain` on a CPU tensor."""
    _check_rows(x)
    b, n, c = x.shape
    _check_param("g_in", g_in, (c,), torch.float32, x.device)
    _check_param("wk", wk, (c, HIDDEN), torch.bfloat16, x.device)
    if nb < BLOCK_STEP or nb % BLOCK_STEP or nb > MAX_BLOCKS:
        raise ValueError(f"nb {nb} is not a multiple of {BLOCK_STEP} up to {MAX_BLOCKS}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return plain(x, g_in, wk, nb)
    refuse_graph(symbol, x, g_in, wk)
    _check_aligned(x=x, wk=wk)
    m = torch.empty((b, HIDDEN), dtype=torch.float32, device=x.device)
    l = torch.empty_like(m)
    gram = torch.empty((b, c, HIDDEN), dtype=torch.float32, device=x.device)
    scratch = torch.empty((b, nb, c + 2, HIDDEN), dtype=torch.float32, device=x.device)
    fn = getattr(_lib(), symbol)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        counter = _row_counters(x.device, b)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g_in.data_ptr(), wk.data_ptr(), scratch.data_ptr(),
                 counter.data_ptr(), m.data_ptr(), l.data_ptr(), gram.data_ptr(), b, n, c,
                 nb, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    _build.count_launch(counted)
    return m, l, gram


def linear_attention_kv(x, g_in, wk, nb):
    """Pass 1 (the kv kernel).  x: [B, N, C] bf16 contiguous; g_in: [C]
    float32; wk: [C, 128] bf16; nb: blocks per row, a multiple of 8 up to
    64 (`blocks_per_row(N)`).  Returns m, l [B, 128] and G [B, C, 128]
    float32, l and G relative to m.  A CUDA tensor runs the kernel; a CPU
    tensor runs the plain version, `kv_reference`."""
    return _kv(linear_attention_kv, "linear_attention_kv", kv_reference, x, g_in, wk, nb)


linear_attention_kv.launches = 0


def kv_linear_exp(x, g_in, wk, nb):
    """Pass 1 of the attribution variant: `linear_attention_kv` with every
    exponential a·0.5 + 1 (the kernel's `kLin` instantiation); the plain
    version on a CPU tensor is `kv_linear_reference`."""
    return _kv(kv_linear_exp, "linear_attention_kv_linexp", kv_linear_reference,
               x, g_in, wk, nb)


kv_linear_exp.launches = 0


# ---------------------------------------------------------------------------
# between the passes
# ---------------------------------------------------------------------------

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


def q_pass_reference(x, g_in, wq, wtil, b_out, g_out, dim_head=DIM_HEAD, exp=None):
    """Plain pass 2: x [B, N, C] bf16, wq [C, 128] bf16, wtil [B, 128, C]
    bf16 → out [B, N, C] bf16 (without the residual).  `exp=lin_exp` is the
    attribution variant's softmax, lin(q − m) / Σ_head lin(q − m) with m
    the token's max over its 128 columns (the JAX script's q_kernel: a
    softmax does not see the shift, the linear map does)."""
    b, n, c = x.shape
    xn = _rms(x, g_in, torch.bfloat16).float()
    q = (xn @ wq.float()).to(torch.bfloat16).float()
    q = q.reshape(b, n, -1, dim_head)
    if exp is None:
        p = torch.softmax(q, dim=-1)
    else:
        e = exp(q - q.amax(dim=(-2, -1), keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    qs = p.to(torch.bfloat16).float() * _scale(dim_head)
    qs = qs.to(torch.bfloat16).float().reshape(b, n, -1)
    out = torch.einsum("bnd,bdc->bnc", qs, wtil.float()) + b_out.float()
    return _rms(out.to(torch.bfloat16), g_out, torch.bfloat16)


def _q(counted, symbol, plain, x, g_in, wq, wtil, b_out, g_out):
    """Pass 2 through the C function `symbol` (counted on `counted`), or
    `plain` on a CPU tensor."""
    _check_rows(x)
    b, n, c = x.shape
    for name, t in (("g_in", g_in), ("b_out", b_out), ("g_out", g_out)):
        _check_param(name, t, (c,), torch.float32, x.device)
    _check_param("wq", wq, (c, HIDDEN), torch.bfloat16, x.device)
    _check_param("wtil", wtil, (b, HIDDEN, c), torch.bfloat16, x.device)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return plain(x, g_in, wq, wtil, b_out, g_out)
    refuse_graph(symbol, x, g_in, wq, wtil, b_out, g_out)
    _check_aligned(x=x, wq=wq, wtil=wtil)
    out = torch.empty_like(x)
    fn = getattr(_lib(), symbol)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
    fn.restype = ci
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g_in.data_ptr(), wq.data_ptr(), wtil.data_ptr(),
                 b_out.data_ptr(), g_out.data_ptr(), out.data_ptr(), b, n, c,
                 _scale(DIM_HEAD), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    _build.count_launch(counted)
    return out


def q_linear_conditioning(x, g_in, wq, dim_head=DIM_HEAD):
    """Per token [B, N], the attribution variant's worst head of
    Σ|lin(q − m)| / |Σ lin(q − m)|: how much the head's normalisation
    amplifies a change of one term (1 where every term is positive; large
    where lin(q − m) = (q − m)·0.5 + 1 goes negative and the sum cancels)."""
    b, n, _ = x.shape
    xn = _rms(x, g_in, torch.bfloat16).float()
    q = (xn @ wq.float()).to(torch.bfloat16).float().reshape(b, n, -1, dim_head)
    e = lin_exp(q - q.amax(dim=(-2, -1), keepdim=True))
    return (e.abs().sum(dim=-1) / e.sum(dim=-1).abs()).amax(dim=-1)


def linear_attention_q(x, g_in, wq, wtil, b_out, g_out):
    """Pass 2 (the q kernel).  x: [B, N, C] bf16 contiguous; g_in, b_out,
    g_out: [C] float32; wq: [C, 128] bf16; wtil: [B, 128, C] bf16.  Returns
    [B, N, C] bf16.  A CUDA tensor runs the kernel; a CPU tensor runs the
    plain version."""
    return _q(linear_attention_q, "linear_attention_q", q_pass_reference,
              x, g_in, wq, wtil, b_out, g_out)


linear_attention_q.launches = 0


def q_linear_exp(x, g_in, wq, wtil, b_out, g_out):
    """Pass 2 of the attribution variant: `linear_attention_q` with the
    softmax's exponentials a·0.5 + 1 (the kernel's `kLin` instantiation);
    the plain version on a CPU tensor is `q_pass_reference(...,
    exp=lin_exp)`."""
    plain = lambda *a: q_pass_reference(*a, exp=lin_exp)
    return _q(q_linear_exp, "linear_attention_q_linexp", plain, x, g_in, wq, wtil, b_out, g_out)


q_linear_exp.launches = 0


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
    wq, wk, wv = split_qkv(w_qkv)
    g_in = g_in.float().contiguous()
    _, l, gram = linear_attention_kv(xr, g_in, wk, blocks_per_row(h * w))
    wtil = fold(l, gram, wv, w_out)
    out = linear_attention_q(xr, g_in, wq, wtil, b_out.float().contiguous(),
                             g_out.float().contiguous())
    return out.reshape(b, h, w, c)


def _linear_attention(x, g_in, w_qkv, w_out, b_out, g_out, heads, dim_head):
    """The two kernels on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        return linear_attention_two_pass(x, g_in, w_qkv, w_out, b_out, g_out)
    return linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out, heads, dim_head)


class LinearAttentionFn(torch.autograd.Function):
    """`linear_attention` with a gradient, over the whole two-pass function
    (kv, the fold, q): the forward saves x and the parameters as given
    (`models.blocks.LinearAttention` hands views of its `nn.Parameter`s,
    which carry the gradients back), and the backward is autograd through
    `linear_attention_reference` on them."""

    @staticmethod
    def forward(ctx, x, g_in, w_qkv, w_out, b_out, g_out, heads, dim_head):
        ctx.heads, ctx.dim_head = heads, dim_head
        ctx.save_for_backward(x, g_in, w_qkv, w_out, b_out, g_out)
        return _linear_attention(x, g_in, w_qkv, w_out, b_out, g_out, heads, dim_head)

    @staticmethod
    def backward(ctx, grad):
        fn = lambda *a: linear_attention_reference(*a, ctx.heads, ctx.dim_head)
        return recompute_grads(fn, ctx.saved_tensors, ctx.needs_input_grad[:6], grad) + (None, None)


def linear_attention(x, g_in, w_qkv, w_out, b_out, g_out, heads=HEADS,
                     dim_head=DIM_HEAD):
    """LinearAttention without the residual, x [B, H, W, C].

    A CUDA tensor must be contiguous and inside `supports`, and runs the two
    kernels; a CPU tensor runs the plain version,
    `linear_attention_reference`.  Where autograd records the call, it goes
    through `LinearAttentionFn`.
    """
    if x.is_cuda:
        if not supports(x.shape, heads, dim_head, x.dtype):
            raise ValueError(
                f"linear attention kernels do not take {tuple(x.shape)} {x.dtype} "
                f"with heads={heads} dim_head={dim_head}"
            )
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    params = (g_in, w_qkv, w_out, b_out, g_out)
    if needs_graph(x, *params):
        return LinearAttentionFn.apply(x, *params, heads, dim_head)
    return _linear_attention(x, *params, heads, dim_head)
