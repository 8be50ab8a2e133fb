"""Fused GroupNorm + FiLM + SiLU: the CUDA kernels and their plain versions.

`groupnorm_film_silu` replaces `groupnorm_film_silu` of
`localdiffusion_tpu/ops/pallas_groupnorm.py` and takes its row gate
(`large_block`): a row of at most 512 KiB (h·w·c·4 bytes, whatever the
dtype) goes to the single-pass kernel, a larger one to the tiled pair.

  * single pass, `csrc/groupnorm_film_silu.cu` (replaces `_gn_kernel`): one
    launch, one thread-block cluster of k blocks per row.  The TPU kernel
    keeps a row in VMEM; here each block keeps its slice of the row in
    shared memory, so x is read from device memory once, and the blocks
    fold the group statistics (the mean, then the centred squares) through
    distributed shared memory.  `gn_plan` picks k, the slice and its shared
    memory from h, w, c, the groups and the dtype alone, never from the
    batch; its launches are counted on `groupnorm_film_silu.launches`;
  * tiled pair, `csrc/groupnorm_tiled.cu` (replaces `_stats_kernel` +
    `_apply_kernel`, `_gn_tiled_impl`): `gn_tiled_stats` writes each row's
    per-channel sum and sum of squares, [B, 2, C] float32 as the TPU kernel
    does, from one thread-block cluster of k blocks a row that sums in
    float64 and folds its blocks' sums on chip; `gn_tiled_apply` folds a row's sums to the group
    statistics in float64 and normalises, applies γ/β, FiLM and SiLU,
    streaming x 16 bytes a thread.  Two launches and no PyTorch op between
    them; the dispatcher launches the apply as a programmatic dependent of
    the stats pass, so that it starts while the stats pass ends.  Their
    plan (`gn_tiled_plan`) comes from h, w, c and the dtype alone, so a
    row's result does not depend on its batch.

Both kernels are bound by device memory; see the sources for the designs.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it computes its plain version.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from localdiffusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX package's row gate (`_MAX_VMEM_BLOCK_BYTES`): a larger row leaves
# the single-pass kernel
MAX_BLOCK_BYTES = 512 * 1024
MAX_GROUPS = 64  # csrc/groupnorm_tiled.cu: kMaxGroups
# the tiled pair's plan (csrc/groupnorm_tiled.cu), from gn_tiled_sweep.py's
# timings on the card (PERF.md).  The stats pass's blocks a row, a cluster:
# 8, faster than a non-portable 16 at each of the main paths' tiled sites
# with x in L2, as the op before leaves it (with L2 flushed, 16 is faster at
# the stem's f32 rows).  The apply pass's tile: at least GN_APPLY_TILE_BYTES
# of x, at most GN_APPLY_TILES tiles a row (16 to 32 at those sites, 128 to
# 256 blocks at batch 8), the fastest of 16 to 64 KiB there.
GN_TILED_CLUSTER = 8
GN_APPLY_TILE_BYTES = 32 * 1024
GN_APPLY_TILES = 32
# the single-pass kernel's launch plan (csrc/groupnorm_film_silu.cu)
GN_THREADS = 256  # kThreads
GN_MAX_CLUSTER = 16  # kMaxCluster: blocks a row; above 8 a non-portable cluster
# Rows of at least GN_SPLIT_ROW bytes (the 256px and stem sites, 8 rows a
# launch) are cut 8 ways, past 512 KiB 16 ways, so that a launch puts its
# rows on 64 to 128 SMs; smaller rows (the flagship's, 128 rows a launch)
# into slices of at most GN_SLICE_BYTES: more clusters of more blocks cost
# there more than they spread.
GN_SPLIT_ROW = 128 * 1024
GN_SLICE_BYTES = 64 * 1024
# Hopper: the most dynamic shared memory one block may take (227 KB), and a
# resident slice's limit, half of it, so that two blocks fit an SM and a
# cluster of 16 needs no more than 8 SMs of one GPC
SMEM_PER_BLOCK = 232448
GN_RESIDENT_SMEM = SMEM_PER_BLOCK // 2


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def gn_chunks(c: int, esize: int) -> int:
    """16-byte chunks in one pixel's c channels of esize bytes."""
    return c * esize // 16


def gn_smem(pixels: int, c: int, groups: int, esize: int, resident: bool) -> int:
    """Dynamic shared memory of one single-pass block: its slice of
    `pixels` pixels if resident, the threads' per-channel sums (one row of c
    floats per set of threads holding the same channels) and the group
    partials and statistics (csrc: gn_work_bytes)."""
    slice_bytes = _align128(pixels * c * esize) if resident else 0
    return slice_bytes + 4 * ((GN_THREADS // gn_chunks(c, esize)) * c + 4 * groups)


def gn_plan(h: int, w: int, c: int, groups: int, esize: int) -> dict:
    """The single-pass kernel's plan for an [*, h, w, c] input of esize-byte
    elements: k blocks a row (see GN_SPLIT_ROW; at most h·w), the pixels a
    block, whether the slice stays in shared memory (within
    `GN_RESIDENT_SMEM`) or is streamed, and the block's shared memory.  It
    depends on neither the batch nor the device: k fixes the order of the
    group sums, so a row gives the same result alone or in a batch."""
    hw = h * w
    row = hw * c * esize
    if row >= GN_SPLIT_ROW:
        k = 8 if row <= MAX_BLOCK_BYTES else GN_MAX_CLUSTER
    else:
        k = 1
        while row > k * GN_SLICE_BYTES:
            k *= 2
    k = min(k, hw)
    pixels = -(-hw // k)
    resident = gn_smem(pixels, c, groups, esize, True) <= GN_RESIDENT_SMEM
    return dict(k=k, pixels=pixels, resident=resident,
                smem=gn_smem(pixels, c, groups, esize, resident))


def gn_plan_of(shape, groups: int, dtype) -> dict:
    """`gn_plan` for an NHWC input of this shape and dtype: the batch is
    not read."""
    _, h, w, c = shape
    return gn_plan(h, w, c, groups, torch.empty((), dtype=dtype).element_size())


def large_block(shape) -> bool:
    """Whether an NHWC input of this shape takes the tiled pair: its row,
    counted at 4 bytes an element, is over `MAX_BLOCK_BYTES`."""
    _, h, w, c = shape
    return h * w * c * 4 > MAX_BLOCK_BYTES


def groupnorm_film_silu_reference(x, gamma, beta, scale=None, shift=None,
                                  groups=8, eps=1e-5):
    """Plain PyTorch GroupNorm + FiLM + SiLU, a transcription of
    `groupnorm_film_silu_reference` in the JAX package.

    x: [B, H, W, C]; gamma/beta: [C]; scale/shift: [B, C] or None.
    """
    b, h, w, c = x.shape
    cg = c // groups
    xg = x.reshape(b, h * w, groups, cg).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    normed = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = normed * gamma.float() + beta.float()
    if scale is not None:
        y = y * (scale.float()[:, None, None, :] + 1.0) + shift.float()[:, None, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype)


# ---------------------------------------------------------------------------
# the tiled pair's plain versions
# ---------------------------------------------------------------------------

def pick_tile(hw: int, c: int, budget: int = MAX_BLOCK_BYTES) -> int:
    """`_pick_tile` of the JAX package: the largest divisor of hw of at most
    max(8, budget / (4c)) pixels."""
    max_rows = max(8, budget // (c * 4))
    t = 1
    for d in range(1, hw + 1):
        if hw % d == 0 and d <= max_rows:
            t = d
    return t


def gn_tiled_plan(h: int, w: int, c: int, dtype) -> dict:
    """The tiled pair's plan for an [*, h, w, c] input of this dtype: the
    stats pass's k blocks a row (a cluster; at most h·w) and `pixels` a block
    (the last blocks' slices may be shorter or empty), and the apply pass's
    `apply_pixels` a block (`GN_APPLY_TILE_BYTES` of x, or a
    `GN_APPLY_TILES`-th of a larger row; the last tile of a row may be
    ragged).  It reads neither the batch nor the device: k and the slices
    fix the order of the row's sums, so a row gives the same result alone or
    in a batch."""
    hw = h * w
    pixel_bytes = c * torch.empty((), dtype=dtype).element_size()
    k = min(GN_TILED_CLUSTER, hw)
    tile_bytes = max(GN_APPLY_TILE_BYTES, -(-hw * pixel_bytes // GN_APPLY_TILES))
    return dict(k=k, pixels=-(-hw // k),
                apply_pixels=max(1, min(hw, tile_bytes // pixel_bytes)))


def _slice_sums(x, pixels: int):
    """Per row of x [B, H, W, C], the per-channel sum and sum of squares:
    float64 sums over each slice of `pixels` pixels, the slices folded in
    float64 and rounded once to float32: [B, 2, C].  In float64 the sums of
    a row are within ~1e-12 of the exact ones, so the rounded result is the
    same whatever the slices (and is the kernel's)."""
    b, h, w, c = x.shape
    hw = h * w
    n = -(-hw // pixels)
    xd = torch.nn.functional.pad(x.reshape(b, hw, c).double(), (0, 0, 0, n * pixels - hw))
    xd = xd.reshape(b, n, pixels, c)
    part = torch.stack([xd.sum(dim=2), (xd * xd).sum(dim=2)], dim=1)  # [B, 2, n, C]
    return part.sum(dim=2).float()


def tiled_stats_reference(x):
    """The stats pass's plain version: per row of x [B, H, W, C], the
    per-channel sum and sum of squares [B, 2, C] float32, as float64 sums of
    `gn_tiled_plan`'s slices folded in float64 and rounded once."""
    _, h, w, c = x.shape
    return _slice_sums(x, gn_tiled_plan(h, w, c, x.dtype)["pixels"])


def tiled_apply_reference(x, sums, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """The apply pass: the row sums [B, 2, C] folded to each group's mean and
    1/std in float64 (var = E[x²] − mean² clamped at 0, then eps, then
    1/sqrt), rounded to float32, then the normalisation, γ/β, FiLM and SiLU
    in float32; the output in x's type."""
    b, h, w, c = x.shape
    cg = c // groups
    sums = sums.double().reshape(b, 2, groups, cg).sum(dim=3)  # [B, 2, G]
    n = float(h * w * cg)
    mean = sums[:, 0] / n
    var = (sums[:, 1] / n - mean * mean).clamp(min=0.0)
    rstd = (1.0 / torch.sqrt(var + eps)).float().repeat_interleave(cg, dim=1)
    mean = mean.float().repeat_interleave(cg, dim=1)
    normed = (x.float() - mean[:, None, None, :]) * rstd[:, None, None, :]
    y = normed * gamma.float() + beta.float()
    if scale is not None:
        y = y * (scale.float()[:, None, None, :] + 1.0) + shift.float()[:, None, None, :]
    return (y * torch.sigmoid(y)).to(x.dtype)


def groupnorm_film_silu_tiled_reference(x, gamma, beta, scale=None, shift=None,
                                        groups=8, eps=1e-5):
    """Plain tiled GroupNorm + FiLM + SiLU, a transcription of
    `_gn_tiled_impl` in the JAX package: the row sums over `pick_tile`'s
    tiles, the group fold and the apply.  The tiles' sums and the fold are
    the CUDA pair's, in float64 (JAX adds the tiles and folds in float32,
    where E[x²] − mean² can go below 0)."""
    _, h, w, c = x.shape
    sums = _slice_sums(x, pick_tile(h * w, c))
    return tiled_apply_reference(x, sums, gamma, beta, scale, shift, groups, eps)


def groupnorm_film_silu_plain(x, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """The plain version of `groupnorm_film_silu`, on either side of the
    gate: the tiled transcription for a large block, the single-pass
    reference otherwise."""
    fn = (groupnorm_film_silu_tiled_reference if large_block(x.shape)
          else groupnorm_film_silu_reference)
    return fn(x, gamma, beta, scale, shift, groups, eps)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------

def _check(x, gamma, beta, scale, shift, groups):
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"C={c} is not divisible by groups={groups}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift are given together or not at all")
    params = [("gamma", gamma, (c,)), ("beta", beta, (c,))]
    if scale is not None:
        params += [("scale", scale, (b, c)), ("shift", shift, (b, c))]
    for name, t, shape in params:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in [("x", x)] + [(n, t) for n, t, _ in params]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.is_cuda


def _fn(lib_name, fn_name, argtypes):
    fn = getattr(_build.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _call(fn, name, x, *args):
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_chunks(x, kernel: str):
    """Raise unless `kernel` (the single pass, the tiled pair) can read x
    [B, H, W, C]: a thread reads 16-byte chunks of a pixel's channels, so
    C·esize must be a multiple of 16, at most one chunk a thread, and x on a
    16-byte boundary."""
    c, esize = x.shape[-1], x.element_size()
    if (c * esize) % 16 or gn_chunks(c, esize) > GN_THREADS:
        raise ValueError(f"the {kernel} reads 16-byte chunks of a pixel's channels: "
                         f"C·{esize} bytes must be a multiple of 16 and at most "
                         f"{16 * GN_THREADS}, got C={c}")
    if x.data_ptr() % 16:
        raise ValueError(f"the {kernel} reads x in 16-byte pieces: it must start on "
                         "a 16-byte boundary")


def _launch(x, gamma, beta, scale, shift, groups, eps, plan=None):
    """The single-pass kernel on x with `gn_plan`'s plan, or with `plan`
    (k, pixels, resident, smem) where a test asks for another."""
    b, h, w, c = x.shape
    _check_chunks(x, "single-pass kernel")
    plan = plan or gn_plan_of(x.shape, groups, x.dtype)
    fn = _fn("groupnorm_film_silu", "gn_film_silu",
             [_VP] * 6 + [_CI] * 4 + [_CF] + [_CI] * 5 + [_VP])
    out = torch.empty_like(x)
    _call(fn, "gn_film_silu", x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
          _ptr(scale), _ptr(shift), out.data_ptr(), b, h * w, c, groups, float(eps),
          _DTYPE_CODES[x.dtype], plan["k"], plan["pixels"], int(plan["resident"]),
          plan["smem"])
    _build.count_launch(groupnorm_film_silu)
    return out


def groupnorm_film_silu_single_pass(x, gamma, beta, scale=None, shift=None, groups=8,
                                    eps=1e-5):
    """The single-pass kernel at any size, whatever the gate says (its
    launches count on `groupnorm_film_silu.launches`); on a CPU tensor the
    plain reference."""
    _check(x, gamma, beta, scale, shift, groups)
    if _device(x):
        return _launch(x, gamma, beta, scale, shift, groups, eps)
    return groupnorm_film_silu_reference(x, gamma, beta, scale, shift, groups, eps)


def _check_groups(groups):
    if groups > MAX_GROUPS:
        raise ValueError(f"groups={groups} is over the kernel's {MAX_GROUPS}")


def _tiled_plan_of(x):
    _, h, w, c = x.shape
    return gn_tiled_plan(h, w, c, x.dtype)


def _launch_stats(x, plan=None):
    """The stats pass on x with `gn_tiled_plan`'s plan, or with `plan` (k,
    pixels) where a test asks for another."""
    b, h, w, c = x.shape
    _check_chunks(x, "tiled pair")
    plan = plan or _tiled_plan_of(x)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    fn = _fn("groupnorm_tiled", "gn_tiled_stats", [_VP, _VP] + [_CI] * 6 + [_VP])
    _call(fn, "gn_tiled_stats", x, x.data_ptr(), sums.data_ptr(), b, h * w, c, plan["k"],
          plan["pixels"], _DTYPE_CODES[x.dtype])
    _build.count_launch(gn_tiled_stats)
    return sums


def _launch_apply(x, sums, gamma, beta, scale, shift, groups, eps, plan=None,
                  after_stats=False):
    """The apply pass with `gn_tiled_plan`'s tile, or `plan`'s
    apply_pixels.  after_stats: launched right after the stats pass that
    wrote `sums`, with nothing between them on the stream, as the
    dispatcher does; it then starts while that pass ends (a programmatic
    dependent launch)."""
    b, h, w, c = x.shape
    _check_chunks(x, "tiled pair")
    plan = plan or _tiled_plan_of(x)
    out = torch.empty_like(x)
    fn = _fn("groupnorm_tiled", "gn_tiled_apply",
             [_VP] * 7 + [_CI] * 5 + [_CF, _CI, _CI, _VP])
    _call(fn, "gn_tiled_apply", x, x.data_ptr(), sums.data_ptr(), gamma.data_ptr(),
          beta.data_ptr(), _ptr(scale), _ptr(shift), out.data_ptr(), b, h * w, c, groups,
          plan["apply_pixels"], float(eps), _DTYPE_CODES[x.dtype], int(after_stats))
    _build.count_launch(gn_tiled_apply)
    return out


def gn_tiled_stats(x):
    """Pass 1 of the tiled pair: x [B, H, W, C] contiguous, float32 or
    bfloat16 → sums [B, 2, C] float32, per row the sum and sum of squares of
    each channel (`tiled_stats_reference` on a CPU tensor)."""
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not _device(x):
        return tiled_stats_reference(x)
    return _launch_stats(x)


def gn_tiled_apply(x, sums, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """Pass 2 of the tiled pair: the group fold of `sums` (from
    `gn_tiled_stats` on the same x) and the normalisation, γ/β, FiLM and
    SiLU; the output in x's type."""
    _check(x, gamma, beta, scale, shift, groups)
    _check_groups(groups)
    b, _, _, c = x.shape
    want = (b, 2, c)
    if (tuple(sums.shape) != want or sums.dtype != torch.float32
            or not sums.is_contiguous() or sums.device != x.device):
        raise ValueError(f"sums must be contiguous float32 {want} on {x.device}, "
                         f"got {sums.dtype} {tuple(sums.shape)} on {sums.device}")
    if not _device(x):
        return tiled_apply_reference(x, sums, gamma, beta, scale, shift, groups, eps)
    return _launch_apply(x, sums, gamma, beta, scale, shift, groups, eps)


def groupnorm_film_silu(x, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """GroupNorm(groups, eps) · γ + β, then FiLM y·(scale+1)+shift, then SiLU.

    x: [B, H, W, C] contiguous, float32 or bfloat16; gamma/beta: [C] float32;
    scale/shift: [B, C] float32 or None.  Returns x's shape and type.
    A CUDA tensor runs the single-pass kernel, or past the gate
    (`large_block`) the tiled pair; a CPU tensor runs the plain version of
    the same side of the gate.
    """
    _check(x, gamma, beta, scale, shift, groups)
    if not _device(x):
        return groupnorm_film_silu_plain(x, gamma, beta, scale, shift, groups, eps)
    if not large_block(x.shape):
        return _launch(x, gamma, beta, scale, shift, groups, eps)
    _check_groups(groups)
    plan = _tiled_plan_of(x)
    return _launch_apply(x, _launch_stats(x, plan), gamma, beta, scale, shift, groups, eps, plan,
                         after_stats=True)


groupnorm_film_silu.launches = 0
gn_tiled_stats.launches = 0
gn_tiled_apply.launches = 0
