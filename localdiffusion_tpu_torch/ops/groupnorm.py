"""Fused GroupNorm + FiLM + SiLU: the CUDA kernel and its plain version.

`groupnorm_film_silu` replaces `localdiffusion_tpu/ops/pallas_groupnorm.py`
(`_gn_kernel`, reached through `groupnorm_film_silu` / `_gn_fwd_impl`).  The
kernel is `csrc/groupnorm_film_silu.cu`: bound by device memory (it reads x
once and writes the output once, 2·x bytes), so it is one launch with one
thread block per (row, group) and no scratch memory; see the source for the
design.  On a CUDA tensor the wrapper launches the kernel or raises; on a
CPU tensor it computes the plain version.  There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch(x, gamma, beta, scale, shift, groups, eps):
    from localdiffusion_tpu_torch.ops import _build

    lib = _build.load("groupnorm_film_silu")
    fn = lib.gn_film_silu
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, ci, vp]
    fn.restype = ci
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            shift.data_ptr() if shift is not None else None,
            out.data_ptr(), b, h * w, c, groups, float(eps),
            _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"gn_film_silu launch failed: CUDA error {err}")
    groupnorm_film_silu.launches += 1
    return out


def groupnorm_film_silu(x, gamma, beta, scale=None, shift=None, groups=8, eps=1e-5):
    """GroupNorm(groups, eps) · γ + β, then FiLM y·(scale+1)+shift, then SiLU.

    x: [B, H, W, C] contiguous, float32 or bfloat16; gamma/beta: [C] float32;
    scale/shift: [B, C] float32 or None.  Returns x's shape and type.
    A CUDA tensor runs the kernel; a CPU tensor runs the plain version.
    """
    _check(x, gamma, beta, scale, shift, groups)
    if x.is_cuda:
        return _launch(x, gamma, beta, scale, shift, groups, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return groupnorm_film_silu_reference(x, gamma, beta, scale, shift, groups, eps)


groupnorm_film_silu.launches = 0
