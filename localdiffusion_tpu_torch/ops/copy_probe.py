"""A bare copy of a row-tiled tensor: the floor of a kernel launch and of
its programs, for the linear-attention attribution
(`scripts.bench_linatt_attrib`).

Port of `scripts/bench_linatt_attrib.py::_copy_kernel`, the trivial
pallas_call over [B, N, C] in row tiles of T tokens (B·N/T programs).  The
kernel is `csrc/copy_probe.cu`: `copy_tiles(x, tile)` launches B·N/T blocks,
each copying the bytes of one tile (16-byte streaming loads and stores).
A CUDA tensor runs the kernel; a CPU tensor gets the plain version,
`x.clone()`.
"""

from __future__ import annotations

import ctypes

import torch

from localdiffusion_tpu_torch.ops import _build


def programs(shape, tile: int) -> int:
    """The JAX grid's program count for [B, N, C] in row tiles of `tile`
    tokens: B·N/tile (N must divide by the tile)."""
    b, n = shape[0], shape[1]
    if n % tile:
        raise ValueError(f"N={n} is not a multiple of the tile {tile}")
    return b * (n // tile)


def copy_tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """A copy of x [B, N, C] (contiguous) by B·N/tile programs of one tile
    each.  The bytes of a tile must be a multiple of 16."""
    if x.ndim != 3:
        raise ValueError(f"x must be [B, N, C], got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    progs = programs(x.shape, tile)
    nbytes = x.numel() * x.element_size()
    if (nbytes // progs) % 16:
        raise ValueError(f"a tile of {nbytes // progs} bytes is not a multiple of 16")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return x.clone()
    if x.data_ptr() % 16:
        raise ValueError("x does not start on a 16-byte boundary")
    out = torch.empty_like(x)
    fn = _build.load("copy_probe").copy_probe
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), nbytes, progs, stream)
    if err != 0:
        raise RuntimeError(f"copy_probe launch failed: CUDA error {err}")
    _build.count_launch(copy_tiles)
    return out


copy_tiles.launches = 0
