"""Full float32 on the card, whatever the process's TF32 setting.

PyTorch lets cuDNN run a float32 convolution in TF32 (inputs rounded to 10
mantissa bits) by default (`torch.backends.cudnn.allow_tf32 = True`), and
cuBLAS a float32 matrix product when `torch.backends.cuda.matmul.allow_tf32`
is set.  The port's float32 paths are held to the CPU's float32 (and the
JAX package's) within 1e-3 to 1e-4, which TF32 breaks, so each turns both
off for its own calls with `full_float32()`:

  * the denoiser's every call (`GaussianDiffusion.apply_model`,
    `encode_cond` and the Stage A taps of
    `ood.features.DenoiserFeatureSource`), whichever entry point reaches
    it: `translate`, `detect`, the server's threads, the bank CLI.  TF32
    applies to float32 operands only: all of a float32 UNet's, and of a
    bf16 UNet the final 1×1 conv, which computes in float32;
  * PatchCore's distance product;
  * the SegUNet and the WRN50-2 and seg-encoder sources.

A block turns off both flags, also where its calls use only one kind of
operation: the other flag then changes nothing.  The flags are the
process's, not the thread's: while a block is open, every float32
convolution or product of the process runs without TF32, e.g. a float32
Stage B that the server samples on its other thread.  Blocks nest and
overlap across threads: the first to open turns both off, the last to close
restores the settings the first found.  cuDNN and cuBLAS read the flags
when an operation is launched, so closing a block before the card has run
its launches is safe.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_open = 0
_saved = None


@contextlib.contextmanager
def full_float32():
    """cuDNN float32 convolutions and cuBLAS float32 matrix products
    without TF32 inside the block."""
    global _open, _saved
    with _lock:
        if _open == 0:
            _saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _saved
