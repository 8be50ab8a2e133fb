"""Full float32 for Stage A's cuDNN convolutions.

The seg detector's SegUNet and the WRN50-2 and seg-encoder feature sources
run their convolutions in float32, and their outputs on the card are held
to the CPU's within 1e-4 relative L2.  PyTorch's default lets cuDNN run a
float32 convolution in TF32 (inputs rounded to 10 mantissa bits), which
breaks that bar; `float32_convs()` turns it off for the block.

The switch (`torch.backends.cudnn.allow_tf32`) is the process's, not the
thread's: while a block is open, every float32 cuDNN convolution of the
process runs without TF32, e.g. a float32 Stage B that the server samples
on its other thread.  Blocks nest and overlap across threads: the first to
open turns TF32 off, the last to close restores the setting the first
found.  cuDNN reads the flag when a convolution is launched, so closing the
block before the card has run the launches is safe.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
_open = 0
_saved = None


@contextlib.contextmanager
def float32_convs():
    """cuDNN float32 convolutions without TF32 inside the block."""
    global _open, _saved
    with _lock:
        if _open == 0:
            _saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if _open == 0:
                torch.backends.cudnn.allow_tf32 = _saved
