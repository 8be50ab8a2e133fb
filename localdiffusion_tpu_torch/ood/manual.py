"""The manual OOD mask, copied from `localdiffusion_tpu/ood/thresholds.py`
(`manual_mask`).  The rest of Stage A comes in a later slice."""

from __future__ import annotations

import numpy as np


def manual_mask(shape, cols: int = 7) -> np.ndarray:
    """Left-columns mask: the `cols` leftmost columns flagged OOD."""
    m = np.zeros(shape, np.float32)
    m[:, :, :cols, :] = 1.0
    return m
