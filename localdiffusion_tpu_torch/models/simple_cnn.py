"""SimpleCNN, the MNIST digit classifier of the downstream evaluation.  Port
of `localdiffusion_tpu/models/simple_cnn.py`.

Two conv3×3 (padding 1) + ReLU + 2×2 max-pool stages (32, 64 channels),
flattened in NHWC order, then Dense 128 + ReLU and Dense `num_classes`: is
an 8→3 translation still classified as a 3 (`scripts/eval_translation.py`)?
Input is [B, 28, 28, 1] NHWC float32 in the pipeline's [0, 2] range (the
flax module infers its sizes from the 28px digits it is initialised on);
module names are the flax tree's, so `utils.params_io.params_from_jax`
carries its params across and `save_params_npz` writes them back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.utils.precision import full_float32

SIZE, CHANNELS = 28, 1


class SimpleCNN(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(CHANNELS, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(64 * (SIZE // 4) ** 2, 128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 28, 28, 1] → logits [B, num_classes], in full float32
        (`full_float32`)."""
        with full_float32():
            h = F.max_pool2d(F.relu(self.conv1(x.permute(0, 3, 1, 2))), 2, 2)
            h = F.max_pool2d(F.relu(self.conv2(h)), 2, 2)
            h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax flattens NHWC
            return self.fc2(F.relu(self.fc1(h)))
