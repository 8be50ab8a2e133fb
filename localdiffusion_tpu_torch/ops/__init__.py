"""Numerics and kernels: schedules, diffusion math, resizing, and the
kernels' wrappers (GroupNorm+FiLM+SiLU single pass and tiled, flash and
linear attention, the fused ResnetBlock) with their CUDA build
(`ops._build`, which compiles a kernel on its first CUDA launch, never at
import).  The exports of `localdiffusion_tpu/ops/__init__.py`."""

from localdiffusion_tpu_torch.ops.schedules import (  # noqa: F401
    Schedule,
    cosine_beta_schedule,
    linear_beta_schedule,
    make_schedule,
    sigmoid_beta_schedule,
)
from localdiffusion_tpu_torch.ops import diffusion_math  # noqa: F401
