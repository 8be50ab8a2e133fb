"""Run logs and profiler traces, image metrics, weight I/O, float32
precision and the reference-checkpoint converter.  The exports of
`localdiffusion_tpu/utils/__init__.py`."""

from localdiffusion_tpu_torch.utils.logging import CsvLogger, Timer, profile_trace  # noqa: F401
from localdiffusion_tpu_torch.utils.metrics import mse, psnr, ssim  # noqa: F401
