"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The module imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)

# the flagship's five Block shapes at batch 64 (a branched [2B] pair)
FLAGSHIP_SHAPES = [(128, 28, 28, 32), (128, 14, 14, 32), (128, 14, 14, 64),
                   (128, 7, 7, 64), (128, 7, 7, 128)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, film, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    b, _, _, c = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = (r(*shape) * 1.5 + 0.3).to(dtype)
    scale, shift = (r(b, c), r(b, c)) if film else (None, None)
    return x, r(c), r(c), scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", FLAGSHIP_SHAPES)
def test_groupnorm_kernel_matches_plain_version(cuda_device, shape, film, dtype):
    """f32: 2e-5 (summation order only); bf16: 2e-2 relative, one rounding
    step of the bf16 output (the kernel and the plain version round the same
    f32 value)."""
    x, g, b, s, h = _inputs(shape, film, dtype, cuda_device)
    before = groupnorm_film_silu.launches
    got = groupnorm_film_silu(x, g, b, s, h, groups=8)
    torch.cuda.synchronize()
    assert groupnorm_film_silu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = groupnorm_film_silu_reference(x, g, b, s, h, groups=8)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_groupnorm_kernel_rejects_what_it_cannot_take(cuda_device):
    x, g, b, s, h = _inputs((2, 4, 4, 32), True, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="divisible"):
        groupnorm_film_silu(x, g, b, s, h, groups=6)
    with pytest.raises(ValueError, match="on cpu"):
        groupnorm_film_silu(x, g.cpu(), b, s, h)
    with pytest.raises(TypeError):
        groupnorm_film_silu(x.half(), g, b, s, h)
