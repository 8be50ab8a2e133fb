"""Port parity: the fused GroupNorm+FiLM+SiLU wrapper and its plain version.

On the CPU the wrapper computes the plain version; it is held against the
JAX reference and against the Pallas kernel run in interpret mode, at
rtol/atol 2e-5 in f32 (the bar the JAX package holds its own kernel to).
The CUDA kernel itself is compared with the plain version in
test_torch_kernels_cuda.py, which runs only where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from localdiffusion_tpu.ops.pallas_groupnorm import (
    _gn_film_silu,
    groupnorm_film_silu_reference as jax_reference,
)
from localdiffusion_tpu_torch.ops.groupnorm import (
    groupnorm_film_silu,
    groupnorm_film_silu_reference,
)

# small shapes with the flagship's channel counts (32, 64, 128), groups 8
SHAPES = [(2, 6, 6, 32), (2, 4, 4, 64), (1, 3, 3, 128)]


def _inputs(shape, film, seed=0):
    rng = np.random.default_rng(seed)
    b, _, _, c = shape
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    scale = rng.standard_normal((b, c)).astype(np.float32) if film else None
    shift = rng.standard_normal((b, c)).astype(np.float32) if film else None
    return x, gamma, beta, scale, shift


def _t(a, device="cpu"):
    return None if a is None else torch.as_tensor(a, device=device)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax(shape, film):
    args = _inputs(shape, film)
    want_ref = np.asarray(jax_reference(*map(_j, args), groups=8))
    want_kernel = np.asarray(_gn_film_silu(*map(_j, args), 8, 1e-5, True))
    got = groupnorm_film_silu_reference(*map(_t, args), groups=8).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("film", [True, False])
def test_wrapper_on_cpu_is_the_plain_version(film):
    args = list(map(_t, _inputs(SHAPES[0], film)))
    before = groupnorm_film_silu.launches
    got = groupnorm_film_silu(*args, groups=8)
    assert groupnorm_film_silu.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, groupnorm_film_silu_reference(*args, groups=8),
                               rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    x, g, b, s, h = map(_t, _inputs((2, 4, 4, 32), True))
    with pytest.raises(ValueError, match="divisible"):
        groupnorm_film_silu(x, g, b, s, h, groups=7)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        groupnorm_film_silu(x.double(), g, b, s, h)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_film_silu(x.transpose(1, 2), g, b, s, h)
    with pytest.raises(ValueError, match="shape"):
        groupnorm_film_silu(x, g[:16], b, s, h)
    with pytest.raises(ValueError, match="together"):
        groupnorm_film_silu(x, g, b, s, None)
    with pytest.raises(TypeError, match="gamma must be float32"):
        groupnorm_film_silu(x, g.double(), b, s, h)
