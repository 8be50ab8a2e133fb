"""Port parity: full attention against the JAX package's.

`full_attention` on a CPU tensor runs the plain version at every size (the
CUDA kernel has no CPU mode; `test_torch_kernels_cuda.py` holds it against
the plain version on the card).  Here the port is held against JAX's
`xla_attention` and against the Pallas kernel in interpret mode, on the
same numpy inputs:

  * float32: rtol/atol 2e-5, the JAX package's own bar between its kernel
    and its reference (`tests/test_pallas_kernels.py`), summation order only;
  * bfloat16: rtol/atol 1e-2.  Both sides read bf16 q/k/v with float32
    scores; the outputs are bf16 (one rounding step is 2^-8 relative), and
    the Pallas kernel keeps the probabilities in float32 where the plain
    versions round them to bf16 first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.ops.attention import xla_attention as jax_xla_attention
from localdiffusion_tpu.ops.pallas_attention import flash_attention as jax_flash
from localdiffusion_tpu_torch.ops.attention import (
    FLASH_MIN_TOKENS,
    flash_attention,
    full_attention,
    xla_attention,
)

TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _qkv(n, dtype, seed=0, b=2, h=2, d=32):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 1024])
def test_full_attention_matches_jax(n, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(n, dtype, seed=n)
    assert n >= FLASH_MIN_TOKENS  # the kernel's side of the dispatch
    got = full_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    for want in (jax_xla_attention(jq, jk, jv), jax_flash(jq, jk, jv, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_strided_views_give_the_contiguous_result():
    """`Attention` hands over q/k/v cut from one qkv projection by reshape
    and permute; the wrapper takes such views as they are."""
    rng = np.random.default_rng(3)
    b, h, d, s = 2, 4, 32, 16
    qkv = torch.as_tensor(rng.standard_normal((b, 3 * h * d, s, s)).astype(np.float32))
    qkv = qkv.contiguous(memory_format=torch.channels_last)
    views = [t.permute(0, 3, 1, 2) for t in qkv.reshape(b, 3, h, d, s * s).unbind(1)]
    assert not views[0].is_contiguous() and views[0].stride(3) == 1
    got = flash_attention(*views)
    want = flash_attention(*(t.contiguous() for t in views))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attention_on_cpu_is_the_plain_version_and_checks_its_inputs():
    _, (q, k, v) = _qkv(64, "float32")
    torch.testing.assert_close(flash_attention(q, k, v, scale=0.3),
                               xla_attention(q, k, v, scale=0.3), rtol=0, atol=0)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :32], v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    assert flash_attention.launches == before  # the CPU never counts a launch
