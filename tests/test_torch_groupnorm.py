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


# ---------------------------------------------------------------------------
# the single-pass kernel's launch plan (pure Python; the kernel runs on the
# card, tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

def _gn_sites(cfg, dtype, size, full, batch):
    """Every GroupNormFilmSiLU input of one UNet call of `cfg` at a `full`
    px input and `batch` rows, as {NHWC shape: count}: the UNet runs once on
    the CPU at `size` px (it is fully convolutional, so each site's H and W
    scale by full / size)."""
    from localdiffusion_tpu_torch.models.blocks import GroupNormFilmSiLU
    from localdiffusion_tpu_torch.models.unet import UNet

    unet = UNet(cfg.model, dtype).eval()
    seen = []
    hook = lambda _m, args: seen.append(tuple(args[0].shape))
    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, GroupNormFilmSiLU)]
    x = torch.zeros(1, size, size, 1)
    with torch.no_grad():
        unet(x, x, torch.tensor([5]))
    for h in handles:
        h.remove()
    f = full // size
    out = {}
    for _, c, h, w in seen:
        key = (batch, h * f, w * f, c)
        out[key] = out.get(key, 0) + 1
    return out


# per configuration: (config, compute dtype, CPU input size, full size, UNet
# batch in chip_smoke.py), and the single-pass sites' k (blocks a row) by
# shape: the flagship's rows of at most 100 KB take 1 or 2 blocks, the
# stem's and the 256px chain's rows of 128 to 512 KiB take 8
GN_CONFIGS = {
    "flagship": ("flagship_config", torch.float32, 28, 28, 128,
                 {(7, 7, 64): 1, (7, 7, 128): 1, (14, 14, 32): 1, (14, 14, 64): 1,
                  (28, 28, 32): 2}),
    "256px": ("mri256_config", torch.bfloat16, 64, 256, 8, {(32, 32, 128): 8}),
    "stem": ("stem256_config", torch.float32, 64, 256, 8,
             {(16, 16, 128): 8, (16, 16, 256): 8, (32, 32, 64): 8, (32, 32, 128): 8,
              (64, 64, 32): 8}),
}


@pytest.mark.parametrize("name", list(GN_CONFIGS))
def test_single_pass_plan_at_every_site(name):
    """At every single-pass site of the configuration (below the row gate)
    the plan keeps the slice resident within a block's 227 KB, its k blocks
    cover the row's pixels, and k is the one the plan documents; at another
    batch the plan is the same (it never reads the batch)."""
    from localdiffusion_tpu_torch import config as tcfg
    from localdiffusion_tpu_torch.ops import groupnorm as G

    cfg_fn, dtype, size, full, batch, want_k = GN_CONFIGS[name]
    sites = _gn_sites(getattr(tcfg, cfg_fn)(), dtype, size, full, batch)
    single = {s: n for s, n in sites.items() if not G.large_block(s)}
    assert {s[1:]: G.gn_plan_of(s, 8, dtype)["k"] for s in single} == want_k
    esize = torch.empty((), dtype=dtype).element_size()
    for shape in single:
        _, h, w, c = shape
        plan = G.gn_plan_of(shape, 8, dtype)
        assert plan["resident"] and plan["smem"] <= G.SMEM_PER_BLOCK
        assert plan["smem"] == G.gn_smem(plan["pixels"], c, 8, esize, True)
        assert 1 <= plan["k"] <= G.GN_MAX_CLUSTER
        assert plan["k"] * plan["pixels"] >= h * w > (plan["k"] - 1) * plan["pixels"]
        for b in (1, 3, batch, 2 * batch):
            assert G.gn_plan_of((b, h, w, c), 8, dtype) == plan


@pytest.mark.parametrize("shape,dtype,k,resident", [
    ((8, 256, 256, 32), torch.bfloat16, 16, False),  # 4 MiB a row
    ((8, 256, 256, 32), torch.float32, 16, False),
    ((8, 128, 128, 64), torch.bfloat16, 16, False),
    ((8, 128, 128, 32), torch.bfloat16, 16, True),
    ((8, 64, 64, 128), torch.bfloat16, 16, True),
    ((3, 25, 19, 64), torch.float32, 2, True),
])
def test_single_pass_plan_past_the_gate(shape, dtype, k, resident):
    """`groupnorm_film_silu_single_pass` takes any row: past 512 KiB the
    plan splits it 16 ways, and a slice over the resident limit (half a
    block's shared memory) is streamed, with only the reduction buffers in
    shared memory."""
    from localdiffusion_tpu_torch.ops import groupnorm as G

    plan = G.gn_plan_of(shape, 8, dtype)
    assert (plan["k"], plan["resident"]) == (k, resident)
    assert plan["smem"] <= (G.GN_RESIDENT_SMEM if resident else G.SMEM_PER_BLOCK)
    esize = torch.empty((), dtype=dtype).element_size()
    assert plan["smem"] == G.gn_smem(plan["pixels"], shape[3], 8, esize, resident)
