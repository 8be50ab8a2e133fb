"""Port parity: the tiled GroupNorm+FiLM+SiLU pair's plain versions and the
row gate between the single-pass kernel and the pair.

The plain tiled version (`groupnorm_film_silu_tiled_reference`, the CPU
path past the gate) is held against the JAX package's Pallas pair
(`_gn_tiled`, `_stats_kernel` + `_apply_kernel`) run in interpret mode and
against the JAX reference `groupnorm_film_silu_reference`, at rtol/atol
3e-5 in f32: the bar the JAX package holds its tiled kernel to
(`tests/test_pallas_kernels.py`).  Its tiles, sums and fold run in
another order than the one-pass reference, which is all 3e-5 allows for.
The CUDA pair itself is compared with these plain versions in
test_torch_kernels_cuda.py, which runs only where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.ops import pallas_groupnorm as JG
from localdiffusion_tpu_torch.ops import groupnorm as G

TOL = dict(rtol=3e-5, atol=3e-5)
# [1,128,128,32]: `pick_tile` gives 4 tiles of 4096 pixels; [2,32,32,256]:
# 2 tiles (the 256px chain's 32x32 mid-block shape); [1,16,16,64]: a small
# block, one tile
SHAPES = [(1, 128, 128, 32), (2, 32, 32, 256), (1, 16, 16, 64)]


def _inputs(shape, film, seed=0):
    rng = np.random.default_rng(seed)
    b, _, _, c = shape
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    scale = rng.standard_normal((b, c)).astype(np.float32) if film else None
    shift = rng.standard_normal((b, c)).astype(np.float32) if film else None
    return x, gamma, beta, scale, shift


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_plain_version_matches_the_jax_pair_and_reference(shape, film):
    args = _inputs(shape, film)
    got = G.groupnorm_film_silu_tiled_reference(*map(_t, args), groups=8).numpy()
    pallas = np.asarray(JG._gn_tiled(*map(_j, args), 8, 1e-5, True))
    ref = np.asarray(JG.groupnorm_film_silu_reference(*map(_j, args), groups=8))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_pick_tile_is_the_jax_rule_and_gives_several_tiles():
    for hw in (1, 7, 64, 256, 1024, 4096, 16384, 65536, 12 * 12):
        for c in (32, 64, 128, 256):
            assert G.pick_tile(hw, c) == JG._pick_tile(hw, c), (hw, c)
    assert 128 * 128 // G.pick_tile(128 * 128, 32) == 4


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 32), (3, 64, 64, 64), (2, 32, 32, 256),
                                   (1, 20, 30, 96)])
def test_the_kernel_tiling_passes_match_the_jax_reference(shape, film):
    """The two passes' plain versions at the CUDA pair's own tile
    (`stats_tile`, ragged last tile at [1,20,30,96]) through the CPU
    wrappers, as the dispatcher chains them on the card."""
    args = _inputs(shape, film, seed=1)
    x, g, b, s, h = map(_t, args)
    partials = G.gn_tiled_stats(x)
    tile = G.stats_tile(shape[1] * shape[2], shape[3])
    nt = -(-shape[1] * shape[2] // tile)
    assert partials.shape == (shape[0], nt, 2, shape[3]) and partials.dtype == torch.float32
    got = G.gn_tiled_apply(x, partials, g, b, s, h, groups=8).numpy()
    ref = np.asarray(JG.groupnorm_film_silu_reference(*map(_j, args), groups=8))
    np.testing.assert_allclose(got, ref, **TOL)
    # the per-tile sums are the tile's own: their total is the row's
    np.testing.assert_allclose(partials.double().sum(1)[:, 0].numpy(),
                               args[0].reshape(shape[0], -1, shape[3]).sum(1),
                               rtol=1e-5, atol=1e-3)


def test_kernel_tile_follows_the_image_not_the_batch():
    """The CUDA pair's grid at the main path's large blocks: ~8192 elements
    a tile, a function of h·w and c alone; [8,32,32,256] gives 32 tiles a
    row (256 blocks), where `pick_tile` gives 2."""
    assert G.stats_tile(32 * 32, 256) == 32 and G.pick_tile(32 * 32, 256) == 512
    assert G.stats_tile(128 * 128, 32) == 256
    assert G.stats_tile(64 * 64, 64) == 128
    x = torch.randn(8, 32, 32, 256)
    assert torch.equal(G.gn_tiled_stats(x[:1]), G.gn_tiled_stats(x)[:1])


@pytest.mark.parametrize("shape", [(1, 32, 32, 128), (1, 32, 32, 256), (4, 64, 64, 32),
                                   (1, 64, 64, 64), (1, 128, 128, 32), (2, 16, 16, 256),
                                   (1, 16, 16, 512), (1, 64, 32, 64)])
def test_gate_is_the_jax_rule(shape):
    """`large_block` is the JAX row gate: h·w·c·4 bytes over 512 KiB leaves
    the single-pass kernel; 32x32x128 sits exactly at it and stays."""
    _, h, w, c = shape
    jax_single = h * w * c * 4 <= JG._MAX_VMEM_BLOCK_BYTES
    assert G.large_block(shape) == (not jax_single)
    assert G.MAX_BLOCK_BYTES == JG._MAX_VMEM_BLOCK_BYTES


def test_gate_edges():
    assert not G.large_block((8, 32, 32, 128))  # exactly 512 KiB: single pass
    assert G.large_block((8, 32, 32, 256))
    assert G.large_block((1, 128, 128, 32)) and G.large_block((1, 64, 64, 64))
    assert not G.large_block((1, 16, 16, 256))


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", [(1, 32, 32, 128), (2, 32, 32, 256)])
def test_dispatcher_on_the_cpu_takes_each_side_of_the_gate(shape, film):
    """On a CPU tensor the dispatcher runs the plain version of the gate's
    side, and counts no launch."""
    x, g, b, s, h = map(_t, _inputs(shape, film, seed=2))
    before = (G.groupnorm_film_silu.launches, G.gn_tiled_stats.launches,
              G.gn_tiled_apply.launches)
    got = G.groupnorm_film_silu(x, g, b, s, h, groups=8)
    assert (G.groupnorm_film_silu.launches, G.gn_tiled_stats.launches,
            G.gn_tiled_apply.launches) == before
    want = (G.groupnorm_film_silu_tiled_reference if G.large_block(shape)
            else G.groupnorm_film_silu_reference)(x, g, b, s, h, groups=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(G.groupnorm_film_silu_plain(x, g, b, s, h, groups=8), want,
                               rtol=0, atol=0)


def test_bf16_tiled_plain_version_rounds_once():
    """bf16 x: the plain pair computes in float32 and rounds the output once;
    it equals the float32 result on the same (bf16) values rounded to bf16,
    within one bf16 step (2^-8 relative)."""
    x, g, b, s, h = map(_t, _inputs((2, 32, 32, 256), True, seed=3))
    xb = x.bfloat16()
    got = G.groupnorm_film_silu_tiled_reference(xb, g, b, s, h, groups=8)
    assert got.dtype == torch.bfloat16
    want = G.groupnorm_film_silu_tiled_reference(xb.float(), g, b, s, h, groups=8)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), rtol=0, atol=0)


def test_wrappers_reject_what_the_kernels_cannot_take():
    x, g, b, s, h = map(_t, _inputs((1, 32, 32, 256), True))
    with pytest.raises(TypeError):
        G.gn_tiled_stats(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        G.gn_tiled_stats(x.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\[B, H, W, C\]"):
        G.gn_tiled_stats(x[0])
    partials = G.gn_tiled_stats(x)
    with pytest.raises(ValueError, match="partials"):
        G.gn_tiled_apply(x, partials[:, :-1].contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="partials"):
        G.gn_tiled_apply(x, partials.double(), g, b, s, h)
    with pytest.raises(ValueError, match="divisible"):
        G.gn_tiled_apply(x, partials, g, b, s, h, groups=7)
    with pytest.raises(ValueError, match="over the kernel"):
        G.gn_tiled_apply(x, partials, g, b, s, h, groups=128)
    with pytest.raises(ValueError, match="together"):
        G.gn_tiled_apply(x, partials, g, b, s, None)
