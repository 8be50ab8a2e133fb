"""Port parity: the tiled GroupNorm+FiLM+SiLU pair's plain versions and the
row gate between the single-pass kernel and the pair.

The plain tiled version (`groupnorm_film_silu_tiled_reference`, the CPU
path past the gate) is held against the JAX package's Pallas pair
(`_gn_tiled`, `_stats_kernel` + `_apply_kernel`) run in interpret mode and
against the JAX reference `groupnorm_film_silu_reference`, at rtol/atol
3e-5 in f32: the bar the JAX package holds its tiled kernel to
(`tests/test_pallas_kernels.py`).  Its tiles, sums and fold run in
another order than the one-pass reference, which is all 3e-5 allows for.
The stats pass's plain version (`tiled_stats_reference`, the row sums
[B, 2, C] over `gn_tiled_plan`'s slices, in float64) is held against the
Pallas `_stats_kernel` itself in interpret mode: rtol 1e-5 / atol 1e-3,
where the Pallas kernel adds up to 16,384 terms in float32.  The CUDA pair itself is
compared with these plain versions in test_torch_kernels_cuda.py, which
runs only where a card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from localdiffusion_tpu.ops import pallas_groupnorm as JG
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.models.blocks import GroupNormFilmSiLU
from localdiffusion_tpu_torch.ops import groupnorm as G

TOL = dict(rtol=3e-5, atol=3e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-3)
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


def _pallas_stats(x):
    """JAX `_stats_kernel` through `pl.pallas_call` with `_gn_tiled_impl`'s
    specs (`pick_tile`'s tiles, the [1, 2, C] output block revisited across
    them), in interpret mode: [B, 2, C] float32."""
    b, h, w, c = x.shape
    hw = h * w
    tile = JG._pick_tile(hw, c)
    return np.asarray(pl.pallas_call(
        JG._stats_kernel,
        grid=(b, hw // tile),
        in_specs=[pl.BlockSpec((1, tile, c), lambda i, j: (i, j, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 2, c), lambda i, j: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, 2, c), jnp.float32),
        interpret=True,
    )(jnp.asarray(x).reshape(b, hw, c)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_plain_version_matches_the_pallas_stats_kernel(shape, dtype):
    """The stats pass's plain version gives the TPU kernel's own output, the
    per-channel row sums [B, 2, C], in its own order (`gn_tiled_plan`'s
    slices in float64, folded in float64); bf16 x on the same bf16
    values."""
    x = torch.as_tensor(_inputs(shape, False)[0]).to(dtype)
    got = G.tiled_stats_reference(x)
    assert got.shape == (shape[0], 2, shape[3]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas_stats(x.float().numpy()), **STATS_TOL)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_on_the_row_sums_matches_the_jax_pair_and_reference(shape, film):
    """The apply pass's plain version on the stats pass's row sums: the JAX
    pair's output and the JAX reference, within 3e-5."""
    args = _inputs(shape, film, seed=4)
    x, g, b, s, h = map(_t, args)
    got = G.tiled_apply_reference(x, G.tiled_stats_reference(x), g, b, s, h, groups=8).numpy()
    pallas = np.asarray(JG._gn_tiled(*map(_j, args), 8, 1e-5, True))
    ref = np.asarray(JG.groupnorm_film_silu_reference(*map(_j, args), groups=8))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (2, 43, 45, 96), (1, 24, 24, 512)])
def test_plain_row_sums_do_not_depend_on_the_slices(shape, dtype):
    """Summed in float64 and rounded once, a row's sums come out the same
    over `pick_tile`'s tiles, the plan's slices or any other: so the plain
    tiled version and the pair on the plan's sums agree bit for bit, and
    the CUDA pair, which sums the same way, is held to one bf16 step of
    the plain version (float32 sums in another order move an output near 0
    by more than that)."""
    args = _inputs(shape, True, seed=5)
    x, g, b, s, h = map(_t, args)
    x = x.to(dtype)
    hw = shape[1] * shape[2]
    want = G.tiled_stats_reference(x)
    for pixels in (1, 7, G.pick_tile(hw, shape[3]), hw):
        assert torch.equal(G._slice_sums(x, pixels), want), pixels
    assert torch.equal(G.groupnorm_film_silu_tiled_reference(x, g, b, s, h, groups=8),
                       G.tiled_apply_reference(x, want, g, b, s, h, groups=8))


def test_pick_tile_is_the_jax_rule_and_gives_several_tiles():
    for hw in (1, 7, 64, 256, 1024, 4096, 16384, 65536, 12 * 12):
        for c in (32, 64, 128, 256):
            assert G.pick_tile(hw, c) == JG._pick_tile(hw, c), (hw, c)
    assert 128 * 128 // G.pick_tile(128 * 128, 32) == 4


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 32), (3, 64, 64, 64), (2, 32, 32, 256),
                                   (1, 25, 30, 96)])
def test_the_kernel_tiling_passes_match_the_jax_reference(shape, film):
    """The two passes' plain versions at the CUDA pair's own plan
    (`gn_tiled_plan`: 750 pixels in 8 slices of 94 at [1,25,30,96], the
    last one ragged) through the CPU wrappers, as the dispatcher chains them
    on the card."""
    args = _inputs(shape, film, seed=1)
    x, g, b, s, h = map(_t, args)
    sums = G.gn_tiled_stats(x)
    assert sums.shape == (shape[0], 2, shape[3]) and sums.dtype == torch.float32
    got = G.gn_tiled_apply(x, sums, g, b, s, h, groups=8).numpy()
    ref = np.asarray(JG.groupnorm_film_silu_reference(*map(_j, args), groups=8))
    np.testing.assert_allclose(got, ref, **TOL)
    # the sums are the row's
    np.testing.assert_allclose(sums[:, 0].numpy(), args[0].reshape(shape[0], -1, shape[3]).sum(1),
                               **STATS_TOL)
    np.testing.assert_allclose(sums[:, 1].numpy(),
                               (args[0].astype(np.float64) ** 2).reshape(
                                   shape[0], -1, shape[3]).sum(1), **STATS_TOL)


def test_kernel_tile_follows_the_image_not_the_batch():
    """The CUDA pair's plan at the main path's large blocks: the stats
    pass's cluster of 8 blocks a row, the apply pass's tiles of 32 KiB (256px
    32x32x256 bf16, stem 64x64x64) or a 32nd of the row (stem 128x128x32,
    64 KiB), a function of h, w, c and the dtype alone; row 0 through the
    CPU wrappers alone equals row 0 of the batch."""
    assert G.gn_tiled_plan(32, 32, 256, torch.bfloat16) == dict(k=8, pixels=128,
                                                                 apply_pixels=64)
    assert G.gn_tiled_plan(128, 128, 32, torch.float32) == dict(k=8, pixels=2048,
                                                                apply_pixels=512)
    assert G.gn_tiled_plan(64, 64, 64, torch.float32) == dict(k=8, pixels=512,
                                                              apply_pixels=128)
    x, g, b, s, h = map(_t, _inputs((8, 32, 32, 256), True, seed=5))
    sums = G.gn_tiled_stats(x)
    assert torch.equal(G.gn_tiled_stats(x[:1]), sums[:1])
    assert torch.equal(G.gn_tiled_apply(x[:1], sums[:1], g, b, s[:1], h[:1], groups=8),
                       G.gn_tiled_apply(x, sums, g, b, s, h, groups=8)[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hwc", [(32, 32, 256), (128, 128, 32), (64, 64, 64), (40, 45, 96),
                                 (24, 24, 512), (1, 5, 64), (3, 3, 1024)])
def test_tiled_plan_rules(hwc, dtype):
    """`gn_tiled_plan`: 8 blocks a row, or h·w when it is smaller, slices
    that cover the row, apply tiles of one pixel at least and at most the
    row, as large as 32 KiB or a 32nd of a larger row allow; the same plan
    whatever the batch, since it is given none."""
    h, w, c = hwc
    hw = h * w
    plan = G.gn_tiled_plan(h, w, c, dtype)
    k, pixels, tile = plan["k"], plan["pixels"], plan["apply_pixels"]
    esize = torch.empty((), dtype=dtype).element_size()
    row = hw * c * esize
    assert k == min(G.GN_TILED_CLUSTER, hw)
    assert pixels == -(-hw // k) and k * pixels >= hw
    assert 1 <= tile <= hw
    assert tile == 1 or tile * c * esize <= max(G.GN_APPLY_TILE_BYTES, -(-row // G.GN_APPLY_TILES))
    # a larger tile would pass both limits
    assert tile == hw or (tile + 1) * c * esize > max(G.GN_APPLY_TILE_BYTES,
                                                      -(-row // G.GN_APPLY_TILES))
    for batch in (1, 8):
        x = torch.zeros(batch, h, w, c, dtype=dtype)
        assert G._tiled_plan_of(x) == plan


CONFIGS = {"flagship": tcfg.flagship_config, "mri256": tcfg.mri256_config,
           "stem256": tcfg.stem256_config}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_no_configuration_reaches_the_kernels_refusal(name):
    """Both GroupNorm kernels read 16-byte chunks of a pixel's channels, so
    they refuse C·esize not a multiple of 16 or over 4 KiB, and x off a
    16-byte boundary; every GroupNorm of the three configurations, in its
    compute type, is within those rules and the apply pass's 64 groups."""
    cfg = CONFIGS[name]()
    gd = build_gd(cfg, device="cpu")
    dtype = getattr(torch, cfg.train.compute_dtype)
    norms = [m for m in gd.model.modules() if isinstance(m, GroupNormFilmSiLU)]
    assert norms
    for m in norms:
        c = m.weight.numel()
        assert c % m.groups == 0 and m.groups <= G.MAX_GROUPS
        G._check_chunks(torch.zeros(1, 2, 2, c, dtype=dtype), "tiled pair")


@pytest.mark.parametrize("c,dtype", [(12, torch.bfloat16), (6, torch.float32),
                                     (2056, torch.float32), (4112, torch.bfloat16)])
def test_the_kernels_refuse_what_they_cannot_read(c, dtype):
    """The rule the wrappers hold a CUDA tensor to, here on CPU tensors:
    C·esize a multiple of 16 and at most 4 KiB, x on a 16-byte boundary."""
    with pytest.raises(ValueError, match="16-byte chunks"):
        G._check_chunks(torch.zeros(1, 1, 1, c, dtype=dtype), "tiled pair")
    chunk = 16 // torch.empty((), dtype=dtype).element_size()
    off = torch.zeros(2 * chunk + 1, dtype=dtype)[1:]  # 32 bytes, one element in
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        G._check_chunks(off.view(1, 1, 1, -1), "tiled pair")


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
    sums = G.gn_tiled_stats(x)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums[:, :1].contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums.double(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):
        G.gn_tiled_apply(x, sums.transpose(1, 2).contiguous(), g, b, s, h)
    with pytest.raises(ValueError, match="sums"):  # [B, 2, C], not contiguous
        G.gn_tiled_apply(x, sums.transpose(1, 2).contiguous().transpose(1, 2), g, b, s, h)
    with pytest.raises(ValueError, match="divisible"):
        G.gn_tiled_apply(x, sums, g, b, s, h, groups=7)
    with pytest.raises(ValueError, match="over the kernel"):
        G.gn_tiled_apply(x, sums, g, b, s, h, groups=128)
    with pytest.raises(ValueError, match="together"):
        G.gn_tiled_apply(x, sums, g, b, s, None)
