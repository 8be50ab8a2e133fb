"""Port parity: the fused three-pass ResnetBlock against the JAX package's.

Held against JAX on the same numpy inputs, in bf16, at the JAX tests'
W-fold sizes (`tests/test_pallas_resnet_block.py`, `WFOLD_CASES`):

  * each pass's plain version, `conv_stats_reference` (pass 1, and pass 2
    with its affine+SiLU prologue), against the Pallas `_conv_stats_call`
    in interpret mode, fed the W-folded view JAX runs (x as [B, H, W/r,
    r·Cin], the weights through `wfold_conv_kernel`, lanes unfolded after):
    h within one bf16 step, the sums within 1e-5 relative norm;
  * `gn_affine` against `_gn_affine`;
  * the whole plain composition against `resnet_block_wfold_fused(...,
    interpret=True)` and against `_reference_normal`, at the JAX tests' bar
    (atol 0.05 / rtol 0.06, correlation > 0.999) and at the relative L2
    read here;
  * the `ResnetBlock` module against the JAX module with
    `LOCALDIFF_FUSED_BLOCK=interpret`;
  * the gate on the 20 ResnetBlocks of a 256px UNet, a row alone against
    the same row in a batch, and the zero padding after the activation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import localdiffusion_tpu.models.blocks as JB
from localdiffusion_tpu.ops.pallas_resnet_block import (
    _conv_stats_call,
    _gn_affine,
    _reference_normal,
    resnet_block_wfold_fused,
    supports_normal as jax_supports_normal,
    wfold_conv_kernel,
)
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.models.blocks import ResnetBlock
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.utils.params_io import params_from_jax

GROUPS = 8
BAR = dict(atol=0.05, rtol=0.06)  # the JAX tests' bar, with correlation > 0.999

# (NHWC shape, dim_out, FiLM): identity residual with and without FiLM,
# res_conv 96→64 (r = 2), res_conv 192→128 (r = 1)
CASES = [
    ((2, 8, 32, 32), 32, True),
    ((2, 8, 32, 32), 32, False),
    ((1, 8, 16, 96), 64, True),
    ((1, 8, 8, 192), 128, True),
]
IDS = ["identity-film", "identity-nofilm", "res96to64", "res192to128"]


def _np_params(cin, dim_out, seed):
    """A flax ResnetBlock subtree (block1, block2, res_conv when Cin ≠
    dim_out) of seeded numpy arrays."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)

    def block(ci):
        return {"proj": {"kernel": r(3, 3, ci, dim_out) * 0.1, "bias": r(dim_out) * 0.05},
                "norm": {"scale": r(dim_out) * 0.2 + 1.0, "bias": r(dim_out) * 0.1}}

    p = {"block1": block(cin), "block2": block(dim_out)}
    if cin != dim_out:
        p["res_conv"] = {"kernel": r(1, 1, cin, dim_out) * 0.1, "bias": r(dim_out) * 0.05}
    return p


def _module(p, cin, dim_out):
    """The port's ResnetBlock (bf16 compute, no time MLP) holding p."""
    mod = ResnetBlock(cin, dim_out, GROUPS, None, torch.bfloat16)
    mod.load_state_dict(params_from_jax(p, mod))
    return mod


def _inputs(shape, dim_out, film, seed=0):
    """x as bf16 values (float32 numpy) and the FiLM pair or None."""
    rng = np.random.default_rng(seed + 100)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    x = torch.as_tensor(x).bfloat16().float().numpy()
    ss = None
    if film:
        ss = tuple((rng.standard_normal((shape[0], dim_out)) * 0.3).astype(np.float32)
                   for _ in range(2))
    return x, ss


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bf16_steps(got, want):
    """|got − want| in units of the bf16 spacing at max(|got|, |want|),
    element by element (largest)."""
    got, want = torch.as_tensor(_f32(got)), torch.as_tensor(_f32(want))
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()).clamp_min(2.0**-120))
    return float(((got - want).abs() / torch.ldexp(torch.ones_like(got), e - 8)).max())


def _assert_bar(got, want, rel_bar):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **BAR)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    assert _rel(got, want) <= rel_bar, _rel(got, want)


# ---------------------------------------------------------------------------
# each pass against the Pallas kernel
# ---------------------------------------------------------------------------

def _jax_conv_stats(x, w_hwio, bias, a=None, b=None):
    """JAX `_conv_stats_call` (interpret mode) on the W-folded view of x
    [B, H, W, Cin]; h unfolded to [B, H, W, Cout], the sums' lanes summed
    over the r phases to [B, Cout]."""
    bsz, hh, ww, cin = x.shape
    cout = w_hwio.shape[-1]
    r = RB.LANES // cout
    xf = jnp.asarray(x).astype(jnp.bfloat16).reshape(bsz, hh, ww // r, r * cin)
    wk = wfold_conv_kernel(jnp.asarray(w_hwio), r).astype(jnp.bfloat16)
    bias_t = jnp.tile(jnp.asarray(bias), r)[None, :]
    lanes = lambda v: jnp.tile(jnp.asarray(v), (1, r))  # lane = p·C + c
    affine = a is not None
    if not affine:
        a, b = np.ones((bsz, cin), np.float32), np.zeros((bsz, cin), np.float32)
    h, s, ss = _conv_stats_call(xf, wk, bias_t, lanes(a), lanes(b), apply_in_affine=affine,
                                interpret=True)
    h = _f32(h).reshape(bsz, hh, ww, cout)
    fold = lambda v: np.asarray(v).reshape(bsz, r, cout).sum(1)
    return h, fold(s), fold(ss)


@pytest.mark.parametrize("shape,dim_out,film", CASES, ids=IDS)
@pytest.mark.parametrize("pass_", [1, 2])
def test_conv_stats_matches_the_pallas_kernel(shape, dim_out, film, pass_):
    """h within one bf16 step (float32 sums in another order round a few
    values one step apart), and the sums Σ and Σ² per (row, channel), each
    the sum of its own rounded h: with the part that those one-step
    differences of h explain taken out, within 1e-5 relative norm per row
    (read ≤ 7.6e-8; the few steps alone move Σ by up to 7.6e-5)."""
    bsz, hh, ww, cin = shape
    p = _np_params(cin, dim_out, seed=dim_out + cin)
    x, _ = _inputs(shape, dim_out, False)
    blk = p["block1"] if pass_ == 1 else p["block2"]
    ab = ()
    if pass_ == 2:  # pass 2 reads a dim_out-channel h with a per-(row, channel) affine
        rng = np.random.default_rng(pass_ + dim_out)
        x = torch.as_tensor(rng.standard_normal((bsz, hh, ww, dim_out)).astype(np.float32))
        x = x.bfloat16().float().numpy()
        ab = tuple((rng.standard_normal((bsz, dim_out)) * s + m).astype(np.float32)
                   for s, m in ((0.3, 1.0), (0.5, 0.0)))
    w_hwio, bias = blk["proj"]["kernel"], blk["proj"]["bias"]
    want_h, want_s, want_ss = _jax_conv_stats(x, w_hwio, bias, *ab)
    w = RB.pack_conv3x3(torch.as_tensor(w_hwio).permute(3, 2, 0, 1))
    got_h, got_s, got_ss = RB.conv_stats_reference(
        torch.as_tensor(x).bfloat16(), w, torch.as_tensor(bias),
        *(torch.as_tensor(v) for v in ab))
    assert got_h.dtype == torch.bfloat16 and got_h.shape == (bsz, hh, ww, dim_out)
    assert got_s.shape == got_ss.shape == (bsz, RB.num_tiles(hh, ww), dim_out)
    assert _bf16_steps(got_h, want_h) <= 1.0
    hg, hw = got_h.double().numpy(), want_h.astype(np.float64)
    for got, want, moved in ((got_s, want_s, hg - hw), (got_ss, want_ss, hg**2 - hw**2)):
        diff = got.sum(1).double().numpy() - want - moved.sum(axis=(1, 2))
        err = np.linalg.norm(diff, axis=1) / np.linalg.norm(want, axis=1)
        assert err.max() <= 1e-5, err


def test_gn_affine_is_the_jax_fold():
    rng = np.random.default_rng(5)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    n = 16 * 16 * 4
    s, ss = r(2, 3, 32) * 10, np.abs(r(2, 3, 32)) * 100 + 50  # three tiles' sums
    gamma, beta, scale, shift = r(32), r(32), r(2, 32), r(2, 32)
    for sc, sh in ((scale, shift), (None, None)):
        want = _gn_affine(jnp.asarray(s.sum(1)), jnp.asarray(ss.sum(1)), jnp.asarray(gamma),
                          jnp.asarray(beta), None if sc is None else jnp.asarray(sc),
                          None if sh is None else jnp.asarray(sh), GROUPS, jnp.float32(n),
                          1, 32)
        t = lambda v: None if v is None else torch.as_tensor(v)
        got = RB.gn_affine(t(s), t(ss), t(gamma), t(beta), t(sc), t(sh), GROUPS, n)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (2, 32)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_gn_affine_clamps_a_negative_variance():
    """Σ²/n − mean² rounds below 0 for a constant group: the one-pass
    variance is clamped, so the scale is rsqrt(eps)·γ, finite."""
    s = torch.full((1, 1, 32), 3.0 * 64)
    ss = torch.full((1, 1, 32), 9.0 * 64 * (1 - 1e-7))
    a, b = RB.gn_affine(s, ss, torch.ones(32), torch.zeros(32), None, None, GROUPS, 4 * 64)
    torch.testing.assert_close(a, torch.full((1, 32), 1e-5**-0.5), rtol=1e-6, atol=0)
    assert torch.isfinite(b).all()


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dim_out,film", CASES, ids=IDS)
def test_plain_fused_block_matches_jax(shape, dim_out, film):
    """The three passes through their plain versions (the CPU side of
    `resnet_block_fused`) against the Pallas kernels in interpret mode at
    the JAX bar and relative L2 ≤ 2e-3 (read ≤ 5.6e-4: both round at the
    same points), and against `_reference_normal`, the unfused block, at
    the JAX bar and relative L2 ≤ 1e-2 (read ≤ 4.7e-3: the unfused block
    rounds the conv before a bf16 bias and its residual elsewhere)."""
    p = _np_params(shape[-1], dim_out, seed=dim_out + shape[-1])
    x, ss = _inputs(shape, dim_out, film)
    jp = jax.tree.map(jnp.asarray, p)
    jss = None if ss is None else tuple(map(jnp.asarray, ss))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = resnet_block_wfold_fused(jx, jp, jss, dim_out, GROUPS, True)
    unfused = _reference_normal(jx, jp, jss, dim_out, GROUPS)
    tss = None if ss is None else tuple(map(torch.as_tensor, ss))
    before = (RB.conv3x3_stats.launches, RB.epilogue.launches)
    got = RB.resnet_block_fused(torch.as_tensor(x).bfloat16(), _module(p, shape[-1], dim_out),
                                tss)
    assert (RB.conv3x3_stats.launches, RB.epilogue.launches) == before  # no kernel on the CPU
    assert got.dtype == torch.bfloat16 and got.shape == shape[:3] + (dim_out,)
    _assert_bar(got, pallas, 2e-3)
    _assert_bar(got, unfused, 1e-2)


@pytest.mark.parametrize("shape,dim_out,film", CASES, ids=IDS)
def test_unfused_reference_is_the_jax_reference(shape, dim_out, film):
    """`resnet_block_reference` is `_reference_normal` (the same rounding
    points; float32 sums in another order): relative L2 ≤ 2e-3 (read
    ≤ 6e-4)."""
    p = _np_params(shape[-1], dim_out, seed=dim_out + shape[-1])
    x, ss = _inputs(shape, dim_out, film)
    want = _reference_normal(jnp.asarray(x).astype(jnp.bfloat16), jax.tree.map(jnp.asarray, p),
                             None if ss is None else tuple(map(jnp.asarray, ss)), dim_out,
                             GROUPS)
    got = RB.resnet_block_reference(torch.as_tensor(x).bfloat16(),
                                    _module(p, shape[-1], dim_out),
                                    None if ss is None else tuple(map(torch.as_tensor, ss)))
    assert got.dtype == torch.bfloat16
    _assert_bar(got, want, 2e-3)


def test_module_matches_the_jax_module_on_its_fused_path(monkeypatch):
    """The JAX module takes its kernel (`LOCALDIFF_FUSED_BLOCK=interpret`,
    as `tests/test_pallas_resnet_block.py` does), the port's module its
    fused block through the plain versions, on the same parameters (through
    `params_from_jax`, unchanged).  The whole module: the JAX module test's
    bar, atol 0.06 / rtol 0.08 and correlation > 0.999, and relative L2
    ≤ 1e-2 (read 4.0e-3: the bf16 FiLM Dense rounds its output once in the
    port and twice, product then bias, in flax).  Given flax's own FiLM
    output, the fused block holds relative L2 ≤ 2e-3 (read 0)."""
    shape, dim_out, tdim = (1, 64, 64, 32), 32, 128
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    t_emb = rng.standard_normal((1, tdim)).astype(np.float32)
    jmod = JB.ResnetBlock(dim_out=dim_out, groups=GROUPS, dtype=jnp.bfloat16)
    monkeypatch.setenv("LOCALDIFF_FUSED_BLOCK", "interpret")
    monkeypatch.setattr(JB, "_FUSED_BLOCK_N", None)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t_emb))
    # non-trivial norms and biases (flax initialises them to 1 and 0)
    params = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(t_emb))
    assert JB._FUSED_BLOCK_N not in (None, False)  # JAX took its fused kernel
    monkeypatch.setattr(JB, "_FUSED_BLOCK_N", None)

    tmod = ResnetBlock(dim_out, dim_out, GROUPS, tdim, torch.bfloat16)
    tmod.load_state_dict(params_from_jax(params, tmod))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    assert RB.fuses(shape, dim_out, GROUPS, torch.bfloat16)
    with torch.no_grad():
        got = tmod(xt.bfloat16(), torch.as_tensor(t_emb))
        tmod.use_kernel = False
        plain = tmod(xt.bfloat16(), torch.as_tensor(t_emb))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, plain)  # the CPU runs the plain versions either way
    got = _f32(got.permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, _f32(want), atol=0.06, rtol=0.08)
    assert np.corrcoef(got.ravel(), _f32(want).ravel())[0, 1] > 0.999
    assert _rel(got, want) <= 1e-2

    film = jax.nn.silu(jnp.asarray(t_emb)).astype(jnp.bfloat16) @ jnp.asarray(
        params["params"]["mlp"]["kernel"]).astype(jnp.bfloat16)
    film = film + jnp.asarray(params["params"]["mlp"]["bias"]).astype(jnp.bfloat16)
    ss = tuple(torch.as_tensor(_f32(v)) for v in jnp.split(film, 2, axis=-1))
    xh = xt.bfloat16().permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        _assert_bar(RB.resnet_block_fused(xh, tmod, ss), want, 2e-3)


def test_module_outside_the_gate_runs_the_blocks():
    """float32 compute, or fewer than 4096 pixels: the two Blocks, as the
    JAX module runs them."""
    assert RB.fuses((2, 64, 64, 32), 32, GROUPS, torch.bfloat16)
    assert not RB.fuses((2, 32, 32, 32), 32, GROUPS, torch.bfloat16)
    assert not RB.fuses((2, 64, 64, 32), 32, GROUPS, torch.float32)
    mod = ResnetBlock(32, 32, GROUPS, None, torch.bfloat16)
    x = torch.randn(1, 32, 32, 32).bfloat16().contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = mod(x)
        want = mod.block2(mod.block1(x)) + x
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the gate, the batch, the padding
# ---------------------------------------------------------------------------

# the 13 ResnetBlocks of a 256px UNet call that JAX fuses (dim 32, mults
# 1/2/4/8, 8 groups), and their NHWC inputs at batch 8
FUSED_256 = {
    "down0_block1": (8, 256, 256, 32), "down0_block2": (8, 256, 256, 32),
    "down1_block1": (8, 128, 128, 32), "down1_block2": (8, 128, 128, 32),
    "down2_block1": (8, 64, 64, 64), "down2_block2": (8, 64, 64, 64),
    "up1_block1": (8, 64, 64, 192), "up1_block2": (8, 64, 64, 192),
    "up2_block1": (8, 128, 128, 96), "up2_block2": (8, 128, 128, 96),
    "up3_block1": (8, 256, 256, 64), "up3_block2": (8, 256, 256, 64),
    "final_res_block": (8, 256, 256, 64),
}


def test_gate_picks_the_13_blocks_of_a_256px_unet():
    """Each ResnetBlock's input shape at batch 8, from the UNet's stage
    structure (stage i at 256 / 2^i pixels; mid, fusion and up0 at the last
    stage), through the port's gate and the JAX gate."""
    cfg = tcfg.mri256_config().model
    unet = UNet(cfg, torch.bfloat16)
    n = len(unet.in_out)
    side = lambda stage: 256 // 2**stage
    seen = {}
    for name, mod in unet.named_modules():
        if not isinstance(mod, ResnetBlock):
            continue
        head = name.split("_")[0]
        if head.startswith("down"):
            s = side(int(head[4:]))
        elif head.startswith("up"):
            s = side(n - 1 - int(head[2:]))
        else:
            s = side(n - 1) if name != "final_res_block" else side(0)
        shape = (8, s, s, mod.block1.proj.in_channels)
        dim_out = mod.block1.proj.out_channels
        port = RB.fuses(shape, dim_out, GROUPS, torch.bfloat16)
        jax_gate = s * s >= 4096 and jax_supports_normal(shape, dim_out, GROUPS)
        assert port == jax_gate, name
        seen[name] = (shape, port)
    assert len(seen) == 20
    assert {k: s for k, (s, f) in seen.items() if f} == FUSED_256


def test_fused_inputs_reach_the_kernel_as_nhwc_views():
    """In the UNet every fused block's input, after a skip `cat` and an
    `Upsample` too, is channels_last, so its NHWC view is free: the 256px
    configuration at a 64px input, where the first stage's blocks, the last
    up stage's and the final block fuse."""
    unet = UNet(tcfg.mri256_config().model, torch.bfloat16).eval()
    seen = []

    def hook(mod, args):
        b, c, h, w = args[0].shape
        if RB.fuses((b, h, w, c), mod.block1.proj.out_channels, GROUPS, torch.bfloat16):
            seen.append((mod, args[0].is_contiguous(memory_format=torch.channels_last)))

    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, ResnetBlock)]
    rng = np.random.default_rng(4)
    x, cond = (torch.as_tensor(rng.standard_normal((1, 64, 64, 1)).astype(np.float32))
               for _ in range(2))
    with torch.no_grad():
        out = unet(x, cond, torch.tensor([5]))
    for h in handles:
        h.remove()
    names = {m: n for n, m in unet.named_modules()}
    assert sorted(names[m] for m, _ in seen) == [
        "down0_block1", "down0_block2", "final_res_block", "up3_block1", "up3_block2"]
    assert all(cl for _, cl in seen)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("shape,dim_out", [
    ((2, 64, 64, 32), 32), ((2, 128, 128, 96), 64), ((2, 64, 64, 192), 128),
    ((2, 64, 60, 32), 32), ((2, 64, 64, 640), 128), ((2, 1, 64, 32), 32),
    ((2, 64, 28, 32), 32), ((2, 64, 64, 32), 16), ((2, 64, 64, 48), 64),
])
def test_supports_normal_is_the_jax_gate(shape, dim_out):
    assert RB.supports_normal(shape, dim_out, GROUPS) == jax_supports_normal(
        shape, dim_out, GROUPS)


def test_fused_block_row_alone_equals_row_in_batch():
    """The tiles come from H and W alone: row 0 by itself gives, bit for
    bit, what it gives inside a batch of 8 (with FiLM and a res_conv)."""
    shape, dim_out = (8, 16, 32, 64), 32
    mod = _module(_np_params(shape[-1], dim_out, seed=11), shape[-1], dim_out)
    x, ss = _inputs(shape, dim_out, True, seed=3)
    x = torch.as_tensor(x).bfloat16()
    ss = tuple(map(torch.as_tensor, ss))
    with torch.no_grad():
        whole = RB.resnet_block_fused(x, mod, ss)
        alone = RB.resnet_block_fused(x[:1].clone(), mod, tuple(t[:1].clone() for t in ss))
    assert torch.equal(alone, whole[:1])


def test_tile_sums_cover_every_pixel_once():
    """Ragged tiles included (H = 12, W = 20 are not multiples of 8 × 16)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((2, 12, 20, 16)).astype(np.float32)).bfloat16()
    w = RB.pack_conv3x3(torch.as_tensor(rng.standard_normal((32, 16, 3, 3)).astype(np.float32)))
    h, s, ss = RB.conv3x3_stats(x, w, torch.zeros(32))
    assert s.shape == ss.shape == (2, RB.num_tiles(12, 20), 32) == (2, 4, 32)
    hf = h.float()
    torch.testing.assert_close(s.sum(1), hf.sum(dim=(1, 2)), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ss.sum(1), (hf * hf).sum(dim=(1, 2)), rtol=1e-5, atol=1e-4)


def test_prologue_pads_with_zero_after_the_activation():
    """Pass 2's input is silu(x·a + b) inside the image and 0 outside: with
    every pixel at silu(2), an interior output sums 9 taps and a corner 4."""
    x = torch.ones(1, 4, 16, 8).bfloat16()
    a, b = torch.zeros(1, 8), torch.full((1, 8), 2.0)
    w = RB.pack_conv3x3(torch.ones(32, 8, 3, 3))
    h, _, _ = RB.conv3x3_stats(x, w, torch.zeros(32), a, b)
    v = float((torch.tensor(2.0) * torch.sigmoid(torch.tensor(2.0))).bfloat16())
    assert float(h[0, 1, 1, 0]) == pytest.approx(72 * v, rel=4e-3)  # 9 taps × 8 channels
    assert float(h[0, 0, 0, 0]) == pytest.approx(32 * v, rel=4e-3)  # corner: 4 taps


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 8, 16, 32, dtype=torch.bfloat16)
    w = torch.zeros(9, 32, 32, dtype=torch.bfloat16)
    bias = torch.zeros(32)
    with pytest.raises(TypeError, match="bfloat16"):
        RB.conv3x3_stats(x.float(), w, bias)
    with pytest.raises(ValueError, match="contiguous"):
        RB.conv3x3_stats(x.transpose(1, 2), w, bias)
    with pytest.raises(ValueError, match="shape"):
        RB.conv3x3_stats(x, w[:, :, :16], bias)
    with pytest.raises(ValueError, match="together"):
        RB.conv3x3_stats(x, w, bias, torch.zeros(1, 32), None)
    with pytest.raises(ValueError, match="shape"):
        RB.conv3x3_stats(x, w, bias, torch.zeros(2, 32), torch.zeros(2, 32))
    a = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="identity residual"):
        RB.epilogue(x, torch.zeros(1, 8, 16, 64, dtype=torch.bfloat16), a, a)
    with pytest.raises(TypeError, match="w_res"):
        RB.epilogue(x, x, a, a, torch.zeros(32, 32), torch.zeros(32))


# ---------------------------------------------------------------------------
# the epilogue kernel's launch plan (pure Python; the kernel runs on the
# card, tests/test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

# the 256px chain's six epilogue sites (FUSED_256's shapes with their
# dim_out), and ragged ones
EPI_SITES = [((8, 256, 256, 32), 32), ((8, 128, 128, 32), 32), ((8, 64, 64, 64), 64),
             ((8, 64, 64, 192), 128), ((8, 128, 128, 96), 64), ((8, 256, 256, 64), 32),
             ((3, 20, 36, 48), 64), ((2, 12, 40, 8), 128), ((1, 10, 30, 256), 32)]


def _items_walked(plan, c, res):
    """The items each unit of the kernel's grid walks, as the kernel walks
    them (csrc: epilogue_res_kernel, epilogue_identity_kernel): res_conv,
    block b's units (warpgroups, or one pair of them at c = 128) take
    b·units + u, then every G = blocks·units items after; identity, thread
    i of the grid takes the pieces i, i + blocks·256, ..."""
    units = (RB.EPI_THREADS // 128 // RB.epilogue_split(c)) if res else RB.EPI_THREADS
    step = plan["blocks"] * units
    return [range(first, plan["items"], step) for first in range(step)]


@pytest.mark.parametrize("shape,c", EPI_SITES)
def test_epilogue_plan_covers_every_item_once(shape, c):
    """The grid fits the card (the res_conv's one persistent wave of the
    blocks an SM holds, its weights within a block's shared memory; the
    identity kernel's pieces at most two a thread), walks every item once,
    and no unit walks more than `per` of them."""
    bsz, hh, ww, cin = shape
    res = cin != c
    for sms in (132, 7):
        plan = RB.epilogue_plan(bsz, hh * ww, c, cin, res, sms)
        assert plan["smem"] <= RB.SMEM_PER_SM - RB.SMEM_RESERVED
        if res:
            assert plan["blocks"] <= sms * plan["blocks_per_sm"]
            assert plan["smem"] == 32 * -(-cin // 32) * c * 2
            assert plan["tiles"] == -(-hh * ww // RB.EPI_ROWS)
            assert plan["items"] == bsz * plan["tiles"]
        else:
            assert plan["per"] <= RB.EPI_IDENTITY_PER_THREAD
            assert plan["items"] == bsz * hh * ww * c // 8
        walked = _items_walked(plan, c, res)
        flat = sorted(i for w in walked for i in w)
        assert flat == list(range(plan["items"]))
        assert max(len(w) for w in walked) == plan["per"]


def test_epilogue_blocks_per_sm_follow_the_kernels_registers():
    """The res_conv kernel's __launch_bounds__ (csrc: epi_res_blocks): three
    blocks an SM at 32 channels a warpgroup and Cin up to 64, two up to
    192 (at C = 128 each warpgroup takes 64), one past it."""
    assert [RB.epilogue_res_blocks(32, cin) for cin in (64, 96, 192, 256)] == [3, 2, 2, 1]
    assert [RB.epilogue_res_blocks(64, cin) for cin in (32, 96, 192, 224)] == [2, 2, 2, 1]
    assert [RB.epilogue_res_blocks(128, cin) for cin in (64, 192, 256)] == [2, 2, 1]
    assert [RB.epilogue_split(c) for c in (32, 64, 128)] == [1, 1, 2]
