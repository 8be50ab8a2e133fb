"""The kernels' autograd Functions against the JAX package's custom_vjps.

Each Pallas kernel's backward in the JAX package is `jax.vjp` of an XLA
reference; each of the port's wrappers goes through a
`torch.autograd.Function` whose backward recomputes through the port's
counterpart.  On the CPU (the wrappers' plain forwards), with the same
inputs and the same cotangent from a numpy seed, each Function's
gradients are held against `jax.vjp` of:

  * `groupnorm_film_silu_reference` (`_gn_vjp_bwd`, the single pass and,
    past the row gate, the tiled pair), with and without FiLM;
  * `xla_attention` (`_flash_bwd`), the port's inputs strided views of one
    qkv projection as `models.blocks.Attention` cuts them;
  * `linear_attention_folded_reference` (`_bwd`), on the W-folded view the
    JAX kernel differentiates;
  * `_reference_normal` (`_bwd_wfold`), the fused block with and without a
    res_conv and FiLM.

float32 within 1e-5 relative (summation order), bf16 within 2e-2 relative
L2 (the two frameworks round bf16 at other places).  A bias added in bf16
(the linear attention's `b_out`, the fused block's conv biases) gets from
`jax.vjp` its cotangent summed over every position in bf16, which reads 3%
to 7% from the float64 sum at these sizes while the port's reads 0.4%;
there the JAX side is given the bias at every position, and the per-position
cotangents that `jax.vjp` returns are summed in float64.  Under `no_grad` each
wrapper returns what it returned before, bit for bit, and with grad each
output has its Function's `grad_fn`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.ops.attention import xla_attention as jax_attention
from localdiffusion_tpu.ops.pallas_groupnorm import groupnorm_film_silu_reference as jax_gn
from localdiffusion_tpu.ops.pallas_linear_attention import linear_attention_folded_reference
from localdiffusion_tpu.ops.pallas_resnet_block import _reference_normal
from localdiffusion_tpu_torch.models.blocks import ResnetBlock
from localdiffusion_tpu_torch.ops import attention as A
from localdiffusion_tpu_torch.ops import groupnorm as G
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resnet_block as RB
from localdiffusion_tpu_torch.ops.autograd import refuse_graph
from localdiffusion_tpu_torch.utils.params_io import params_from_jax

F32_REL, BF16_REL = 1e-5, 2e-2
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, what):
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_REL,
                                   atol=F32_REL * float(np.abs(_np(want)).max()), err_msg=what)
    else:
        assert _rel(got, want) <= BF16_REL, (what, _rel(got, want))


def _sum64(a, keep):
    """a summed in float64 over all but its last `keep` axes."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)
    return a.reshape(-1, *a.shape[a.ndim - keep:]).sum(0)


def _leaf(a, dtype):
    return torch.tensor(a).to(dtype).requires_grad_(True)


def _jax(a, dtype):
    return jnp.asarray(torch.as_tensor(a).to(dtype).float().numpy()).astype(JDT[dtype])


# ---------------------------------------------------------------------------
# GroupNorm + FiLM + SiLU
# ---------------------------------------------------------------------------

# one shape each side of the row gate (512 KiB at 4 bytes an element)
GN_SHAPES = [(2, 8, 8, 32), (1, 64, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", GN_SHAPES, ids=["single", "tiled"])
def test_groupnorm_backward_is_the_jax_vjp(shape, film, dtype):
    assert G.large_block(shape) == (shape == GN_SHAPES[1])
    rng = np.random.default_rng(1)
    b, _, _, c = shape
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    gamma, beta = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    ss = [rng.standard_normal((b, c)).astype(np.float32) * 0.5 for _ in range(2)]
    cot = rng.standard_normal(shape).astype(np.float32)
    args = [x, gamma, beta] + (ss if film else [])

    tx = [_leaf(x, dtype)] + [_leaf(a, torch.float32) for a in args[1:]]
    out = G.groupnorm_film_silu(*tx, *([None, None] if not film else []), groups=8)
    assert type(out.grad_fn).__name__ == "GroupNormFilmSiLUFnBackward"
    got = torch.autograd.grad(out, tx, torch.tensor(cot).to(dtype))

    jargs = [_jax(x, dtype)] + [jnp.asarray(a) for a in args[1:]]
    fn = lambda *a: jax_gn(*a, *([None, None] if not film else []), 8)
    _, vjp = jax.vjp(fn, *jargs)
    want = vjp(jnp.asarray(cot).astype(JDT[dtype]))
    assert len(got) == len(want) == len(args)
    for name, g, w in zip(["x", "gamma", "beta", "scale", "shift"], got, want):
        _close(g, w, dtype, name)


# ---------------------------------------------------------------------------
# full attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_on_strided_views_is_the_jax_vjp(dtype):
    """q, k, v are the [b, n, H, d] views `Attention` cuts from one qkv
    projection [b, 3·H·d, n]: the gradient reaches the projection through
    them."""
    b, heads, d, n = 2, 2, 32, 256
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((b, 3 * heads * d, n)).astype(np.float32)
    cot = rng.standard_normal((b, n, heads, d)).astype(np.float32)
    t = _leaf(qkv, dtype)
    q, k, v = (u.permute(0, 3, 1, 2) for u in t.reshape(b, 3, heads, d, n).unbind(1))
    assert not q.is_contiguous() and n >= A.FLASH_MIN_TOKENS
    out = A.full_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    (got,) = torch.autograd.grad(out, t, torch.tensor(cot).to(dtype))

    def fn(p):
        u = p.reshape(b, 3, heads, d, n).transpose(1, 0, 4, 2, 3)  # [3, b, n, H, d]
        return jax_attention(u[0], u[1], u[2])

    _, vjp = jax.vjp(fn, _jax(qkv, dtype))
    (want,) = vjp(jnp.asarray(cot).astype(JDT[dtype]))
    _close(got, want, dtype, "qkv")


# ---------------------------------------------------------------------------
# linear attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [(torch.float32, (2, 16, 16, 32)),
                                         (torch.bfloat16, (2, 64, 64, 32))])
def test_linear_attention_backward_is_the_jax_vjp(dtype, shape):
    """The parameters are Function inputs and each gets its gradient; the
    JAX side differentiates its reference on the W-folded view (r = 128/C
    pixels a row) that its kernel takes."""
    b, h, w, c = shape
    r = 128 // c
    hidden = LA.HIDDEN
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    g_in, b_out, g_out = (1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)
                          for _ in range(3))
    w_qkv = (rng.standard_normal((c, 3 * hidden)) / np.sqrt(c)).astype(np.float32)
    w_out = (rng.standard_normal((hidden, c)) / np.sqrt(hidden)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    params = [g_in, w_qkv, w_out, b_out, g_out]

    tp = [_leaf(x, dtype)] + [_leaf(p, torch.float32) for p in params]
    out = LA.linear_attention(*tp)
    assert type(out.grad_fn).__name__ == "LinearAttentionFnBackward"
    got = torch.autograd.grad(out, tp, torch.tensor(cot).to(dtype))

    def fn(xx, *pp):
        y = linear_attention_folded_reference(xx.reshape(b, h, w // r, r * c), *pp,
                                              LA.HEADS, LA.DIM_HEAD, r, add_residual=False)
        return y.reshape(b, h, w, c)

    jparams = list(map(jnp.asarray, params))
    jcot = jnp.asarray(cot).astype(JDT[dtype])
    _, vjp = jax.vjp(fn, _jax(x, dtype), *jparams)
    want = list(vjp(jcot))
    if dtype == torch.bfloat16:  # b_out at every position of the folded view
        jparams[3] = jnp.broadcast_to(jparams[3], (b, h, w // r, r, c))
        _, vjp = jax.vjp(fn, _jax(x, dtype), *jparams)
        want[4] = _sum64(vjp(jcot)[4], 1)
    for name, g, wv in zip(["x", "g_in", "w_qkv", "w_out", "b_out", "g_out"], got, want):
        _close(g, wv, dtype, name)


# ---------------------------------------------------------------------------
# the fused ResnetBlock
# ---------------------------------------------------------------------------

def _np_block(cin, dim_out, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)

    def block(ci):
        return {"proj": {"kernel": r(3, 3, ci, dim_out) * 0.1, "bias": r(dim_out) * 0.05},
                "norm": {"scale": r(dim_out) * 0.2 + 1.0, "bias": r(dim_out) * 0.1}}

    p = {"block1": block(cin), "block2": block(dim_out)}
    if cin != dim_out:
        p["res_conv"] = {"kernel": r(1, 1, cin, dim_out) * 0.1, "bias": r(dim_out) * 0.05}
    return p


@pytest.mark.parametrize("cin,film", [(32, True), (32, False), (64, True)],
                         ids=["identity-film", "identity-nofilm", "res_conv-film"])
def test_fused_block_backward_is_the_jax_vjp(cin, film):
    """Every parameter of the block and the FiLM pair get their gradient,
    as the JAX `_bwd_wfold` gives them."""
    shape, dim_out, groups = (2, 8, 32, cin), 32, 8
    p = _np_block(cin, dim_out, seed=cin + film)
    mod = ResnetBlock(cin, dim_out, groups, None, torch.bfloat16)
    mod.load_state_dict(params_from_jax(p, mod))
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    ss = [(rng.standard_normal((2, dim_out)) * 0.3).astype(np.float32) for _ in range(2)]
    cot = (rng.standard_normal(shape[:3] + (dim_out,)) * 0.1).astype(np.float32)

    tx = _leaf(x, torch.bfloat16)
    tss = tuple(_leaf(s, torch.float32) for s in ss) if film else None
    out = RB.resnet_block_fused(tx, mod, tss)
    assert type(out.grad_fn).__name__ == "ResnetBlockFnBackward"
    names = [n for n, _ in mod.named_parameters()]
    inputs = [tx] + (list(tss) if film else []) + list(mod.parameters())
    got = torch.autograd.grad(out, inputs, torch.tensor(cot).bfloat16())

    jp = jax.tree.map(jnp.asarray, p)
    jx = _jax(x, torch.bfloat16)
    jcot = jnp.asarray(cot).astype(jnp.bfloat16)
    if film:
        _, vjp = jax.vjp(lambda xx, pp, s: _reference_normal(xx, pp, s, dim_out, groups),
                         jx, jp, tuple(map(jnp.asarray, ss)))
        gx, gp, gss = vjp(jcot)
    else:
        _, vjp = jax.vjp(lambda xx, pp: _reference_normal(xx, pp, None, dim_out, groups),
                         jx, jp)
        (gx, gp), gss = vjp(jcot), ()
    # the conv biases at every position: [B, H, W, dim_out], the res_conv's
    # [B, H, W, 1, dim_out] (its product keeps a phase axis)
    full = jax.tree.map(lambda a: a, jp)
    biases = [("block1", "proj"), ("block2", "proj")] + ([("res_conv",)] if "res_conv" in p
                                                         else [])
    for path in biases:
        node = full
        for k in path:
            node = node[k]
        at = shape[:3] + ((1,) if path == ("res_conv",) else ()) + (dim_out,)
        node["bias"] = jnp.broadcast_to(node["bias"], at)
    args = (jx, full) + ((tuple(map(jnp.asarray, ss)),) if film else ())
    _, vjp = jax.vjp(lambda xx, pp, *s: _reference_normal(xx, pp, s[0] if s else None,
                                                          dim_out, groups), *args)
    gfull = vjp(jcot)[1]
    for path in biases:
        src, dst = gfull, gp
        for k in path:
            src, dst = src[k], dst[k]
        dst["bias"] = _sum64(src["bias"], 1)
    want_p = params_from_jax({"params": gp}, mod)
    want = [gx] + list(gss) + [want_p[n] for n in names]
    assert len(got) == len(want)
    for name, g, w in zip(["x"] + ["scale", "shift"][:len(gss)] + names, got, want):
        assert float(np.abs(_np(g)).max()) > 0, name
        _close(g, w, torch.bfloat16, name)


# ---------------------------------------------------------------------------
# serving unchanged, and the graph never dropped
# ---------------------------------------------------------------------------

def _gn_call(t):
    return G.groupnorm_film_silu(t["x"], t["g"], t["b"], t["s"], t["h"], groups=8)


def _attn_call(t):
    return A.flash_attention(t["q"], t["k"], t["v"])


def _linatt_call(t):
    return LA.linear_attention(t["x"], t["g"], t["wqkv"], t["wout"], t["b"], t["h"])


WRAPPERS = {
    "groupnorm": (_gn_call, lambda x, g, b, s, h: G.groupnorm_film_silu_plain(x, g, b, s, h, 8),
                  "GroupNormFilmSiLUFnBackward"),
    "flash_attention": (_attn_call, lambda q, k, v: A.xla_attention(q, k, v),
                        "FlashAttentionFnBackward"),
    "linear_attention": (_linatt_call, LA.linear_attention_reference,
                         "LinearAttentionFnBackward"),
}


def _tensors(name):
    rng = np.random.default_rng(5)
    r = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    if name == "groupnorm":
        return dict(x=r(2, 64, 64, 64), g=r(64), b=r(64), s=r(2, 64), h=r(2, 64))
    if name == "flash_attention":
        return dict(q=r(1, 256, 2, 32), k=r(1, 256, 2, 32), v=r(1, 256, 2, 32))
    return dict(x=r(1, 64, 64, 32).bfloat16(), g=r(32), wqkv=r(32, 384) * 0.2,
                wout=r(128, 32) * 0.1, b=r(32), h=r(32))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_unchanged_under_no_grad_and_recorded_with_grad(name):
    call, plain, fn_name = WRAPPERS[name]
    t = _tensors(name)
    want = plain(*t.values())
    with torch.no_grad():
        bare = call({k: v.requires_grad_(True) for k, v in t.items()})
    assert bare.grad_fn is None and torch.equal(bare, want)
    graphed = call(t)
    assert type(graphed.grad_fn).__name__ == fn_name
    assert torch.equal(graphed.detach(), want)  # the Function's forward is the same call
    for v in t.values():
        v.requires_grad_(False)
    assert call(t).grad_fn is None  # no input requires grad: the bare call


def test_fused_block_unchanged_under_no_grad_and_recorded_with_grad():
    mod = ResnetBlock(32, 32, 8, None, torch.bfloat16)
    x = torch.randn(1, 8, 32, 32, generator=torch.Generator().manual_seed(0)).bfloat16()
    want = RB.resnet_block_fused_plain(x, mod)
    with torch.no_grad():
        bare = RB.resnet_block_fused(x, mod)
    assert bare.grad_fn is None and torch.equal(bare, want.detach())
    graphed = RB.resnet_block_fused(x, mod)
    assert type(graphed.grad_fn).__name__ == "ResnetBlockFnBackward"
    assert torch.equal(graphed.detach(), bare)


def test_a_kernel_refuses_a_call_that_would_drop_the_graph():
    """What every CUDA launch runs first: grad on and an input requiring
    grad raises; under no_grad, or with no such input, it passes."""
    t = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        refuse_graph("conv3x3_stats", None, t)
    with torch.no_grad():
        refuse_graph("conv3x3_stats", None, t)
    refuse_graph("conv3x3_stats", t.detach(), None)
