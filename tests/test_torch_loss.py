"""The port's training loss against the JAX package's.

`GaussianDiffusion.loss` draws t, the noise and the offset from its draws
source in the JAX engine's split order; here the JAX draws (`split(rng,
3)`, then `randint`, `normal`, `normal`) are replayed through `ArrayDraws`,
so both sides see the same t and noise:

  * a narrow float32 UNet (dim 8, mults 1/2, full attention at the last
    stage, 32px: the GroupNorm Function at every Block and the attention
    Function at the 16×16 sites) for pred_noise, pred_x0 and pred_v, with
    the min-SNR weight off and on, offset noise and `auto_normalize`: the
    loss within 1e-5 relative and each gradient leaf within 1e-4 relative
    L2 of `jax.value_and_grad` of the JAX loss (float32 summation order).
    The condition encoder's conv biases feed GroupNorms of one channel a
    group, which remove any per-channel shift: their exact gradient is 0,
    and both sides read rounding residue (~1e-9 of the whole gradient's
    norm), so those leaves are held below 1e-6 of it on both sides;
  * the shipped 256px checkpoint (`results/mri_synth256_ema.npz`, on a
    shape-only template, no flax init) at a 64px input in bf16, where the
    fused ResnetBlocks and linear attention engage: the loss within 1e-2
    relative, the whole gradient within 5e-2 relative L2 and cosine ≥
    0.998, the one-UNet-call bf16 bars (read: 4.6e-4, 3.1e-3 and
    0.999997).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import ArrayDraws, build_gd
from localdiffusion_tpu_torch.utils.params_io import load_params_npz, params_from_jax
from test_torch_support import make_pair, small_model_cfg, to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results/mri_synth256_ema.npz")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_draws(key, shape, timesteps, offset: bool):
    """The JAX `loss`'s draws from `key`, as `ArrayDraws` arguments."""
    t_key, n_key, o_key = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(t_key, (shape[0],), 0, timesteps))
    normals = [np.asarray(jax.random.normal(n_key, shape, dtype=jnp.float32))]
    if offset:
        normals.append(np.asarray(jax.random.normal(o_key, (shape[0], shape[-1]),
                                                    dtype=jnp.float32)))
    return [t], normals


def grads_of(model):
    return {k: p.grad for k, p in model.named_parameters()}


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


VARIANTS = [("pred_noise", False, 0.0, False), ("pred_x0", True, 0.1, False),
            ("pred_v", True, 0.1, True)]


@pytest.mark.parametrize("objective,min_snr,offset,auto", VARIANTS,
                         ids=["noise", "x0-snr-offset", "v-snr-offset-autonorm"])
def test_narrow_f32_loss_and_gradients_match_jax(objective, min_snr, offset, auto):
    dc = tcfg.DiffusionConfig(image_size=32, timesteps=20, objective=objective,
                              beta_schedule="sigmoid", min_snr_loss_weight=min_snr,
                              offset_noise_strength=offset, auto_normalize=auto)
    jgd, params, tgd = make_pair(small_model_cfg(), dc, seed=1, numpy_init=True)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jgd.loss(p, key, jnp.asarray(x), jnp.asarray(cond))))(params)

    t, normals = jax_draws(key, x.shape, dc.timesteps, offset > 0)
    loss = tgd.loss(torch.as_tensor(x), torch.as_tensor(cond),
                    ArrayDraws("cpu", t, normals))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tgd.model)
    got = grads_of(tgd.model)
    assert set(got) == set(want)
    whole = float(torch.cat([g.flatten() for g in want.values()]).norm())
    zero = {n for n, g in want.items() if float(g.norm()) < 1e-6 * whole}
    assert zero and all(n.startswith("cond_model.") and n.endswith(
        ("conv1.bias", "conv2.bias", "id_conv.bias")) for n in zero), zero
    for name, g in got.items():
        if name in zero:
            assert float(g.norm()) < 1e-6 * whole, name
            continue
        assert g is not None and float(g.abs().max()) > 0, name
        assert _rel(g, want[name]) <= 1e-4, (name, _rel(g, want[name]))


def test_p_losses_refuses_self_conditioning():
    """Self-conditioning on an engine whose UNet was built without it (no
    input channels for the estimate) raises rather than train without the
    pre-pass; `test_torch_self_cond.py` holds the pre-pass against JAX."""
    dc = tcfg.DiffusionConfig(image_size=16, timesteps=4)
    _, _, tgd = make_pair(small_model_cfg(), dc, numpy_init=True)
    tgd.model_cfg = dataclasses.replace(tgd.model_cfg, self_condition=True)
    x = torch.zeros(1, 16, 16, 1)
    with pytest.raises(ValueError, match="self_condition"):
        tgd.p_losses(x, x, torch.zeros(1, dtype=torch.long), x, self_cond=True)


def test_array_draws_check_what_they_hand_out():
    d = ArrayDraws("cpu", timesteps=[np.array([1, 2])], normals=[np.zeros((2, 3))])
    with pytest.raises(ValueError, match="shape"):
        d.timesteps(3, 10)
    assert d.normal((2, 3)).dtype == torch.float32
    with pytest.raises(RuntimeError, match="no normal draw left"):
        d.normal((2, 3))


def test_shipped_checkpoint_bf16_gradient_matches_jax():
    cfg = tcfg.mri256_config()
    cfg = cfg.replace(diffusion=dataclasses.replace(cfg.diffusion, image_size=64))
    jgd = JaxGD(to_jax(cfg.model), to_jax(cfg.diffusion), dtype=jnp.bfloat16)
    template = jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))
    params = jax_load_npz(NPZ, template)
    hi = tcfg.min_max_val_for(cfg)[1]
    rng = np.random.default_rng(0)
    x = rng.uniform(0, hi, (2, 64, 64, 1)).astype(np.float32)
    cond = rng.uniform(0, hi, (2, 64, 64, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jgd.loss(p, key, jnp.asarray(x), jnp.asarray(cond))))(params)

    tgd = build_gd(cfg, device="cpu")
    tgd.model.load_state_dict(load_params_npz(NPZ, tgd.model))
    t, normals = jax_draws(key, x.shape, cfg.diffusion.timesteps, False)
    loss = tgd.loss(torch.as_tensor(x), torch.as_tensor(cond), ArrayDraws("cpu", t, normals))
    seen, todo = set(), [loss.grad_fn]
    while todo:  # the Functions on the graph: the fused gates engage at 64px
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    names = {type(f).__name__ for f in seen}
    assert {"ResnetBlockFnBackward", "LinearAttentionFnBackward",
            "GroupNormFilmSiLUFnBackward"} <= names
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-2 * abs(float(jl))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tgd.model)
    got = torch.cat([p.grad.flatten() for p in tgd.model.parameters()]).double()
    ref = torch.cat([want[k].flatten() for k, _ in tgd.model.named_parameters()]).double()
    assert _rel(got, ref) <= 5e-2
    assert float(got @ ref / (got.norm() * ref.norm())) >= 0.998
