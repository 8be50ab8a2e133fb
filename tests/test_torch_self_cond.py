"""The denoiser variants against the JAX package: learned and random
Fourier time features (`RandomOrLearnedSinusoidalPosEmb`) and
self-conditioning.

A narrow float32 UNet (dim 8, mults 1/2, 16px) with the JAX weights carried
across (`params_from_jax`, the key `time_mlp/pos_emb/weights` among them):

  * the forward under each variant, with `x_self_cond` given and None
    (zeros), on the standard layout and the s2d stem (f=2): within 1e-5 of
    the JAX UNet;
  * `p_losses` with the self-conditioning coin injected both ways (JAX: a
    key whose Bernoulli draw is heads or tails; heads with learned
    features and pred_x0, tails with random ones and pred_noise): the loss within 1e-5
    relative and each gradient leaf within 1e-4 relative L2 (float32
    summation order, as `test_torch_loss.py` holds the loss), the learned
    `pos_emb/weights` among them; random features take no gradient on
    either side (JAX's is zero, the port's parameter takes none); `loss`
    draws the coin first, and only with self-conditioning on;
  * the npz round trip of the new keys, both ways between the packages;
  * three `Trainer` steps: random weights bit-equal (their EMA within an
    ulp), learned ones moved, and the clip, Adam and the EMA covering the
    learned weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu.utils.params_io import save_params_npz as jax_save_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import ArrayDraws, GaussianDiffusion
from localdiffusion_tpu_torch.train.trainer import EmaConfig, Trainer
from localdiffusion_tpu_torch.utils.params_io import (
    load_params_npz,
    params_from_jax,
    params_to_jax,
    save_params_npz,
)
from test_torch_support import make_pair, small_model_cfg

S, T = 16, 20
KEY = "params/time_mlp/pos_emb/weights"
VARIANTS = {
    "learned": dict(learned_sinusoidal_cond=True),
    "random": dict(random_fourier_features=True),
    "self_cond": dict(self_condition=True),
    "self_cond_learned": dict(self_condition=True, learned_sinusoidal_cond=True,
                              learned_sinusoidal_dim=8),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model_cfg(variant, stem=1):
    return dataclasses.replace(small_model_cfg(), stem_space_to_depth=stem, **VARIANTS[variant])


def _diff_cfg(objective="pred_x0"):
    return tcfg.DiffusionConfig(image_size=S, timesteps=T, objective=objective,
                                beta_schedule="sigmoid")


def _inputs(seed=3, b=2):
    rng = np.random.default_rng(seed)
    x, cond, sc = (rng.uniform(0, 1, (b, S, S, 1)).astype(np.float32) for _ in range(3))
    return x, cond, sc, np.array([3, 17])[:b]


def _coin_key(heads: bool):
    """A key whose `jax.random.bernoulli` draw is `heads`."""
    for k in range(64):
        key = jax.random.PRNGKey(k)
        if bool(jax.random.bernoulli(key)) == heads:
            return key
    raise AssertionError("no key found")


@pytest.mark.parametrize("stem", [1, 2], ids=["standard", "s2d2"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet_forward_matches_jax(variant, stem):
    mc = _model_cfg(variant, stem)
    jgd, params, tgd = make_pair(mc, _diff_cfg(), seed=2, numpy_init=True)
    want_keys = {k for k in params_to_jax(tgd.model.state_dict())}
    assert (KEY in want_keys) == (variant != "self_cond")
    c_in = (2 if mc.self_condition else 1) * stem * stem
    assert tgd.model.init_conv.weight.shape[1] == c_in
    x, cond, sc, t = _inputs()
    for given in (sc, None):
        want = np.asarray(jgd.apply_model(params, jnp.asarray(x), jnp.asarray(cond),
                                          jnp.asarray(t), x_self_cond=None if given is None
                                          else jnp.asarray(given)))
        with torch.no_grad():
            got = tgd.model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t),
                            x_self_cond=None if given is None else torch.as_tensor(given))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if mc.self_condition:  # None is zeros, and a given estimate moves the output
        with torch.no_grad():
            zeros = tgd.model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t),
                              x_self_cond=torch.zeros(x.shape))
            none = tgd.model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t))
            given = tgd.model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t),
                              x_self_cond=torch.as_tensor(sc))
        assert torch.equal(zeros, none) and not torch.allclose(given, none)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("variant,objective,heads", [
    ("self_cond_learned", "pred_x0", True), ("random", "pred_noise", False),
], ids=["learned-x0-heads", "random-noise-tails"])
def test_p_losses_and_gradients_match_jax(variant, objective, heads):
    mc = _model_cfg(variant)
    if variant == "random":
        mc = dataclasses.replace(mc, self_condition=True)
    jgd, params, tgd = make_pair(mc, _diff_cfg(objective), seed=4, numpy_init=True)
    x, cond, _, t = _inputs(5)
    noise = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    key = _coin_key(heads)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jgd.p_losses(
        p, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t), jnp.asarray(noise),
        self_cond_key=key)))(params)
    loss = tgd.p_losses(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t),
                        torch.as_tensor(noise), self_cond=heads)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tgd.model)
    whole = float(torch.cat([g.flatten() for g in want.values()]).norm())
    for name, p in tgd.model.named_parameters():
        w = want[name]
        if name == "time_mlp.pos_emb.weights" and variant == "random":
            assert p.grad is None and not p.requires_grad  # frozen, as JAX's stop_gradient
            assert float(w.abs().max()) == 0.0
            continue
        if float(w.norm()) < 1e-6 * whole:  # exact zero gradients (GroupNorm-removed biases)
            assert p.grad is None or float(p.grad.norm()) < 1e-6 * whole, name
            continue
        assert _rel(p.grad, w) <= 1e-4, (name, _rel(p.grad, w))
    if variant == "self_cond_learned":
        assert float(tgd.model.time_mlp.pos_emb.weights.grad.abs().max()) > 0


def test_loss_draws_the_coin_first_and_only_with_self_conditioning():
    x = torch.zeros(2, S, S, 1)
    t, noise = np.array([1, 2]), np.zeros((2, S, S, 1), np.float32)
    for variant, coins in (("learned", []), ("self_cond", [True])):
        _, _, tgd = make_pair(_model_cfg(variant), _diff_cfg(), numpy_init=True)
        draws = ArrayDraws("cpu", [t], [noise], coins=coins)
        tgd.loss(x, x, draws)
        with pytest.raises(RuntimeError, match="no coin draw left"):
            draws.coin()
    # from a generator: the coin is the first draw, then t and the noise
    _, _, tgd = make_pair(_model_cfg("self_cond"), _diff_cfg(), numpy_init=True)
    calls = []

    class Spy(ArrayDraws):
        def coin(self):
            calls.append("coin")
            return super().coin()

        def timesteps(self, b, n):
            calls.append("t")
            return super().timesteps(b, n)

        def normal(self, shape):
            calls.append("noise")
            return super().normal(shape)

    tgd.loss(x, x, Spy("cpu", [t], [noise], coins=[False]))
    assert calls == ["coin", "t", "noise"]


@pytest.mark.parametrize("variant", ["self_cond_learned", "random"])
def test_npz_round_trip_of_the_new_keys(tmp_path, variant):
    jgd, params, tgd = make_pair(_model_cfg(variant), _diff_cfg(), seed=8, numpy_init=True)
    ours = str(tmp_path / "port.npz")
    save_params_npz(ours, tgd.model.state_dict())
    with np.load(ours) as f:
        assert KEY in f.files and f[KEY].shape == (tgd.model.cfg.learned_sinusoidal_dim // 2,)
    template = jax.tree.map(np.asarray, params)
    back_jax = jax_load_npz(ours, template)  # the port's npz into the JAX tree
    for (kp, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back_jax)[0],
                               jax.tree_util.tree_flatten_with_path(template)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b).astype(np.float16)
                                      .astype(np.float32), err_msg=jax.tree_util.keystr(kp))
    theirs = str(tmp_path / "jax.npz")
    jax_save_npz(theirs, params)
    state = load_params_npz(theirs, tgd.model)  # and the JAX npz into the port
    rounded = {k: v.half().float() for k, v in tgd.model.state_dict().items()}
    assert set(state) == set(rounded)
    assert all(torch.equal(state[k], rounded[k]) for k in state)
    fresh = GaussianDiffusion(tgd.model_cfg, tgd.diff_cfg, device="cpu")
    fresh.model.load_state_dict(state)
    assert fresh.model.time_mlp.pos_emb.weights.requires_grad == (variant != "random")


def test_trainer_keeps_random_weights_and_trains_learned_ones():
    ema = EmaConfig(update_every=1, update_after_step=1)
    out = {}
    for variant in ("random", "self_cond_learned"):
        mc = dataclasses.replace(_model_cfg(variant), self_condition=True)
        gd = GaussianDiffusion(mc, _diff_cfg(), device="cpu")
        tr = Trainer(gd, tcfg.TrainConfig(batch_size=2, lr=1e-2, max_grad_norm=1e-3), ema)
        w = gd.model.time_mlp.pos_emb.weights
        w0, e0 = w.detach().clone(), tr.ema_model.time_mlp.pos_emb.weights.detach().clone()
        rng = np.random.default_rng(0)
        for step in range(3):
            hr, lr = (rng.uniform(0, 1, (2, S, S, 1)).astype(np.float32) for _ in range(2))
            tr.train_batch_step(hr, lr, torch.Generator().manual_seed(step))
        covered = any(p is w for p in tr.params)
        state = tr.optimizer.state.get(w, {})
        e = tr.ema_model.time_mlp.pos_emb.weights
        out[variant] = (torch.equal(w, w0), covered, "exp_avg" in state,
                        bool(torch.allclose(e, e0, rtol=1e-6, atol=0)))
    # random: bit-equal, outside the clip and Adam; its EMA e·d + e·(1 − d)
    # rounds within an ulp of e, as the JAX EMA of a stop_gradient leaf does
    assert out["random"] == (True, False, False, True)
    assert out["self_cond_learned"] == (False, True, True, False)
