"""The port's trainer against the JAX package's (`train/trainer.py`).

  * `ema_decay_for_step` equals JAX's at steps 0–1,000, and `ema_update`
    JAX's within 1e-7 (the EMA left as it is off its steps);
  * clip + Adam against optax's `clip_by_global_norm` → `adam` over three
    steps on the same gradients, clipping and not: parameters and both
    moments within 1e-6 relative (updated parameters of two independent
    training runs are not compared: Adam's first step is ±lr·sign(g));
  * one batch step's and one streamed epoch step's gradients (the epoch
    with a short last batch, each batch's loss over n batches) against the
    JAX `accum_grad_fn`'s on a narrow float32 UNet, with the JAX draws of
    `train_epoch_step`'s key splits replayed: each leaf within 1e-4
    relative L2 after optax's clip;
  * the device-resident epoch, given a permutation, equals the streamed
    epoch over the same drop-last batches, bit for bit;
  * `save`/`load` restore every tensor bit for bit, and 2 steps + resume +
    2 steps equal 4 straight steps;
  * `save_params_npz` read by the JAX package's `load_params_npz` into its
    template equals `params_to_jax`.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from localdiffusion_tpu.train.trainer import EmaConfig as JEma
from localdiffusion_tpu.train.trainer import Trainer as JTrainer
from localdiffusion_tpu.train.trainer import ema_decay_for_step as j_decay
from localdiffusion_tpu.train.trainer import ema_update as j_ema_update
from localdiffusion_tpu.train.trainer import make_optimizer as j_make_optimizer
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import ArrayDraws
from localdiffusion_tpu_torch.scripts.train import step_seed
from localdiffusion_tpu_torch.train import trainer as T
from localdiffusion_tpu_torch.utils.params_io import (
    params_from_jax,
    params_to_jax,
    save_params_npz,
)
from test_torch_loss import jax_draws
from test_torch_support import make_pair, small_model_cfg, to_jax

S, TSTEPS = 16, 10


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_ema_decay_equals_jax():
    got = np.array([T.ema_decay_for_step(s, T.EmaConfig()) for s in range(1001)], np.float32)
    want = np.asarray(jax.vmap(lambda s: j_decay(s, JEma()))(jnp.arange(1001)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("step", [100, 110, 250, 995, 115])
def test_ema_update_matches_jax(step):
    rng = np.random.default_rng(step)
    ema = [rng.standard_normal((4, 5)).astype(np.float32),
           rng.standard_normal(7).astype(np.float32)]
    params = [rng.standard_normal(a.shape).astype(np.float32) for a in ema]
    got = [torch.tensor(a) for a in ema]
    T.ema_update(got, [torch.tensor(a) for a in params], step, T.EmaConfig())
    want = j_ema_update([jnp.asarray(a) for a in ema], [jnp.asarray(a) for a in params],
                        jnp.asarray(step), JEma())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7, atol=1e-7)
    if step % 10:  # not an update step: untouched
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(got, ema))


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_clip_and_adam_match_optax(scale):
    cfg = tcfg.TrainConfig(lr=1e-3)
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal((6, 3)).astype(np.float32),
          rng.standard_normal(5).astype(np.float32)]
    grads = [[(rng.standard_normal(a.shape) * scale).astype(np.float32) for a in p0]
             for _ in range(3)]
    params = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    opt = T.make_optimizer(params, cfg)
    jopt = j_make_optimizer(to_jax(cfg))
    jp = [jnp.asarray(a) for a in p0]
    jstate = jopt.init(jp)
    for g in grads:
        for p, a in zip(params, g):
            p.grad = torch.tensor(a)
        norm = T.clip_by_global_norm([p.grad for p in params], cfg.max_grad_norm)
        assert (float(norm) >= cfg.max_grad_norm) == (scale > 1)
        opt.step()
        upd, jstate = jopt.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
    adam = jstate[1][0]
    for i, p in enumerate(params):
        st = opt.state[p]
        assert _rel(p.detach().numpy(), jp[i]) <= 1e-6
        assert _rel(st["exp_avg"].numpy(), adam.mu[i]) <= 1e-6
        assert _rel(st["exp_avg_sq"].numpy(), adam.nu[i]) <= 1e-6


# ---------------------------------------------------------------------------
# the steps on a narrow float32 UNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow():
    dc = tcfg.DiffusionConfig(image_size=S, timesteps=TSTEPS, objective="pred_x0",
                              beta_schedule="sigmoid")
    jgd, params, tgd = make_pair(small_model_cfg(), dc, seed=2, numpy_init=True)
    rng = np.random.default_rng(9)
    hr = rng.uniform(0, 2, (10, S, S, 1)).astype(np.float32)
    lr = rng.uniform(0, 2, (10, S, S, 1)).astype(np.float32)
    jtr = JTrainer(jgd, to_jax(tcfg.TrainConfig(batch_size=4, lr=1e-4)))
    return dict(jgd=jgd, params=params, tgd=tgd, hr=hr, lr=lr, accum=jtr.accum_grad_fn())


def _trainer(n, batch_size=4):
    gd = copy.deepcopy(n["tgd"])
    return T.Trainer(gd, tcfg.TrainConfig(batch_size=batch_size, lr=1e-4))


def _check_grads(trainer, jgrads):
    """The trainer's gradients (clipped in place by its step) against
    optax's clip of the JAX gradients, leaf by leaf; leaves whose exact
    gradient is 0 (biases before a one-channel-a-group GroupNorm, see
    test_torch_loss) held below 1e-6 of the whole."""
    clipped, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)
    want = params_from_jax(jax.tree.map(np.asarray, clipped), trainer.model)
    whole = float(torch.cat([g.flatten() for g in want.values()]).norm())
    for name, p in trainer.model.named_parameters():
        if float(want[name].norm()) < 1e-6 * whole:
            assert float(p.grad.norm()) < 1e-6 * whole, name
        else:
            assert _rel(p.grad.numpy(), want[name].numpy()) <= 1e-4, name


def test_batch_step_gradient_matches_jax(narrow):
    tr = _trainer(narrow)
    hr, lr = narrow["hr"][:4], narrow["lr"][:4]
    key = jax.random.PRNGKey(21)
    zero = jax.tree.map(jnp.zeros_like, narrow["params"])
    jgrads, jloss = narrow["accum"](narrow["params"], zero, jnp.zeros(()), jnp.asarray(hr),
                                    jnp.asarray(lr), key, jnp.float32(1.0))
    t, normals = jax_draws(key, hr.shape, TSTEPS, False)
    loss = tr.train_batch_step(hr, lr, ArrayDraws("cpu", t, normals))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert tr.step == 1
    _check_grads(tr, jgrads)


def _epoch_draws(key, batches):
    """The draws of the JAX `train_epoch_step` over these batches: one
    split of the key a batch, then `loss`'s own split of the sub key."""
    t_all, n_all = [], []
    for hr, _ in batches:
        key, sub = jax.random.split(key)
        t, normals = jax_draws(sub, hr.shape, TSTEPS, False)
        t_all += t
        n_all += normals
    return t_all, n_all


def test_epoch_step_gradient_matches_jax(narrow):
    """Batches of 4, 4 and 2 (the short last batch counts as one of n=3),
    each batch's loss scaled by 1/3, the gradients summed."""
    tr = _trainer(narrow)
    hr, lr = narrow["hr"], narrow["lr"]
    batches = [(hr[i:i + 4], lr[i:i + 4]) for i in (0, 4, 8)]
    key = jax.random.PRNGKey(33)
    accum = narrow["accum"]
    grads, jloss, k = jax.tree.map(jnp.zeros_like, narrow["params"]), jnp.zeros(()), key
    for bh, bl in batches:
        k, sub = jax.random.split(k)
        grads, jloss = accum(narrow["params"], grads, jloss, jnp.asarray(bh), jnp.asarray(bl),
                             sub, jnp.float32(1.0 / 3))
    loss = tr.train_epoch_step(batches, ArrayDraws("cpu", *_epoch_draws(key, batches)))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_grads(tr, grads)


def _same_state(a, b):
    for x, y in zip(list(a.model.parameters()) + list(a.ema_model.parameters()),
                    list(b.model.parameters()) + list(b.ema_model.parameters())):
        assert torch.equal(x, y)
    assert a.step == b.step


def test_resident_epoch_equals_streamed_epoch(narrow):
    """Drop-last: 10 rows at batch 4 make two batches; the permutation
    chooses them.  Both steps then see the same batches and draws."""
    perm = np.random.default_rng(4).permutation(10)
    t, normals = _epoch_draws(jax.random.PRNGKey(5), [(narrow["hr"][:4], None)] * 2)
    res, streamed = _trainer(narrow), _trainer(narrow)
    hr, lr = torch.as_tensor(narrow["hr"]), torch.as_tensor(narrow["lr"])
    l1 = res.train_epoch_resident(hr, lr, ArrayDraws("cpu", t, normals, permutations=[perm]))
    batches = [(narrow["hr"][perm[i:i + 4]], narrow["lr"][perm[i:i + 4]]) for i in (0, 4)]
    l2 = streamed.train_epoch_step(batches, ArrayDraws("cpu", t, normals))
    assert l1 == l2
    _same_state(res, streamed)
    with pytest.raises(ValueError, match="no batch"):
        _trainer(narrow, batch_size=16).train_epoch_resident(hr, lr, torch.Generator())


def _draws(step):
    return torch.Generator().manual_seed(step_seed(42, step))


def test_save_load_and_resume_are_exact(narrow, tmp_path):
    cfg = dataclasses.replace(tcfg.TrainConfig(batch_size=4), results_dir=str(tmp_path))
    straight = T.Trainer(copy.deepcopy(narrow["tgd"]), cfg)
    hr, lr = narrow["hr"][:4], narrow["lr"][:4]
    for s in range(4):
        straight.train_batch_step(hr, lr, _draws(s))
    first = T.Trainer(copy.deepcopy(narrow["tgd"]), cfg)
    assert all(e.data_ptr() != p.data_ptr()  # the EMA is a copy, not a view
               for e, p in zip(first.ema_model.parameters(), first.params))
    for s in range(2):
        first.train_batch_step(hr, lr, _draws(s))
    path = first.save("latest")
    assert path.endswith("model-latest.pt")
    resumed = T.Trainer(copy.deepcopy(narrow["tgd"]), cfg)
    resumed.load("latest")
    _same_state(resumed, first)
    for a, b in zip(first.optimizer.state.values(), resumed.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    for s in range(2, 4):
        resumed.train_batch_step(hr, lr, _draws(s))
    _same_state(resumed, straight)
    with pytest.raises(ValueError, match="min_max_val"):
        resumed.eval_sample_mse(hr, lr, 0)
    assert np.isfinite(resumed.eval_sample_mse(hr[:2], lr[:2], 0, (0.0, 2.0)))


def test_best_eval_and_milestones(tmp_path):
    assert T.load_best_eval(str(tmp_path)) == float("inf")
    T.record_best_eval(str(tmp_path), 0.25, "best300")
    assert T.load_best_eval(str(tmp_path)) == 0.25
    assert [T.round_milestone(s) for s in (7, 99, 149, 151, 1000)] == ["7", "99", "100",
                                                                        "200", "1000"]


def test_exported_npz_reads_into_the_jax_package(narrow, tmp_path):
    sd = narrow["tgd"].model.state_dict()
    path = str(tmp_path / "ema.npz")
    save_params_npz(path, sd)
    template = jax.eval_shape(lambda: narrow["jgd"].init_params(jax.random.PRNGKey(0)))
    loaded = jax_load_npz(path, template)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(loaded)[0]}
    want = params_to_jax(sd)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert np.array_equal(flat[k], v.astype(np.float16).astype(np.float32)), k
