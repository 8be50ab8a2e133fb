"""Port parity: the aux models and their scripts.  SimpleCNN and the seg
losses against the JAX package's; `train_mnist_cls` and `train_seg`'s
steps from carried params on the same batches against the JAX scripts'
steps (optax's Adam); `eval_translation` against the JAX script; the npz
`train_seg` writes served by the seg detector.

Tolerances: SimpleCNN logits atol/rtol 1e-5 (f32, summation order); the
losses and their gradients 1e-6; each of 3 training steps' loss within
1e-4 relative.  The parameters after the 3 steps: each tensor within 5e-5
relative L2 (1.0e-5 read) and each weight within 1e-4, a tenth of the
learning rate.  Adam's first steps move a weight by about lr = 1e-3
whatever its gradient's size, so a weight whose gradient is near Adam's
eps (1e-8), where the two float32 gradients part in relative terms, moves
by up to that much apart (8.7e-5 read, one fc1 weight in 401,408).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from localdiffusion_tpu.data.synthetic import synthetic_brain_translation as j_brains
from localdiffusion_tpu.models import SegUNet as JSeg
from localdiffusion_tpu.models import SimpleCNN as JCNN
from localdiffusion_tpu.models import bce_dice_loss as j_bce_dice
from localdiffusion_tpu.models import dice_loss as j_dice
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.data import ArrayLoader
from localdiffusion_tpu_torch.factory import build_frontend
from localdiffusion_tpu_torch.models import seg_unet as SU
from localdiffusion_tpu_torch.models.simple_cnn import SimpleCNN
from localdiffusion_tpu_torch.scripts import eval_translation, train_mnist_cls, train_seg
from localdiffusion_tpu_torch.train.trainer import optax_adam
from localdiffusion_tpu_torch.utils.params_io import params_from_jax, params_to_jax, save_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import eval_translation as jax_eval_translation  # noqa: E402

STEPS, LOSS_REL, PARAM_REL, PARAM_ATOL = 3, 1e-4, 5e-5, 1e-4


def _flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in kp)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def cnn():
    jm = JCNN()
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1))))
    return jm, params


def _port_cnn(params):
    tm = SimpleCNN()
    tm.load_state_dict(params_from_jax(params, tm))
    return tm


def test_simple_cnn_matches_jax(cnn):
    jm, params = cnn
    tm = _port_cnn(params)
    assert set(params_to_jax(tm.state_dict())) == set(_flat(params))  # the round trip's keys
    x = np.random.default_rng(0).uniform(0, 2, (4, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_seg_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 8, 8, 1))).astype(np.float32)
    logits[0, 0, 0, 0] = 40.0  # far out on both tails: the log-sigmoid form
    logits[0, 0, 1, 0] = -40.0
    y = (rng.uniform(size=(3, 8, 8, 1)) > 0.7).astype(np.float32)
    for jfn, tfn in ((j_dice, SU.dice_loss), (j_bce_dice, SU.bce_dice_loss)):
        want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(y))
        lt = torch.as_tensor(logits).requires_grad_(True)
        got = tfn(lt, torch.as_tensor(y))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


def _jax_steps(loss_of, params, batches):
    """The JAX scripts' step (optax.adam(1e-3), value_and_grad) over the
    batches: (losses, final params)."""
    tx = optax.adam(1e-3)
    state = tx.init(params)

    @jax.jit
    def step(params, state, x, y):
        loss, grads = jax.value_and_grad(loss_of)(params, x, y)
        updates, state = tx.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for x, y in batches:
        params, state, loss = step(params, state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, params


def _check_params(got, want_tree):
    want = _flat(want_tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.linalg.norm(got[k] - v) <= PARAM_REL * np.linalg.norm(v), k
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL, err_msg=k)


def _port_steps(step, model, batches):
    opt = optax_adam(model.parameters(), 1e-3)
    return [float(step(model, opt, torch.as_tensor(x), torch.as_tensor(y)))
            for x, y in batches]


def test_train_mnist_cls_steps_match_jax(cnn):
    jm, params = cnn
    hr, y = train_mnist_cls.digits("absent-images", "absent-labels")  # the synthetic digits
    batches = list(ArrayLoader(hr, y, batch_size=32, seed=42).epoch_batches(0))[:STEPS]
    want, jparams = _jax_steps(
        lambda p, x, t: optax.softmax_cross_entropy_with_integer_labels(jm.apply(p, x), t).mean(),
        params, batches)
    tm = _port_cnn(params)
    got = _port_steps(train_mnist_cls.train_step, tm, batches)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _check_params(params_to_jax(tm.state_dict()), jparams)


def test_train_seg_steps_match_jax():
    """A narrow SegUNet (base 8, 16px, numpy-drawn params) through the
    script's step against the JAX script's on the script's data."""
    jm = JSeg(base=8)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1))))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else 1.0 + 0.1 * rng.standard_normal(s.shape))
        .astype(np.float32), template)
    (t1, seg), _ = train_seg.brains(16, False, "mri256_bf16")
    d = tcfg.mri256_bf16_config().data
    _, jt1, jseg = j_brains(64, 16, tumor=True, seed=0, mean_t1=d.mean_t1, std_t1=d.std_t1,
                            mean_flair=d.mean_flair, std_flair=d.std_flair)
    np.testing.assert_array_equal(t1, jt1)
    np.testing.assert_array_equal(seg, (jseg > 0).astype(np.float32))
    batches = list(ArrayLoader(t1, seg, batch_size=4, seed=42).epoch_batches(0))[:STEPS]
    want, jparams = _jax_steps(lambda p, x, t: j_bce_dice(jm.apply(p, x), t), params, batches)
    tm = SU.SegUNet(base=8)
    tm.load_state_dict(SU.seg_params_from_jax(params, tm))
    got = _port_steps(train_seg.train_step, tm, batches)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    _check_params(SU.flax_seg_tree(tm), jparams)


def test_train_seg_npz_serves_as_the_seg_detector(tmp_path, monkeypatch, capsys):
    """One epoch at 16px, one batch of all 64 brains: best_dice.npz (the
    shipped snapshot's 64 keys, fp16) and val.csv; the seg detector finds it
    first in the default order and detects with it."""
    monkeypatch.chdir(tmp_path)
    out = train_seg.main(["--epochs", "1", "--size", "16", "--batch", "64", "--config",
                          "mri256_bf16", "--device", "cpu"])
    assert out["out"] == "results/seg/best_dice.npz" and len(out["logs"]) == 1
    assert "val dice" in capsys.readouterr().out
    with np.load(out["out"]) as a, np.load(os.path.join(ROOT, "results/seg256_params.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 64
        assert {a[k].dtype for k in a.files} == {np.dtype(np.float16)}
    with open("results/seg/val.csv") as f:
        assert f.readline().strip() == "epoch,loss,val_dice"
    base = tcfg.mri256_bf16_config()
    cfg = base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=16),
        ood=dataclasses.replace(base.ood, input_size=16, seg_model_path=None))
    fe, _ = build_frontend(cfg, device="cpu", verbose=True)
    assert "loaded seg checkpoint results/seg/best_dice.npz" in capsys.readouterr().out
    mask, binary, probs = fe.detect(train_seg.brains(16, False, "mri256_bf16")[1][0][:2])
    assert mask.shape == binary.shape == probs.shape == (2, 16, 16, 1)


def test_eval_translation_matches_the_jax_script(cnn, tmp_path, monkeypatch, capsys):
    """The same fp16-rounded params (the slim npz's storage) and
    predictions: the JAX script (an Orbax checkpoint) and the port's (the
    npz) print the same lines."""
    import orbax.checkpoint as ocp

    _, params = cnn
    params = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float16)
                                    .astype(np.float32), params)
    ckpt = str(tmp_path / "cls")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(ckpt, params, force=True)
    ckptr.wait_until_finished()
    npz = str(tmp_path / "cls.npz")
    save_params_npz(npz, _port_cnn(params).state_dict())
    pred = str(tmp_path / "pred_all.npy")
    np.save(pred, np.random.default_rng(3).uniform(0, 2, (32, 28, 28, 1)).astype(np.float32))

    monkeypatch.setattr(sys, "argv", ["eval_translation.py", "--pred", pred, "--cls", ckpt])
    jax_eval_translation.main()
    want = capsys.readouterr().out
    got = eval_translation.main(["--pred", pred, "--cls", npz, "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert sum(got["hist"].values()) == 32
    assert f"class histogram: {got['hist']}" in want
