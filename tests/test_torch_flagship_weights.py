"""The trained MNIST checkpoints in the port.

Each Orbax milestone (`results/mnist_x250/model-best10000`, the flagship,
and `results/mnist_u150/model-best200`, the hallucination-prone model) is
read through the JAX package (read-only), carried into the port by
`params_from_jax` with no leaf left over, and one UNet call at batch 2 is
held against JAX's at atol/rtol 1e-4 (f32 on the CPU; the difference is
convolution summation order).  The exporter, `scripts/export_orbax_npz.py`,
run again into a temporary directory, writes the committed
`results_torch/*.npz` bit for bit, and the port's `factory.load_params`
reads each, every key consumed, to the JAX package's output on the same
npz at the same bar.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu import factory
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch import factory as tfactory
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from test_torch_support import images, jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import export_orbax_npz  # noqa: E402

# project -> (milestone, committed npz)
CKPTS = {"mnist_x250": ("best10000", "results_torch/mnist_x250_best10000.npz"),
         "mnist_u150": ("best200", "results_torch/mnist_u150_best200.npz")}


def _cfg(project):
    cfg = tcfg.flagship_config()
    return cfg.replace(train=dataclasses.replace(cfg.train, project_name=project))


def _unet_call(jgd, params, tgd):
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(np.float32)
    cond = images(1, 2, 28)
    t = np.array([3, 41], np.int32)
    want = np.asarray(jgd.model.apply(params, jnp.asarray(x), jnp.asarray(cond),
                                      jnp.asarray(t)))
    got = tgd.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                          torch.as_tensor(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 0.1  # a trained model, not a zero output


@pytest.mark.parametrize("project", sorted(CKPTS))
def test_flagship_checkpoint_matches_jax(monkeypatch, project):
    milestone, _ = CKPTS[project]
    if not os.path.isdir(os.path.join(ROOT, f"results/{project}/model-{milestone}")):
        pytest.fail(f"results/{project}/model-{milestone} is missing from the checkout")
    monkeypatch.chdir(ROOT)  # the config's results_dir is relative
    cfg = _cfg(project)
    jcfg = jax_config(cfg)
    jgd = factory.build_gd(jcfg)
    params = factory.load_params(jcfg, jgd, milestone=milestone, verbose=False, strict=True)
    leaves = jax.tree_util.tree_leaves(params)
    tgd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tgd.model)
    assert len(sd) == len(leaves) == len(tgd.model.state_dict())
    tgd.model.load_state_dict(sd)
    _unet_call(jgd, params, tgd)


@pytest.mark.parametrize("project", sorted(CKPTS))
def test_exporter_writes_the_committed_npz(tmp_path, project):
    _, committed = CKPTS[project]
    name = os.path.basename(committed)
    path = export_orbax_npz.export(name, str(tmp_path))
    with np.load(path) as fresh, np.load(os.path.join(ROOT, committed)) as kept:
        assert sorted(fresh.files) == sorted(kept.files)
        for k in kept.files:
            assert fresh[k].dtype == kept[k].dtype == np.float16
            np.testing.assert_array_equal(fresh[k], kept[k], err_msg=k)
    cfg = _cfg(project)
    jcfg = jax_config(cfg)
    jgd = factory.build_gd(jcfg)
    params = factory.load_params(jcfg, jgd, params_npz=path, verbose=False)
    tgd = tfactory.load_params(cfg, params_npz=os.path.join(ROOT, committed), device="cpu",
                               verbose=False)  # raises on a key left over or missing
    _unet_call(jgd, params, tgd)
