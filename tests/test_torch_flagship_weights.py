"""The shipped flagship checkpoint in the port.

`results/mnist_x250/model-best10000` is read through the JAX package
(read-only), carried into the port by `params_from_jax` with no leaf left
over, and one UNet call at batch 2 is held against JAX's at atol/rtol 1e-4
(f32 on the CPU; the difference is convolution summation order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu import factory
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from test_torch_support import images, jax_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = "results/mnist_x250/model-best10000"


def test_flagship_checkpoint_matches_jax(monkeypatch):
    if not os.path.isdir(os.path.join(ROOT, CKPT)):
        pytest.fail(f"{CKPT} is missing from the checkout")
    monkeypatch.chdir(ROOT)  # the config's results_dir is relative
    cfg = tcfg.flagship_config()
    jcfg = jax_config(cfg)
    jgd = factory.build_gd(jcfg)
    params = factory.load_params(jcfg, jgd, milestone="best10000", verbose=False,
                                 strict=True)
    leaves = jax.tree_util.tree_leaves(params)
    tgd = GaussianDiffusion(cfg.model, cfg.diffusion, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tgd.model)
    assert len(sd) == len(leaves) == len(tgd.model.state_dict())
    tgd.model.load_state_dict(sd)

    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(np.float32)
    cond = images(1, 2, 28)
    t = np.array([3, 41], np.int32)
    want = np.asarray(jgd.model.apply(params, jnp.asarray(x), jnp.asarray(cond),
                                      jnp.asarray(t)))
    got = tgd.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                          torch.as_tensor(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 0.1  # a trained model, not a zero output
