"""Port parity: the reference-checkpoint converter (`utils/reference_ckpt.py`)
and its CLI (`scripts.convert_reference_ckpt`).

The reference tree is absent here, so a reference-keyed state dict is built
from a known params tree by running the layout rules backwards
(`reference_state_dict`).  The JAX package's own `convert_unet_state_dict`
must give the tree back, with `conv_fusion.mlp` zeroed; the port's
converter must give the same tree bit for bit, and the port's UNet on it
must match the JAX UNet at 1e-5 (f32, a 3-stage MNIST layout with the
shallow condition encoder and a 4-stage MRI layout with the deep one, at a
narrow width).  The CLIs on a whole trainer checkpoint write the same npz
files, key for key and array for array, in float32 and float16.
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.utils import reference_ckpt as JR
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion as TorchGD
from localdiffusion_tpu_torch.scripts import convert_reference_ckpt as cli
from localdiffusion_tpu_torch.utils import reference_ckpt as TR
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from test_torch_support import numpy_params, to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts import convert_reference_ckpt as jax_cli  # noqa: E402

LAYOUTS = {
    # (the CLI's flags, the ModelConfig they describe)
    "mnist": (["--dim", "8", "--dim-mults", "1,2,4", "--full-attn", "0,0,1", "--mode", "mnist"],
              dict(dim=8, dim_mults=(1, 2, 4), full_attn=(False, False, True),
                   cond_encoder_depth="shallow")),
    "mri": (["--dim", "8", "--dim-mults", "1,2,4,8", "--mode", "mri"],
            dict(dim=8, dim_mults=(1, 2, 4, 8), full_attn=(False, False, False, True),
                 cond_encoder_depth="deep")),
}
SIZE = 16
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _engine(cfg):
    """The JAX engine of a layout and its params' shapes (traced once)."""
    jgd = JaxGD(to_jax(cfg), to_jax(tcfg.DiffusionConfig(image_size=SIZE, timesteps=10)))
    return jgd, jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0)))


def _tree(cfg, seed):
    jgd, template = _engine(cfg)
    return jgd, jax.tree_util.tree_map(np.asarray, numpy_params(template, seed))


def _flat(tree):
    return TR.flat_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_converter_and_unet_match_jax(layout):
    cfg = tcfg.ModelConfig(**LAYOUTS[layout][1])
    assert cli.model_config(cli.parse_args(["x.pt", "--out", "o"] + LAYOUTS[layout][0])) == cfg
    jgd, tree = _tree(cfg, seed=3)
    ref_sd = {k: torch.as_tensor(v) for k, v in TR.reference_state_dict(tree, cfg).items()}
    assert ref_sd["mid_attn.norm.g"].shape[0] == 1 and ref_sd["mid_attn.norm.g"].ndim == 4

    jax_tree = JR.convert_unet_state_dict(ref_sd, to_jax(cfg))
    port_tree = TR.convert_unet_state_dict(ref_sd, cfg)
    want = _flat(tree)
    for k, v in want.items():
        if k.startswith("params/conv_fusion/mlp/"):
            want[k] = np.zeros_like(v)  # the converter zeroes the fusion FiLM
    for got in (_flat(jax_tree), _flat(port_tree)):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    tgd = TorchGD(cfg, tcfg.DiffusionConfig(image_size=SIZE, timesteps=10), device="cpu")
    tgd.model.load_state_dict(params_from_jax(port_tree, tgd.model))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    cond = rng.uniform(0, 2, (2, SIZE, SIZE, 1)).astype(np.float32)
    t = np.asarray([0, 7], np.int32)
    want_out = jax.jit(jgd.apply_model)(jax.tree_util.tree_map(jnp.asarray, jax_tree),
                                        jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    got_out = tgd.apply_model(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(t).long())
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **TOL)


def _trainer_checkpoint(path, cfg, seed):
    _, tree = _tree(cfg, seed)
    _, ema = _tree(cfg, seed + 1)
    unet = TR.reference_state_dict(tree, cfg)
    data = {
        "step": 1234,
        "model": {"betas": torch.linspace(0, 1, 10),  # schedule buffers: skipped
                  **{f"model.{k}": torch.as_tensor(v) for k, v in unet.items()}},
        "ema": {"initted": torch.tensor(True), "step": torch.tensor(5),
                **{f"ema_model.model.{k}": torch.as_tensor(v)
                   for k, v in TR.reference_state_dict(ema, cfg).items()}},
        "opt": {"state": {}, "param_groups": []},
        "scaler": None,
    }
    torch.save(data, path)


@pytest.mark.parametrize("layout,f16", [("mnist", False), ("mri", True)])
def test_cli_npz_matches_the_jax_cli(tmp_path, monkeypatch, layout, f16):
    flags, kw = LAYOUTS[layout]
    cfg = tcfg.ModelConfig(**kw)
    ckpt = str(tmp_path / "model-10.pt")
    _trainer_checkpoint(ckpt, cfg, seed=5)
    extra = ["--f16"] if f16 else []
    got = cli.main([ckpt, "--out", str(tmp_path / "port")] + flags + extra)
    monkeypatch.setattr(sys, "argv", ["convert_reference_ckpt.py", ckpt, "--out",
                                      str(tmp_path / "jax")] + flags + extra)
    jax_cli.main()
    assert got["step"] == 1234 and got["ema"] is not None
    for which in ("params", "ema"):
        with np.load(tmp_path / f"port-{which}.npz") as a, \
                np.load(tmp_path / f"jax-{which}.npz") as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype == (np.float16 if f16 else np.float32)
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # what the CLI returns is the port's UNet state of the written params
    from localdiffusion_tpu_torch.factory import load_params

    cfg_full = tcfg.mri256_config()
    cfg_full = cfg_full.replace(model=cfg, diffusion=dataclasses.replace(
        cfg_full.diffusion, image_size=SIZE))
    gd = load_params(cfg_full, params_npz=str(tmp_path / "port-ema.npz"), device="cpu",
                     verbose=False)
    for k, v in got["ema"].items():
        np.testing.assert_array_equal(gd.model.state_dict()[k].numpy(),
                                      v.numpy().astype(np.float16 if f16 else np.float32), k)
