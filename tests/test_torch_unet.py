"""Port parity: the UNet and its condition encoder on the JAX package's
weights, carried across by `params_from_jax`.

Both run float32 on the CPU.  The tolerance (atol/rtol 1e-4) covers the two
libraries' different convolution summation orders through ~40 layers; a
mapping or layout error shows as O(1) differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.utils.params_io import save_params_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.utils.params_io import load_params_npz, params_from_jax
from test_torch_support import images, make_pair, small_model_cfg

TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {
    "narrow_8px": (small_model_cfg(), tcfg.DiffusionConfig(image_size=8, timesteps=10)),
    "flagship_28px": (tcfg.flagship_config().model, tcfg.flagship_config().diffusion),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    mcfg, dcfg = CASES[request.param]
    return make_pair(mcfg, dcfg, seed=1)


def test_unet_matches_jax(pair):
    jgd, params, tgd = pair
    s = jgd.image_size
    x = np.random.default_rng(2).standard_normal((2, s, s, 1)).astype(np.float32)
    cond = images(3, 2, s)
    t = np.array([0, 7], np.int32)
    want = np.asarray(jgd.model.apply(params, jnp.asarray(x), jnp.asarray(cond),
                                      jnp.asarray(t)))
    got = tgd.apply_model(torch.as_tensor(x), torch.as_tensor(cond),
                          torch.as_tensor(t).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    feat_j = jgd.encode_cond(params, jnp.asarray(cond))
    feat_t = tgd.encode_cond(torch.as_tensor(cond))
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), **TOL)
    # precomputed condition features give the same output
    again = tgd.apply_model(torch.as_tensor(x), None, torch.as_tensor(t).long(),
                            cond_feat=feat_t)
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


def test_every_leaf_is_consumed(pair):
    jgd, params, tgd = pair
    flat = {
        "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
        for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    sd = params_from_jax(flat, tgd.model)
    assert len(sd) == len(flat) == len(tgd.model.state_dict())
    extra = dict(flat, **{"params/stray/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        params_from_jax(extra, tgd.model)
    short = dict(flat)
    short.pop("params/init_conv/bias")
    with pytest.raises(KeyError, match="init_conv.bias"):
        params_from_jax(short, tgd.model)


def test_npz_snapshot_round_trip(tmp_path):
    """A slim fp16 npz written by the JAX package loads into the port, cast
    back to float32, equal to the fp16-rounded weights."""
    jgd, params, tgd = make_pair(*CASES["narrow_8px"], seed=4)
    path = str(tmp_path / "snap.npz")
    save_params_npz(path, params)
    sd = load_params_npz(path, tgd.model)
    rounded = params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float16), params),
        tgd.model,
    )
    for k, v in sd.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, rounded[k], rtol=0, atol=0)


def test_plain_groupnorm_switch_is_explicit():
    _, _, tgd = make_pair(*CASES["narrow_8px"], seed=5)
    from localdiffusion_tpu_torch.models.blocks import GroupNormFilmSiLU

    norms = [m for m in tgd.model.modules() if isinstance(m, GroupNormFilmSiLU)]
    assert norms and all(m.use_kernel for m in norms)
    tgd.model.use_plain_groupnorm()
    assert not any(m.use_kernel for m in norms)
    tgd.model.use_plain_groupnorm(False)
    assert all(m.use_kernel for m in norms)
