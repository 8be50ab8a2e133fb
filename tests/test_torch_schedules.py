"""Port parity: schedules and diffusion math against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.ops import diffusion_math as jdm
from localdiffusion_tpu.ops.schedules import make_schedule as jax_schedule
from localdiffusion_tpu_torch.ops import diffusion_math as tdm
from localdiffusion_tpu_torch.ops.schedules import make_schedule as torch_schedule

SCHEDULES = ["linear", "cosine", "sigmoid"]
OBJECTIVES = ["pred_noise", "pred_x0", "pred_v"]


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("beta_schedule", SCHEDULES)
def test_schedule_buffers_equal_jax(beta_schedule, objective):
    """Both packages compute in host float64 and store float32: equal bits."""
    j = jax_schedule(50, beta_schedule=beta_schedule, objective=objective)
    t = torch_schedule(50, beta_schedule=beta_schedule, objective=objective)
    for f in dataclasses.fields(t):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_diffusion_math_matches_jax(objective):
    """Elementwise f32 math on the same inputs; 1e-6 relative covers the
    two libraries' different fused multiply-adds."""
    rng = np.random.default_rng(0)
    shape = (3, 5, 5, 2)
    x0, xt, eps = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    tt = np.array([0, 17, 49], np.int32)
    js = jax_schedule(50, objective=objective)
    ts = torch_schedule(50, objective=objective)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    tl = torch.as_tensor(tt).long()
    pairs = [
        (jdm.q_sample(js, J(x0), J(tt), J(eps)), tdm.q_sample(ts, T(x0), tl, T(eps))),
        (jdm.predict_start_from_noise(js, J(xt), J(tt), J(eps)),
         tdm.predict_start_from_noise(ts, T(xt), tl, T(eps))),
        (jdm.predict_noise_from_start(js, J(xt), J(tt), J(x0)),
         tdm.predict_noise_from_start(ts, T(xt), tl, T(x0))),
        (jdm.predict_v(js, J(x0), J(tt), J(eps)), tdm.predict_v(ts, T(x0), tl, T(eps))),
        (jdm.predict_start_from_v(js, J(xt), J(tt), J(eps)),
         tdm.predict_start_from_v(ts, T(xt), tl, T(eps))),
        (jdm.model_output_to_x_start(js, J(eps), J(xt), J(tt)),
         tdm.model_output_to_x_start(ts, T(eps), T(xt), tl)),
        (jdm.normalize_to_neg_one_to_one(J(x0)), tdm.normalize_to_neg_one_to_one(T(x0))),
        (jdm.unnormalize_to_zero_to_one(J(x0)), tdm.unnormalize_to_zero_to_one(T(x0))),
    ]
    pairs += list(zip(jdm.q_posterior(js, J(x0), J(xt), J(tt)),
                      tdm.q_posterior(ts, T(x0), T(xt), tl)))
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)


def test_mri256_schedule_at_t250():
    """The 256px chain's schedule (sigmoid, pred_x0, T=250): equal buffers,
    and the posterior at its first, fusion and last steps within 1e-6."""
    j = jax_schedule(250, beta_schedule="sigmoid", objective="pred_x0")
    t = torch_schedule(250, beta_schedule="sigmoid", objective="pred_x0")
    for f in dataclasses.fields(t):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(b, torch.Tensor):
            assert b.shape[0] == 250
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f.name)
    rng = np.random.default_rng(1)
    x0, xt = (rng.standard_normal((3, 4, 4, 1)).astype(np.float32) for _ in range(2))
    tt = np.array([249, 2, 0], np.int32)
    want = jdm.q_posterior(j, jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(tt))
    got = tdm.q_posterior(t, torch.as_tensor(x0), torch.as_tensor(xt),
                          torch.as_tensor(tt).long())
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-6)
