"""Stage B as compiled programs (`diffusion.compiled`), on the CPU.

The CPU has no CUDA graphs, so these tests drive the compiled runner,
`GraphSteps`, with the capture left out: every step goes through the
program's static buffers (the chain's tensors copied in once a chain, the
step's state and noise and the device timestep once a step) and runs the
body of the program's first chain.  On a narrow UNet (dim 8, mults 1/2,
8px, T=8, DDIM-4, batch 2):

  * every sampler's chain through `GraphSteps`, two chains on one program,
    equals the eager chain bit for bit, with `ArrayNoise` from numpy and
    with an int seed: plain and branched DDPM, a gated DDPM chain, plain
    and branched DDIM (the fusion mid-chain and on the terminal pair);
  * the plain DDPM and DDIM chains through `GraphSteps` against the JAX
    samplers with the JAX key stream replayed, at test_torch_sampler's and
    test_torch_stem_ddim's 1e-4;
  * the weights' fingerprint moves when a parameter is rebound, not on an
    in-place `copy_`, and `Programs` drops its programs when it moves;
  * the kv kernel's row-counter buffer outlives a larger batch;
  * a capture's launches are recorded, not counted, and a replay counts
    them;
  * `translate` on the CPU runs the eager samplers.

The card's half (a captured chain against the eager one bit for bit, a
recapture after a rebound parameter) is in test_torch_kernels_cuda.py.
"""

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import compiled as TC
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from test_torch_support import MMV, images, left_mask, make_pair, plain_noise

T, STEPS, S, B = 8, 4, 8, 2
TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(5)


def _model_cfg():
    return tcfg.ModelConfig(dim=8, dim_mults=(1, 2), full_attn=(False, True), channels=1,
                            resnet_block_groups=4, attn_heads=2, attn_dim_head=8)


@pytest.fixture(scope="module", params=["ddpm", "ddim"])
def pair(request):
    steps = STEPS if request.param == "ddim" else None
    return make_pair(_model_cfg(), tcfg.DiffusionConfig(image_size=S, timesteps=T,
                                                        sampling_timesteps=steps), seed=4,
                     numpy_init=True)


def _mask():
    mask = left_mask(B, S, 3)
    mask[1, :2] = 0.5  # soft values: IND after binarization
    return torch.as_tensor(mask)


def _gate(x_start, t):
    """A scripted verdict: rejects while the mean is low, by step parity."""
    return x_start.mean(dim=(1, 2, 3)) - 0.8 + 0.3 * (t % 2)


def _chains(tgd):
    """name → fn(noise, steps) running the chain (its output a tensor or a
    tuple of them).  The gated chain's retries draw from a second array
    stream when the noise is one, from the seed's retry stream when it is
    a seed."""
    cond = torch.as_tensor(images(1, B, S))
    mask = _mask()
    if tgd.is_ddim_sampling:
        return {
            "plain": lambda nz, st: TS.ddim_sample_plain(tgd, cond, MMV, noise=nz, steps=st),
            "branched": lambda nz, st: TS.ddim_sample_branched(
                tgd, cond, mask, tcfg.SamplerConfig(start_timestep=1), MMV, noise=nz,
                return_all=True, steps=st),
            "terminal_fusion": lambda nz, st: TS.ddim_sample_branched(
                tgd, cond, mask, tcfg.SamplerConfig(start_timestep=0, mask_x_policy="minval"),
                MMV, noise=nz, steps=st),
        }
    gated = tcfg.SamplerConfig(start_timestep=3, classifier=True, mask_x=False, ood_ad=False,
                               max_classifier_retries=2)
    return {
        "plain": lambda nz, st: TS.ddpm_sample_plain(tgd, cond, MMV, noise=nz, return_all=True,
                                                     steps=st),
        "branched": lambda nz, st: TS.ddpm_sample_branched(
            tgd, cond, mask, tcfg.SamplerConfig(start_timestep=3), MMV, noise=nz, steps=st),
        "gated": lambda nz, st: TS.ddpm_sample_branched(
            tgd, cond, mask, gated, MMV, noise=nz, classifier_fn=_gate,
            retry_noise=None if isinstance(nz, int) else TS.ArrayNoise(_stream(9), "cpu"),
            return_fusion_time=True, steps=st),
    }


def _stream(seed=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, S, 1)).astype(np.float32) for _ in range(T + 1)]


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("chain", ["plain", "branched", "gated_or_terminal"])
@pytest.mark.parametrize("noise", ["array", "seed"])
def test_graph_steps_equal_the_eager_chain(pair, chain, noise):
    _, _, tgd = pair
    chains = _chains(tgd)
    run = chains[chain] if chain in chains else chains[
        "terminal_fusion" if tgd.is_ddim_sampling else "gated"]

    def nz():
        return TS.ArrayNoise(_stream(), "cpu") if noise == "array" else 7

    want = _flat(run(nz(), None))
    program = TC.GraphSteps("cpu")
    assert not program.capture
    for _ in range(2):  # the second chain through the first one's buffers
        got = _flat(run(nz(), program))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert program.chain is not None and program.bodies
    assert program.summary()["graphs"] == 0


def test_graph_steps_hold_against_jax(pair):
    """The plain chain (its every step through the static buffers) against
    the JAX sampler; the branched chains are held against the eager ones
    above, and those against JAX in test_torch_sampler / _stem_ddim."""
    jgd, params, tgd = pair
    cond = images(2, B, S)
    n_draws = STEPS if tgd.is_ddim_sampling else T
    noise = TS.ArrayNoise(plain_noise(KEY, (B, S, S, 1), n_draws), "cpu")
    jax_fn, fn = ((JS.ddim_sample_plain, TS.ddim_sample_plain) if tgd.is_ddim_sampling
                  else (JS.ddpm_sample_plain, TS.ddpm_sample_plain))
    want = jax_fn(jgd, params, jnp.asarray(cond), KEY, MMV)
    got = fn(tgd, torch.as_tensor(cond), MMV, noise=noise, steps=TC.GraphSteps("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fingerprint_moves_on_a_rebound_parameter_only(pair):
    _, _, tgd = pair
    model = tgd.model
    programs = TC.Programs(model, "cpu")
    first = programs.get(("k",))
    assert programs.get(("k",)) is first
    before = TC.weights_fingerprint(model)
    w = model.init_conv.weight
    saved = w.detach().clone()
    with torch.no_grad():
        w.copy_(saved * 2.0)  # in place: a graph reads it where it is
    assert TC.weights_fingerprint(model) == before
    assert programs.get(("k",)) is first and programs.recaptures == 0
    model.init_conv.weight = torch.nn.Parameter(saved.clone())  # rebound
    assert TC.weights_fingerprint(model) != before
    assert programs.get(("k",)) is not first and programs.recaptures == 1
    model.init_conv.weight = w
    with torch.no_grad():
        w.copy_(saved)


def test_row_counters_outlive_a_larger_batch():
    dev = torch.device("cpu")
    small = LA._row_counters(dev, 8)
    ref = weakref.ref(small)
    n = small.numel()
    del small
    big = LA._row_counters(dev, 4 * n)
    assert big.numel() >= 4 * n
    assert ref() is not None and ref().numel() == n  # a graph's buffer stays alive
    assert LA._row_counters(dev, 8) is big


def test_a_capture_records_and_a_replay_counts():
    def fn():
        return None

    fn.launches = 0
    with _build.recording_launches() as rec:
        _build.count_launch(fn)
        _build.count_launch(fn)
    assert fn.launches == 0 and rec == {fn: 2}
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert fn.launches == 4
    _build.count_launch(fn)
    assert fn.launches == 5


def test_translate_runs_the_eager_samplers_on_the_cpu(pair, monkeypatch):
    _, _, tgd = pair
    cfg = tcfg.Config(model=_model_cfg(), diffusion=tgd.diff_cfg,
                      sampler=tcfg.SamplerConfig(start_timestep=1, ood_ad=False),
                      ood=dataclasses.replace(tcfg.OODConfig(), detector="manual"))
    pipe = LocalDiffusionPipeline(cfg, tgd)
    assert not pipe.compiles
    lr = images(3, B, S)
    eager = (TS.ddim_sample_plain if tgd.is_ddim_sampling else TS.ddpm_sample_plain)(
        tgd, torch.as_tensor(lr), pipe.min_max_val, noise=3)
    seen = []
    for name in ("ddim_sample_plain", "ddim_sample_branched", "ddpm_sample_plain",
                 "ddpm_sample_branched"):
        fn = getattr(TS, name)
        monkeypatch.setattr(TS, name, lambda *a, _fn=fn, **kw: seen.append(kw["steps"])
                            or _fn(*a, **kw))
    plain = pipe.translate(lr, noise=3)
    branched = pipe.translate(lr, noise=3, mask=_mask().numpy())
    assert seen == [None, None]
    assert not bool(plain["branched"]) and bool(branched["branched"])
    assert pipe.programs.summary()["programs"] == {}
    np.testing.assert_array_equal(plain["pred"], eager.numpy())
