"""Port parity for the classifier-gated 256px configuration's chain: the
gated phase B through the UNet, and `translate` / `InferenceServer` with
the gate (the gate's parts are in test_torch_classifier_gate.py).

  * the shipped `results/mri_synth256_ema.npz` (full width, f32) through
    one gated phase B at 64px (T=6, fused at 5, budget 3) with a real
    PatchCore gate of each polarity, against the JAX sampler jitted once
    with the gate's formula (`as_sampler_gate`'s, with the threshold and
    sign traced, so one compile serves both), the JAX key stream replayed
    (the retries' draws through `retry_noise`): `fusion_time` equal, the
    image within 1e-4 abs+rel;
  * `translate` without a mask on a narrow gated configuration (dim 8,
    64px, T=6, f32) against the JAX pipeline with its gate: the masks,
    `fusion_time` and the images (1e-4), and the stages the chain marks on
    a `clock`; the server over the gated pipeline against the JAX server
    over its own, each batch's noise a pair of sources replaying the JAX
    server's key (the plain steps' draws and the retries'): masks, images
    (1e-4) and routing, and no `fusion_time` in a served result, as the
    JAX server hands out; a noise source without the retries' stream fails
    the served batch.

Each threshold lies halfway between the two samples' scores at the first
gated step (which no threshold changes), so a sample is rejected there;
no compared gate value lies within 1e-3 of 0.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.ood.classifier import ClassifierPatchCore as JClassifier
from localdiffusion_tpu.ood.features import DenoiserFeatureSource as JSource
from localdiffusion_tpu.ood.frontend import OODFrontend as JFrontend
from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
from localdiffusion_tpu.ood.thresholds import fit_ladder as j_fit_ladder
from localdiffusion_tpu.ood.thresholds import save_ladder
from localdiffusion_tpu.pipeline import LocalDiffusionPipeline as JaxPipeline
from localdiffusion_tpu.serving import InferenceServer as JaxServer
from localdiffusion_tpu.utils.params_io import load_params_npz as jax_load_npz
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.factory import build_frontend
from localdiffusion_tpu_torch.ood.classifier import ClassifierPatchCore
from localdiffusion_tpu_torch.ood.features import DenoiserFeatureSource as TSource
from localdiffusion_tpu_torch.ood.patchcore import PatchCore as TPatchCore
from localdiffusion_tpu_torch.ood.patchcore import StageClock
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from localdiffusion_tpu_torch.serving import InferenceServer
from localdiffusion_tpu_torch.utils.params_io import load_params_npz
from test_torch_support import (
    branched_noise, flair_targets, jax_config, narrow_gated, recording, retry_noise,
    split_threshold,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results/mri_synth256_ema.npz")
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
S, T, SF = 64, 6, 5  # size, timesteps, fusion step: phase B at t = 4 .. 0


def _tumour_t1(cfg, n, seed):
    return flair_targets(cfg, n, seed, tumor=True)[1]


# ---------------------------------------------------------------------------
# the shipped 256px checkpoint through one gated phase B at 64px
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped():
    """Both packages on the shipped weights, the JAX chain jitted once, and
    the two samples' scores at the first gated step, read from the port's
    chain with a gate that accepts at once (the steps before it, the
    fusion and the plain step at t=4, do not depend on the gate)."""
    base = tcfg.mri256_gated_config()
    cfg = base.replace(
        diffusion=dataclasses.replace(base.diffusion, image_size=S, timesteps=T),
        ood=dataclasses.replace(base.ood, input_size=S, memory_bank_path=None),
        train=dataclasses.replace(base.train, compute_dtype="float32"))
    jc = jax_config(cfg)
    jgd = JaxGD(jc.model, jc.diffusion, dtype=jnp.float32)
    params = jax_load_npz(NPZ, jax.eval_shape(lambda: jgd.init_params(jax.random.PRNGKey(0))))
    tgd = build_gd(cfg, device="cpu")
    tgd.model.load_state_dict(load_params_npz(NPZ, tgd.model))
    jpc = JPatchCore(jc.ood, source=JSource(jgd, params, t=5))
    bank = jpc.build_memory_bank([flair_targets(cfg, 2, 11)[0]], sampling_ratio=0.05)
    mem = jnp.asarray(bank)
    lo_hi = tcfg.min_max_val_for(cfg)

    @jax.jit
    def chain(cond, mask, key, thr, sign):
        # as_sampler_gate's formula, the threshold and the sign traced
        gate = lambda xs, t: sign * (jpc._score(xs, mem)[1] - thr)
        return JS.ddpm_sample_branched(jgd, params, cond, mask, key, jc.sampler, lo_hi,
                                       classifier_fn=gate, return_fusion_time=True)

    lr = _tumour_t1(cfg, 2, 13)
    mask = np.zeros((2, S, S, 1), np.float32)
    mask[0, 18:42, 14:38] = 1.0
    mask[1, 30:50, 26:50] = 1.0
    key = jax.random.PRNGKey(8)
    cls = ClassifierPatchCore(TPatchCore(cfg.ood, source=TSource(tgd, t=5), memory_bank=bank))

    def port(polarity, gate, gated):
        scfg = dataclasses.replace(cfg.sampler, classifier_polarity=polarity)
        return TS.ddpm_sample_branched(
            tgd, torch.as_tensor(lr), torch.as_tensor(mask), scfg, lo_hi,
            noise=TS.ArrayNoise(branched_noise(key, lr.shape, T, SF), "cpu"),
            retry_noise=TS.ArrayNoise(retry_noise(key, lr.shape, T, SF, gated), "cpu"),
            classifier_fn=gate, return_fusion_time=True)

    seen = []
    cls.threshold = 0.0  # scores are distances: the preserve gate accepts
    port("preserve", recording(cls.as_sampler_gate("preserve"), seen), 1)
    cls.threshold = split_threshold(seen[0].numpy())
    return dict(chain=chain, port=port, cls=cls, lr=lr, mask=mask, key=key)


@pytest.mark.parametrize("polarity", ["preserve", "suppress"])
def test_shipped_checkpoint_gated_phase_b_matches_jax(shipped, polarity):
    sh = shipped
    sign = 1.0 if polarity == "preserve" else -1.0
    want, want_ft = sh["chain"](jnp.asarray(sh["lr"]), jnp.asarray(sh["mask"]), sh["key"],
                                jnp.float32(sh["cls"].threshold), jnp.float32(sign))
    want_ft = np.asarray(want_ft)
    seen = []
    got, got_ft = sh["port"](polarity, recording(sh["cls"].as_sampler_gate(polarity), seen),
                             SF - int(want_ft.min()))
    np.testing.assert_array_equal(got_ft.numpy(), want_ft)
    assert min(float(v.abs().min()) for v in seen) > MARGIN
    assert want_ft.tolist() != [SF - 1] * 2  # a sample was rejected at t=4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# translate and the server on a narrow gated configuration
# ---------------------------------------------------------------------------

SERVE_SEED = 4
PIPE_KEY = jax.random.fold_in(jax.random.PRNGKey(SERVE_SEED), 0)  # the JAX server's first batch


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    """The narrow gated configuration in both packages: the detector's bank
    (built by the port's `build_frontend` from 6 normal T1 images; JAX
    builds the same rows) and ladder, and the classifier's bank with a
    threshold between the two samples' first gated scores."""
    n = narrow_gated(S, T)
    cfg, tgd, jc = n["cfg"], n["tgd"], n["jc"]
    calib = flair_targets(cfg, 6, 42)[1]
    tfe, _ = build_frontend(cfg, gd=tgd, calibration_images=calib, device="cpu",
                            verbose=False)
    jpc_det = JPatchCore(jc.ood, source=JSource(n["jgd"], n["params"], t=5))
    jbank = jpc_det.build_memory_bank([calib])
    np.testing.assert_allclose(tfe.patchcore.memory_bank.numpy(), jbank, rtol=1e-4, atol=1e-4)
    path = str(tmp_path_factory.mktemp("gated") / "ladder.json")
    save_ladder(j_fit_ladder([np.asarray(jpc_det(jnp.asarray(calib))["anomaly_map"])]), path)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=path))
    jc = jc.replace(ood=dataclasses.replace(jc.ood, ladder_path=path))
    tfe.config = cfg

    lr = _tumour_t1(cfg, 2, 9)
    seen = []
    probe = ClassifierPatchCore(n["tpc"], threshold=0.0).as_sampler_gate("preserve")
    tpipe = LocalDiffusionPipeline(cfg, tgd, frontend=tfe, classifier_gate=recording(probe, seen))
    tpipe.translate(lr, noise=TS.ArrayNoise(branched_noise(PIPE_KEY, lr.shape, T, SF), "cpu"),
                    retry_noise=TS.ArrayNoise(retry_noise(PIPE_KEY, lr.shape, T, SF, 1), "cpu"))
    thr = split_threshold(seen[0].numpy())
    tgate = ClassifierPatchCore(n["tpc"], threshold=thr).as_sampler_gate("suppress")
    jgate = JClassifier(n["jpc"], threshold=thr).as_sampler_gate("suppress")
    seen = []
    tpipe = LocalDiffusionPipeline(cfg, tgd, frontend=tfe, classifier_gate=recording(tgate, seen))
    jpipe = JaxPipeline(jc, n["jgd"], n["params"], frontend=JFrontend(jc, patchcore=jpc_det),
                        classifier_gate=jgate)
    return dict(tpipe=tpipe, jpipe=jpipe, lr=lr, seen=seen)


def test_translate_with_the_gate_matches_jax(pipes):
    p = pipes
    want = p["jpipe"].translate(p["lr"], key=PIPE_KEY)
    ft = np.asarray(want["fusion_time"])
    gated = SF - int(ft.min())
    shape = p["lr"].shape
    p["seen"].clear()
    clock = StageClock("cpu")
    got = p["tpipe"].translate(
        p["lr"], noise=TS.ArrayNoise(branched_noise(PIPE_KEY, shape, T, SF), "cpu"),
        retry_noise=TS.ArrayNoise(retry_noise(PIPE_KEY, shape, T, SF, gated), "cpu"),
        clock=clock)
    assert set(clock.split()) == {"chain", "plain", "gate", "retry"}
    assert bool(got["branched"]) and bool(want["branched"])
    np.testing.assert_array_equal(got["mask"] == 1.0, np.asarray(want["mask"]) == 1.0)
    np.testing.assert_array_equal(got["fusion_time"], ft)
    assert got["fusion_time"].dtype == np.int32 and set(got) == set(want)
    assert len(p["seen"]) == gated and min(float(v.abs().min()) for v in p["seen"]) > MARGIN
    assert ft.tolist() != [SF - 1] * 2  # a sample was rejected at t=4
    np.testing.assert_allclose(got["pred"], np.asarray(want["pred"]), **TOL)


def test_server_over_the_gated_pipeline(pipes):
    """Two requests without masks fill a batch of 2 on the overlapped
    threads, its noise a pair of sources replaying the JAX server's key for
    batch 0: each result's mask, image and routing equal the JAX server's
    over its gated pipeline, a sample is rejected at the first gated step
    (the gate runs again), and no result carries `fusion_time`."""
    p = pipes
    shape = p["lr"].shape

    def noise(i):
        key = jax.random.fold_in(jax.random.PRNGKey(SERVE_SEED), i)
        return (TS.ArrayNoise(branched_noise(key, shape, T, SF), "cpu"),
                TS.ArrayNoise(retry_noise(key, shape, T, SF, SF), "cpu"))

    p["seen"].clear()
    srv = InferenceServer(p["tpipe"], batch_size=2, max_wait_ms=500, noise_for_batch=noise)
    futs = [srv.submit(x) for x in p["lr"]]
    with srv:
        outs = [f.result(timeout=300) for f in futs]
    assert srv.snapshot_stats()["batches"] == 1
    assert len(p["seen"]) > 1 and min(float(v.abs().min()) for v in p["seen"]) > MARGIN
    jsrv = JaxServer(p["jpipe"], batch_size=2, max_wait_ms=500, base_seed=SERVE_SEED)
    jfuts = [jsrv.submit(x) for x in p["lr"]]
    with jsrv:
        want = [f.result(timeout=300) for f in jfuts]
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o["mask"] == 1.0, np.asarray(w["mask"]) == 1.0)
        np.testing.assert_allclose(o["pred"], np.asarray(w["pred"]), **TOL)
        assert o["branched"] and w["branched"]
        assert "fusion_time" not in o and "fusion_time" not in w


def test_server_noise_source_without_retry_stream_fails_the_batch(pipes):
    """A noise source alone cannot draw the retries' noise: the served
    batch fails with the sampler's error, and the server keeps serving."""
    p = pipes
    shape = p["lr"].shape
    srv = InferenceServer(p["tpipe"], batch_size=2, max_wait_ms=500, noise_for_batch=lambda i: (
        TS.ArrayNoise(branched_noise(PIPE_KEY, shape, T, SF), "cpu")))
    with srv:
        futs = [srv.submit(x) for x in p["lr"]]
        for f in futs:
            with pytest.raises(RuntimeError, match="retry_noise"):
                f.result(timeout=300)
        again = srv.submit(p["lr"][0], mask=np.ones((S, S, 1), np.float32))
        assert again.result(timeout=300)["branched"] is False
