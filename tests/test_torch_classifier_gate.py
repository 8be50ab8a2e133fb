"""Port parity for the classifier gate of the gated 256px configuration:
the ROC threshold, the PatchCore classifier, the gated phase B of the
branched DDPM sampler, `build_classifier_gate`, and the classifier's bank
and calibration pairs (the gated chain through the UNet, `translate` and
the server are in test_torch_gated_chain.py).

  * `mri256_gated_config()` is `configs/mri_synthetic_256_gated.yaml`
    field by field, but for its bf16 compute (the file leaves float32);
  * `roc_optimal_threshold` equals scikit-learn's `roc_curve` path
    (pos_label=2, first argmax of TPR − FPR), exactly, on random and tied
    scores, where the best threshold comes first and where none separates;
  * `preprocess_for_patchcore` against JAX (mnist halving, MRI denorm with
    and without translate_zero): 1e-5;
  * `ClassifierPatchCore` over a narrow 4-stage denoiser's taps (dim 8,
    64px, f32, one bank given to both): scores, `__call__` and the gates of
    both polarities within 1e-4 abs+rel, predictions equal;
  * `build_classifier_gate`'s sources (the classifier's own bank, the front
    end's PatchCore, and the WRN last resort, which raises without a bank
    or pairs to build one) and its ROC calibration against JAX's: the same
    threshold within 1e-4;
  * `build_classifier_bank` and `classifier_calibration_pairs` against
    `scripts/eval_gated_quality.py`'s construction on 2 images, and the
    bank CLI's `--classifier` switch;
  * the gated `ddpm_sample_branched` with scripted per-sample verdicts and
    a smooth stand-in for the model, the same in both packages (8px, T=8,
    fused at 5, the JAX key stream replayed: the plain steps' pk draws
    through the main noise source, the retries' rk draws through
    `retry_noise`): final images and every `return_all` frame at 1e-4
    abs+rel, `fusion_time` equal, for budgets 0, 2 and 3, with mask_x
    forced by the retry, and at t_fuse == 0;
  * always accept is bit-equal to the ungated chain, the main stream keeps
    its T + 1 draws whatever the gate does, a gate without the flag and a
    DDIM configuration with both run ungated.

Every gate decision compared with JAX is held away from its threshold: no
compared gate value lies within 1e-3 of 0.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import metrics

import localdiffusion_tpu.config as jcfg
import localdiffusion_tpu.ood.features as jfeatures
from localdiffusion_tpu.diffusion import sampler as JS
from localdiffusion_tpu.diffusion.gaussian import GaussianDiffusion as JaxGD
from localdiffusion_tpu.factory import build_classifier_gate as j_build_gate
from localdiffusion_tpu.ood.classifier import ClassifierPatchCore as JClassifier
from localdiffusion_tpu.ood.classifier import preprocess_for_patchcore as j_prep
from localdiffusion_tpu.ood.features import DenoiserFeatureSource as JSource
from localdiffusion_tpu.ood.patchcore import PatchCore as JPatchCore
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.diffusion import sampler as TS
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.factory import build_classifier_gate, classifier_bank_beside
from localdiffusion_tpu_torch.ood import bank as tbank
from localdiffusion_tpu_torch.ood import features as TF
from localdiffusion_tpu_torch.ood.classifier import (
    ClassifierPatchCore,
    balanced_accuracy,
    preprocess_for_patchcore,
    roc_optimal_threshold,
)
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline
from test_torch_support import (
    MMV, branched_noise, flair_targets, images, jax_config, left_mask, narrow_gated,
    retry_noise, small_model_cfg, to_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs/mri_synthetic_256_gated.yaml")
NPZ = os.path.join(ROOT, "results/mri_synth256_ema.npz")
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3  # no compared gate value lies this close to 0


def test_mri256_gated_config_is_the_yaml():
    got = tcfg.mri256_gated_config()
    want = jcfg.Config.load_yaml(YAML)
    for section in ("model", "diffusion", "sampler", "ood", "data", "train"):
        for f in dataclasses.fields(getattr(got, section)):
            g, w = getattr(getattr(got, section), f.name), getattr(getattr(want, section), f.name)
            if (section, f.name) == ("train", "compute_dtype"):
                assert (g, w) == ("bfloat16", "float32")
                continue
            assert g == w, (section, f.name)
    assert got.sampler.classifier and got.ood.classifier_threshold is None
    assert tcfg.min_max_val_for(got) == tcfg.min_max_val_for(tcfg.mri256_config())


# ---------------------------------------------------------------------------
# the ROC threshold
# ---------------------------------------------------------------------------

ROC_CASES = ["random", "ties", "ties_thirds", "best_first", "none_separates", "all_tied"]


def _roc_case(name):
    rng = np.random.default_rng(ROC_CASES.index(name))
    if name == "random":
        return rng.integers(1, 3, 64), rng.standard_normal(64).astype(np.float32)
    if name == "ties":
        return rng.integers(1, 3, 48), rng.integers(0, 5, 48).astype(np.float32)
    if name == "ties_thirds":  # equal steps along the curve, sums not exact in binary
        return rng.integers(1, 3, 30), (rng.integers(0, 7, 30) / 3).astype(np.float32)
    if name == "best_first":  # only the top score is anomalous: its own score wins
        return np.array([1, 1, 2, 1, 1]), np.array([0.1, 0.3, 0.9, 0.2, 0.5], np.float32)
    if name == "none_separates":  # anomalous scores lowest: the (0, 0) point, +inf
        return np.array([2, 2, 1, 1]), np.array([0.1, 0.2, 0.8, 0.9], np.float32)
    if name == "all_tied":
        return np.array([1, 2, 1, 2]), np.full(4, 0.5, np.float32)
    raise ValueError(name)


@pytest.mark.parametrize("name", ROC_CASES)
def test_roc_threshold_is_sklearns(name):
    labels, scores = _roc_case(name)
    fpr, tpr, thresholds = metrics.roc_curve(labels, scores, pos_label=2)
    want = float(thresholds[int(np.argmax(tpr - fpr))])
    got = roc_optimal_threshold(labels, scores)
    assert got == want
    if name == "best_first":
        assert got == float(np.float32(0.9))
    if name in ("none_separates", "all_tied"):
        assert got == np.inf


def test_roc_threshold_many_random_cases_and_one_class():
    rng = np.random.default_rng(5)
    for _ in range(300):
        n = int(rng.integers(2, 30))
        labels = np.r_[1, 2, rng.integers(1, 3, n)]
        scores = (rng.integers(0, 6, n + 2) / 7).astype(np.float32)
        fpr, tpr, thresholds = metrics.roc_curve(labels, scores, pos_label=2)
        assert roc_optimal_threshold(labels, scores) == float(thresholds[int(np.argmax(tpr - fpr))])
    with pytest.raises(ValueError, match="both classes"):
        roc_optimal_threshold(np.array([1, 1]), np.array([0.1, 0.2]))
    labels, scores = np.array([1, 1, 2, 2]), np.array([0.1, 0.4, 0.35, 0.8])
    assert balanced_accuracy(labels, scores, 0.4) == 0.5 * (1.0 + 0.5)


@pytest.mark.parametrize("denorm", [None, (250.0, 280.0, True), (250.0, 280.0, False)])
def test_preprocess_for_patchcore_matches_jax(denorm):
    x = np.random.default_rng(1).uniform(0, 2, (2, 28, 28, 1)).astype(np.float32)
    want = np.asarray(j_prep(jnp.asarray(x), 84, denorm))
    got = preprocess_for_patchcore(torch.as_tensor(x), 84, denorm).numpy()
    assert got.shape == want.shape == (2, 84, 84, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the narrow 4-stage configuration: classifier, gate factory, pipeline
# ---------------------------------------------------------------------------

S = 64
_flair = flair_targets


@pytest.fixture(scope="module")
def narrow():
    return narrow_gated(S)


def test_classifier_matches_jax(narrow):
    n = narrow
    pairs = tbank.classifier_calibration_pairs(n["cfg"], n=3)
    x = np.concatenate([img for img, _ in pairs])
    jcls, tcls = JClassifier(n["jpc"]), ClassifierPatchCore(n["tpc"])
    want = np.asarray(jcls.score_raw(jnp.asarray(x)))
    got = tcls.score_raw(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # a threshold between the scores, none within MARGIN of it
    thr = float(np.median(want)) + 1e-2
    assert np.min(np.abs(want - thr)) > MARGIN
    jcls.threshold = tcls.threshold = thr
    jp, ja, js = jcls(jnp.asarray(x))
    tp, ta, ts = tcls(torch.as_tensor(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < int(tp.sum()) < len(x) and tp.dtype == torch.int32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert ta.shape == (len(x), S, S, 1)
    for polarity in ("preserve", "suppress"):
        jgate = jax.jit(jcls.as_sampler_gate(polarity))
        tgate = tcls.as_sampler_gate(polarity)
        gw = np.asarray(jgate(jnp.asarray(x)))
        gg = tgate(torch.as_tensor(x), 4)
        assert gg.dtype == torch.float32 and gg.shape == (len(x),)
        np.testing.assert_allclose(gg.numpy(), gw, **TOL)
        np.testing.assert_array_equal(gg.numpy() > 0, gw > 0)
    with pytest.raises(ValueError, match="polarity"):
        tcls.as_sampler_gate("invert")


@pytest.fixture
def jax_source(narrow, monkeypatch):
    """The JAX factory builds its denoiser source from `feature_npz`,
    through flax's init (a minute on the CPU); hand it the shared one."""
    n = narrow
    monkeypatch.setattr(jfeatures, "make_feature_source",
                        lambda cfg, **kw: JSource(n["jgd"], n["params"], t=5))


def test_build_classifier_gate_sources_and_roc_match_jax(narrow, jax_source, tmp_path):
    n = narrow
    det_bank = str(tmp_path / "memory_bank_mri256_denoiser.npy")  # the detector's: absent
    obj = classifier_bank_beside(det_bank, n["cfg"])
    assert obj == str(tmp_path / "memory_bank_synthetic_brain_flair_denoiser.npy")
    np.save(obj, n["bank"])
    cfg = n["cfg"].replace(ood=dataclasses.replace(n["cfg"].ood, memory_bank_path=det_bank))
    jc = jax_config(cfg)
    pairs = tbank.classifier_calibration_pairs(cfg, n=4)

    # (1) the classifier's own bank, ROC-calibrated
    gate = build_classifier_gate(cfg, calibration_pairs=pairs, gd=n["tgd"], device="cpu",
                                 verbose=False)
    jgate = j_build_gate(jc, None, calibration_pairs=pairs, verbose=False)
    jthr = JClassifier(n["jpc"]).calibrate(pairs)  # the same bank and source
    assert gate.polarity == "suppress" and gate.classifier.patchcore.source.gd is n["tgd"]
    np.testing.assert_allclose(gate.threshold, jthr, rtol=1e-4)
    labels, scores = gate.classifier.calibration
    assert labels.tolist() == [1] * 4 + [2] * 4
    x = _flair(cfg, 4, 30, tumor=True)[0]  # not the calibration images
    want = np.asarray(jax.jit(jgate)(jnp.asarray(x)))
    got = gate(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.min(np.abs(want)) > MARGIN
    np.testing.assert_array_equal(got > 0, want > 0)

    # a set threshold is taken as it is
    fixed = cfg.replace(ood=dataclasses.replace(cfg.ood, classifier_threshold=2.5))
    assert build_classifier_gate(fixed, gd=n["tgd"], device="cpu", verbose=False).threshold == 2.5
    with pytest.raises(ValueError, match="calibration_pairs"):
        build_classifier_gate(cfg, gd=n["tgd"], device="cpu", verbose=False)

    # (2) no bank of its own: the front end's PatchCore
    os.remove(obj)
    fe = OODFrontend(cfg, patchcore=n["tpc"])
    gate = build_classifier_gate(fixed, frontend=fe, verbose=False)
    assert gate.classifier.patchcore is n["tpc"]

    # (3) neither: the JAX package's WRN50-2 last resort (held against the
    # JAX factory's in test_torch_wrn.py).  No fallback: with no bank and
    # no calibration pairs to build one from, it raises; with pairs it
    # builds its seeded WRN PatchCore on their images
    with pytest.raises(ValueError, match="no memory bank and no calibration_pairs"):
        build_classifier_gate(fixed, device="cpu", verbose=False)
    gate = build_classifier_gate(fixed, calibration_pairs=pairs, device="cpu", verbose=False)
    pc = gate.classifier.patchcore
    assert isinstance(pc.source, TF.WRNFeatureSource) and pc.layers == ("layer2", "layer3")
    assert pc.memory_bank.shape == (51, 1536) and gate.threshold == 2.5
    assert build_classifier_gate(tcfg.mri256_config(), verbose=False) is None


def test_classifier_bank_and_pairs_match_the_eval_script(narrow, tmp_path):
    """`build_classifier_bank` on 2 images, and the pairs of both
    polarities, against scripts/eval_gated_quality.py's construction."""
    n = narrow
    cfg = n["cfg"]
    out = str(tmp_path / "bank.npy")
    res = tbank.build_classifier_bank(cfg, out, gd=n["tgd"], n_images=2, device="cpu")
    hr_n = _flair(cfg, 2, 11)[0]
    jpc = JPatchCore(n["jc"].ood, source=JSource(n["jgd"], n["params"], t=5))
    want = jpc.build_memory_bank([hr_n[i:i + 4] for i in range(0, 2, 4)], sampling_ratio=0.05)
    assert res["patches"] == 2 * 16 * 16 and want.shape == (25, 48)
    np.testing.assert_allclose(np.load(out), want, rtol=1e-4, atol=1e-4)

    calib, amp = 2, 2.0
    for polarity in ("suppress", "preserve"):
        pcfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler,
                                                       classifier_polarity=polarity))
        got = tbank.classifier_calibration_pairs(pcfg, n=calib, lesion_amp=amp)
        # the script's lines, on the JAX package's data
        hr_cn = _flair(cfg, calib, 21)[0]
        if polarity == "preserve":
            hr_ct = _flair(cfg, calib, 22, tumor=True)[0]
        else:
            hr_ct = _flair(cfg, calib, 22)[0]
            rng = np.random.default_rng(23)
            yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
            tr = S / 10
            for i in range(calib):
                ty = int(rng.integers(S // 4, 3 * S // 4))
                tx = int(rng.integers(S // 4, 3 * S // 4))
                lesion = np.exp(-((yy - ty) ** 2 + (xx - tx) ** 2) / (2 * tr**2))
                hr_ct[i, :, :, 0] += amp * lesion
        want = [(hr_cn[i:i + 1], 0) for i in range(calib)] + \
               [(hr_ct[i:i + 1], 1) for i in range(calib)]
        assert [label for _, label in got] == [label for _, label in want]
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_array_equal(g, w)




# ---------------------------------------------------------------------------
# the gated sampler with scripted verdicts (narrow 2-stage UNet, 8px)
# ---------------------------------------------------------------------------

SS, ST, SB, SF = 8, 8, 2, 5  # size, T, batch, fusion step
KEY = jax.random.PRNGKey(6)


@pytest.fixture(scope="module")
def small():
    """(JAX engine, its params, port engine) whose model is the same smooth
    function of the sample, the condition features (the condition itself)
    and t in both packages, so the sampler's own arithmetic is compared: a
    swapped branch half, a stale noise draw or a wrong selection moves the
    image by O(1)."""
    dcfg = tcfg.DiffusionConfig(image_size=SS, timesteps=ST)
    jgd = JaxGD(to_jax(small_model_cfg()), to_jax(dcfg))
    jgd.encode_cond = lambda params, cond: cond
    jgd.apply_model = lambda params, x, cond, t, cond_feat=None: (
        jnp.tanh(0.6 * x + 0.4 * cond_feat) + 0.05 * t[:, None, None, None] / ST)
    tgd = build_gd(tcfg.Config(model=small_model_cfg(), diffusion=dcfg), device="cpu")
    tgd.encode_cond = lambda cond: cond
    tgd.apply_model = lambda x, cond, t, cond_feat=None: (
        torch.tanh(0.6 * x + 0.4 * cond_feat) + 0.05 * t[:, None, None, None].float() / ST)
    return jgd, {}, tgd


@pytest.fixture(scope="module")
def jax_scripted(small):
    """The JAX gated chain with a scripted gate, jitted once per sampler
    configuration, the verdict table [T, B] traced: run(scfg, cond, mask,
    table, **kw) → the sampler's outputs."""
    jgd, params, _ = small
    compiled = {}

    def run(scfg, cond, mask, table, **kw):
        key = (dataclasses.astuple(scfg), tuple(sorted(kw.items())))
        if key not in compiled:
            jscfg = to_jax(scfg)

            def chain(cond, mask, table):
                gate = lambda xs, t: jnp.where(table[t], -1.0, 1.0)
                return JS.ddpm_sample_branched(jgd, params, cond, mask, KEY, jscfg, MMV,
                                               classifier_fn=gate, **kw)
            compiled[key] = jax.jit(chain)
        return compiled[key](jnp.asarray(cond), jnp.asarray(mask), jnp.asarray(table))

    return run


def _table(rejects):
    """The verdicts [T, B]: True where sample b is rejected at step t."""
    table = np.zeros((ST, SB), bool)
    for b, ts in enumerate(rejects):
        table[list(ts), b] = True
    return table


def _scripted_port(table):
    return lambda xs, t: torch.where(torch.as_tensor(table[t]), -1.0, 1.0)


def _expected_fusion_time(rejects, budget, s=SF):
    out = []
    for ts in rejects:
        n = 0
        for t in range(s - 1, -1, -1):
            if t not in ts or t == 0 or (budget > 0 and n >= budget):
                out.append(t)
                break
            n += 1
    return out


@pytest.mark.parametrize("rejects,budget,variant", [
    (({4, 3}, set()), 0, {}),
    (({4, 3, 2, 1}, {4}), 0, {}),  # accepted only by t == 0
    (({4, 3, 2, 1}, {4, 3, 2, 1}), 2, {}),
    (({4, 3, 2, 1}, {4, 3, 2, 1}), 3, {}),  # always reject: fusion_time 1
    (({3}, {4, 2}), 3, dict(mask_x_policy="minval", cond_in_floor=0.95)),
    # mask_x off: only the retry applies it (force_mask_x)
    (({4}, {4, 3}), 0, dict(mask_x=False, ood_ad=False, mask_x_policy="minval")),
])
def test_gated_sampler_matches_jax(small, jax_scripted, rejects, budget, variant):
    _, _, tgd = small
    scfg = tcfg.SamplerConfig(start_timestep=SF, classifier=True,
                              max_classifier_retries=budget, **variant)
    cond = images(3, SB, SS)
    mask = left_mask(SB, SS, 3)
    table = _table(rejects)
    tgate = _scripted_port(table)
    want, want_frames, want_ft = jax_scripted(scfg, cond, mask, table, return_all=True,
                                              return_fusion_time=True)
    ft = _expected_fusion_time(rejects, budget)
    np.testing.assert_array_equal(np.asarray(want_ft), ft)
    shape = (SB, SS, SS, 1)
    retries = retry_noise(KEY, shape, ST, SF, SF - min(ft))
    got, got_frames, got_ft = TS.ddpm_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg, MMV,
        noise=TS.ArrayNoise(branched_noise(KEY, shape, ST, SF), "cpu"),
        retry_noise=TS.ArrayNoise(retries, "cpu"), classifier_fn=tgate,
        return_all=True, return_fusion_time=True)
    assert got_ft.dtype == torch.int32 and got_ft.tolist() == ft
    assert got_frames.shape == want_frames.shape == (ST + 1, 2, SB, SS, SS, 1)
    np.testing.assert_allclose(got_frames.numpy(), np.asarray(want_frames), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gate_without_a_fusion_step_and_without_intermediate(small, jax_scripted):
    """t_fuse == 0: no phase B, fusion_time stays T; start_intermediate off
    returns the branch pair alone, as JAX does."""
    _, _, tgd = small
    cond, mask = images(4, SB, SS), left_mask(SB, SS, 4)
    table = _table(({1}, {1}))
    tgate = _scripted_port(table)
    shape = (SB, SS, SS, 1)
    scfg = tcfg.SamplerConfig(start_timestep=0, classifier=True)
    want, want_ft = jax_scripted(scfg, cond, mask, table, return_fusion_time=True)
    got, got_ft = TS.ddpm_sample_branched(
        tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg, MMV,
        noise=TS.ArrayNoise(branched_noise(KEY, shape, ST, 0), "cpu"), classifier_fn=tgate,
        return_fusion_time=True)
    assert got_ft.tolist() == np.asarray(want_ft).tolist() == [ST, ST]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    scfg = tcfg.SamplerConfig(start_intermediate=False, classifier=True)
    got = TS.ddpm_sample_branched(tgd, torch.as_tensor(cond), torch.as_tensor(mask), scfg,
                                  MMV, noise=2, classifier_fn=tgate, return_fusion_time=True)
    assert got.shape == (2, SB, SS, SS, 1)


def test_gated_always_accept_matches_ungated(small):
    """The port's copy of tests/test_sampler.py's bit-equality test: a gate
    that always accepts latches at the first post-fusion step, and the chain
    equals the ungated one bit for bit (the retry drew from its own
    stream), with an int seed and with the JAX stream replayed."""
    _, _, tgd = small
    cond = torch.as_tensor(images(5, SB, SS))
    mask = torch.as_tensor(left_mask(SB, SS, 3))
    calls = []
    accept = lambda xs, t: calls.append(t) or torch.ones(xs.shape[0])
    gated_cfg = tcfg.SamplerConfig(start_timestep=4, classifier=True)
    ungated_cfg = tcfg.SamplerConfig(start_timestep=4)
    shape = (SB, SS, SS, 1)
    for noise in (7, None):
        main = lambda: (noise if noise is not None else
                        TS.ArrayNoise(branched_noise(KEY, shape, ST, 4), "cpu"))
        retry = None if noise is not None else TS.ArrayNoise(
            retry_noise(KEY, shape, ST, 4, 1), "cpu")
        g, ft = TS.ddpm_sample_branched(tgd, cond, mask, gated_cfg, MMV, noise=main(),
                                        retry_noise=retry, classifier_fn=accept,
                                        return_fusion_time=True)
        u = TS.ddpm_sample_branched(tgd, cond, mask, ungated_cfg, MMV, noise=main())
        np.testing.assert_array_equal(g.numpy(), u.numpy())
        assert ft.tolist() == [3, 3]
    assert calls == [3, 3]  # the gate ran at the first post-fusion step only


def test_retry_noise_is_a_stream_of_its_own(small):
    """Always rejecting (budget 3, fused at 5): the main stream still gives
    its T + 1 draws, the retry stream one draw a gated step (t = 4, 3, 2,
    1); a given main source with no retry source raises at the first retry;
    an int seed derives the retries' generator from it."""
    _, _, tgd = small
    cond = torch.as_tensor(images(6, SB, SS))
    mask = torch.as_tensor(left_mask(SB, SS, 3))
    scfg = tcfg.SamplerConfig(start_timestep=SF, classifier=True, max_classifier_retries=3)
    reject = lambda xs, t: -torch.ones(xs.shape[0])
    main, retry = [], []

    def counting(log):
        gen = TS.GeneratorNoise(0, "cpu")
        return lambda shape: log.append(shape) or gen(shape)

    _, ft = TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=counting(main),
                                    retry_noise=counting(retry), classifier_fn=reject,
                                    return_fusion_time=True)
    assert len(main) == ST + 1 and len(retry) == 4 and ft.tolist() == [1, 1]
    with pytest.raises(RuntimeError, match="retry"):
        TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=TS.GeneratorNoise(0, "cpu"),
                                classifier_fn=reject)
    a = TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=5, classifier_fn=reject)
    b = TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=TS.GeneratorNoise(5, "cpu"),
                                retry_noise=TS.GeneratorNoise(TS.retry_seed(5), "cpu"),
                                classifier_fn=reject)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gated_ddim_configuration_runs_ungated():
    """A DDIM configuration with the flag and a gate samples ungated, as the
    JAX pipeline does, and sets no fusion_time; the DDPM one is gated."""
    dcfg = tcfg.DiffusionConfig(image_size=SS, timesteps=ST, sampling_timesteps=4)
    cfg = tcfg.Config(model=small_model_cfg(), diffusion=dcfg,
                      sampler=tcfg.SamplerConfig(start_timestep=1, classifier=True),
                      ood=tcfg.OODConfig(detector="none"))
    cond, mask = images(8, SB, SS), left_mask(SB, SS, 3)
    calls = []
    reject = lambda xs, t: calls.append(t) or -torch.ones(xs.shape[0])
    for ddim in (True, False):
        c = cfg if ddim else cfg.replace(diffusion=dataclasses.replace(
            dcfg, sampling_timesteps=None))
        tgd = build_gd(c, device="cpu")
        gated = LocalDiffusionPipeline(c, tgd, classifier_gate=reject).translate(
            cond, noise=3, mask=mask)
        plain = LocalDiffusionPipeline(c, tgd).translate(cond, noise=3, mask=mask)
        assert bool(gated["branched"]) and tgd.is_ddim_sampling == ddim
        if ddim:
            assert "fusion_time" not in gated and calls == []
            np.testing.assert_array_equal(gated["pred"], plain["pred"])
        else:
            assert gated["fusion_time"].tolist() == [0, 0] and calls == [0]


def test_gate_without_the_flag_runs_ungated(small):
    _, _, tgd = small
    cond = torch.as_tensor(images(7, SB, SS))
    mask = torch.as_tensor(left_mask(SB, SS, 3))
    reject = lambda xs, t: -torch.ones(xs.shape[0])
    scfg = tcfg.SamplerConfig(start_timestep=SF)
    g, ft = TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=3, classifier_fn=reject,
                                    return_fusion_time=True)
    u = TS.ddpm_sample_branched(tgd, cond, mask, scfg, MMV, noise=3)
    np.testing.assert_array_equal(g.numpy(), u.numpy())
    assert ft.tolist() == [ST, ST]


def test_bank_cli_builds_the_classifier_bank(tmp_path):
    """`python -m localdiffusion_tpu_torch.ood.bank --classifier` on 2
    FLAIR images at 256px with the shipped weights (CPU), calibrated on 2 +
    2 pairs: the bank lands where `build_classifier_gate` finds it."""
    out = str(tmp_path / "memory_bank.npy")
    proc = subprocess.run(
        [sys.executable, "-m", "localdiffusion_tpu_torch.ood.bank", "--classifier", "--out", out,
         "--n-images", "2", "--calib", "2", "--device", "cpu", "--feature-npz", NPZ],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert "ROC threshold" in proc.stdout and "balanced accuracy" in proc.stdout
    cfg = tcfg.mri256_gated_config()
    obj = classifier_bank_beside(out, cfg)
    assert np.load(obj).shape == (409, 192)  # 5% of 2 x 64 x 64 patches
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, memory_bank_path=out, feature_npz=NPZ,
                                              classifier_threshold=1.0))
    gate = build_classifier_gate(cfg, device="cpu", verbose=False)
    assert gate.classifier.patchcore.memory_bank.shape == (409, 192)
