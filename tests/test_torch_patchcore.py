"""Port parity for Stage A's building blocks, against the JAX package on the
same numpy-seeded inputs:

  * resize (bilinear up, down with the antialias, mixed; nearest), centre
    crop, gaussian blur, ImageNet normalization and the 3×3 average pool:
    within 1e-6 (float32 rounding of a different summation order; the blur
    sums its taps in the JAX order and is exact);
  * `nearest_neighbors` and `compute_anomaly_score` on the shipped banks
    (`results/memory_bank_synthetic_brain.npy`, 1,638 × 768, and
    `memory_bank_mnist.npy`, 5,644 × 768): scores within 1e-5 relative;
    locations equal except at near-ties, where both rows must be within
    1e-5 relative of the query's true (float64) nearest distance;
  * `kcenter_greedy_indices` given the JAX package's own projection matrix:
    the same indices, for d > 128 (projected) and d <= 128;
  * the `thresholds` copy bit-equal to the JAX module on seeded maps, and
    `load_ladder` of every shipped ladder;
  * the launch counters under the two serving threads: no count lost.
"""

import glob
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localdiffusion_tpu.ood import patchcore as JP
from localdiffusion_tpu.ood import thresholds as JT
from localdiffusion_tpu.ops import resize as JR
from localdiffusion_tpu_torch import config as tcfg
from localdiffusion_tpu_torch.ood import patchcore as TP
from localdiffusion_tpu_torch.ood import thresholds as TT
from localdiffusion_tpu_torch.ops import _build
from localdiffusion_tpu_torch.ops import linear_attention as LA
from localdiffusion_tpu_torch.ops import resize as TR
from localdiffusion_tpu_torch.serving import InferenceServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKS = ["results/memory_bank_synthetic_brain.npy", "results/memory_bank_mnist.npy"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,size", [
    ((2, 16, 16, 3), (64, 64)),    # up
    ((2, 64, 64, 1), (16, 16)),    # down: the antialiased path
    ((2, 256, 256, 1), (224, 224)),  # down by a non-integer factor
    ((2, 20, 30, 2), (13, 41)),    # one axis down, one up
    ((17, 9, 1), (40, 5)),         # HWC
])
def test_resize_matches_jax(shape, size):
    x = _rand(0, shape)
    for jf, tf in ((JR.resize_bilinear, TR.resize_bilinear),
                   (JR.resize_nearest, TR.resize_nearest)):
        np.testing.assert_allclose(tf(torch.as_tensor(x), size).numpy(),
                                   _np(jf(jnp.asarray(x), size)), **TOL, err_msg=jf.__name__)


@pytest.mark.parametrize("shape,size", [((2, 20, 30, 2), (16, 16)), ((2, 10, 12, 1), (16, 16)),
                                        ((13, 9, 1), (10, 12))])
def test_center_crop_matches_jax(shape, size):
    x = _rand(1, shape)
    np.testing.assert_array_equal(TR.center_crop(torch.as_tensor(x), size).numpy(),
                                  _np(JR.center_crop(jnp.asarray(x), size)))


@pytest.mark.parametrize("shape,sigma,ks", [((2, 64, 64, 1), 4.0, 33), ((2, 40, 30, 3), 1.5, None),
                                            ((64, 64, 1), 4.0, None)])
def test_blur_pool_normalize_match_jax(shape, sigma, ks):
    x = _rand(2, shape)
    np.testing.assert_allclose(TR.gaussian_blur(torch.as_tensor(x), sigma, ks).numpy(),
                               _np(JR.gaussian_blur(jnp.asarray(x), sigma, ks)), **TOL)
    if x.ndim == 4:
        np.testing.assert_allclose(TP.avg_pool_3x3(torch.as_tensor(x)).numpy(),
                                   _np(JP.avg_pool_3x3(jnp.asarray(x))), **TOL)
        rgb = np.random.default_rng(3).uniform(0, 1, (*shape[:3], 3)).astype(np.float32)
        np.testing.assert_allclose(TR.imagenet_normalize(torch.as_tensor(rgb)).numpy(),
                                   _np(JR.imagenet_normalize(jnp.asarray(rgb))), **TOL)


def test_anomaly_map_matches_jax():
    """Upsample 16→64 and the 33-tap blur, on scores of a distance's size."""
    s = np.abs(_rand(4, (2, 16, 16, 1))) * 3.0
    got = TP.anomaly_map_from_scores(torch.as_tensor(s), (64, 64)).numpy()
    want = _np(JP.anomaly_map_from_scores(jnp.asarray(s), (64, 64)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("bank_file", BANKS)
def test_nearest_neighbors_and_score_match_jax(bank_file):
    bank = np.load(os.path.join(ROOT, bank_file))
    rng = np.random.default_rng(5)
    b, p = 3, 96
    picks = rng.integers(0, bank.shape[0], b * p)
    q = (bank[picks] + rng.normal(0, 0.5 * bank.std(), (b * p, bank.shape[1]))).astype(np.float32)
    j_scores, j_loc = JP.nearest_neighbors(jnp.asarray(q), jnp.asarray(bank), 1)
    t_scores, t_loc = TP.nearest_neighbors(torch.as_tensor(q), torch.as_tensor(bank), 1)
    j_scores, j_loc, t_scores, t_loc = (_np(j_scores), _np(j_loc), t_scores.numpy(),
                                        t_loc.numpy())
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)
    for i in np.flatnonzero(t_loc != j_loc):  # near-ties only
        exact = np.sqrt(((q[i].astype(np.float64) - bank.astype(np.float64)) ** 2).sum(-1))
        for loc in (t_loc[i], j_loc[i]):
            assert abs(exact[loc] - exact.min()) <= 1e-5 * exact.min(), (i, loc)
    assert (t_loc == j_loc).mean() > 0.99
    # the image score, and the k > 1 search it makes
    j_pred = JP.compute_anomaly_score(jnp.asarray(j_scores.reshape(b, p)),
                                      jnp.asarray(j_loc.reshape(b, p)), jnp.asarray(q),
                                      jnp.asarray(bank), 9)
    t_pred = TP.compute_anomaly_score(torch.as_tensor(t_scores.reshape(b, p)),
                                      torch.as_tensor(t_loc.reshape(b, p)), torch.as_tensor(q),
                                      torch.as_tensor(bank), 9)
    np.testing.assert_allclose(t_pred.numpy(), _np(j_pred), rtol=1e-5)
    j9, jl9 = JP.nearest_neighbors(jnp.asarray(q[:8]), jnp.asarray(bank), 9)
    t9, tl9 = TP.nearest_neighbors(torch.as_tensor(q[:8]), torch.as_tensor(bank), 9)
    np.testing.assert_allclose(t9.numpy(), _np(j9), rtol=1e-5)
    assert (tl9.numpy() == _np(jl9)).mean() > 0.95


def test_nearest_neighbors_chunks_do_not_change_the_result(monkeypatch):
    bank = _rand(6, (300, 64))
    q = _rand(7, (50, 64))
    whole = TP.nearest_neighbors(torch.as_tensor(q), torch.as_tensor(bank), 1)
    monkeypatch.setattr(TP, "NN_CHUNK_ELEMENTS", 300 * 7)  # 7 queries a chunk
    chunked = TP.nearest_neighbors(torch.as_tensor(q), torch.as_tensor(bank), 1)
    for a, c in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("n,d,k", [(600, 192, 60), (500, 64, 50)])
def test_kcenter_matches_jax_given_its_projection(n, d, k):
    """d > 128 projects by the JAX package's own matrix (key 3); d <= 128
    runs on the features as they are."""
    emb = _rand(8, (n, d)) * 2.0 + 0.5
    key = jax.random.PRNGKey(3)
    want = _np(JP.kcenter_greedy_indices(jnp.asarray(emb), k, key))
    proj = None
    if d > 128:
        proj = np.array(jax.random.normal(key, (d, 128), dtype=jnp.float32)
                        / jnp.sqrt(jnp.asarray(128, jnp.float32)))
    got = TP.kcenter_greedy_indices(torch.as_tensor(emb), k, proj=proj).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k  # k distinct rows


def test_kcenter_default_projection_is_seeded():
    """The default projection is `random_projection`'s seed 0; another
    seed's matrix, passed as `proj`, picks other rows."""
    emb = torch.as_tensor(_rand(9, (400, 192)))
    a = TP.kcenter_greedy_indices(emb, 40)
    assert torch.equal(a, TP.kcenter_greedy_indices(emb, 40, proj=TP.random_projection(192)))
    other = TP.random_projection(192, seed=2)
    b = TP.kcenter_greedy_indices(emb, 40, proj=other)
    assert not torch.equal(a, b)
    assert torch.equal(TP.subsample_embedding(emb, 0.1, proj=other), emb[b])


def test_distance_product_refuses_tf32_on_the_card(monkeypatch):
    """TF32 on the card would break the float32 bar, so the check raises
    for a CUDA device and lets the CPU through; it writes no flag."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        TP.check_full_float32(torch.device("cuda"))
    TP.check_full_float32(torch.device("cpu"))
    q = torch.as_tensor(_rand(2, (5, 8)))
    dist, loc = TP.nearest_neighbors(q, q)
    assert torch.equal(loc, torch.arange(5)) and torch.all(torch.isfinite(dist))
    assert torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# the thresholds copy
# ---------------------------------------------------------------------------

def _maps(seed, b=4, s=48, blobs=True):
    """Blurred noise on a distance's scale, with a bright blob in the first
    b - 1 maps (the last is normal-looking) unless `blobs` is False."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:s, :s]
    m = np.abs(rng.normal(1.0, 0.2, (b, s, s, 1)))
    for i in range(b - 1 if blobs else 0):
        cy, cx = rng.integers(10, s - 10, 2)
        m[i, ..., 0] += 2.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 40.0)
    return _np(JR.gaussian_blur(jnp.asarray(m.astype(np.float32)), 1.5))


def _fitted(mod):
    return mod.fit_ladder([_maps(10, blobs=False), _maps(11, blobs=False)], pixel_q=0.99)


@pytest.mark.parametrize("case", ["soft_mask", "soft_mask_dilated", "refine_fwhm",
                                  "refine_ladder_min_area", "backoff", "fit_ladder",
                                  "hand_ladders"])
def test_thresholds_bit_equal_to_jax(case):
    amap = _maps(12)
    lad_j, lad_t = _fitted(JT), _fitted(TT)
    assert lad_t == TT.ThresholdLadder(lad_j.gate, tuple(TT.LadderRung(r.above, r.threshold)
                                                          for r in lad_j.rungs), lad_j.clip_lo)
    if case == "fit_ladder":
        return
    if case == "hand_ladders":
        for key in JT.LADDERS:
            got = TT.soft_mask_from_map(amap * 20.0, TT.ladder_for(*key))
            want = JT.soft_mask_from_map(amap * 20.0, JT.ladder_for(*key))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert TT.ladder_for("mvtec", "carpet") == TT.DEFAULT_LADDER
        return
    dil = 3 if case == "soft_mask_dilated" else 0
    got = TT.soft_mask_from_map(amap, lad_t, dilate=dil)
    want = JT.soft_mask_from_map(amap, lad_j, dilate=dil)
    assert 0 < want[1][:-1].mean() < 1  # the blobs are gated and thresholded
    if case.startswith("refine"):
        kw = (dict(seed="fwhm", lo_frac=0.45) if case == "refine_fwhm"
              else dict(seed="ladder", hi_frac=0.6, lo_frac=0.3, min_area=20))
        got = TT.refine_masks(amap, *got, **kw)
        want = JT.refine_masks(amap, *want, **kw)
    if case == "backoff":
        got = [np.stack(z) for z in zip(*(TT.dilate_with_backoff(m, b, 30)
                                          for m, b in zip(*got)))]
        want = [np.stack(z) for z in zip(*(JT.dilate_with_backoff(m, b, 30)
                                           for m, b in zip(*want)))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_load_ladder_of_every_shipped_ladder(tmp_path):
    paths = sorted(glob.glob(os.path.join(ROOT, "results", "*_ladder.json")))
    assert len(paths) >= 5
    for p in paths:
        got, want = TT.load_ladder(p), JT.load_ladder(p)
        assert (got.gate, got.clip_lo) == (want.gate, want.clip_lo)
        assert [(r.above, r.threshold) for r in got.rungs] == [
            (r.above, r.threshold) for r in want.rungs]
        TT.save_ladder(got, str(tmp_path / "l.json"))
        assert TT.load_ladder(str(tmp_path / "l.json")) == got
    assert np.array_equal(TT.manual_mask((2, 8, 8, 1), 3), JT.manual_mask((2, 8, 8, 1), 3))
    assert np.array_equal(TT.mnist_half_mask((1, 28, 28, 1)), JT.mnist_half_mask((1, 28, 28, 1)))


def test_near_threshold_finds_the_levels_masks_come_from():
    """A map is near a threshold where a value lies within `tol` of the
    ladder's threshold or a hysteresis level, or its max of the gate."""
    lad = TT.ThresholdLadder(gate=2.0, rungs=(TT.LadderRung(-np.inf, 3.0),))
    a = np.full((8, 8, 1), 1.0)
    a[2, 2] = 5.5  # median 1: levels 3.25 and 2.125, threshold 3.0, no value near them
    assert not TT.near_threshold(a, lad, 1e-4)
    a[3, 3] = 3.0 + 5e-5
    assert TT.near_threshold(a, lad, 1e-4)
    assert not TT.near_threshold(a, lad, 1e-5)
    b = np.full((8, 8, 1), 1.0)
    b[0, 0] = 2.0 + 5e-5  # the max just past the gate
    assert TT.near_threshold(b, lad, 1e-4) and not TT.near_threshold(b, lad, 1e-5)


def test_mask_dilate_resolution_matches_jax():
    """A set radius, and auto (-1) from the denoiser source's own strides:
    the 256px model's, the s2d stem's, and a chosen deepest tap."""
    from test_torch_support import to_jax

    for kw in (dict(mask_dilate=8), dict(mask_dilate=0),
               dict(mask_dilate=-1, feature_source="denoiser"),
               dict(mask_dilate=-1, feature_source="denoiser",
                    feature_layers=("down0_block2", "down1_block2"))):
        t = tcfg.OODConfig(**kw)
        j = to_jax(t)
        for stem in (1, 2):
            strides = {f"down{i}_block{b}": 2**i * stem for i in range(4) for b in (1, 2)}
            assert t.resolved_mask_dilate(strides) == j.resolved_mask_dilate(256, strides)
    with pytest.raises(ValueError, match="refine_lo_frac"):
        tcfg.OODConfig(refine_lo_frac=0.9)


# ---------------------------------------------------------------------------
# launch counters under the serving threads
# ---------------------------------------------------------------------------

class _CountingPipe:
    """Stands in for a pipeline: Stage A (`detect`, on the collecting
    thread) and Stage B (`translate`, on the sampler thread) each count
    `per_call` launches of one wrapper, as the kernels' wrappers do."""

    def __init__(self, fn, per_call, s=4):
        self.fn, self.per_call, self.s = fn, per_call, s
        self.config = tcfg.Config(sampler=tcfg.SamplerConfig(ood_ad=True))

    def _launch(self):
        for _ in range(self.per_call):
            _build.count_launch(self.fn)

    def detect(self, lr):
        self._launch()
        m = np.zeros((lr.shape[0], self.s, self.s, 1), np.float32)
        m[:, :, :1] = 1.0
        return m, m, None

    def translate(self, lr, noise=None, mask=None):
        self._launch()
        return {"pred": np.asarray(lr), "branched": np.asarray(True)}


def test_launch_counts_survive_the_two_serving_threads():
    """With overlap_detect, Stage A of a batch and Stage B of the one before
    launch at once; with a tiny switch interval an unguarded `+=` loses
    counts.  Every launch is counted, and the kv kernel's row-counter buffer
    asked for at once from many threads ends as one buffer large enough."""
    def fn():
        pass

    fn.launches = 0
    per_call, n_req, bsz = 20_000, 12, 2
    pipe = _CountingPipe(fn, per_call)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = InferenceServer(pipe, batch_size=bsz, max_wait_ms=1, overlap_detect=True,
                              noise_for_batch=lambda i: i)
        with srv:
            futs = [srv.submit(np.zeros((4, 4, 1), np.float32)) for _ in range(n_req)]
            outs = [f.result(timeout=120) for f in futs]
        stats = srv.snapshot_stats()
        assert len(outs) == n_req and stats["requests"] == n_req
        dispatches = stats["branched_dispatches"] + stats["merged_dispatches"]
        assert fn.launches == per_call * (stats["batches"] + dispatches)

        LA._counters.pop(torch.device("cpu"), None)
        got = {}

        def ask(i):
            got[i] = LA._row_counters(torch.device("cpu"), 8 * i)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(1, 33)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        final = LA._counters[torch.device("cpu")]
        assert final.numel() >= 256 and all(got[i].numel() >= 8 * i for i in got)
    finally:
        sys.setswitchinterval(before)
        LA._counters.pop(torch.device("cpu"), None)
