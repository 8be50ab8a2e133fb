"""PatchCore OOD detector: embeddings, coreset, nearest-neighbour search,
anomaly maps.  Port of `localdiffusion_tpu/ood/patchcore.py`.

  * pairwise distances by the identity |x|² − 2x·yᵀ + |y|², one float32
    matrix product against the memory bank (the JAX package's `jnp.dot`,
    outside any Pallas kernel), taken in chunks of queries: at the 256px
    deployment the whole product would be 16,384 × 81,920 floats (5.4 GB),
    and a query's nearest neighbour does not depend on the other queries;
  * the k-center-greedy coreset as a loop of max-min distance updates that
    stays on the device: the argmax is a tensor, so no step waits for the
    host;
  * the anomaly map as a bilinear upsample and a separable gaussian blur
    (σ = 4, 33 taps).

On a CUDA tensor the distance product must run in full float32, as the CPU
computes it: it raises while TF32 is on, rather than switch a flag that is
the whole process's.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.ops.resize import gaussian_blur, resize_bilinear

# queries × bank rows of one chunk of the distance matrix (float32): 512 MiB
NN_CHUNK_ELEMENTS = 2**27


def check_full_float32(device) -> None:
    """Raise if a float32 product on `device` would run in TF32: the
    distance product's bar (the card's map within 1e-4 of the CPU's, and the
    same nearest bank rows) holds only in full float32."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: PatchCore's distance product "
            "needs full float32 to hold the card's anomaly map within 1e-4 of the CPU's; "
            "set it to False")


def avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 1, 1) over NHWC: zero padding, sums divided by 9."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1,
                        count_include_pad=True).permute(0, 2, 3, 1)


def generate_embedding(feats: Dict[str, torch.Tensor], layers) -> torch.Tensor:
    """Deeper taps resized to the shallowest's grid, channels concatenated."""
    emb = feats[layers[0]]
    h, w = emb.shape[1:3]
    parts = [emb] + [resize_bilinear(feats[layer], (h, w)) for layer in layers[1:]]
    return torch.cat(parts, dim=-1)


def reshape_embedding(embedding: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B·H·W, C]."""
    return embedding.reshape(-1, embedding.shape[-1])


def euclidean_dist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distances [N, M] by the matrix-product identity, in
    the JAX package's order: |x|² − 2·x·yᵀ + |y|², clamped at 0."""
    x_norm = (x * x).sum(-1, keepdim=True)
    y_norm = (y * y).sum(-1, keepdim=True)
    prod = x @ y.T
    # in place: (−2·p + |x|²) is x_norm − 2·p exactly
    return prod.mul_(-2.0).add_(x_norm).add_(y_norm.T).clamp_min_(0.0)


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return euclidean_dist_sq(x, y).sqrt_()


def nearest_neighbors(embedding: torch.Tensor, memory_bank: torch.Tensor,
                      n_neighbors: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances, bank rows) of each query's nearest `n_neighbors`: [N] for
    one, else [N, k], nearest first.  The queries go in chunks of at most
    `NN_CHUNK_ELEMENTS` distances."""
    check_full_float32(embedding.device)
    rows = max(1, NN_CHUNK_ELEMENTS // max(memory_bank.shape[0], 1))
    scores, locations = [], []
    for q in embedding.split(rows):
        dist = euclidean_dist(q, memory_bank)
        if n_neighbors == 1:
            loc = dist.argmin(dim=1)
            scores.append(dist.gather(1, loc[:, None])[:, 0])
        else:
            neg, loc = torch.topk(-dist, n_neighbors, dim=1)
            scores.append(-neg)
        locations.append(loc)
    return torch.cat(scores), torch.cat(locations)


def compute_anomaly_score(patch_scores: torch.Tensor, locations: torch.Tensor,
                          embedding: torch.Tensor, memory_bank: torch.Tensor,
                          num_neighbors: int = 9) -> torch.Tensor:
    """Image score [B] with the neighbourhood reweighting: the score of the
    most anomalous patch times 1 − softmax weight of its nearest bank row
    among that row's own `num_neighbors` nearest rows.  patch_scores and
    locations [B, P], embedding [B·P, C]."""
    if num_neighbors == 1:
        return patch_scores.max(dim=1).values
    b, p = patch_scores.shape
    max_patches = patch_scores.argmax(dim=1)  # [B]
    emb = embedding.reshape(b, p, -1)
    rows = torch.arange(b, device=emb.device)
    max_feats = emb[rows, max_patches]  # [B, C]
    score = patch_scores[rows, max_patches]
    nn_sample = memory_bank[locations[rows, max_patches]]  # [B, C]
    k = min(num_neighbors, memory_bank.shape[0])
    _, support = nearest_neighbors(nn_sample, memory_bank, n_neighbors=k)  # [B, k]
    support_feats = memory_bank[support]  # [B, k, C]
    d = ((max_feats[:, None, :] - support_feats) ** 2).sum(-1).clamp_min(0.0).sqrt()
    weights = (1.0 - torch.softmax(d, dim=1))[:, 0]
    return weights * score


def anomaly_map_from_scores(patch_scores: torch.Tensor, image_size,
                            sigma: float = 4.0) -> torch.Tensor:
    """[B, h, w, 1] patch scores → [B, H, W, 1] map: bilinear upsample, then
    a gaussian blur of 2·int(4σ)+1 taps (anomalib's AnomalyMapGenerator)."""
    up = resize_bilinear(patch_scores, image_size)
    return gaussian_blur(up, sigma=sigma, kernel_size=2 * int(4.0 * sigma) + 1)


# ---------------------------------------------------------------------------
# coreset subsampling
# ---------------------------------------------------------------------------

def random_projection(d: int, proj_dim: int = 128, seed: int = 0) -> torch.Tensor:
    """The k-center projection [d, proj_dim]: N(0, 1) / √proj_dim, drawn on
    the CPU from `seed`, so every device gets the same matrix.  (The JAX
    package draws it with `jax.random.normal`, a stream PyTorch does not
    reproduce; its tests hand that matrix to `kcenter_greedy_indices`.)"""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(d, proj_dim, generator=gen) / math.sqrt(proj_dim)


def kcenter_greedy_indices(embedding: torch.Tensor, k: int,
                           proj: Optional[torch.Tensor] = None,
                           proj_dim: int = 128) -> torch.Tensor:
    """Greedy k-center selection [k] (int64) on randomly projected features.

    Embeddings wider than `proj_dim` are projected by `proj` [d, proj_dim]
    (default `random_projection(d, proj_dim)`, seed 0), rounded to float32 as
    the JAX package's float32 product is.  Start at row 0; each step takes
    the row farthest from every centre so far (the first of equal ones, as
    `jnp.argmax` does) and lowers each row's distance to the nearest centre.

    A row's squared distance to the new centre, |f|² − 2f·c + |c|², is
    computed in float64 and rounded to float32: the result is the float32
    nearest the exact value but for a rare rounding boundary, on every
    device, so the card and the CPU pick the same rows.  The k steps queue
    on the device without a host sync.
    """
    d = embedding.shape[1]
    dev = embedding.device
    if d > proj_dim:
        if proj is None:
            proj = random_projection(d, proj_dim)
        proj = torch.as_tensor(proj).to(dev, torch.float64)
        feats = (embedding.double() @ proj).float().double()
    else:
        feats = embedding.double()
    norms = (feats * feats).sum(-1)  # [n] float64

    def dist_to(idx):  # idx: [1] int64 on the device
        centre = feats.index_select(0, idx)[0]
        return (norms - 2.0 * torch.mv(feats, centre) + norms.index_select(0, idx)).float()

    selected = torch.zeros(k, dtype=torch.int64, device=dev)
    min_d = dist_to(selected[:1])
    for i in range(1, k):
        idx = min_d.argmax().view(1)
        selected[i:i + 1] = idx
        torch.minimum(min_d, dist_to(idx), out=min_d)
    return selected


def subsample_embedding(embedding: torch.Tensor, sampling_ratio: float,
                        proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The coreset memory bank: max(1, int(N·ratio)) k-center rows."""
    k = max(1, int(embedding.shape[0] * sampling_ratio))
    return embedding[kcenter_greedy_indices(embedding, k, proj=proj)]


# ---------------------------------------------------------------------------
# model wrapper
# ---------------------------------------------------------------------------

class StageClock:
    """Times the stages of one Stage A call: `mark(name)` ends the stage
    begun at the previous mark.  On a CUDA device the marks are CUDA events
    on the current stream, read by `split()` after the caller has waited
    for the device (no mark waits for it); on the CPU they are host clock
    readings.  `split()` gives milliseconds per stage."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def split(self) -> Dict[str, float]:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
        return out


class PatchCore:
    """PatchCore bound to a feature source and a memory bank.

    The source (ood/features.py) exposes `.layers`, `.preprocess` and
    `.apply(x) → {layer: [B, h, w, c]}` on its device.  The WRN50-2
    default of the JAX package is not ported yet.

    `embed(x)` streams patch embeddings for building a bank;
    `__call__(x)` → {'anomaly_map', 'pred_score'}.
    """

    def __init__(self, cfg, source=None, memory_bank=None):
        if source is None:
            raise NotImplementedError(
                "the WRN50-2 feature source is a later slice of the port (ROADMAP queue 1); "
                "use feature_source='denoiser'")
        self.cfg = cfg
        self.source = source
        self.device = source.device
        self.layers = tuple(source.layers)
        self.input_size = (cfg.input_size, cfg.input_size)
        self.num_neighbors = cfg.num_neighbors
        self.memory_bank = None
        if memory_bank is not None:
            self.memory_bank = torch.as_tensor(np.array(memory_bank, np.float32),
                                               device=self.device)
        self.last_build_s: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def embed_map(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] images → [B, h, w, D] patch embeddings (float32)."""
        feats = self.source.apply(x)
        feats = {k: avg_pool_3x3(v) for k, v in feats.items()}
        return generate_embedding(feats, self.layers)

    def _input(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x, np.float32))
        return x.to(self.device, torch.float32)

    def embed(self, x) -> torch.Tensor:
        """[B, H, W, C] → [B·P, D] patch embeddings (bank building)."""
        return reshape_embedding(self.embed_map(self._input(x)))

    def build_memory_bank(self, batches, proj: Optional[torch.Tensor] = None) -> np.ndarray:
        """Batches → embeddings → a `coreset_ratio` coreset bank (kept on the
        device and returned as numpy), projected for k-center by `proj` or
        `random_projection`'s seed 0.  `last_build_s` holds the seconds of
        the taps (with the pooling and concatenation) and of k-center."""
        t0 = time.perf_counter()
        embedding = torch.cat([self.embed(b) for b in batches])
        self._sync()
        t1 = time.perf_counter()
        self.memory_bank = subsample_embedding(embedding, self.cfg.coreset_ratio, proj=proj)
        self._sync()
        self.last_build_s = {"taps": t1 - t0, "kcenter": time.perf_counter() - t1,
                             "patches": int(embedding.shape[0])}
        return self.memory_bank.cpu().numpy()

    def __call__(self, x, clock: Optional[StageClock] = None) -> Dict[str, torch.Tensor]:
        """{'anomaly_map' [B, H, W, 1], 'pred_score' [B]} on the device.
        `clock` (optional) is marked after the feature pass ('features'),
        the nearest-neighbour search and image score ('nn') and the map
        ('map')."""
        if self.memory_bank is None:
            raise ValueError("load or build a memory bank first")
        emb_map = self.embed_map(self._input(x))
        if clock is not None:
            clock.mark("features")
        b, h, w, c = emb_map.shape
        embedding = emb_map.reshape(-1, c)
        patch_scores, locations = nearest_neighbors(embedding, self.memory_bank, 1)
        scores_b = patch_scores.reshape(b, -1)
        pred_score = compute_anomaly_score(scores_b, locations.reshape(b, -1), embedding,
                                           self.memory_bank, self.num_neighbors)
        if clock is not None:
            clock.mark("nn")
        anomaly_map = anomaly_map_from_scores(scores_b.reshape(b, h, w, 1), self.input_size)
        if clock is not None:
            clock.mark("map")
        return {"anomaly_map": anomaly_map, "pred_score": pred_score}
