#!/usr/bin/env python3
"""Emulate on the CPU the control of `chip_smoke.py`'s check of the
classifier gate's WRN50-2 last resort: the gate's scores with the
distance product's inputs rounded as TF32 rounds them.

    python3 gate_tf32_emulation.py

Builds the gate as `chip_smoke.py` does (`mri256_gated_config()` with the
seg detector and no bank: a WRN bank from `GATE_WRN_PAIRS` + the same
number of calibration images, seeded weights) on the CPU, scores the same
2 + 2 images in float32, in float64 from the same embeddings, and with
x·yᵀ of the distance identity taken over inputs rounded to TF32's 10
mantissa bits (round to nearest), and prints one JSON object: the scores
and each score's relative difference from the float32 one, against the
per-score bar the card's control must exceed.  About a minute on 4 cores.
"""

import dataclasses
import json

import numpy as np
import torch

import chip_smoke as cs
from localdiffusion_tpu_torch.config import mri256_gated_config
from localdiffusion_tpu_torch.factory import build_classifier_gate
from localdiffusion_tpu_torch.ood import patchcore as PC
from localdiffusion_tpu_torch.ood.bank import classifier_calibration_pairs


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest value with TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dist_sq_tf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`patchcore.euclidean_dist_sq` with the product over TF32 inputs; the
    norms stay float32, as cuBLAS leaves them."""
    x_norm = (x * x).sum(-1, keepdim=True)
    y_norm = (y * y).sum(-1, keepdim=True)
    prod = to_tf32(x) @ to_tf32(y).T
    return prod.mul_(-2.0).add_(x_norm).add_(y_norm.T).clamp_min_(0.0)


def main() -> None:
    torch.set_num_threads(4)
    n = cs.GATE_WRN_PAIRS
    base = mri256_gated_config()
    cfg = base.replace(ood=dataclasses.replace(base.ood, detector="seg",
                                               memory_bank_path=None))
    pairs = classifier_calibration_pairs(cfg, n=n)
    gate = build_classifier_gate(cfg, calibration_pairs=pairs, device="cpu", verbose=False)
    cls, pc = gate.classifier, gate.classifier.patchcore
    x = np.concatenate([pairs[i][0] for i in (0, 1, n, n + 1)])
    f32 = cls.score_raw(x).numpy()
    emb = pc.embed_map(cls._prep(x))
    b, _, _, c = emb.shape
    e, bank = emb.reshape(-1, c).double(), pc.memory_bank.double()
    dist, loc = PC.nearest_neighbors(e, bank, 1)
    f64 = PC.compute_anomaly_score(dist.reshape(b, -1), loc.reshape(b, -1), e, bank,
                                   pc.num_neighbors).numpy()
    exact = PC.euclidean_dist_sq
    PC.euclidean_dist_sq = dist_sq_tf32
    try:
        tf32 = cls.score_raw(x).numpy()
    finally:
        PC.euclidean_dist_sq = exact
    rel = lambda a: (np.abs(a - f32) / np.abs(f32)).tolist()
    print(json.dumps({"bank": list(pc.memory_bank.shape), "float32": f32.tolist(),
                      "float64": f64.tolist(), "tf32": tf32.tolist(),
                      "float64_rel": rel(f64), "tf32_rel": rel(tf32),
                      "bar": cs.GATE_WRN_F32_SCORE_REL}))


if __name__ == "__main__":
    main()
