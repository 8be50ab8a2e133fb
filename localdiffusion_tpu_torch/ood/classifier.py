"""PatchCore as an accept/reject classifier, with its threshold calibrated
by an ROC sweep.  Port of `localdiffusion_tpu/ood/classifier.py`.

The classifier-gated phase B of `diffusion.sampler.ddpm_sample_branched`
scores each post-fusion x_start with it (`ClassifierPatchCore.as_sampler_gate`).
The threshold maximizes TPR − FPR over labelled images; the ROC curve is
computed here in numpy, as scikit-learn's `roc_curve` computes it.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.ops.resize import imagenet_normalize, resize_bilinear


def roc_optimal_threshold(labels, scores) -> float:
    """The threshold of the first maximum of TPR − FPR, the anomalous class
    being label 2 (labels are class + 1).

    The curve is scikit-learn's `roc_curve(labels, scores, pos_label=2)`:
    one point per distinct score, from the highest down, each counting the
    samples scoring at or above it, after the point (0, 0) at threshold +∞,
    which is the answer where no threshold separates the classes.  Like
    scikit-learn's default `drop_intermediate`, the middle points of a run
    of equal steps are dropped: TPR − FPR is linear along such a run, so no
    first maximum moves, and the float64 arithmetic stays scikit-learn's,
    ties within one rounding included."""
    pos = np.asarray(labels).ravel() == 2
    s = np.asarray(scores).ravel()
    if pos.shape != s.shape:
        raise ValueError(f"{pos.size} labels for {s.size} scores")
    if pos.all() or not pos.any():
        raise ValueError("ROC calibration needs both classes")
    order = np.argsort(s, kind="mergesort")[::-1]
    s, pos = s[order], pos[order]
    last = np.r_[np.flatnonzero(np.diff(s)), s.size - 1]  # each distinct score's last row
    tps = np.cumsum(pos)[last]
    fps = last + 1 - tps
    thresholds = s[last]
    if tps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        tps, fps, thresholds = tps[keep], fps[keep], thresholds[keep]
    tpr = np.r_[0, tps] / tps[-1]
    fpr = np.r_[0, fps] / fps[-1]
    return float(np.r_[np.inf, thresholds][int(np.argmax(tpr - fpr))])


def balanced_accuracy(labels, scores, threshold: float) -> float:
    """Mean of the normal class's share at or below the threshold and the
    anomalous class's share above it (labels 1 and 2)."""
    labels, scores = np.asarray(labels).ravel(), np.asarray(scores).ravel()
    return float(0.5 * ((scores[labels == 1] <= threshold).mean()
                        + (scores[labels == 2] > threshold).mean()))


def preprocess_for_patchcore(x: torch.Tensor, input_size: int,
                             denorm: Optional[Tuple[float, float, bool]] = None) -> torch.Tensor:
    """The WRN source's image preparation: one channel repeated to three;
    values halved from [0, 2] to [0, 1], or, with `denorm` (mean, std,
    translate_zero), an MRI image brought back to its intensities and
    divided by 4096; a bilinear resize to the PatchCore input; ImageNet
    normalization."""
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    if denorm is None:
        x = x / 2.0
    else:
        mean, std, translate_zero = denorm
        if translate_zero:
            x = x - abs((0.0 - mean) / std)
        x = (x * std + mean) / 4096.0
    return imagenet_normalize(resize_bilinear(x, (input_size, input_size)))


class SamplerGate:
    """The sampler's gate: `gate(x_start, t)` → sign · (score − threshold),
    a [B] float32 tensor on the PatchCore's device, where sign is +1 for
    'preserve' and −1 for 'suppress'; the sampler accepts a sample where
    the value is > 0.  It reads nothing back to the host.

    'preserve' accepts while the fused x_start still scores anomalous (a
    rejection means the anomaly was hallucinated away); 'suppress' accepts
    while it scores normal (a rejection means lesion-like residue leaked
    into the output)."""

    def __init__(self, classifier: "ClassifierPatchCore", polarity: str):
        if classifier.threshold is None:
            raise ValueError("calibrate the classifier or set its threshold first")
        if polarity not in ("preserve", "suppress"):
            raise ValueError(f"bad classifier polarity {polarity!r}")
        self.classifier = classifier
        self.polarity = polarity
        self.threshold = float(classifier.threshold)
        self.sign = 1.0 if polarity == "preserve" else -1.0

    def __call__(self, x_start: torch.Tensor, t=None) -> torch.Tensor:
        score = self.classifier.score_raw(x_start)
        # the threshold rounded to float32, as the JAX gate subtracts it
        thr = torch.tensor(self.threshold, dtype=torch.float32, device=score.device)
        return self.sign * (score - thr)


class ClassifierPatchCore:
    """An accept/reject oracle over generated images: a PatchCore (its own
    bank) and a threshold on its image score."""

    def __init__(self, patchcore: PatchCore, threshold: Optional[float] = None,
                 denorm: Optional[Tuple[float, float, bool]] = None):
        self.patchcore = patchcore
        self.threshold = threshold
        self.denorm = denorm

    def _prep(self, x) -> torch.Tensor:
        """A 'raw' source (the denoiser's taps) scores the image as the
        sampler holds it; the ImageNet preparation is the WRN source's."""
        x = self.patchcore._input(x)
        if getattr(self.patchcore.source, "preprocess", "imagenet") == "raw":
            return x
        return preprocess_for_patchcore(x, self.patchcore.cfg.input_size, self.denorm)

    def score_raw(self, x) -> torch.Tensor:
        """Image scores [B] on the device."""
        return self.patchcore.score(self._prep(x))

    def calibrate(self, loader: Iterable[Tuple[np.ndarray, int]]) -> float:
        """Set the threshold by `roc_optimal_threshold` from (image, label)
        pairs, one image [1, H, W, C] a pair, label 1 = anomalous (stored as
        label + 1).  `calibration` keeps (labels, scores)."""
        scores, labels = [], []
        for img, label in loader:
            scores.append(self.score_raw(img).cpu().numpy())
            labels.append(np.asarray([int(label) + 1]))
        scores, labels = np.concatenate(scores), np.concatenate(labels)
        self.calibration = (labels, scores)
        self.threshold = roc_optimal_threshold(labels, scores)
        return self.threshold

    def __call__(self, x):
        """(pred [B] int32, 1 where the score is above the threshold; the
        anomaly map resized to the input [B, H, W, 1]; the score [B])."""
        if self.threshold is None:
            raise ValueError("calibrate the classifier or set its threshold first")
        out = self.patchcore(self._prep(x))
        score = out["pred_score"]
        pred = (score > self.threshold).to(torch.int32)
        amap = resize_bilinear(out["anomaly_map"], tuple(x.shape[1:3]))
        return pred, amap, score

    def as_sampler_gate(self, polarity: str = "preserve") -> SamplerGate:
        return SamplerGate(self, polarity)
