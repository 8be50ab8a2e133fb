"""Per-dataset anomaly-threshold ladders and soft-mask construction.

A copy of `localdiffusion_tpu/ood/thresholds.py` (numpy, with
`scipy.ndimage` imported where the refinement needs it), kept here because
the port imports nothing of the JAX package.  The ladders are the
reference's hand-tuned ones (reference test.py:251-375) and the fitted
ladder `fit_ladder` calibrates from normal-set anomaly maps; the per-image
scalar decisions run on the host and emit fixed-shape masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class LadderRung:
    above: float  # applies when map.max() > above
    threshold: float | str  # absolute value, or 'max-K*std' / 'max-K'


@dataclass(frozen=True)
class ThresholdLadder:
    """gate: no anomaly if map.max() <= gate → uniform mask of ones
    (reference e.g. test.py:253, 264-266)."""

    gate: float
    rungs: Tuple[LadderRung, ...]  # checked top-down (highest `above` first)
    clip_lo: str = "thr-std"  # 'thr-std' | 'thr-halfstd' | 'min'

    def resolve_threshold(self, amax: float, astd: float) -> Optional[float]:
        if amax <= self.gate:
            return None
        for rung in self.rungs:
            if amax > rung.above:
                t = rung.threshold
                if isinstance(t, str):
                    if t.startswith("max-") and t.endswith("std"):
                        k = float(t[4:-3] or "1")
                        return amax - k * astd
                    if t.startswith("max-"):
                        return amax - float(t[4:])
                    raise ValueError(t)
                return float(t)
        raise AssertionError("gate passed but no rung matched")


# reference test.py:251-281 (mnist), 291-323 (mri), 329-375 (mvtec)
LADDERS = {
    ("mnist", "8to3"): ThresholdLadder(
        gate=37.0,
        rungs=(
            LadderRung(44.0, 41.7),
            LadderRung(40.0, 38.2),
            LadderRung(-np.inf, 35.0),
        ),
    ),
    ("mnist", "8to5"): ThresholdLadder(
        gate=58.5,
        rungs=(
            LadderRung(71.0, 61.0),
            LadderRung(65.0, 57.0),
            LadderRung(-np.inf, 55.0),
        ),
    ),
    ("mri", "t12flair"): ThresholdLadder(
        gate=43.0,
        rungs=(
            LadderRung(60.0, "max-12"),
            LadderRung(51.0, 47.0),
            LadderRung(48.5, 44.0),
            LadderRung(-np.inf, 42.0),
        ),
    ),
    ("mri", "flair2t1"): ThresholdLadder(
        gate=43.0,
        rungs=(
            LadderRung(60.0, 47.0),
            LadderRung(50.0, 43.0),
            LadderRung(-np.inf, 42.0),
        ),
    ),
    ("mvtec", "transistor"): ThresholdLadder(
        gate=32.0,
        rungs=(
            LadderRung(40.0, 33.5),
            LadderRung(36.8, "max-2std"),
            LadderRung(35.0, "max-1std"),
            LadderRung(-np.inf, 29.5),
        ),
        clip_lo="thr-halfstd",
    ),
    ("mvtec", "toothbrush"): ThresholdLadder(
        gate=35.0,
        rungs=(LadderRung(49.0, 40.0), LadderRung(-np.inf, 28.0)),
        clip_lo="min",
    ),
    ("mvtec", "grid"): ThresholdLadder(
        gate=27.0,
        rungs=(
            LadderRung(40.0, 35.0),
            LadderRung(35.0, 30.0),
            LadderRung(-np.inf, 26.5),
        ),
        clip_lo="min",
    ),
}


def _soft_mask_single(
    a: np.ndarray, ladder: ThresholdLadder
) -> Tuple[np.ndarray, np.ndarray]:
    """(mask_pred, binary) for ONE image's anomaly map [H, W, 1]."""
    amax = float(a.max())
    astd = float(a.std())
    thr = ladder.resolve_threshold(amax, astd)
    if thr is None:
        ones = np.ones_like(a, dtype=np.float32)
        return ones, ones
    if thr >= amax:
        # fitted ladders can produce a pixel threshold above this image's
        # max even though the gate fired; pull it below the max so the
        # binary OOD region is non-empty (the reference asserts non-empty
        # masked branches, ddpm.py:790)
        thr = amax - 0.25 * max(astd, 1e-12)
    binary = (a > thr).astype(np.float32)
    if ladder.clip_lo == "thr-std":
        lo = thr - astd
    elif ladder.clip_lo == "thr-halfstd":
        lo = thr - 0.5 * astd
    else:
        lo = float(a.min())
    clipped = np.clip(a, lo, thr)
    mask = (clipped - clipped.min()) / (thr - clipped.min())
    return (mask**2).astype(np.float32), binary


def dilate_mask(m: np.ndarray, radius: int) -> np.ndarray:
    """Grey dilation of one mask [H, W, 1] by `radius` pixels (iterated 3×3
    max filter, edge-padded).  EXTENSION — the reference ships raw
    thresholded masks (test.py:260); see OODConfig.mask_dilate."""
    out = np.asarray(m, np.float32)
    h, w = out.shape[:2]
    for _ in range(int(radius)):
        p = np.pad(out, ((1, 1), (1, 1), (0, 0)), mode="edge")
        out = np.maximum.reduce(
            [p[i : i + h, j : j + w] for i in range(3) for j in range(3)]
        )
    return out


def erode_mask(m: np.ndarray, radius: int) -> np.ndarray:
    """Grey erosion of one mask [H, W, 1] by `radius` pixels (iterated 3×3
    min filter, edge-padded) — dilate_mask's dual, used by the margin
    harness's core-only oracle variant (scripts/eval_margins.py)."""
    out = np.asarray(m, np.float32)
    h, w = out.shape[:2]
    for _ in range(int(radius)):
        p = np.pad(out, ((1, 1), (1, 1), (0, 0)), mode="edge")
        out = np.minimum.reduce(
            [p[i : i + h, j : j + w] for i in range(3) for j in range(3)]
        )
    return out


def dilate_with_backoff(
    mask: np.ndarray, binary: np.ndarray, radius: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Dilate ONE image's (soft mask, binary mask) by up to `radius` steps,
    backing off before the binary saturates to all-ones: a mask dilated to
    uniform ones would collide with the uniform-ones bypass sentinel
    (pipeline.py) and silently route a detected anomaly onto the PLAIN
    chain — the opposite of what dilation is for.  Uniform-ones inputs
    (bypass masks) pass through untouched."""
    if binary.min() >= 1.0:
        return mask, binary
    for _ in range(int(radius)):
        b_next = dilate_mask(binary, 1)
        if b_next.min() >= 1.0:
            break
        mask, binary = dilate_mask(mask, 1), b_next
    return mask, binary


def refine_mask_single(
    a: np.ndarray,
    soft: np.ndarray,
    binary: np.ndarray,
    seed: str = "fwhm",
    hi_frac: float = 0.5,
    lo_frac: float = 0.25,
    min_area: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image adaptive refinement of ONE image's ladder mask
    (EXTENSION — VERDICT r4 next #1: raw mask quality without the
    isotropic-dilation crutch).

    The fitted ladder keeps the anomalous-or-not GATE decision (calibrated
    on normal data); this refines the SEGMENTATION of an already-gated
    image from its own score distribution:

      bg    = median of the image's anomaly map (the in-distribution level
              — lesions cover a small fraction of pixels, so the median is
              robust to them)
      seeds = pixels ≥ bg + hi_frac·(max − bg)  ('fwhm': full-width at a
              fraction of max — the blurred NN-distance blob is segmented
              at half-height instead of at a global constant), or the
              ladder's own threshold pixels ('ladder')
      grow  = seeds flood-filled through connected pixels ≥
              bg + lo_frac·(max − bg)  (hysteresis, à la Canny): the mask
              follows the lesion's actual support instead of a fixed-radius
              halo, so it stops at the background level in every direction
      filter= components smaller than min_area px are dropped (components
              not connected to any seed never survive the flood fill)

    Uniform-ones inputs (the no-anomaly bypass sentinel) pass through
    untouched.  The soft mask is floored at 1 inside the grown region —
    the same full-strength treatment grey dilation gave the halo, which is
    what the round-3 dilation sweep showed the branched chain needs."""
    if binary.min() >= 1.0:
        return soft, binary
    from scipy import ndimage

    a2 = np.asarray(a, np.float32)[..., 0]
    amax = float(a2.max())
    bg = float(np.median(a2))
    scale = max(amax - bg, 1e-12)
    if seed == "fwhm":
        seeds = a2 >= bg + hi_frac * scale
    else:
        seeds = binary[..., 0] > 0
    lo = bg + lo_frac * scale
    grown = ndimage.binary_propagation(seeds, mask=(a2 >= lo))
    if min_area > 0:
        lab, n = ndimage.label(grown)
        if n > 0:
            sizes = ndimage.sum_labels(grown, lab, index=np.arange(1, n + 1))
            keep = np.flatnonzero(sizes >= min_area) + 1
            grown = np.isin(lab, keep)
    if not grown.any():
        # never hand a gated (anomalous) image an empty OOD region — fall
        # back to the seeds (the reference asserts non-empty masked
        # branches, ddpm.py:790)
        grown = seeds
    binary_out = grown[..., None].astype(np.float32)
    soft_out = np.maximum(np.asarray(soft, np.float32), binary_out)
    return soft_out, binary_out


def refine_masks(
    anomaly_map: np.ndarray,
    masks: np.ndarray,
    binaries: np.ndarray,
    seed: str = "fwhm",
    hi_frac: float = 0.5,
    lo_frac: float = 0.25,
    min_area: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch wrapper over refine_mask_single ([B, H, W, 1] stacks)."""
    out_m, out_b = [], []
    for a, m, b in zip(np.asarray(anomaly_map, np.float32), masks, binaries):
        m2, b2 = refine_mask_single(
            a, m, b, seed=seed, hi_frac=hi_frac, lo_frac=lo_frac,
            min_area=min_area,
        )
        out_m.append(m2)
        out_b.append(b2)
    return np.stack(out_m), np.stack(out_b)


def soft_mask_from_map(
    anomaly_map: np.ndarray, ladder: ThresholdLadder, dilate: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """(mask_pred, binary_mask) from an anomaly map [B, H, W, 1].

    Per image: mask_pred = ((clip(map, lo, thr) − min) / (thr − min))²,
    binary at > thr (reference e.g. test.py:260-263); uniform ones when the
    gate says no anomaly (test.py:264-266).  The ladder statistics (max,
    std) are computed PER IMAGE — the reference only ever sees batch 1
    (test.py:190), so its global max/std are per-image by construction; for
    B > 1 a batch-global max would leak one image's anomaly into another's
    threshold.
    """
    amap = np.asarray(anomaly_map, np.float32)
    masks, binaries = zip(*(_soft_mask_single(a, ladder) for a in amap))
    masks, binaries = list(masks), list(binaries)
    if dilate > 0:
        for i in range(len(masks)):
            masks[i], binaries[i] = dilate_with_backoff(
                masks[i], binaries[i], dilate
            )
    return np.stack(masks), np.stack(binaries)


def near_threshold(
    anomaly_map: np.ndarray,
    ladder: ThresholdLadder,
    tol: float,
    hi_frac: float = 0.5,
    lo_frac: float = 0.25,
) -> bool:
    """Whether a map [H, W, 1] has a value within `tol` of a threshold its
    masks come from: the ladder's gate (against the max) and threshold, and
    the hysteresis seed and growth levels.  Two maps that agree within `tol`
    may give other masks only where this holds."""
    a = np.asarray(anomaly_map)[..., 0].astype(np.float64)
    amax, bg = float(a.max()), float(np.median(a))
    if abs(amax - ladder.gate) <= tol:
        return True
    levels = [ladder.resolve_threshold(amax, float(a.std())),
              bg + hi_frac * (amax - bg), bg + lo_frac * (amax - bg)]
    return any(np.any(np.abs(a - lv) <= tol) for lv in levels if lv is not None)


def fit_ladder(
    normal_maps,
    pixel_q: float = 0.999,
    gate_margin: float = 0.0,
    rel_above: float = 1.1,
    rel_rung: str = "max-1std",
    clip_lo: str = "thr-std",
    gate_q: float = 0.95,
) -> ThresholdLadder:
    """Self-calibrate a threshold ladder from NORMAL-set anomaly maps.

    The reference's ladders are hand-tuned constants valid only for its
    ImageNet-pretrained WideResNet50-2 (test.py:251-375).  This fits the
    same two-level mechanism from data — the anomalib adaptive-threshold
    idea — so Stage A produces usable masks with *any* backbone:

      gate      = max over per-image map maxima of the normal set, scaled by
                  (1 + gate_margin): an image whose map max exceeds anything
                  normal data produced is declared anomalous
                  (reference gate, e.g. test.py:253).
      rung 1    = for maps far above the gate (amax > gate·rel_above) a
                  RELATIVE threshold `rel_rung` (default max−1·std): a
                  strong anomaly shifts the whole image's score distribution
                  upward, so an absolute cut saturates — this mirrors the
                  reference's own relative rungs for high maxima
                  (test.py:293 'max-12', test.py:336 'max-2std').
      rung 2    = otherwise an ABSOLUTE threshold at the `pixel_q` quantile
                  of all normal pixel scores: pixels scoring above (almost)
                  every normal patch are the OOD region (like e.g.
                  test.py:263).

    `normal_maps`: iterable of [H,W,1] or [B,H,W,1] anomaly maps computed on
    anomaly-free data with the same detector + memory bank.

    Validated (tests/test_ood.py::test_fit_ladder_localizes_synthetic_*):
    with a random-init backbone and layers=('layer1','layer2') this fits
    ladders whose masks reach IoU ≥ 0.3 against ground truth on both
    synthetic lesions and texture defects.
    """
    maxima, pix = [], []
    for m in normal_maps:
        m = np.asarray(m, np.float32)
        if m.ndim == 4:
            maxima.extend(float(x.max()) for x in m)
        else:
            maxima.append(float(m.max()))
        pix.append(m.ravel())
    # gate_q < 1 swaps the max of the normal maxima (an extreme statistic —
    # a single outlier image moves it, which is why refit ladders vary
    # run to run; docs/STATUS.md round 3) for a quantile of them; the
    # robust 0.95 is the DEFAULT (VERDICT r2 item 5); pass 1.0 for the
    # reference-style max gate
    gate = float(np.quantile(maxima, gate_q)) * (1.0 + gate_margin)
    thr = float(np.quantile(np.concatenate(pix), pixel_q))
    return ThresholdLadder(
        gate=gate,
        rungs=(
            LadderRung(gate * rel_above, rel_rung),
            LadderRung(-np.inf, thr),
        ),
        clip_lo=clip_lo,
    )


def save_ladder(ladder: ThresholdLadder, path: str) -> None:
    """JSON round-trip so a fitted ladder ships next to its memory bank."""
    import json

    with open(path, "w") as f:
        json.dump(
            {
                "gate": ladder.gate,
                "clip_lo": ladder.clip_lo,
                "rungs": [
                    {"above": None if np.isneginf(r.above) else r.above,
                     "threshold": r.threshold}
                    for r in ladder.rungs
                ],
            },
            f,
        )


def load_ladder(path: str) -> ThresholdLadder:
    import json

    with open(path) as f:
        d = json.load(f)
    rungs = tuple(
        LadderRung(
            -np.inf if r["above"] is None else float(r["above"]), r["threshold"]
        )
        for r in d["rungs"]
    )
    return ThresholdLadder(gate=float(d["gate"]), rungs=rungs,
                           clip_lo=d.get("clip_lo", "thr-std"))


def manual_mask(shape, cols: int = 7) -> np.ndarray:
    """Left-columns manual OOD mask — the committed reference behavior
    (test.py:379-381, the paper's motivational experiment)."""
    m = np.zeros(shape, np.float32)
    m[:, :, :cols, :] = 1.0
    return m


def mnist_half_mask(shape) -> np.ndarray:
    """Right-half-zero mask used when branch_out without detector
    (reference test.py:401-406)."""
    m = np.zeros(shape, np.float32)
    m[:, :, 14:, :] = 1.0
    return 1.0 - m


# fallback for dataset/category combinations without a hand-tuned ladder
# (e.g. MVTec categories beyond the reference's transistor/toothbrush/grid):
# a mid-range gate with relative rungs that track the map statistics.
DEFAULT_LADDER = ThresholdLadder(
    gate=30.0,
    rungs=(LadderRung(-np.inf, "max-1std"),),
    clip_lo="min",
)


def ladder_for(
    data_name: str, variant: str, default_ok: bool = True
) -> ThresholdLadder:
    key = (data_name, variant)
    if key not in LADDERS:
        if default_ok:
            return DEFAULT_LADDER
        raise KeyError(
            f"no threshold ladder for {key}; available: {sorted(LADDERS)}"
        )
    return LADDERS[key]
