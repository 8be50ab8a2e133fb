"""Build a PatchCore memory bank and its fitted threshold ladder.

The port's counterpart of `scripts/anomaly_model_train.py`: a dataset's
normal conditioning images (`data.datasets.bank_images`, the JAX script's
branches: MNIST's digit 8, synthetic textures, normal synthetic brains of
seed 42, BraTS training slices, MVTec `good` images) go through the front
end's preprocessing and the feature source, their patch embeddings are
coreset-subsampled by k-center greedy, and the bank is saved; then the
ladder is fitted on the same images' anomaly maps and saved beside the bank
as `<bank>_ladder.json`, where `build_frontend` finds it.

    python -m localdiffusion_tpu_torch.ood.bank --out /path/to/memory_bank.npy

builds the bank of `mri256_config()` (200 images at 256px: 819,200 patches,
a 10% coreset of 81,920 × 192) with the weights of its `ood.feature_npz`, on
the card unless `--device cpu`.  `--config mri256_bf16` or `mri64` takes
`mri256_bf16_config()` or `mri64_config()` and `--feature-source` names
the taps: `wrn` (the WRN50-2's `ood.layers`, weights seeded by `--seed` or
the torchvision state dict of `--backbone-weights`; at 256px layer2 ⊕
layer3, 204,800 patches × 1,536 → 20,480 rows), `seg_encoder` (the
SegUNet of `--seg-npz`, down2 ⊕ down3, 768 channels at 64×64) or
`denoiser`.  `--seed` also seeds the k-center projection, as the JAX
script's does.  `--config` takes any builder of `config.CONFIGS` (or a `.json`/`.yaml`
file, `config.load_config`):
`mnist_gated` (the WRN50-2 at an 84px input on 28px digits) reads the idx
files of `--mnist-path`/`--mnist-labels-path`, `mvtec_synthetic` the
synthetic textures; `synthetic_texture_denoise` has no bank branch and
raises, as in the JAX script.

    python -m localdiffusion_tpu_torch.ood.bank --classifier --out /path/to/memory_bank.npy

builds instead the classifier gate's own bank for `mri256_gated_config()`
(the counterpart of the bank and ROC sections of
`scripts/eval_gated_quality.py`): 64 normal FLAIR targets (seed 11) → a 5%
coreset of their 262,144 patches, 13,107 × 192, saved beside `--out` as
`memory_bank_synthetic_brain_flair_denoiser.npy`, where
`factory.build_classifier_gate` finds it; then it prints the threshold
ROC-calibrated on `classifier_calibration_pairs` and its balanced accuracy.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

import torch

from localdiffusion_tpu_torch import config as C
from localdiffusion_tpu_torch.config import Config, mri256_config, mri256_gated_config
from localdiffusion_tpu_torch.data.datasets import add_data_args, bank_images, with_data_paths
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.factory import (
    build_classifier_gate,
    classifier_bank_beside,
    ladder_beside,
)
from localdiffusion_tpu_torch.ood.classifier import balanced_accuracy
from localdiffusion_tpu_torch.ood.features import make_feature_source
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.ood.thresholds import fit_ladder, save_ladder


def brains(cfg: Config, n: int, tumor: bool, seed: int):
    """(hr FLAIR, lr T1, seg) synthetic brains normalized as `cfg` says:
    the sets of the classifier gate and the margin evaluations, which exist
    for `synthetic_brain` only."""
    if cfg.data.name != "synthetic_brain":
        raise NotImplementedError(f"dataset {cfg.data.name!r}: these sets are synthetic "
                                  "brains ('synthetic_brain')")
    d = cfg.data
    return synthetic_brain_translation(
        n, cfg.diffusion.image_size, tumor=tumor, seed=seed, mean_t1=d.mean_t1,
        std_t1=d.std_t1, mean_flair=d.mean_flair, std_flair=d.std_flair,
        translate_zero=d.translate_zero)


BATCH = 8  # calibration images a feature pass


def build_bank(cfg: Config, out: str, gd=None, n_images: int = 200, images=None,
               device="cuda", seed: int = 0) -> dict:
    """Build the bank of `cfg`'s detector (a `cfg.ood.coreset_ratio`
    coreset, 0.1 as the JAX script's; the k-center projection from `seed`)
    with `cfg.ood.feature_source`'s taps and save it to `out` (np.save),
    then fit its ladder (`fit_ladder`'s defaults, those of the JAX script)
    and save it beside the bank.

    gd: the denoiser to tap (default: built on `device` with
    `cfg.ood.feature_npz`'s weights); a WRN is seeded from `seed`.  images:
    the calibration images (default `bank_images(cfg, n_images)`),
    `BATCH` at a time.  Returns {'bank', 'ladder', 'ladder_path', 'seconds':
    {'taps', 'kcenter', 'ladder'}, 'patches', 'patchcore'}."""
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore"))
    lr = bank_images(cfg, n_images) if images is None else np.asarray(images, np.float32)
    pc = PatchCore(cfg.ood, source=make_feature_source(
        cfg, denoiser=gd, device=device, generator=torch.Generator().manual_seed(seed)))
    # the bank shares the inference front end's preprocessing
    fe = OODFrontend(cfg, patchcore=pc)
    batches = [fe._preprocess_patchcore(lr[i:i + BATCH]) for i in range(0, len(lr), BATCH)]
    bank = pc.build_memory_bank(batches, seed=seed)
    np.save(out, bank)
    # the normal set's own maps: nonzero, since the coreset keeps 10%
    t0 = time.perf_counter()
    ladder = fit_ladder([pc(x)["anomaly_map"].cpu().numpy() for x in batches])
    path = ladder_beside(out)
    save_ladder(ladder, path)
    return dict(bank=bank, ladder=ladder, ladder_path=path,
                seconds=dict(taps=pc.last_build_s["taps"], kcenter=pc.last_build_s["kcenter"],
                             ladder=time.perf_counter() - t0),
                patches=pc.last_build_s["patches"], patchcore=pc)


def build_classifier_bank(cfg: Config, out: str, gd=None, n_images: int = 64,
                          ratio: float = 0.05, device="cuda") -> dict:
    """Build the classifier gate's bank over `n_images` normal FLAIR
    targets (seed 11), the images the gate scores, as the sampler holds
    them, with `cfg`'s feature source (the denoiser `gd`, or one built on
    `device` with `cfg.ood.feature_npz`'s weights): a `ratio` coreset (the
    k-center projection from seed 0), saved to `out` (np.save).  Returns
    {'bank', 'seconds': {'taps', 'kcenter'}, 'patches'}."""
    hr = brains(cfg, n_images, False, 11)[0]
    pc = PatchCore(cfg.ood, source=make_feature_source(cfg, denoiser=gd, device=device))
    bank = pc.build_memory_bank([hr[i:i + BATCH] for i in range(0, len(hr), BATCH)],
                                sampling_ratio=ratio)
    np.save(out, bank)
    return dict(bank=bank, seconds={k: pc.last_build_s[k] for k in ("taps", "kcenter")},
                patches=pc.last_build_s["patches"])


def classifier_calibration_pairs(cfg: Config, n: int = 32, lesion_amp: float = 2.0) -> list:
    """(image [1, H, W, 1], label) pairs for the gate's ROC calibration: n
    normal FLAIR targets (seed 21, label 0), then n anomalous ones (label
    1).  For 'suppress' those are normal FLAIR (seed 22) with a Gaussian
    lesion of peak `lesion_amp` and radius size/10 added at a place in the
    image's middle half (rng seed 23), a synthetic hallucination residue;
    for 'preserve' the tumour-carrying FLAIR of seed 22."""
    size = cfg.diffusion.image_size
    normal = brains(cfg, n, False, 21)[0]
    if cfg.sampler.classifier_polarity == "preserve":
        anomalous = brains(cfg, n, True, 22)[0]
    else:
        anomalous = brains(cfg, n, False, 22)[0]
        rng = np.random.default_rng(23)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        radius = size / 10
        for i in range(n):
            ty = int(rng.integers(size // 4, 3 * size // 4))
            tx = int(rng.integers(size // 4, 3 * size // 4))
            lesion = np.exp(-((yy - ty) ** 2 + (xx - tx) ** 2) / (2 * radius**2))
            anomalous[i, :, :, 0] += lesion_amp * lesion
    return ([(normal[i:i + 1], 0) for i in range(n)]
            + [(anomalous[i:i + 1], 1) for i in range(n)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="the detector bank's .npy path (its ladder goes beside it; with "
                         "--classifier, the classifier's bank)")
    ap.add_argument("--classifier", action="store_true",
                    help="build the classifier gate's bank of mri256_gated_config() and "
                         "ROC-calibrate its threshold")
    ap.add_argument("--config", default="mri256",
                    help="the detector's configuration (default mri256): " + C.CONFIG_HELP)
    ap.add_argument("--feature-source", choices=["denoiser", "wrn", "seg_encoder"],
                    default=None, help="the taps (default: the configuration's)")
    ap.add_argument("--n-images", type=int, default=None,
                    help="images of the bank (default 200; with --classifier 64)")
    ap.add_argument("--calib", type=int, default=32,
                    help="with --classifier: calibration images per class")
    ap.add_argument("--feature-npz", default=mri256_config().ood.feature_npz,
                    help="the denoiser's params snapshot")
    ap.add_argument("--seg-npz", default=None,
                    help="the SegUNet's slim npz for --feature-source seg_encoder (default: "
                         "ood.seg_model_path's resolution, results/seg256_params.npz)")
    ap.add_argument("--backbone-weights", default=None,
                    help="a torchvision wide_resnet50_2 state dict for --feature-source wrn")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the WRN50-2's random weights and the k-center projection")
    ap.add_argument("--device", default="cuda")
    add_data_args(ap)
    args = ap.parse_args(argv)
    cfg = mri256_gated_config() if args.classifier else C.load_config(args.config)
    cfg = with_data_paths(cfg, args)
    over = dict(feature_npz=args.feature_npz)
    if args.feature_source:
        over["feature_source"] = args.feature_source
    if args.seg_npz:
        over["seg_model_path"] = args.seg_npz
    if args.backbone_weights:
        over["backbone_weights_path"] = args.backbone_weights
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, **over))
    if args.classifier:
        # one denoiser with the snapshot's weights taps for the bank and the calibration
        gd = make_feature_source(cfg, device=args.device).gd
        cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, memory_bank_path=args.out))
        out = classifier_bank_beside(args.out, cfg)
        res = build_classifier_bank(cfg, out, gd=gd, n_images=args.n_images or 64,
                                    device=args.device)
        print(f"saved {out}: {res['bank'].shape} from {res['patches']} patches; seconds "
              + " ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
        t0 = time.perf_counter()
        gate = build_classifier_gate(cfg, calibration_pairs=classifier_calibration_pairs(
            cfg, n=args.calib), gd=gd, device=args.device, verbose=False)
        labels, scores = gate.classifier.calibration
        print(f"ROC threshold {gate.threshold:.6g} ({gate.polarity}), balanced accuracy "
              f"{balanced_accuracy(labels, scores, gate.threshold):.4f} on {len(labels)} "
              f"calibration images ({time.perf_counter() - t0:.2f}s)")
        return dict(res, gate=gate)
    res = build_bank(cfg, args.out, n_images=args.n_images or 200, device=args.device,
                     seed=args.seed)
    lad = res["ladder"]
    print(f"saved {args.out}: {res['bank'].shape} from {res['patches']} patches "
          f"({cfg.ood.feature_source} taps {list(res['patchcore'].layers)}); seconds "
          + " ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
    print(f"saved fitted ladder {res['ladder_path']}: gate={lad.gate:.4f} "
          f"rungs={[(r.above, r.threshold) for r in lad.rungs]}")
    return res


if __name__ == "__main__":
    main()
