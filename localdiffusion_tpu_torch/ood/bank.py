"""Build a PatchCore memory bank and its fitted threshold ladder.

The port's counterpart of `scripts/anomaly_model_train.py` for the
`synthetic_brain` data: normal conditioning images (seed 42) go through the
front end's preprocessing and the feature source, their patch embeddings are
coreset-subsampled by k-center greedy, and the bank is saved; then the
ladder is fitted on the same images' anomaly maps and saved beside the bank
as `<bank>_ladder.json`, where `build_frontend` finds it.

    python -m localdiffusion_tpu_torch.ood.bank --out /path/to/memory_bank.npy

builds the bank of `mri256_config()` (200 images at 256px: 819,200 patches,
a 10% coreset of 81,920 × 192) with the weights of its `ood.feature_npz`, on
the card unless `--device cpu`.  Other datasets wait for their readers.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from localdiffusion_tpu_torch.config import Config, mri256_config
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.factory import ladder_beside
from localdiffusion_tpu_torch.ood.features import make_feature_source
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.ood.thresholds import fit_ladder, save_ladder


def calibration_images(cfg: Config, n_images: int) -> np.ndarray:
    """The normal conditioning images [n, H, W, 1] a bank is built from."""
    if cfg.data.name != "synthetic_brain":
        raise NotImplementedError(f"dataset {cfg.data.name!r}: its reader is a later slice "
                                  "of the port (ROADMAP queue 1)")
    d = cfg.data
    _, lr, _ = synthetic_brain_translation(
        n_images, cfg.diffusion.image_size, tumor=False, seed=42, mean_t1=d.mean_t1,
        std_t1=d.std_t1, mean_flair=d.mean_flair, std_flair=d.std_flair)
    return lr


BATCH = 8  # calibration images a feature pass


def build_bank(cfg: Config, out: str, gd=None, n_images: int = 200, images=None,
               device="cuda") -> dict:
    """Build the bank of `cfg`'s detector (a `cfg.ood.coreset_ratio`
    coreset; the k-center projection from seed 0) and save it to `out`
    (np.save), then fit its ladder (`fit_ladder`'s defaults, those of the
    JAX script) and save it beside the bank.

    gd: the denoiser to tap (default: built on `device` with
    `cfg.ood.feature_npz`'s weights).  images: the calibration images
    (default `calibration_images(cfg, n_images)`), `BATCH` at a time.
    Returns {'bank', 'ladder', 'ladder_path', 'seconds': {'taps',
    'kcenter', 'ladder'}, 'patches'}."""
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="patchcore"))
    lr = calibration_images(cfg, n_images) if images is None else np.asarray(images, np.float32)
    pc = PatchCore(cfg.ood, source=make_feature_source(cfg, denoiser=gd, device=device))
    # the bank shares the inference front end's preprocessing
    fe = OODFrontend(cfg, patchcore=pc)
    batches = [fe._preprocess_patchcore(lr[i:i + BATCH]) for i in range(0, len(lr), BATCH)]
    bank = pc.build_memory_bank(batches)
    np.save(out, bank)
    # the normal set's own maps: nonzero, since the coreset keeps 10%
    t0 = time.perf_counter()
    ladder = fit_ladder([pc(x)["anomaly_map"].cpu().numpy() for x in batches])
    path = ladder_beside(out)
    save_ladder(ladder, path)
    return dict(bank=bank, ladder=ladder, ladder_path=path,
                seconds=dict(taps=pc.last_build_s["taps"], kcenter=pc.last_build_s["kcenter"],
                             ladder=time.perf_counter() - t0),
                patches=pc.last_build_s["patches"])


def main(argv=None) -> None:
    cfg = mri256_config()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the bank's .npy path (its ladder goes beside it)")
    ap.add_argument("--n-images", type=int, default=200)
    ap.add_argument("--feature-npz", default=cfg.ood.feature_npz,
                    help="the denoiser's params snapshot")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, feature_npz=args.feature_npz))
    res = build_bank(cfg, args.out, n_images=args.n_images, device=args.device)
    lad = res["ladder"]
    print(f"saved {args.out}: {res['bank'].shape} from {res['patches']} patches; seconds "
          + " ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
    print(f"saved fitted ladder {res['ladder_path']}: gate={lad.gate:.4f} "
          f"rungs={[(r.above, r.threshold) for r in lad.rungs]}")


if __name__ == "__main__":
    main()
