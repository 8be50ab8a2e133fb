"""Whole-volume translation: one medical volume in, the translated volume
out.  Port of `scripts/translate_volume.py`.

    python -m localdiffusion_tpu_torch.scripts.translate_volume --config mri256 \
        --params-npz results/mri_synth256_ema.npz --t1 vol_t1.mha \
        [--flair vol_flair.mha] [--seg vol_seg.mha] \
        [--detector patchcore|seg|manual|none] [--batch 8] [--out pred_volume.npy] \
        [--device cpu]

Every slice of the volume (`BRATSVolumeDataset.single_volume`) goes through
`pipeline.translate_volume`, `--batch` at a time; the translated volume is
written to `--out` and the masks beside it (`*_masks.npy`).  Inputs are
.mha/.mhd (`data/mha.py`) or .npy volumes [D, H, W].  With `--flair` the
target is known and the volume MSE is printed, and with `--seg` the MSE
over the segmented region too; without it the volume is translated blind.
`--config` names a builder of `config.CONFIGS` or a `.json`/`.yaml` file
(`config.load_config`) and `--params-npz`, a slim
npz, is required (the JAX script's `--milestone` reads an Orbax directory,
which the port does not).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from localdiffusion_tpu_torch.config import CONFIG_HELP, load_config
from localdiffusion_tpu_torch.data.brats import BRATSVolumeDataset
from localdiffusion_tpu_torch.data.mha import load_mha
from localdiffusion_tpu_torch.factory import build_pipeline


def load_volume(path: str) -> np.ndarray:
    """A volume from a .npy file or a MetaImage (.mha/.mhd)."""
    if path.endswith(".npy"):
        return np.load(path)
    vol, _ = load_mha(path)
    return vol


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, help=CONFIG_HELP)
    ap.add_argument("--t1", required=True, help="conditioning-modality volume")
    ap.add_argument("--flair", default=None, help="target-modality volume "
                    "(enables MSE; name reflects the default t1→flair task)")
    ap.add_argument("--seg", default=None, help="tumor segmentation volume "
                    "(enables OOD-region MSE)")
    ap.add_argument("--params-npz", required=True, help="the denoiser's slim npz snapshot")
    ap.add_argument("--detector", default=None, choices=["patchcore", "seg", "manual", "none"],
                    help="override ood.detector")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", default="flair",
                    help="'flair' = translate t1→flair (the reference's mode semantics)")
    ap.add_argument("--out", default="pred_volume.npy")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.detector:
        cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector=args.detector))

    t1 = load_volume(args.t1).astype(np.float32)
    flair = load_volume(args.flair).astype(np.float32) if args.flair else t1.copy()
    seg = load_volume(args.seg).astype(np.float32) if args.seg else None
    print(f"volume {t1.shape}, target={'given' if args.flair else 'ABSENT'}")

    ds = BRATSVolumeDataset.single_volume(cfg.data, t1, flair, seg=seg,
                                          crop=cfg.diffusion.image_size, mode=args.mode)
    pipe = build_pipeline(cfg, args.params_npz, device=args.device)
    out = pipe.translate_volume(ds, batch_size=args.batch)

    np.save(args.out, out["pred_volume"][..., 0])
    np.save(args.out.replace(".npy", "_masks.npy"), out["mask_volume"][..., 0])
    print(f"saved {args.out} {out['pred_volume'].shape}")
    if args.flair:
        msg = f"volume MSE: {float(out['mse']):.5f}"
        if "mean_mse_ood_region" in out:
            msg += f"  OOD-region MSE: {float(out['mean_mse_ood_region']):.5f}"
        print(msg)
    return out


if __name__ == "__main__":
    main()
