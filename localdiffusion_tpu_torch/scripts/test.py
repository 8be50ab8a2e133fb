"""A test set through the pipeline: Stage A, Stage B, metrics.  Port of
`scripts/test.py`.

    python -m localdiffusion_tpu_torch.scripts.test --config mri256 \
        --params-npz results/mri_synth256_ema.npz --max-images 8 [--device cpu]

`--config` names a builder of `config.CONFIGS` or a `.json`/`.yaml`
configuration file (`config.load_config`; the card's machine has no PyYAML,
so it reads `.json`).  The test set is the JAX script's
(`data.datasets.test_arrays`): up to 32 tumour brains of seed 0, up to 16
defective synthetic textures (their defect masks the ground truth), the
anomalous digit of the MNIST t10k idx files (`data.anomaly_name`, synthetic
digits where the files are missing), the BraTS tumour slices or the MVTec
defect class `data.anomaly_name`; `--mnist-path` and its siblings point the
configuration at the files.  The classifier gate (`sampler.classifier`)
acts on the ancestral DDPM chain only.  The pipeline is
`factory.build_pipeline`'s, its weights a slim npz (the JAX script's Orbax
milestones wait for the exporter).  A seg
detector without a checkpoint gives way to the ground-truth masks, one
image a batch, as in the JAX script (so does a PatchCore detector with
`sampler.ood_ad` off, which has no front end).  Each
batch's noise is seeded from 10 (`pipeline.batch_noise`).  With
`--save-prefix` the stacks are written as `{prefix}hr_all.npy` and so on,
`fusion_time.npy` among them (the JAX script also writes that one into the
working directory; this one writes nothing outside the prefix).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from localdiffusion_tpu_torch.config import CONFIG_HELP, load_config
from localdiffusion_tpu_torch.data import datasets
from localdiffusion_tpu_torch.factory import build_pipeline
from localdiffusion_tpu_torch.ood.features import seg_checkpoint
from localdiffusion_tpu_torch.pipeline import batch_noise

NOISE_SEED = 10  # the JAX script's PRNGKey(10)


def add_config_args(ap, config_default: str = "mri256") -> None:
    """The configuration, its weights and the overrides `configure` applies,
    as options of a command line (`--config` required where
    `config_default` is None)."""
    ap.add_argument("--config", default=config_default, required=config_default is None,
                    help=CONFIG_HELP)
    ap.add_argument("--detector", default=None, choices=["patchcore", "seg", "manual", "none"],
                    help="override ood.detector")
    ap.add_argument("--params-npz", required=True, help="the denoiser's slim npz snapshot")
    ap.add_argument("--mask-dilate", type=int, default=None, help="override ood.mask_dilate")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                    help="override train.compute_dtype")
    ap.add_argument("--feature-source", default=None, choices=["wrn", "seg_encoder", "denoiser"],
                    help="override ood.feature_source")
    ap.add_argument("--feature-npz", default=None,
                    help="the denoiser source's snapshot (default --params-npz)")
    ap.add_argument("--feature-t", type=int, default=None, help="override ood.feature_t")
    ap.add_argument("--memory-bank", default=None,
                    help="override ood.memory_bank_path (its ladder is found beside it)")
    datasets.add_data_args(ap)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_args(ap)
    ap.add_argument("--max-images", type=int, default=100)
    ap.add_argument("--save-prefix", default=None,
                    help="write hr_all/lr_all/pred_all/ad_masks/fusion_time .npy with this prefix")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def configure(args):
    """The configuration with the command line's overrides, as the JAX
    script applies them."""
    cfg = datasets.with_data_paths(load_config(args.config), args)
    if args.dtype:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=args.dtype))
    over = {}
    if args.detector:
        over["detector"] = args.detector
    if args.mask_dilate is not None:
        over["mask_dilate"] = args.mask_dilate
    if args.feature_source:
        over["feature_source"] = args.feature_source
        if args.feature_source == "denoiser":
            over["feature_npz"] = args.feature_npz or args.params_npz
    if args.feature_t is not None:
        over["feature_t"] = args.feature_t
    if args.memory_bank is not None:
        over.update(memory_bank_path=args.memory_bank, ladder_path=None)
    return cfg.replace(ood=dataclasses.replace(cfg.ood, **over)) if over else cfg


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = configure(args)
    hr, lr, seg = datasets.test_arrays(cfg, args.max_images)
    # no front end (as the JAX factory builds none) and ground truth to hand
    det = cfg.ood.detector
    no_frontend = ((det == "seg" and not os.path.exists(seg_checkpoint(cfg.ood.seg_model_path)))
                   or (det == "patchcore" and not cfg.sampler.ood_ad))
    gt_masks_only = seg is not None and no_frontend
    if gt_masks_only:
        print("no front end: using the ground-truth seg masks")
        cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, detector="manual"))
    # the ROC calibration pairs where no threshold is configured: the JAX
    # script's, ground truth labelled 1 and conditioning images 0
    cal_pairs = ([(hr[i:i + 1], 1) for i in range(min(8, len(hr)))]
                 + [(lr[i:i + 1], 0) for i in range(min(8, len(lr)))])
    pipe = build_pipeline(cfg, args.params_npz, calibration_images=lr[:16],
                          calibration_pairs=cal_pairs, device=args.device)
    cfg = pipe.config
    if cfg.sampler.classifier and pipe.gd.is_ddim_sampling:
        print("NOTE: the classifier gate applies to the ancestral DDPM chain only; DDIM "
              "ignores it")

    if gt_masks_only:
        losses, times, region = [], [], []
        for i in range(len(hr)):
            m = (seg[i:i + 1] > 0).astype(np.float32)
            noise, _ = batch_noise(NOISE_SEED, i)
            r = pipe.translate(lr[i:i + 1], hr=hr[i:i + 1], noise=noise, mask=m, gt_region=m)
            losses.append(float(r["mse"]))
            times.append(float(r["time"]))
            region.append(float(r["mse_ood_region"]))
            print(f"[{i}] mse={losses[-1]:.5f} mse_ood={region[-1]:.5f} "
                  f"time={times[-1]:.3f}s branched={bool(r['branched'])}")
        out = {"mean_mse": np.asarray(np.mean(losses)),
               "mean_mse_ood_region": np.asarray(np.mean(region)),
               "mean_time": np.asarray(np.mean(times[1:] if len(times) > 1 else times))}
        print(f"Test loss: {float(out['mean_mse']):.4f}")
        print(f"OOD-region loss: {float(out['mean_mse_ood_region']):.4f}")
        print(f"Average sampling time: {float(out['mean_time']):.4f}")
        return out
    pairs = [(hr[i:i + 1], lr[i:i + 1]) for i in range(len(hr))]
    gt_masks = None if seg is None else [seg[i:i + 1] for i in range(len(hr))]
    out = pipe.run(pairs, noise=NOISE_SEED, save_prefix=args.save_prefix, gt_masks=gt_masks)
    if cfg.sampler.classifier:
        print(f"fusion_time (acceptance t per image): {out['fusion_time'].tolist()}")
    print(f"Test loss: {float(out['mean_mse']):.4f}")
    return out


if __name__ == "__main__":
    main()
