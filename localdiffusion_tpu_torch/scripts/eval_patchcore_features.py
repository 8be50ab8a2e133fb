"""PatchCore feature sources compared: the mask IoU over independent refits.

    python -m localdiffusion_tpu_torch.scripts.eval_patchcore_features \\
        --config mri256 --sources wrn,denoiser \\
        --feature-npz results/mri_synth256_ema.npz --refits 5 --out /tmp/shootout.json

The port of `scripts/eval_patchcore_features.py`, with its flags and its
JSON.  Per feature source (`wrn`, `denoiser`, `seg_encoder`;
`ood/features.py`) and refit r: a memory bank and a self-calibrated
ladder from `--normals` normal synthetic brains (seed 100 + r, which
also seeds the coreset's projection and the WRN's weights), then detection
on `--tests` tumour brains (seed 1234, the same for every source and
refit), each binary mask scored against the ground-truth segmentation by
IoU: the raw mask, the dilated one, and each refinement of the sweep
(`--refine-seeds`, `--hi-fracs`, `--lo-fracs`, `--refine-dilate`).
`--config` names a builder of `config.CONFIGS` or a `.json`/`.yaml` file
(`config.load_config`); on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from localdiffusion_tpu_torch.config import CONFIG_HELP, load_config
from localdiffusion_tpu_torch.data.synthetic import synthetic_brain_translation
from localdiffusion_tpu_torch.diffusion.gaussian import resolve_device
from localdiffusion_tpu_torch.ood.features import make_feature_source
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.ood.thresholds import (
    dilate_with_backoff,
    fit_ladder,
    refine_masks,
    soft_mask_from_map,
)


def iou(binary: np.ndarray, gt: np.ndarray) -> float:
    inter = float((binary * gt).sum())
    union = float(((binary + gt) > 0).sum())
    return inter / max(union, 1.0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mri256", help=CONFIG_HELP)
    ap.add_argument("--sources", default="wrn,denoiser")
    ap.add_argument("--refits", type=int, default=5)
    ap.add_argument("--normals", type=int, default=48)
    ap.add_argument("--tests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ratio", type=float, default=0.1)
    ap.add_argument("--gate-q", type=float, default=0.95)
    ap.add_argument("--feature-npz", default=None)
    ap.add_argument("--feature-t", default=None,
                    help="tap timestep; comma list = multi-t ensemble")
    ap.add_argument("--feature-layers", default=None)
    ap.add_argument("--refine-seeds", default="fwhm",
                    help="comma list of refine seed modes (fwhm,ladder)")
    ap.add_argument("--hi-fracs", default="0.5", help="comma list of refine_hi_frac values")
    ap.add_argument("--lo-fracs", default="0.25", help="comma list of refine_lo_frac values")
    ap.add_argument("--min-area", type=int, default=0)
    ap.add_argument("--refine-dilate", default="0",
                    help="residual dilation applied AFTER refinement "
                         "(comma list sweeps several radii)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _brains(d, n, size, tumor, seed):
    return synthetic_brain_translation(n, size, tumor=tumor, seed=seed, mean_t1=d.mean_t1,
                                       std_t1=d.std_t1, mean_flair=d.mean_flair,
                                       std_flair=d.std_flair)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg0 = load_config(args.config)
    d = cfg0.data
    size = cfg0.diffusion.image_size
    if d.name != "synthetic_brain":
        raise ValueError("the IoU evaluation needs ground-truth masks (data.name synthetic_brain)")

    _, lr_t, seg = _brains(d, args.tests, size, True, 1234)
    gt = (seg > 0).astype(np.float32)

    results = {}
    for src_name in args.sources.split(","):
        over = {"feature_source": src_name, "detector": "patchcore"}
        if args.feature_npz:
            over["feature_npz"] = args.feature_npz
        if args.feature_t is not None:
            ts = [int(v) for v in str(args.feature_t).split(",")]
            over["feature_t"] = ts[0] if len(ts) == 1 else tuple(ts)
        if args.feature_layers:
            over["feature_layers"] = tuple(args.feature_layers.split(","))
        cfg = cfg0.replace(ood=dataclasses.replace(cfg0.ood, **over))
        dilate = None  # resolved from the instantiated source's strides

        per_refit = []
        for r in range(args.refits):
            seed = 100 + r
            _, lr_n, _ = _brains(d, args.normals, size, False, seed)
            source = make_feature_source(cfg, device=device, verbose=(r == 0),
                                         generator=torch.Generator().manual_seed(seed))
            pc = PatchCore(cfg.ood, source=source)
            if dilate is None:
                dilate = cfg.ood.resolved_mask_dilate(
                    size, strides=getattr(pc.source, "strides", None))
            fe = OODFrontend(cfg, patchcore=pc)
            batches = [fe._preprocess_patchcore(lr_n[i:i + args.batch])
                       for i in range(0, len(lr_n), args.batch)]
            pc.build_memory_bank(batches, sampling_ratio=args.ratio, seed=seed)
            normal_maps = [pc(b)["anomaly_map"].float().cpu().numpy() for b in batches]
            ladder = fit_ladder(normal_maps, gate_q=args.gate_q)
            amap = pc(fe._preprocess_patchcore(lr_t))["anomaly_map"].float().cpu().numpy()

            def score(binary):
                fired = [not bool((binary[i] == 1.0).all()) for i in range(len(lr_t))]
                ious = [iou(binary[i], gt[i]) if fired[i] else 0.0 for i in range(len(lr_t))]
                return float(np.mean(ious)), int(np.sum(fired))

            row = {}
            mask_raw, binary_raw = soft_mask_from_map(amap, ladder, dilate=0)
            row["iou"], row["iou_fired"] = score(binary_raw)
            _, binary_dil = soft_mask_from_map(amap, ladder, dilate=dilate)
            row["iou_dilated"], row["iou_dilated_fired"] = score(binary_dil)
            for seed_mode in args.refine_seeds.split(","):
                for hi in (float(v) for v in args.hi_fracs.split(",")):
                    for lo in (float(v) for v in args.lo_fracs.split(",")):
                        if lo > hi:
                            continue
                        m, b = refine_masks(amap, mask_raw, binary_raw, seed=seed_mode,
                                            hi_frac=hi, lo_frac=lo, min_area=args.min_area)
                        tag = f"iou_{seed_mode}_h{hi:g}_l{lo:g}"
                        row[tag], row[f"{tag}_fired"] = score(b)
                        for rd in (int(v) for v in str(args.refine_dilate).split(",")):
                            if rd <= 0:
                                continue
                            pairs = [dilate_with_backoff(m[i], b[i], rd) for i in range(len(b))]
                            row[f"{tag}_d{rd}"], _ = score(np.stack([p[1] for p in pairs]))
            per_refit.append(row)
            extras = " ".join(f"{k[4:]}={v:.3f}" for k, v in row.items()
                              if k.startswith("iou_") and not k.endswith("_fired")
                              and k != "iou_dilated")
            print(f"[{src_name}] refit {r}: iou={row['iou']:.3f} "
                  f"dilated={row['iou_dilated']:.3f} "
                  f"fired={row['iou_fired']}/{len(lr_t)} {extras}", flush=True)

        agg = {k: {"mean": float(np.mean([x[k] for x in per_refit])),
                   "std": float(np.std([x[k] for x in per_refit])),
                   "min": float(np.min([x[k] for x in per_refit]))}
               for k in per_refit[0] if k.startswith("iou") and not k.endswith("_fired")}
        results[src_name] = {"refits": per_refit, "agg": agg, "dilate": dilate}
        print(f"== {src_name}: IoU {agg['iou']['mean']:.3f}±{agg['iou']['std']:.3f} "
              f"(min {agg['iou']['min']:.3f}), dilated {agg['iou_dilated']['mean']:.3f}±"
              f"{agg['iou_dilated']['std']:.3f}", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"saved {args.out}")
    return results


if __name__ == "__main__":
    main()
