"""Branched against plain, with confidence intervals.  Port of
`scripts/eval_margins.py`.

N synthetic tumour brains (seed `--seed`) go through every detector variant's
mask, under DDPM and/or DDIM: per-image whole-image MSE and MSE over the
ground-truth OOD region, each mean with its Student-t 95% interval, and the
paired per-image deltas against the plain chain (the same image and the
same noise, so the difference is the branching's).

    python -m localdiffusion_tpu_torch.scripts.eval_margins --config mri256 \
        --params-npz results/mri_synth256_ema.npz --images 64 --batch 8 \
        --variants plain,denoiser --samplers ddpm --out margins.json

Variants: `plain` (uniform ones: the plain chain), `denoiser`, `wrn` and
`seg` (the detectors' masks), and the oracles `gt` (the ground-truth
region), `gtd` (it dilated by the configured residual dilation), `gte` (it
eroded by `--gte-radius`) and `gts` (`gtd` scaled to `--gts-scale`).  The
`denoiser` and `wrn` banks, with their ladders, are built on the device
under `--work-dir` from 200 normal brains (`ood.bank.build_bank`; the
denoiser's from the trained weights of `ood.feature_npz`): the JAX
package's banks of these names are not in the repo.  Batch b of every
variant samples with the seed `batch_seed(--seed, b)` (the JAX script
folds its key by the batch index), so the deltas are paired.  The JSON has
the JAX script's layout, with the device added.

Two departures from the JAX script: the result keys of a comma list of
snapshots are their file names without the directory, and names that
collide are told apart by their place in the list (`a#1/…`, `a#2/…`); and
the DDIM fallback for a configuration that samples every step is
min(50, T − 1) steps, not 50 whatever T.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from localdiffusion_tpu_torch.config import CONFIG_HELP, Config, load_config
from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
from localdiffusion_tpu_torch.factory import build_frontend, load_params
from localdiffusion_tpu_torch.ood.bank import brains, build_bank
from localdiffusion_tpu_torch.ood.features import make_feature_source
from localdiffusion_tpu_torch.ood.thresholds import dilate_mask, erode_mask
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_noise

VARIANTS = ("plain", "denoiser", "wrn", "seg", "gt", "gtd", "gte", "gts")


def mean_ci(xs) -> dict:
    """Mean, its two-sided 95% Student-t interval (None below two samples)
    and n, in float64."""
    from scipy import stats

    xs = np.asarray(xs, np.float64)
    n = len(xs)
    m = float(xs.mean())
    if n < 2:
        return {"mean": m, "ci95": None, "n": n}
    half = float(stats.t.ppf(0.975, n - 1) * xs.std(ddof=1) / np.sqrt(n))
    return {"mean": m, "ci95": [m - half, m + half], "n": n}


def per_image_mse(pred: np.ndarray, hr: np.ndarray, region: np.ndarray):
    """(whole-image MSE [B], MSE over `region` [B]; a region of no pixel
    divides by 1)."""
    err = (np.asarray(pred, np.float32) - hr) ** 2
    b = err.shape[0]
    whole = err.reshape(b, -1).mean(1)
    ood = (err * region).reshape(b, -1).sum(1) / np.maximum(region.reshape(b, -1).sum(1), 1.0)
    return whole, ood


def device_record(device) -> dict:
    """The device a run used: the card's name and power limit as nvidia-smi
    gives them, or 'cpu'."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def result_prefixes(npz_list) -> list:
    """The result-key prefix of each snapshot: none for one; else its file
    name without the directory and extension, followed by '#k' (its place
    among the names that collide, from 1) where two names collide."""
    if len(npz_list) == 1:
        return [""]
    stems = [os.path.splitext(os.path.basename(p))[0] for p in npz_list]
    counts, seen, out = collections.Counter(stems), collections.Counter(), []
    for stem in stems:
        if counts[stem] > 1:
            seen[stem] += 1
            stem = f"{stem}#{seen[stem]}"
        out.append(stem + "/")
    return out


def ddim_steps(cfg: Config) -> int:
    """The DDIM chain's steps for `--samplers ddim`: the configuration's,
    or min(50, T − 1) where it samples every step."""
    t = cfg.diffusion.timesteps
    st = cfg.diffusion.sampling_timesteps
    if not st or st >= t:
        st = min(50, t - 1)
    if st < 1:
        raise ValueError(f"T={t}: no DDIM chain is shorter than the ancestral one")
    return st


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mri256", help=CONFIG_HELP)
    ap.add_argument("--frontend-config", default=None,
                    help="build the detectors from this configuration instead (a builder "
                         "name or a .json/.yaml file)")
    ap.add_argument("--params-npz", required=True,
                    help="Stage B's snapshot; a comma list runs each, its result keys "
                         "prefixed by its file name")
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=777,
                    help="the test set's seed and the noise's")
    ap.add_argument("--variants", default="plain,denoiser,gt",
                    help="comma list of " + "|".join(VARIANTS))
    ap.add_argument("--samplers", default="ddim", help="comma list of ddim|ddpm")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    ap.add_argument("--mask-refine", default=None, help="override ood.mask_refine")
    ap.add_argument("--refine-lo-frac", type=float, default=None)
    ap.add_argument("--refine-dilate", type=int, default=None,
                    help="ood.mask_dilate for the refined path")
    ap.add_argument("--mask-dilate", type=int, default=None)
    ap.add_argument("--gts-scale", type=float, default=0.5)
    ap.add_argument("--gte-radius", type=int, default=4)
    ap.add_argument("--save-masks", default=None,
                    help="npz path: every variant's masks and the ground-truth region")
    ap.add_argument("--work-dir", default="build/eval",
                    help="where the detectors' banks and ladders are built")
    ap.add_argument("--bank-images", type=int, default=200,
                    help="normal brains of a detector bank")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def _dilation(args, cfg_fe: Config) -> int:
    if args.refine_dilate is not None:
        return args.refine_dilate
    return args.mask_dilate if args.mask_dilate is not None else cfg_fe.ood.mask_dilate


def detector_config(args, cfg_fe: Config, variant: str) -> Config:
    over = {}
    if variant == "denoiser":
        over = {"detector": "patchcore", "feature_source": "denoiser"}
    elif variant == "wrn":
        over = {"detector": "patchcore", "feature_source": "wrn"}
    elif variant == "seg":
        over = {"detector": "seg"}
    if variant in ("denoiser", "wrn"):
        over.update(memory_bank_path=os.path.join(args.work_dir, f"memory_bank_{variant}.npy"),
                    ladder_path=None)
    if args.mask_refine is not None:
        over["mask_refine"] = args.mask_refine
    if args.refine_lo_frac is not None:
        over["refine_lo_frac"] = args.refine_lo_frac
    if args.refine_dilate is not None:
        over["mask_dilate"] = args.refine_dilate
    elif args.mask_dilate is not None:
        over["mask_dilate"] = args.mask_dilate
    return cfg_fe.replace(ood=dataclasses.replace(cfg_fe.ood, **over))


def detector_masks(args, cfg_fe: Config, variant: str, lr: np.ndarray) -> np.ndarray:
    """A detector's masks of `lr`, `args.batch` images a detect; a
    PatchCore detector's bank and ladder built first under the work dir."""
    cfg_v = detector_config(args, cfg_fe, variant)
    if variant in ("denoiser", "wrn"):
        os.makedirs(args.work_dir, exist_ok=True)
        source = make_feature_source(cfg_v, device=args.device) if variant == "denoiser" else None
        res = build_bank(cfg_v, cfg_v.ood.memory_bank_path, n_images=args.bank_images,
                         gd=source.gd if source else None, device=args.device)
        secs = ", ".join(f"{k} {v:.1f}s" for k, v in res["seconds"].items())
        print(f"[{variant}] bank {res['bank'].shape} ({secs})", flush=True)
        fe, _ = build_frontend(cfg_v, gd=source.gd if source else None, device=args.device)
    else:
        fe, _ = build_frontend(cfg_v, device=args.device)
    if fe is None:
        raise SystemExit(f"variant {variant}: no front end (a missing checkpoint?)")
    return np.concatenate([fe.detect(lr[i:i + args.batch])[0]
                           for i in range(0, len(lr), args.batch)])


def variant_masks(args, cfg_fe: Config, variant: str, lr, gt_region) -> np.ndarray:
    n = len(lr)
    if variant == "plain":
        return np.ones_like(gt_region)
    if variant == "gt":
        return gt_region.copy()
    if variant == "gtd":
        rad = max(int(_dilation(args, cfg_fe)), 0)
        return np.stack([dilate_mask(gt_region[i], rad) for i in range(n)])
    if variant == "gte":
        return np.stack([erode_mask(gt_region[i], max(int(args.gte_radius), 0)) for i in range(n)])
    if variant == "gts":
        rad = max(int(_dilation(args, cfg_fe)), 0)
        return args.gts_scale * np.stack([dilate_mask(gt_region[i], rad) for i in range(n)])
    if variant in ("denoiser", "wrn", "seg"):
        return detector_masks(args, cfg_fe, variant, lr)
    raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")


def main(argv=None, noise_for=None) -> dict:
    """Run the evaluation; returns the JSON's contents.  `noise_for(b,
    mask)`, when given, supplies batch b's noise for the given masks
    instead of the seed `batch_seed(--seed, b)`: a seed or a noise source
    (see `pipeline.batch_noise`)."""
    args = parse_args(argv)
    cfg0 = load_config(args.config)
    if args.dtype:
        cfg0 = cfg0.replace(train=dataclasses.replace(cfg0.train, compute_dtype=args.dtype))
    d, size = cfg0.data, cfg0.diffusion.image_size
    if d.name != "synthetic_brain":
        raise ValueError("the margin evaluation needs ground-truth segmentations: "
                         "a synthetic_brain configuration")
    n = args.images - args.images % args.batch or args.batch
    hr, lr, seg = brains(cfg0, n, True, args.seed)
    gt_region = (seg > 0).astype(np.float32)
    gt_px = gt_region.reshape(n, -1).sum(1)
    print(f"test set: {n} tumor images @ {size}px, gt region {gt_px.mean():.0f}±"
          f"{gt_px.std():.0f} px", flush=True)

    cfg_fe = cfg0
    if args.frontend_config:
        cfg_fe = load_config(args.frontend_config)
        if args.dtype:
            cfg_fe = cfg_fe.replace(train=dataclasses.replace(cfg_fe.train,
                                                              compute_dtype=args.dtype))
    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    masks = {}
    for v in variants:
        masks[v] = variant_masks(args, cfg_fe, v, lr, gt_region)
        fired = sum(not bool((masks[v][i] == 1.0).all()) for i in range(n))
        print(f"[{v}] masks ready: fired {fired}/{n}", flush=True)
    if args.save_masks:
        np.savez_compressed(args.save_masks, gt=gt_region,
                            **{f"mask_{v}": masks[v] for v in variants})
        print(f"saved masks {args.save_masks}", flush=True)

    npz_list = [p.strip() for p in args.params_npz.split(",") if p.strip()]
    results = {"n": n, "size": size, "config": args.config, "params_npz": args.params_npz,
               **device_record(args.device), "variants": {}}
    for sampler in [s.strip() for s in args.samplers.split(",") if s.strip()]:
        if sampler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown sampler {sampler!r}: ddpm or ddim")
        st = None if sampler == "ddpm" else ddim_steps(cfg0)
        cfg_s = cfg0.replace(diffusion=dataclasses.replace(cfg0.diffusion,
                                                           sampling_timesteps=st))
        gd = build_gd(cfg_s, device=args.device)
        for npz, ck in zip(npz_list, result_prefixes(npz_list)):
            load_params(cfg_s, gd, params_npz=npz)
            pipe = LocalDiffusionPipeline(cfg_s, gd)
            per_variant = {}
            for v in variants:
                mse_whole, mse_ood = np.zeros(n), np.zeros(n)
                t0 = time.perf_counter()
                for i in range(0, n, args.batch):
                    sl = slice(i, i + args.batch)
                    b = i // args.batch
                    noise, _ = batch_noise(
                        (lambda _: noise_for(b, masks[v][sl])) if noise_for else args.seed, b)
                    r = pipe.translate(lr[sl], noise=noise, mask=masks[v][sl])
                    mse_whole[sl], mse_ood[sl] = per_image_mse(r["pred"], hr[sl], gt_region[sl])
                dt = time.perf_counter() - t0
                per_variant[v] = (mse_whole, mse_ood)
                key = f"{ck}{sampler}/{v}"
                results["variants"][key] = {
                    "whole": mean_ci(mse_whole),
                    "ood_region": mean_ci(mse_ood),
                    "wall_s": round(dt, 2),
                    "per_image_whole": [round(float(x), 6) for x in mse_whole],
                    "per_image_ood": [round(float(x), 6) for x in mse_ood],
                }
                w, o = results["variants"][key]["whole"], results["variants"][key]["ood_region"]
                print(f"[{key}] whole {w['mean']:.4f} ood {o['mean']:.4f} ({dt:.0f}s)",
                      flush=True)
            if "plain" not in per_variant:
                continue
            pw, po = per_variant["plain"]
            for v in variants:
                if v == "plain":
                    continue
                vw, vo = per_variant[v]
                dkey = f"{ck}{sampler}/{v}_minus_plain"
                results["variants"][dkey] = {
                    "whole_delta": mean_ci(vw - pw),
                    "ood_delta": mean_ci(vo - po),
                    "ood_delta_pct": round(100.0 * float((vo - po).mean()) / float(po.mean()), 2),
                }
                od = results["variants"][dkey]["ood_delta"]
                lo, hi = od["ci95"] if od["ci95"] else (float("nan"), float("nan"))
                tag = ("SIGNIFICANT (better)" if hi < 0.0 else
                       "SIGNIFICANT (worse)" if lo > 0.0 else "ns")
                print(f"[{dkey}] ood Δ {od['mean']:+.4f} CI [{lo:+.4f}, {hi:+.4f}] "
                      f"({results['variants'][dkey]['ood_delta_pct']:+.1f}%) {tag}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"saved {args.out}")
    return results


if __name__ == "__main__":
    main()
