"""The classifier-gated phase B end to end at 256px.  Port of
`scripts/eval_gated_quality.py`.

    python -m localdiffusion_tpu_torch.scripts.eval_gated_quality --dtype float32 \
        --images 16 --batch 4 --out gated_quality.json

A PatchCore classifier over target-domain (FLAIR) normal images, with the
configured feature source (the trained denoiser's taps), ROC-calibrated on
labelled images; it gates each post-fusion x_start of the ancestral chain
(a rejected sample is re-fused from the saved branch pair).  The run builds
the classifier's bank (`--bank-normals` normal FLAIR targets, a
`--bank-ratio` coreset) on the device under `--work-dir`, reusing it when
it is there unless `--rebuild-bank`, as the JAX script does; builds Stage
A's detector bank (`--bank-images` normal brains, with its ladder) there
on every run, since the JAX script's is the shipped one and another run
(`eval_margins` on the same work dir) may have left a bank of that name
from other weights or another precision; calibrates on `--calib`
images a class (`ood.bank.classifier_calibration_pairs`: for 'suppress',
normal FLAIR against FLAIR with an injected lesion of peak
`--lesion-amp`); then samples the same tumour brains, masks and noise
ungated and gated.  Batch b samples with the seed `batch_seed(--seed, b)`
in both, the gated chain's retries with the stream derived from it.

Outputs, in the JAX script's JSON layout with the device added: the
threshold and its balanced accuracy, each sample's `fusion_time` (its
acceptance step), the samples accepted at the first gated step and those
rejected at least once, the mean acceptance step, and gated − ungated.
`--dtype float32` runs the configuration file's precision, which the JAX
record was measured in (`mri256_gated_config()` is bf16).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from localdiffusion_tpu_torch.config import CONFIG_HELP, load_config
from localdiffusion_tpu_torch.factory import (
    build_classifier_gate,
    build_frontend,
    classifier_bank_beside,
    denoiser_for_taps,
    load_params,
)
from localdiffusion_tpu_torch.ood.bank import (
    brains,
    build_bank,
    build_classifier_bank,
    classifier_calibration_pairs,
)
from localdiffusion_tpu_torch.ood.classifier import ClassifierPatchCore, balanced_accuracy
from localdiffusion_tpu_torch.ood.features import make_feature_source
from localdiffusion_tpu_torch.ood.patchcore import PatchCore
from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline, batch_noise
from localdiffusion_tpu_torch.scripts.eval_margins import device_record, per_image_mse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mri256_gated", help=CONFIG_HELP)
    ap.add_argument("--params-npz", default="results/mri_synth256_ema.npz")
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--bank-normals", type=int, default=64,
                    help="normal FLAIR images of the classifier's bank")
    ap.add_argument("--bank-ratio", type=float, default=0.05,
                    help="the classifier bank's coreset ratio")
    ap.add_argument("--calib", type=int, default=32,
                    help="calibration images a class for the ROC sweep")
    ap.add_argument("--bank-images", type=int, default=200,
                    help="normal brains of Stage A's detector bank")
    ap.add_argument("--rebuild-bank", action="store_true",
                    help="rebuild the classifier's bank even if the work dir holds one")
    ap.add_argument("--polarity", choices=["preserve", "suppress"], default=None,
                    help="override sampler.classifier_polarity")
    ap.add_argument("--lesion-amp", type=float, default=2.0,
                    help="peak of the injected calibration lesions (normalized units)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                    help="override train.compute_dtype")
    ap.add_argument("--work-dir", default="build/eval")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None, noise_for=None, gate_for=None) -> dict:
    """Run the evaluation; returns the JSON's contents.  `noise_for(b)`,
    when given, supplies batch b's noise (see `pipeline.batch_noise`; a
    (noise, retry_noise) pair for the gated chain) to both runs instead of
    the seed; `gate_for(gate)`, when given, replaces the calibrated gate in
    the gated run."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.dtype:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=args.dtype))
    if args.polarity:
        cfg = cfg.replace(sampler=dataclasses.replace(cfg.sampler,
                                                      classifier_polarity=args.polarity))
    if not cfg.sampler.classifier or cfg.data.name != "synthetic_brain":
        raise ValueError("the gated evaluation needs a classifier-gated synthetic_brain "
                         "configuration")
    polarity = cfg.sampler.classifier_polarity
    os.makedirs(args.work_dir, exist_ok=True)
    bank_path = os.path.join(args.work_dir, "memory_bank_denoiser.npy")
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, memory_bank_path=bank_path,
                                              ladder_path=None))
    gd = load_params(cfg, params_npz=args.params_npz, device=args.device)
    tap = denoiser_for_taps(cfg, gd, args.params_npz)
    if tap is None:
        tap = make_feature_source(cfg, device=args.device).gd

    # ---- the classifier's bank over normal FLAIR targets, its ROC threshold
    obj_path = classifier_bank_beside(bank_path, cfg)
    if args.rebuild_bank or not os.path.exists(obj_path):
        res = build_classifier_bank(cfg, obj_path, gd=tap, n_images=args.bank_normals,
                                    ratio=args.bank_ratio, device=args.device)
        print(f"classifier bank {obj_path} {res['bank'].shape} "
              f"(taps {res['seconds']['taps']:.1f}s, k-center {res['seconds']['kcenter']:.1f}s)",
              flush=True)
    mb = np.load(obj_path)
    source = make_feature_source(cfg, denoiser=tap, device=args.device)
    cls = ClassifierPatchCore(PatchCore(cfg.ood, source=source, memory_bank=mb))
    thr = cls.calibrate(classifier_calibration_pairs(cfg, n=args.calib,
                                                     lesion_amp=args.lesion_amp))
    labels, scores = cls.calibration
    acc = balanced_accuracy(labels, scores, thr)
    sc_n, sc_t = scores[labels == 1], scores[labels == 2]
    print(f"ROC threshold {thr:.4f}  normal scores {sc_n.mean():.3f}±{sc_n.std():.3f}  "
          f"tumor {sc_t.mean():.3f}±{sc_t.std():.3f}  balanced acc {acc:.3f}", flush=True)
    cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, classifier_threshold=float(thr)))

    # ---- the test set and Stage A's masks, shared by both runs
    n = args.images - args.images % args.batch or args.batch
    hr, lr, seg = brains(cfg, n, True, args.seed)
    gt = (seg > 0).astype(np.float32)
    res = build_bank(cfg, bank_path, gd=tap, n_images=args.bank_images, device=args.device)
    print(f"detector bank {bank_path} {res['bank'].shape}", flush=True)
    frontend, cfg = build_frontend(cfg, gd=tap, device=args.device)
    masks = np.concatenate([frontend.detect(lr[i:i + args.batch])[0]
                            for i in range(0, n, args.batch)])
    gate = build_classifier_gate(cfg, frontend, gd=tap, device=args.device)
    if gate_for is not None:
        gate = gate_for(gate)

    results = {"config": args.config, "n": n, "threshold": float(thr), "polarity": polarity,
               "balanced_acc": float(acc), "bank_rows": int(mb.shape[0]),
               **device_record(args.device), "variants": {}}

    def run(tag, pipe):
        mse_w, mse_o, ft = np.zeros(n), np.zeros(n), []
        t0 = time.perf_counter()
        for i in range(0, n, args.batch):
            sl = slice(i, i + args.batch)
            noise, retry = batch_noise(noise_for if noise_for else args.seed, i // args.batch)
            r = pipe.translate(lr[sl], noise=noise, retry_noise=retry, mask=masks[sl])
            mse_w[sl], mse_o[sl] = per_image_mse(r["pred"], hr[sl], gt[sl])
            if "fusion_time" in r:
                ft.append(np.asarray(r["fusion_time"]).reshape(-1))
        dt = time.perf_counter() - t0
        row = {"whole_mse": float(mse_w.mean()), "ood_mse": float(mse_o.mean()),
               "wall_s": round(dt, 1),
               "per_image_whole": [round(float(x), 6) for x in mse_w],
               "per_image_ood": [round(float(x), 6) for x in mse_o]}
        if ft:
            ft = np.concatenate(ft)
            rejected = ft < int(cfg.sampler.start_timestep) - 1  # accepted after the first gated step
            row["fusion_time"] = ft.tolist()
            row["accepted_first_step"] = int((~rejected).sum())
            row["rejected_at_least_once"] = int(rejected.sum())
            row["mean_accept_t"] = float(ft.mean())
        results["variants"][tag] = row
        print(f"[{tag}] whole {mse_w.mean():.4f} ood {mse_o.mean():.4f} ({dt:.0f}s)"
              + (f" fusion_t {sorted(set(ft.tolist()))}" if len(ft) else ""), flush=True)
        return mse_w, mse_o

    cfg_un = cfg.replace(sampler=dataclasses.replace(cfg.sampler, classifier=False))
    uw, uo = run("ungated", LocalDiffusionPipeline(cfg_un, gd))
    gw, go = run("gated", LocalDiffusionPipeline(cfg, gd, classifier_gate=gate))
    dw, do = gw - uw, go - uo
    results["gated_minus_ungated"] = {
        "whole_delta": float(dw.mean()), "ood_delta": float(do.mean()),
        "ood_delta_pct": round(100.0 * float(do.mean()) / float(uo.mean()), 2),
    }
    print(f"gated − ungated: whole Δ {dw.mean():+.4f} ood Δ {do.mean():+.4f} "
          f"({results['gated_minus_ungated']['ood_delta_pct']:+.1f}%)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"saved {args.out}")
    return results


if __name__ == "__main__":
    main()
