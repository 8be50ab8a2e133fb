"""Train the segmentation OOD detector (SegUNet).  Port of
`scripts/train_seg.py`.

    python -m localdiffusion_tpu_torch.scripts.train_seg [--epochs 20] [--batch 4] \
        [--size 64] [--config mri256_bf16 | --raw] [--out results/seg/best_dice.npz] \
        [--device cpu]

Synthetic tumour brains: 64 to train (seed 0), 16 to validate (seed 1), the
t1 image normalized as the pipeline feeds the detector (`--config` names a
builder of `config.CONFIGS`, or a `.json`/`.yaml` file, whose `data`
statistics apply; without it
`synthetic_brain_translation`'s own), or raw-intensity t1 with `--raw`.
BCE with logits (positives weighted 10) + Dice (`models.seg_unet.
bce_dice_loss`), Adam 1e-3 (optax's defaults), batches of
`ArrayLoader(seed=42)`; after each epoch the validation Dice at a 0.5
threshold.  The best epoch's weights are written as a slim npz in the
shipped `seg256_params.npz` layout (`models.seg_unet.save_seg_npz`; the JAX
script writes an Orbax directory), which the seg detector and the
seg-encoder source read without conversion: the default `--out` is the
first of `ood.features.SEG_CANDIDATES`.  `val.csv` (epoch, loss, val_dice)
goes beside it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from localdiffusion_tpu_torch.config import load_config
from localdiffusion_tpu_torch.data import (
    ArrayLoader,
    synthetic_brain_pair,
    synthetic_brain_translation,
)
from localdiffusion_tpu_torch.models.seg_unet import SegUNet, bce_dice_loss, save_seg_npz
from localdiffusion_tpu_torch.ood.features import SEG_CANDIDATES
from localdiffusion_tpu_torch.train.trainer import optax_adam
from localdiffusion_tpu_torch.utils.logging import CsvLogger
from localdiffusion_tpu_torch.utils.precision import full_float32

LR = 1e-3  # optax.adam(1e-3), as the JAX script


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--out", default=SEG_CANDIDATES[0])
    ap.add_argument("--raw", action="store_true",
                    help="train on raw-intensity t1 instead of the pipeline-normalized "
                         "conditioning distribution")
    ap.add_argument("--config", default=None,
                    help="the configuration whose normalization statistics define the "
                         "training distribution (the detector must see what the front end "
                         "feeds it); default: synthetic_brain_translation's own")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def brains(size: int, raw: bool, config):
    """(t1, seg) to train and (t1, seg) to validate, seg binary."""
    if raw:
        t1, _, seg = synthetic_brain_pair(64, size=size, tumor=True, seed=0)
        t1v, _, segv = synthetic_brain_pair(16, size=size, tumor=True, seed=1)
    else:
        norm = {}
        if config:
            d = load_config(config).data
            norm = dict(mean_t1=d.mean_t1, std_t1=d.std_t1, mean_flair=d.mean_flair,
                        std_flair=d.std_flair)
        _, t1, seg = synthetic_brain_translation(64, size, tumor=True, seed=0, **norm)
        _, t1v, segv = synthetic_brain_translation(16, size, tumor=True, seed=1, **norm)
    return ((t1, (seg > 0).astype(np.float32)), (t1v, (segv > 0).astype(np.float32)))


def train_step(model, opt, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One Adam step on `bce_dice_loss`; returns the loss (a device scalar)."""
    opt.zero_grad(set_to_none=True)
    with full_float32():
        loss = bce_dice_loss(model(x), y)
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def val_dice(model, x: torch.Tensor, y: torch.Tensor) -> float:
    """Dice of the masks thresholded at probability 0.5 over the whole set."""
    with full_float32():
        pred = (torch.sigmoid(model(x)) > 0.5).float()
    num = 2 * (pred * y).sum()
    den = pred.sum() + y.sum()
    return float(num / den.clamp(min=1.0))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    (t1, seg), (t1v, segv) = brains(args.size, args.raw, args.config)
    xv, yv = torch.as_tensor(t1v, device=dev), torch.as_tensor(segv, device=dev)

    with torch.random.fork_rng(devices=[]):  # seeded weights, the process's stream untouched
        torch.manual_seed(0)
        model = SegUNet().to(dev)
    opt = optax_adam(model.parameters(), LR)
    dl = ArrayLoader(t1, seg, batch_size=args.batch, seed=42)
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    csv = os.path.join(out_dir, "val.csv")
    if os.path.exists(csv):  # one run's log, as the JAX script writes it
        os.remove(csv)
    log = CsvLogger(csv, ["epoch", "loss", "val_dice"])
    best, logs = -1.0, []
    try:
        for epoch in range(args.epochs):
            losses = [train_step(model, opt, torch.as_tensor(x, device=dev),
                                 torch.as_tensor(y, device=dev))
                      for x, y in dl.epoch_batches(epoch)]
            loss = float(torch.stack(losses).double().mean())
            d = val_dice(model, xv, yv)
            logs.append((epoch, loss, d))
            log.log(epoch=epoch, loss=loss, val_dice=d)
            print(f"epoch {epoch}: loss {loss:.4f} val dice {d:.4f}")
            if d > best:
                best = d
                save_seg_npz(args.out, model)
    finally:
        log.close()
    print(f"best dice {best:.4f}")
    return dict(logs=logs, best=best, out=args.out)


if __name__ == "__main__":
    main()
