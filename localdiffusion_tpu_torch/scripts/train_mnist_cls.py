"""Train the MNIST evaluation classifier (SimpleCNN).  Port of
`scripts/train_mnist_cls.py`.

    python -m localdiffusion_tpu_torch.scripts.train_mnist_cls [--epochs 10] \
        [--batch 128] [--out results/mnist_cls/best.npz] \
        [--mnist-path MNIST/raw/t10k-images-idx3-ubyte] \
        [--mnist-labels-path MNIST/raw/t10k-labels-idx1-ubyte] [--device cpu]

The MNIST t10k idx files (raw or .gz), or without them the synthetic digits
(`synthetic_digits(2048, seed=0)`, printed), normalized to [0, 2]; the
first 90% train, the rest test.  Cross-entropy, Adam 1e-3 (optax's
defaults: β = (0.9, 0.999), eps 1e-8), batches of `ArrayLoader(seed=42)`.
After each epoch the test accuracy; the best epoch's weights are written as
a slim npz (`utils.params_io.save_params_npz`; the JAX script writes an
Orbax directory), and `cls_loss.csv` (epoch, loss, test_acc) beside it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from localdiffusion_tpu_torch.data import (
    ArrayLoader,
    MNISTDataset,
    load_mnist_arrays,
    synthetic_digits,
)
from localdiffusion_tpu_torch.models.simple_cnn import SimpleCNN
from localdiffusion_tpu_torch.train.trainer import optax_adam
from localdiffusion_tpu_torch.utils.logging import CsvLogger
from localdiffusion_tpu_torch.utils.params_io import save_params_npz
from localdiffusion_tpu_torch.utils.precision import full_float32

LR = 1e-3  # optax.adam(1e-3), as the JAX script


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default="results/mnist_cls/best.npz")
    ap.add_argument("--mnist-path", default="MNIST/raw/t10k-images-idx3-ubyte")
    ap.add_argument("--mnist-labels-path", default="MNIST/raw/t10k-labels-idx1-ubyte")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def digits(images_path: str, labels_path: str):
    """(hr [N, 28, 28, 1] in [0, 2], labels [N]) of the idx files, or of the
    synthetic digits without them."""
    try:
        imgs, labels = load_mnist_arrays(images_path, labels_path)
    except (FileNotFoundError, OSError):
        print(f"no MNIST idx files at {images_path}: using synthetic digits")
        imgs, labels = synthetic_digits(2048, seed=0)
    hr, _, y = MNISTDataset(imgs, labels).as_arrays()
    return hr, y


def train_step(model, opt, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One Adam step on the batch's mean cross-entropy; returns the loss
    (a device scalar)."""
    opt.zero_grad(set_to_none=True)
    with full_float32():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def accuracy(model, x: torch.Tensor, y: torch.Tensor) -> float:
    return float((model(x).argmax(-1) == y).float().mean())


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    hr, y = digits(args.mnist_path, args.mnist_labels_path)
    split = int(0.9 * len(hr))
    xtr, ytr = hr[:split], y[:split]
    xte = torch.as_tensor(hr[split:], device=dev)
    yte = torch.as_tensor(y[split:], device=dev)

    with torch.random.fork_rng(devices=[]):  # seeded weights, the process's stream untouched
        torch.manual_seed(0)
        model = SimpleCNN().to(dev)
    opt = optax_adam(model.parameters(), LR)
    dl = ArrayLoader(xtr, ytr, batch_size=args.batch, seed=42)
    out_dir = os.path.dirname(args.out) or "."
    csv = os.path.join(out_dir, "cls_loss.csv")
    if os.path.exists(csv):  # one run's log, as the JAX script writes it
        os.remove(csv)
    log = CsvLogger(csv, ["epoch", "loss", "test_acc"])
    best, logs = 0.0, []
    try:
        for epoch in range(args.epochs):
            losses = [train_step(model, opt, torch.as_tensor(x, device=dev),
                                 torch.as_tensor(yb, device=dev))
                      for x, yb in dl.epoch_batches(epoch)]
            loss = float(torch.stack(losses).double().mean())
            a = accuracy(model, xte, yte)
            logs.append((epoch, loss, a))
            log.log(epoch=epoch, loss=loss, test_acc=a)
            print(f"epoch {epoch}: loss {loss:.4f} test acc {a:.4f}")
            if a > best:
                best = a
                os.makedirs(out_dir, exist_ok=True)
                save_params_npz(args.out, model.state_dict())
    finally:
        log.close()
    print(f"best acc {best:.4f}")
    return dict(logs=logs, best=best, out=args.out)


if __name__ == "__main__":
    main()
