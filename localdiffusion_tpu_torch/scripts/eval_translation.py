"""Classify translated digits with the SimpleCNN classifier.  Port of
`scripts/eval_translation.py`.

    python -m localdiffusion_tpu_torch.scripts.eval_translation \
        --pred <prefix>pred_all.npy --cls results/mnist_cls/best.npz \
        [--target-digit 3] [--source-digit 8] [--device cpu]

Is an 8→3 translation still recognized as a 3?  The saved pipeline outputs
(`pred_all.npy`, [N, H, W, C] in [0, 2], the range the classifier was
trained on) are classified, and the shares of the target digit and of the
source digit (hallucinated structure) and the class histogram printed.
`--cls` is the slim npz `train_mnist_cls` writes (the JAX script reads an
Orbax directory).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from localdiffusion_tpu_torch.models.simple_cnn import SimpleCNN
from localdiffusion_tpu_torch.utils.params_io import load_params_npz


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pred", required=True)
    ap.add_argument("--cls", default="results/mnist_cls/best.npz")
    ap.add_argument("--target-digit", type=int, default=3)
    ap.add_argument("--source-digit", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    preds = np.load(args.pred)
    model = SimpleCNN()
    model.load_state_dict(load_params_npz(args.cls, model))
    model = model.to(args.device).eval()
    with torch.no_grad():
        logits = model(torch.as_tensor(np.asarray(preds, np.float32), device=args.device))
    cls = logits.argmax(-1).cpu().numpy()
    n = len(cls)
    frac_target = float((cls == args.target_digit).mean())
    frac_source = float((cls == args.source_digit).mean())
    print(f"{n} translated images")
    print(f"classified as target digit {args.target_digit}: {frac_target:.1%}")
    print(f"classified as source digit {args.source_digit} (hallucinated "
          f"structure): {frac_source:.1%}")
    hist = {int(d): int((cls == d).sum()) for d in np.unique(cls)}
    print("class histogram:", hist)
    return dict(classes=cls, frac_target=frac_target, frac_source=frac_source, hist=hist)


if __name__ == "__main__":
    main()
