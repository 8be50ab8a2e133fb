#!/usr/bin/env python
"""Export the trained MNIST milestones (Orbax directories) as slim npz snapshots.

The PyTorch port reads slim npz snapshots only (flat `params/<module>/…/<leaf>`
keys, fp16; `localdiffusion_tpu/utils/params_io.py`) and imports neither JAX
nor Orbax.  This one-off exporter reads each milestone through the JAX
package, read-only, as its own scripts load it (`factory.load_params(...,
strict=True)`: the EMA params), and writes it with the JAX package's
`save_params_npz`:

    python scripts/export_orbax_npz.py [--out-dir results_torch] [--only NAME ...]

  mnist_x250_best10000.npz  results/mnist_x250/model-best10000, configs/mnist.yaml:
                            the flagship
  mnist_u150_best200.npz    results/mnist_u150/model-best200, the same configuration
                            with project_name mnist_u150: the hallucination-prone model

The port then loads either through `factory.load_params(params_npz=...)` on
`flagship_config()`.  Run from anywhere: paths resolve against the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = "configs/mnist.yaml"
# output name -> (project_name under results/, milestone)
EXPORTS = {
    "mnist_x250_best10000.npz": ("mnist_x250", "best10000"),
    "mnist_u150_best200.npz": ("mnist_u150", "best200"),
}


def export(name: str, out_dir: str) -> str:
    """Write EXPORTS[name]'s EMA params as `out_dir/name`; returns the path."""
    from scripts.train import load_config

    from localdiffusion_tpu import factory
    from localdiffusion_tpu.utils.params_io import save_params_npz

    project, milestone = EXPORTS[name]
    out = os.path.join(os.path.abspath(out_dir), name)
    cwd = os.getcwd()
    os.chdir(ROOT)  # the configuration's results_dir is relative to the repository
    try:
        cfg = load_config(CONFIG)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, project_name=project))
        params = factory.load_params(cfg, milestone=milestone, verbose=False, strict=True)
    finally:
        os.chdir(cwd)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_params_npz(out, params)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "results_torch"))
    ap.add_argument("--only", nargs="+", choices=sorted(EXPORTS), default=sorted(EXPORTS))
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in args.only:
        path = export(name, args.out_dir)
        project, milestone = EXPORTS[name]
        print(f"results/{project}/model-{milestone} -> {path} "
              f"({os.path.getsize(path) / 2**20:.2f} MiB)")


if __name__ == "__main__":
    main()
