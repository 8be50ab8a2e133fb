"""Convert a reference PyTorch checkpoint (`Trainer.save`'s .pt) into the
slim npz snapshots the port and the JAX package load.

    python -m localdiffusion_tpu_torch.scripts.convert_reference_ckpt model-10.pt \\
        --out results/ref --dim 32 --dim-mults 1,2,4 --full-attn 0,0,1 --mode mnist

The port of `scripts/convert_reference_ckpt.py`, with its flags: the UNet
and the EMA UNet of `{'step', 'model', 'opt', 'ema', 'scaler'}` are mapped
onto the params tree (`utils.reference_ckpt`) and written as
`<out>-params.npz` and `<out>-ema.npz` (float32, or float16 with `--f16`),
which `factory.load_params` reads; each tree is also loaded into the
port's UNet of the same configuration on the CPU, so a key left over or a
shape that does not fit raises before anything is written.
"""

from __future__ import annotations

import argparse

import numpy as np

from localdiffusion_tpu_torch.config import ModelConfig
from localdiffusion_tpu_torch.models.unet import UNet
from localdiffusion_tpu_torch.utils.params_io import params_from_jax
from localdiffusion_tpu_torch.utils.reference_ckpt import (
    load_reference_checkpoint,
    save_tree_npz,
)


def model_config(args) -> ModelConfig:
    """The UNet configuration the flags describe (the JAX CLI's rules)."""
    mults = tuple(int(v) for v in args.dim_mults.split(","))
    if args.full_attn is None:
        full_attn = tuple(i == len(mults) - 1 for i in range(len(mults)))
    else:
        full_attn = tuple(bool(int(v)) for v in args.full_attn.split(","))
    depth = "shallow" if args.mode in ("mnist", "mvtecSR") else "deep"
    return ModelConfig(dim=args.dim, dim_mults=mults, full_attn=full_attn,
                       channels=args.channels, cond_encoder_depth=depth)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="reference model-<milestone>.pt")
    ap.add_argument("--out", required=True, help="output prefix")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--dim-mults", default="1,2,4,8")
    ap.add_argument("--full-attn", default=None,
                    help="comma 0/1 per stage; default: last stage only")
    ap.add_argument("--mode", default="mri",
                    help="reference cond-encoder mode (mri|mnist|mvtec|mvtecSR)")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--f16", action="store_true",
                    help="store float16 (default float32 to preserve parity)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {'step', 'params', 'ema'}: the port's UNet state dicts
    (`ema` None without an EMA in the checkpoint)."""
    args = parse_args(argv)
    cfg = model_config(args)
    out = load_reference_checkpoint(args.checkpoint, cfg)
    unet = UNet(cfg)
    states = {name: params_from_jax(tree, unet)
              for name, tree in (("params", out["params"]), ("ema", out["ema_params"]))
              if tree is not None}
    dtype = np.float16 if args.f16 else np.float32
    save_tree_npz(f"{args.out}-params.npz", out["params"], dtype=dtype)
    print(f"wrote {args.out}-params.npz (step {out['step']})")
    if out["ema_params"] is not None:
        save_tree_npz(f"{args.out}-ema.npz", out["ema_params"], dtype=dtype)
        print(f"wrote {args.out}-ema.npz")
    return dict(step=out["step"], params=states["params"], ema=states.get("ema"))


if __name__ == "__main__":
    main()
