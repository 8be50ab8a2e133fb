"""MetaImage volumes (.mha/.mhd) to the .npy arrays the volume datasets
read.  Port of `scripts/convert_mha.py` (numpy only).

    python -m localdiffusion_tpu_torch.scripts.convert_mha \
        'BRATS/*/VSD.Brain*T1*.mha' --out-dir npy/ [--dtype float32]

Globs are expanded per argument (a path that matches no glob but exists is
taken as it is); each volume is written as `<out-dir>/<stem>.npy`.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from localdiffusion_tpu_torch.data.mha import load_mha


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("patterns", nargs="+", help=".mha paths or globs")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--dtype", default=None,
                    help="optional cast (e.g. float32) to shrink disk use")
    args = ap.parse_args(argv)

    files = []
    for pat in args.patterns:
        matched = sorted(glob.glob(pat))
        if not matched and os.path.exists(pat):
            matched = [pat]
        files.extend(matched)
    if not files:
        print("no .mha files matched", file=sys.stderr)
        sys.exit(1)

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for path in files:
        vol, header = load_mha(path)
        if args.dtype:
            vol = vol.astype(args.dtype)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_dir, stem + ".npy")
        np.save(out, vol)
        written.append(out)
        print(f"{path} -> {out}  shape={vol.shape} dtype={vol.dtype} "
              f"(ElementType={header.get('ElementType')})")
    return written


if __name__ == "__main__":
    main()
