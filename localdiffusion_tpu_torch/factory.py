"""Stage A's construction: configuration → OOD front end.  Port of
`build_frontend` in `localdiffusion_tpu/factory.py` (the engine's
`build_gd` lives in `diffusion/gaussian.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from localdiffusion_tpu_torch.config import Config
from localdiffusion_tpu_torch.ood.frontend import OODFrontend


def ladder_beside(bank_path: str) -> str:
    """Where a bank's fitted ladder is saved: `<bank>_ladder.json`."""
    return os.path.splitext(bank_path)[0] + "_ladder.json"


def build_frontend(cfg: Config, gd=None, calibration_images=None, device="cuda",
                   verbose: bool = True) -> Tuple[Optional[OODFrontend], Config]:
    """The Stage A front end of `cfg.ood.detector`, and `cfg`, which gains
    the ladder found beside the memory bank when it names none.

    'none' and 'manual' need nothing.  'patchcore' (with `sampler.ood_ad`)
    builds the feature source (the denoiser `gd`, e.g. the pipeline's own;
    without one a denoiser on `device` with `ood.feature_npz`'s weights)
    and loads `ood.memory_bank_path`; without a bank it builds one from
    `calibration_images` (normal conditioning images), and without those it
    raises.  With `ood_ad` off there is no Stage A: the front end is None.
    'seg' is a later slice of the port.
    """
    det = cfg.ood.detector
    if det in ("none", "manual"):
        return OODFrontend(cfg), cfg
    if det == "seg":
        raise NotImplementedError("the seg detector is a later slice of the port "
                                  "(ROADMAP queue 1)")
    if not cfg.sampler.ood_ad:
        return None, cfg
    from localdiffusion_tpu_torch.ood.features import make_feature_source
    from localdiffusion_tpu_torch.ood.patchcore import PatchCore

    bank = None
    path = cfg.ood.memory_bank_path
    if path and os.path.exists(path):
        bank = np.load(path)
        if verbose:
            print(f"loaded memory bank {path} {bank.shape}")
        lad = ladder_beside(path)
        if not cfg.ood.ladder_path and os.path.exists(lad):
            # the ladder saved beside the bank: a rebuilt bank never pairs
            # with a stale ladder named in the configuration
            cfg = cfg.replace(ood=dataclasses.replace(cfg.ood, ladder_path=lad))
            if verbose:
                print(f"using fitted threshold ladder {lad}")
    source = make_feature_source(cfg, denoiser=gd, device=device, verbose=verbose)
    pc = PatchCore(cfg.ood, source=source, memory_bank=bank)
    frontend = OODFrontend(cfg, patchcore=pc)
    if bank is None:
        if calibration_images is None:
            raise ValueError(
                f"patchcore detector has no memory bank ({path!r}) and no "
                "calibration_images to build one: build one with "
                "`python -m localdiffusion_tpu_torch.ood.bank`")
        if verbose:
            print("no memory bank: building one from the calibration images")
        pc.build_memory_bank([frontend._preprocess_patchcore(calibration_images)])
    return frontend, cfg
