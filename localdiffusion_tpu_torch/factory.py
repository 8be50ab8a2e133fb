"""Construction from a configuration: Stage A's OOD front end and the
classifier gate of the gated phase B.  Port of `build_frontend` and
`build_classifier_gate` in `localdiffusion_tpu/factory.py` (the engine's
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


def classifier_bank_beside(bank_path: str, cfg: Config) -> str:
    """Where the classifier's own bank lies: beside the detector's bank,
    named `memory_bank_{data.name}_{sampler.classifier_obj}.npy`."""
    return os.path.join(os.path.dirname(bank_path),
                        f"memory_bank_{cfg.data.name}_{cfg.sampler.classifier_obj}.npy")


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


def build_classifier_gate(cfg: Config, frontend=None, calibration_pairs=None, gd=None,
                          device="cuda", verbose: bool = True):
    """The classifier gate of the gated phase B (`ClassifierPatchCore
    .as_sampler_gate` with `sampler.classifier_polarity`), or None without
    `sampler.classifier`.

    Its PatchCore is, first, one over the classifier's own bank
    (`classifier_bank_beside(ood.memory_bank_path)`, built by `python -m
    localdiffusion_tpu_torch.ood.bank --classifier`) with the configured
    feature source (the denoiser `gd`, e.g. the pipeline's own; without one
    a denoiser on `device` with `ood.feature_npz`'s weights); failing that,
    the front end's.  The JAX package's last resort, a WRN50-2 PatchCore on
    the detector's bank, is a later slice of the port and raises.  Without
    `ood.classifier_threshold` the threshold is ROC-calibrated from
    `calibration_pairs`, (image [1, H, W, C], label) pairs with label 1 =
    anomalous (`ood.bank.classifier_calibration_pairs`)."""
    if not cfg.sampler.classifier:
        return None
    from localdiffusion_tpu_torch.ood.classifier import ClassifierPatchCore
    from localdiffusion_tpu_torch.ood.features import make_feature_source
    from localdiffusion_tpu_torch.ood.patchcore import PatchCore

    pc = None
    if cfg.ood.memory_bank_path:
        path = classifier_bank_beside(cfg.ood.memory_bank_path, cfg)
        if os.path.exists(path):
            bank = np.load(path)
            if verbose:
                print(f"classifier memory bank: {path} {bank.shape}")
            source = make_feature_source(cfg, denoiser=gd, device=device, verbose=verbose)
            pc = PatchCore(cfg.ood, source=source, memory_bank=bank)
    if pc is None and frontend is not None:
        pc = getattr(frontend, "patchcore", None)
    if pc is None:
        raise NotImplementedError(
            "the classifier gate has no bank of its own and no front-end PatchCore; its "
            "last resort, a WRN50-2 PatchCore on the detector's bank, is a later slice of "
            "the port (ROADMAP queue 1): build the classifier's bank with `python -m "
            "localdiffusion_tpu_torch.ood.bank --classifier`")
    cls = ClassifierPatchCore(pc, threshold=cfg.ood.classifier_threshold)
    if cls.threshold is None:
        if calibration_pairs is None:
            raise ValueError("classifier_threshold unset and no calibration_pairs to "
                             "ROC-calibrate from")
        if verbose:
            print("calibrating the classifier threshold from the pairs")
        cls.calibrate(calibration_pairs)
    return cls.as_sampler_gate(polarity=cfg.sampler.classifier_polarity)
