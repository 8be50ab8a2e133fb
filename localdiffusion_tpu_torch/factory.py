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
import torch

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

    'none' and 'manual' need nothing.  'seg' loads the SegUNet of
    `ood.seg_model_path` (default: the JAX package's order,
    `features.load_seg_params`) onto `device`; without a checkpoint the
    front end is None, as in the JAX package (a caller may fall back to
    ground-truth masks).  'patchcore' (with `sampler.ood_ad`) builds the
    feature source on `device` (`features.make_feature_source`: the WRN50-2
    by default, the denoiser `gd`, e.g. the pipeline's own, for
    'denoiser') and loads `ood.memory_bank_path`; without a bank it builds
    one from `calibration_images` (normal conditioning images), and without
    those it raises.  With `ood_ad` off there is no Stage A: the front end
    is None.
    """
    det = cfg.ood.detector
    if det in ("none", "manual"):
        return OODFrontend(cfg), cfg
    if det == "seg":
        from localdiffusion_tpu_torch.models.seg_unet import SegDetector
        from localdiffusion_tpu_torch.ood.features import build_seg_unet

        model, _ = build_seg_unet(cfg, device=device, verbose=verbose)
        if model is None:
            return None, cfg
        return OODFrontend(cfg, seg_apply=SegDetector(model)), cfg
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
    if bank is None and calibration_images is None:
        raise ValueError(
            f"patchcore detector has no memory bank ({path!r}) and no "
            "calibration_images to build one: build one with "
            "`python -m localdiffusion_tpu_torch.ood.bank`")
    source = make_feature_source(cfg, denoiser=gd, device=device, verbose=verbose)
    pc = PatchCore(cfg.ood, source=source, memory_bank=bank)
    frontend = OODFrontend(cfg, patchcore=pc)
    if bank is None:
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
    the front end's; failing that, the JAX package's last resort: a WRN50-2
    PatchCore on `device` (`ood.layers`, seeded or
    `ood.backbone_weights_path`'s weights) on the detector's bank
    (`ood.memory_bank_path`), or, with none there, on a bank built from the
    images of `calibration_pairs` (ImageNet-prepared by
    `classifier.preprocess_for_patchcore`).  Without
    `ood.classifier_threshold` the threshold is ROC-calibrated from
    `calibration_pairs`, (image [1, H, W, C], label) pairs with label 1 =
    anomalous (`ood.bank.classifier_calibration_pairs`)."""
    if not cfg.sampler.classifier:
        return None
    from localdiffusion_tpu_torch.ood.classifier import (
        ClassifierPatchCore,
        preprocess_for_patchcore,
    )
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
        bank = None
        path = cfg.ood.memory_bank_path
        if path and os.path.exists(path):
            bank = np.load(path)
            if verbose:
                print(f"classifier memory bank: {path} {bank.shape}")
        pc = PatchCore(cfg.ood, memory_bank=bank, device=device)
        if bank is None:
            if calibration_pairs is None:
                raise ValueError("the classifier gate has no memory bank and no "
                                 "calibration_pairs to build one")
            if verbose:
                print("classifier gate: a WRN50-2 bank from the calibration images")
            imgs = torch.cat([torch.as_tensor(np.asarray(b, np.float32))
                              for b, _ in calibration_pairs]).to(pc.device)
            pc.build_memory_bank([preprocess_for_patchcore(imgs, cfg.ood.input_size)])
    cls = ClassifierPatchCore(pc, threshold=cfg.ood.classifier_threshold)
    if cls.threshold is None:
        if calibration_pairs is None:
            raise ValueError("classifier_threshold unset and no calibration_pairs to "
                             "ROC-calibrate from")
        if verbose:
            print("calibrating the classifier threshold from the pairs")
        cls.calibrate(calibration_pairs)
    return cls.as_sampler_gate(polarity=cfg.sampler.classifier_polarity)
