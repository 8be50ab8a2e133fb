"""Construction from a configuration: the denoiser's trained weights,
Stage A's OOD front end, the classifier gate of the gated phase B and the
whole pipeline.  Port of `load_params`, `build_frontend`,
`build_classifier_gate` and `build_pipeline` in
`localdiffusion_tpu/factory.py` (the engine's `build_gd` lives in
`diffusion/gaussian.py`).
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from localdiffusion_tpu_torch.config import Config
from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion, build_gd
from localdiffusion_tpu_torch.ood.frontend import OODFrontend
from localdiffusion_tpu_torch.utils.params_io import load_params_npz

EXPORTER = ("the Orbax→npz exporter, `scripts/export_orbax_npz.py`, writes such a checkpoint "
            "as a slim npz (results_torch/ holds the MNIST milestones'): pass that as "
            "params_npz")


def load_params(cfg: Config, gd: Optional[GaussianDiffusion] = None, *, params_npz: str,
                device="cuda", verbose: bool = True) -> GaussianDiffusion:
    """The trained weights of a slim npz snapshot (`utils.params_io`, every
    key consumed) loaded into `gd` (default: `build_gd(cfg, device)`), which
    is returned.

    The port reads the npz route only: given an Orbax directory (the JAX
    package's milestones) it raises and names the exporter, and a missing
    or corrupt file raises.  The JAX package's random-init last resort is
    not carried: a pipeline never runs on weights nobody trained."""
    if os.path.isdir(params_npz):
        raise NotImplementedError(f"{params_npz} is an Orbax checkpoint directory, which the "
                                  f"port does not read; {EXPORTER}")
    if not os.path.exists(params_npz):
        raise FileNotFoundError(f"params snapshot {params_npz} does not exist")
    gd = gd if gd is not None else build_gd(cfg, device=device)
    try:
        state = load_params_npz(params_npz, gd.model)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise RuntimeError(f"params snapshot {params_npz} could not be read: {e}") from e
    gd.model.load_state_dict(state)
    if verbose:
        print(f"loaded params snapshot {params_npz}")
    return gd


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


def denoiser_for_taps(cfg: Config, gd: GaussianDiffusion,
                      params_npz: str) -> Optional[GaussianDiffusion]:
    """The denoiser a denoiser feature source or gate taps: `gd` (holding
    `params_npz`'s weights) unless `ood.feature_npz` names another file,
    and then None (the source builds its own from that file)."""
    feature_npz = cfg.ood.feature_npz
    if feature_npz is None or os.path.realpath(feature_npz) == os.path.realpath(params_npz):
        return gd
    return None


def build_pipeline(cfg: Config, params_npz: str, calibration_images=None,
                   calibration_pairs=None, device="cuda", verbose: bool = True, mesh=None):
    """The whole pipeline of `cfg` on `device`: the engine (`build_gd`),
    its weights (`load_params`: the npz route only), Stage A's front end
    (`build_frontend`) and the classifier gate (`build_classifier_gate`);
    over `mesh` (`parallel.mesh.make_mesh`) when given, every rank calling
    this with the same arguments (see `pipeline`).
    A denoiser feature source and a denoiser gate tap the pipeline's own
    denoiser unless `ood.feature_npz` names other weights.  Raises for
    detector='seg' without a trained SegUNet, as the JAX factory does: the
    ground-truth-mask fallback is the evaluation script's, not a
    deployable pipeline's."""
    from localdiffusion_tpu_torch.pipeline import LocalDiffusionPipeline

    gd = load_params(cfg, params_npz=params_npz, device=device, verbose=verbose)
    tap = denoiser_for_taps(cfg, gd, params_npz)
    frontend, cfg = build_frontend(cfg, gd=tap, calibration_images=calibration_images,
                                   device=device, verbose=verbose)
    if frontend is None and cfg.ood.detector == "seg":
        where = cfg.ood.seg_model_path or "the default checkpoints"
        raise ValueError(f"detector='seg' has no trained SegUNet ({where}): pass "
                         "ood.seg_model_path")
    gate = build_classifier_gate(cfg, frontend, calibration_pairs=calibration_pairs, gd=tap,
                                 device=device, verbose=verbose)
    return LocalDiffusionPipeline(cfg, gd, frontend=frontend, classifier_gate=gate, mesh=mesh)
