"""PatchCore feature sources.  Port of `localdiffusion_tpu/ood/features.py`.

  * 'wrn': WideResNet50-2 taps (`ood/wide_resnet.py`), ImageNet
    preprocessing.  Weights: a torchvision state dict
    (`ood.backbone_weights_path`) or, without one, seeded random weights.
    The JAX package's random WRN comes from `jax.random.PRNGKey(0)`, which
    PyTorch does not reproduce: the shipped WRN banks
    (`results/memory_bank_synthetic_brain.npy`, `memory_bank_mnist.npy`)
    were embedded with those weights and pair with the port only when the
    JAX parameters are carried across (`wide_resnet.params_from_jax`), as
    the CPU tests do.  A bank for the port's seeded WRN is built with
    `python -m localdiffusion_tpu_torch.ood.bank --feature-source wrn`.
  * 'seg_encoder': encoder taps of the trained SegUNet
    (`models/seg_unet.py`), the DoubleConv outputs `inc` .. `down4`.
  * 'denoiser': down-path activations of the trained denoiser UNet at a
    fixed small timestep.  The denoiser was trained only on normal
    anatomy, so anomalous content gives off-manifold activations; no extra
    training.  The conditioning image is fed as the sample at a small t (a
    near-clean pass) and the `down{i}_block2` outputs are tapped
    (`UNet.down_taps`, which stops after the deepest tap).

A source exposes `.layers` (tap names, shallowest first), `.preprocess`
('imagenet': channel repeat, de/re-normalization, resize to `input_size`
and ImageNet normalization; 'raw': the conditioning image exactly as the
diffusion pipeline sees it), `.strides` (each tap's stride in the pixels
it sees), `.device` and `.apply(x) → {layer: [B, h, w, c] float32}`.  The
WRN50-2 and the seg encoder apply their convolutions in full float32, and
the denoiser its taps (`utils.precision.full_float32`, as
`GaussianDiffusion` its every call).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from localdiffusion_tpu_torch.utils.precision import full_float32

DEFAULT_LAYERS = ("down2_block2", "down3_block2")
SEG_LAYERS = ("down2", "down3")
# the seg detector's checkpoints, in the JAX package's order: a local
# training run's (the port's `scripts.train_seg` npz, then the JAX script's
# Orbax directory), then the shipped slim snapshot
SEG_CANDIDATES = ("results/seg/best_dice.npz", "results/seg/best_dice",
                  "results/seg256_params.npz")


class WRNFeatureSource:
    """WideResNet50-2 taps.  `params`: a state dict in torchvision's names
    (`wide_resnet.params_from_jax` gives one from the JAX params); without
    it the weights are seeded from `generator` (default: seed 0)."""

    name = "wrn"
    preprocess = "imagenet"
    strides = {"layer1": 4, "layer2": 8, "layer3": 16, "layer4": 32}

    def __init__(self, layers: Tuple[str, ...], params=None,
                 generator: Optional[torch.Generator] = None, input_size: int = 224,
                 device="cuda"):
        from localdiffusion_tpu_torch.ood.wide_resnet import build_wrn

        self.layers = tuple(layers)
        self.input_size = input_size
        self.device = torch.device(device)
        self.backbone = build_wrn(self.layers, self.device, state_dict=params,
                                  generator=generator)

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with full_float32():
            return {k: v.float() for k, v in self.backbone(x).items()}


class SegEncoderFeatureSource:
    """Encoder taps of a SegUNet (`models.seg_unet.SegUNet`, on its
    device): the DoubleConv outputs named in `layers`."""

    name = "seg_encoder"
    preprocess = "raw"
    strides = {"inc": 1, "down1": 2, "down2": 4, "down3": 8, "down4": 16}

    def __init__(self, model, layers: Tuple[str, ...] = SEG_LAYERS):
        self.layers = tuple(layers)
        self.model = model
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with full_float32():
            return self.model.encoder_taps(x, self.layers)


class DenoiserFeatureSource:
    """Down-path taps of a denoiser (`GaussianDiffusion`) at timestep t.

    t may be one timestep or a tuple: a multi-t ensemble exposes the taps at
    every listed t as separate layers ("t{t}:{tap}"), which PatchCore
    concatenates into one embedding, one bank and one search."""

    name = "denoiser"
    preprocess = "raw"

    def __init__(self, gd, t=5, layers: Tuple[str, ...] = DEFAULT_LAYERS):
        self.ts = (tuple(int(v) for v in t) if isinstance(t, (tuple, list)) else (int(t),))
        self.base_layers = tuple(layers)
        if len(self.ts) == 1:
            self.layers = self.base_layers
        else:
            self.layers = tuple(f"t{tt}:{l}" for tt in self.ts for l in self.base_layers)
        self.gd = gd
        self.device = gd.device
        # stage i runs at H/2^i, and a space-to-depth stem moves every stage
        # one level down
        s = gd.model_cfg.stem_space_to_depth
        base = {f"down{i}_block{j}": (2**i) * s
                for i in range(len(gd.model_cfg.dim_mults)) for j in (1, 2)}
        self.strides = dict(base)
        for tt in self.ts:
            for k, v in base.items():
                self.strides[f"t{tt}:{k}"] = v

    @torch.no_grad()
    def apply(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, H, W, C] on the source's device: the sample (and, in the
        JAX UNet, the condition, which the down path never reads)."""
        b = x.shape[0]
        out: Dict[str, torch.Tensor] = {}
        for tt in self.ts:
            t = torch.full((b,), tt, dtype=torch.float32, device=x.device)
            with full_float32():
                taps = self.gd.model.down_taps(x, t, self.base_layers)
            for k in self.base_layers:
                key = k if len(self.ts) == 1 else f"t{tt}:{k}"
                out[key] = taps[k].float()
        return out


def load_backbone_weights(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision `wide_resnet50_2` state dict saved with `torch.save`,
    read with `weights_only=True` onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def wrn_source(ood, device="cuda", generator: Optional[torch.Generator] = None,
               verbose: bool = False) -> WRNFeatureSource:
    """The WRN50-2 source of `ood` (an OODConfig) on `device`: `ood.layers`
    at `ood.input_size`, with the state dict of `ood.backbone_weights_path`,
    else weights seeded from `generator` (default seed 0)."""
    params = None
    if ood.backbone_weights_path:
        params = load_backbone_weights(ood.backbone_weights_path)
        if verbose:
            print(f"WRN50-2 weights: {ood.backbone_weights_path}")
    return WRNFeatureSource(ood.layers, params=params, generator=generator,
                            input_size=ood.input_size, device=device)


def seg_checkpoint(path: Optional[str]) -> str:
    """The SegUNet checkpoint the seg detector and the seg-encoder source
    read: `path`, or with none the JAX package's order: a local training
    run's (`results/seg/best_dice.npz`, which `scripts.train_seg` writes,
    then `results/seg/best_dice`, the JAX script's Orbax directory), then
    the shipped `results/seg256_params.npz`."""
    if path is None:
        path = next((c for c in SEG_CANDIDATES if os.path.exists(c)), SEG_CANDIDATES[-1])
    return path


def load_seg_params(path: Optional[str], model):
    """(resolved path (`seg_checkpoint`), `model`'s state dict or None) of
    the SegUNet checkpoint for the seg detector and the seg-encoder source.

    A missing file gives None.  The port reads slim npz snapshots only; an
    Orbax directory raises rather than fall back to the npz, which would be
    another model than the JAX package's."""
    from localdiffusion_tpu_torch.models.seg_unet import load_seg_npz

    path = seg_checkpoint(path)
    if not os.path.exists(path):
        return path, None
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint, which the port does not read: train the "
            "detector with `python -m localdiffusion_tpu_torch.scripts.train_seg` (a slim "
            "npz), or write it as one with an exporter (the JAX package's "
            "`save_params_npz`, as `scripts/export_orbax_npz.py` does for the denoiser), "
            "and name the npz in ood.seg_model_path")
    return path, load_seg_npz(path, model)


def build_seg_unet(cfg, device="cuda", verbose: bool = True):
    """(the SegUNet of `cfg.ood.seg_model_path` on `device` in eval mode, its
    path), or (None, path) when there is no checkpoint."""
    from localdiffusion_tpu_torch.models.seg_unet import SegUNet

    model = SegUNet()
    path, state = load_seg_params(cfg.ood.seg_model_path, model)
    if state is None:
        return None, path
    model.load_state_dict(state)
    if verbose:
        print(f"loaded seg checkpoint {path}")
    return model.to(device).eval().requires_grad_(False), path


def make_feature_source(cfg, denoiser=None, device="cuda", verbose: bool = True,
                        generator: Optional[torch.Generator] = None):
    """The feature source `cfg.ood.feature_source` names (cfg is the full
    Config), on `device`.  'wrn': `wrn_source`, seeded from `generator`.
    'seg_encoder': the SegUNet of `ood.seg_model_path`
    (see `load_seg_params`); raises without one.  'denoiser' taps
    `denoiser` (a GaussianDiffusion, e.g. the pipeline's own) or, without
    one, a denoiser built from the configuration with the weights of
    `ood.feature_npz`."""
    ood = cfg.ood
    name = ood.feature_source
    if name == "wrn":
        return wrn_source(ood, device=device, generator=generator, verbose=verbose)
    if name == "seg_encoder":
        model, path = build_seg_unet(cfg, device=device, verbose=verbose)
        if model is None:
            raise FileNotFoundError(f"the seg_encoder feature source needs a trained SegUNet "
                                    f"at {path} (scripts/train_seg.py)")
        return SegEncoderFeatureSource(model, ood.feature_layers or SEG_LAYERS)
    if name != "denoiser":
        raise ValueError(f"unknown feature_source {name!r}")
    gd = denoiser
    if gd is None:
        from localdiffusion_tpu_torch.diffusion.gaussian import build_gd
        from localdiffusion_tpu_torch.utils.params_io import load_params_npz

        if not ood.feature_npz:
            raise ValueError("the denoiser feature source needs a denoiser or "
                             "ood.feature_npz (a params snapshot)")
        gd = build_gd(cfg, device=device)
        gd.model.load_state_dict(load_params_npz(ood.feature_npz, gd.model))
        if verbose:
            print(f"denoiser feature source: {ood.feature_npz}")
    return DenoiserFeatureSource(gd, t=ood.feature_t, layers=ood.feature_layers or DEFAULT_LAYERS)
