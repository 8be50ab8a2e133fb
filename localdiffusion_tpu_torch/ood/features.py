"""PatchCore feature sources.  Port of the denoiser source of
`localdiffusion_tpu/ood/features.py`.

'denoiser': down-path activations of the trained denoiser UNet at a fixed
small timestep.  The denoiser was trained only on normal anatomy, so
anomalous content gives off-manifold activations; no extra training.  The
conditioning image is fed as the sample at a small t (a near-clean pass)
and the `down{i}_block2` outputs are tapped (`UNet.down_taps`, which stops
after the deepest tap).

A source exposes `.layers` (tap names, shallowest first), `.preprocess`
('raw': the conditioning image exactly as the diffusion pipeline sees it),
`.strides` (each tap's stride in input pixels), `.device` and
`.apply(x) → {layer: [B, h, w, c] float32}`.  The WRN50-2 and seg-encoder
sources of the JAX package are later slices of the port (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DEFAULT_LAYERS = ("down2_block2", "down3_block2")


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
            taps = self.gd.model.down_taps(x, t, self.base_layers)
            for k in self.base_layers:
                key = k if len(self.ts) == 1 else f"t{tt}:{k}"
                out[key] = taps[k].float()
        return out


def make_feature_source(cfg, denoiser=None, device="cuda", verbose: bool = True):
    """The feature source `cfg.ood.feature_source` names (cfg is the full
    Config).  'denoiser' taps `denoiser` (a GaussianDiffusion, e.g. the
    pipeline's own) or, without one, a denoiser built from the configuration
    on `device` with the weights of `cfg.ood.feature_npz`."""
    ood = cfg.ood
    name = ood.feature_source
    if name in ("wrn", "seg_encoder"):
        raise NotImplementedError(
            f"feature source {name!r}: a later slice of the port (ROADMAP queue 1); "
            "use feature_source='denoiser'")
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
