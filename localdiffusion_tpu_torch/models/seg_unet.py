"""Segmentation UNet, the 'seg' OOD detector, and its training losses.
Port of `localdiffusion_tpu/models/seg_unet.py`.

The classic 4-down/4-up UNet, 64 → 1024 channels: each `DoubleConv` is
(conv3×3 without bias → GroupNorm(min(32, ch), eps 1e-6, flax's) → ReLU)
twice; the up path is a 2×2 stride-2 transposed conv (`up{i}_up`), the
skip concatenated before it (`[skip, up]`) and a DoubleConv (`up{i}_conv`);
`outc` is a 1×1 conv with bias, in float32.  (The up path's first conv
runs over the two halves of the concatenation, see `SegUNet._up`.)  Submodule names are the flax
tree's (`Conv_0`, `GroupNorm_0`, ...), so `seg_params_from_jax` maps the
slim npz by name; the transposed convs need their own rule (see there).

Input and output are NHWC float32; the convolutions run in NCHW.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.utils.params_io import params_from_jax, torch_leaf
from localdiffusion_tpu_torch.utils.precision import full_float32

GN_EPS = 1e-6  # flax nn.GroupNorm's default
ENCODER = ("inc", "down1", "down2", "down3", "down4")


class DoubleConv(nn.Module):
    """(conv3×3 → GroupNorm → ReLU) ×2."""

    def __init__(self, cin: int, out_ch: int, mid_ch: int = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.Conv_0 = nn.Conv2d(cin, mid, 3, padding=1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(min(32, mid), mid, eps=GN_EPS)
        self.Conv_1 = nn.Conv2d(mid, out_ch, 3, padding=1, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(min(32, out_ch), out_ch, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class SegUNet(nn.Module):
    """4-down/4-up segmentation UNet: [B, H, W, 1] → per-pixel logits
    [B, H, W, n_classes] (float32)."""

    def __init__(self, n_classes: int = 1, base: int = 64, in_channels: int = 1):
        super().__init__()
        b = base
        self.inc = DoubleConv(in_channels, b)
        self.down1 = DoubleConv(b, 2 * b)
        self.down2 = DoubleConv(2 * b, 4 * b)
        self.down3 = DoubleConv(4 * b, 8 * b)
        self.down4 = DoubleConv(8 * b, 16 * b)
        for i, (cin, out) in enumerate(((16 * b, 8 * b), (8 * b, 4 * b), (4 * b, 2 * b),
                                        (2 * b, b)), start=1):
            setattr(self, f"up{i}_up", nn.ConvTranspose2d(cin, out, 2, stride=2))
            setattr(self, f"up{i}_conv", DoubleConv(2 * out, out))
        self.outc = nn.Conv2d(b, n_classes, 1)

    def _encode(self, x: torch.Tensor, stop: int):
        """NCHW encoder outputs inc..ENCODER[stop]."""
        feats = [self.inc(x)]
        for name in ENCODER[1:stop + 1]:
            feats.append(getattr(self, name)(F.max_pool2d(feats[-1], 2, 2)))
        return feats

    def _up(self, i: int, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """up{i}: the transposed conv, then the DoubleConv over [skip, up].
        Its first conv runs as two convs, over the skip and over the up
        half with the weight split along its input channels, summed: the
        same function without the concatenation.  Over the concatenation
        cuDNN's heuristics give up3's conv (256 → 128 channels at 128²) an
        FFT algorithm of 33,024 launches, ~440 ms at batch 4 on an H100
        with TF32 off; each half takes an implicit GEMM."""
        up = getattr(self, f"up{i}_up")(h)
        dc = getattr(self, f"up{i}_conv")
        w, c = dc.Conv_0.weight, skip.shape[1]
        x = F.conv2d(skip, w[:, :c], padding=1) + F.conv2d(up, w[:, c:], padding=1)
        x = F.relu(dc.GroupNorm_0(x))
        return F.relu(dc.GroupNorm_1(dc.Conv_1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self._encode(x.permute(0, 3, 1, 2).float(), len(ENCODER) - 1)
        h = feats[-1]
        for i, skip in enumerate(reversed(feats[:-1]), start=1):
            h = self._up(i, h, skip)
        return self.outc(h).permute(0, 2, 3, 1)

    def encoder_taps(self, x: torch.Tensor, layers: Iterable[str]) -> Dict[str, torch.Tensor]:
        """The DoubleConv outputs named in `layers` (of `ENCODER`), NHWC;
        the encoder stops after the deepest."""
        layers = tuple(layers)
        bad = [l for l in layers if l not in ENCODER]
        if bad:
            raise ValueError(f"seg-encoder taps are {ENCODER}, got {bad}")
        feats = self._encode(x.permute(0, 3, 1, 2).float(),
                             max(ENCODER.index(l) for l in layers))
        return {l: feats[ENCODER.index(l)].permute(0, 2, 3, 1) for l in layers}


def _seg_leaf(path: str, arr: np.ndarray):
    """A transposed conv's flax kernel [kh, kw, in, out] (applied unflipped,
    `transpose_kernel=False`) is torch's ConvTranspose2d weight [in, out,
    kh, kw] flipped in space; every other leaf as `torch_leaf` maps it."""
    parts = path.split("/")
    if parts[-1] == "kernel" and parts[-2].endswith("_up"):
        name, _ = torch_leaf(path, arr)
        return name, arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return torch_leaf(path, arr)


def seg_params_from_jax(tree, model: SegUNet) -> Dict[str, torch.Tensor]:
    """The state dict for `model` from the JAX SegUNet's params (nested or
    flat '/'-joined keys, numpy); every leaf consumed, every parameter
    filled."""
    return params_from_jax(tree, model, leaf=_seg_leaf)


def load_seg_npz(path: str, model: SegUNet) -> Dict[str, torch.Tensor]:
    """A slim npz snapshot of the JAX SegUNet as `model`'s state dict."""
    with np.load(path) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files}
    return seg_params_from_jax(flat, model)


def flax_seg_tree(model: SegUNet) -> Mapping[str, np.ndarray]:
    """The inverse map: `model`'s weights as the JAX SegUNet's flat npz keys
    (`params/<module>/.../<leaf>`), float32."""
    out = {}
    for name, t in model.state_dict().items():
        a = t.detach().cpu().float().numpy()
        parts = name.split(".")
        leaf, mod = parts[-1], parts[:-1]
        if leaf == "weight" and a.ndim == 4:
            leaf = "kernel"
            a = (a.transpose(2, 3, 0, 1)[::-1, ::-1] if mod[-1].endswith("_up")
                 else a.transpose(2, 3, 1, 0))
        elif leaf == "weight":
            leaf = "scale"
        out["/".join(["params", *mod, leaf])] = np.ascontiguousarray(a)
    return out


def save_seg_npz(path: str, model: SegUNet, dtype=np.float16) -> None:
    """`model`'s weights as a slim npz in the shipped snapshot's layout
    (`flax_seg_tree`'s keys, `dtype` storage, compressed): what
    `load_seg_npz` and the JAX package's `load_params_npz` read."""
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in flax_seg_tree(model).items()})


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Soft Dice loss on sigmoid probabilities, per image over H, W, C,
    then 1 - the batch mean."""
    probs = torch.sigmoid(logits)
    num = 2.0 * (probs * targets).sum(dim=(1, 2, 3))
    den = probs.sum(dim=(1, 2, 3)) + targets.sum(dim=(1, 2, 3))
    return 1.0 - ((num + eps) / (den + eps)).mean()


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                  pos_weight: float = 10.0) -> torch.Tensor:
    """BCE with logits, the positives weighted by `pos_weight`, written with
    log-sigmoids as the JAX loss is, plus `dice_loss`."""
    bce = -(pos_weight * targets * F.logsigmoid(logits)
            + (1.0 - targets) * F.logsigmoid(-logits))
    return bce.mean() + dice_loss(logits, targets)


class SegDetector:
    """A SegUNet as the front end's `seg_apply`: conditioning images
    [B, H, W, 1] (numpy or a tensor) → logits [B, H, W, 1] float32 on the
    model's device, its convolutions in full float32 (`full_float32`)."""

    def __init__(self, model: SegUNet):
        self.model = model
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32))
        with full_float32():
            return self.model(x.to(self.device, torch.float32))
