"""WideResNet-50-2 feature extractor for PatchCore.  Port of
`localdiffusion_tpu/ood/wide_resnet.py`.

torchvision's `wide_resnet50_2` (bottlenecks of base width 128) with its
BatchNorms frozen to their inference affine, through the deepest requested
stage: layer1 (256 channels, stride 4), layer2 (512, 8), layer3 (1024, 16),
layer4 (2048, 32).  The parameter names are torchvision's (`conv1.weight`,
`layer2.0.downsample.1.running_var`, ...), so a torchvision state dict
loads by name (`load_torchvision_state_dict`); `params_from_jax` takes the
JAX package's flax tree, the inverse of its `convert_torch_state_dict`.

Without weights the module is initialised from an explicit seeded
`torch.Generator`: conv kernels N(0, 1/fan_in) (flax's lecun-normal scale),
the BatchNorms the identity (scale 1, bias 0, mean 0, var 1), as flax
initialises them.  The JAX package draws its random WRN from
`jax.random.PRNGKey(0)`, a stream PyTorch does not reproduce: the two
random WRNs differ, and a bank embedded by one pairs only with that one's
weights.  No ImageNet weights are in the repo.

Input and output are NHWC float32; the convolutions run in NCHW.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLOCKS_PER_STAGE = (3, 4, 6, 3)
PLANES_PER_STAGE = (64, 128, 256, 512)
BN_EPS = 1e-5


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: x·inv + (bias − mean·inv), inv = weight ·
    rsqrt(var + eps), in the JAX package's order."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (stride on the 3×3) at base width 128."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 base_width: int = 128):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        out = planes * 4
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride), FrozenBatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out, 1), FrozenBatchNorm(out)
        # a 1×1 stride-2 conv: flax's 'SAME' pads nothing at even sizes,
        # which is padding 0 here
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), FrozenBatchNorm(out))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(h + idn)


class WideResNet50Features(nn.Module):
    """Stem and layer1..layerN, N the deepest of `layers`; `forward(x)`
    [B, H, W, 3] → {layer: [B, h, w, c]} for the requested layers."""

    def __init__(self, layers: Tuple[str, ...] = ("layer2", "layer3"), base_width: int = 128):
        super().__init__()
        self.layers = tuple(layers)
        bad = [l for l in self.layers if l not in ("layer1", "layer2", "layer3", "layer4")]
        if bad or not self.layers:
            raise ValueError(f"WRN50-2 taps are layer1..layer4, got {self.layers}")
        self.deepest = max(int(l[-1]) for l in self.layers)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage in range(self.deepest):
            planes = PLANES_PER_STAGE[stage]
            blocks = []
            for b in range(BLOCKS_PER_STAGE[stage]):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(cin, planes, stride, downsample=(b == 0),
                                         base_width=base_width))
                cin = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def init_seeded(self, generator: torch.Generator) -> "WideResNet50Features":
        """Conv kernels N(0, 1/fan_in) drawn on the CPU from `generator` in
        parameter order; the BatchNorms stay the identity."""
        with torch.no_grad():
            for _, p in self.named_parameters():
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) / np.sqrt(fan_in))
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h)))
        # flax pads with −inf and pools 3×3/2 VALID: MaxPool2d(3, 2, 1)
        h = F.max_pool2d(h, 3, 2, 1)
        out: Dict[str, torch.Tensor] = {}
        for stage in range(self.deepest):
            name = f"layer{stage + 1}"
            h = getattr(self, name)(h)
            if name in self.layers:
                out[name] = h.permute(0, 2, 3, 1)
        return out


def load_torchvision_state_dict(model: WideResNet50Features,
                                state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a torchvision `wide_resnet50_2` state dict by name: the entries
    `model` has (its stages only) are taken, as float32, the others (fc,
    deeper stages, `num_batches_tracked`) left.  Raises KeyError on a
    missing entry, ValueError on a shape that does not fit."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state_dict)
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} WRN50-2 entries: {missing[:5]}")
    picked = {}
    for k, v in own.items():
        w = torch.as_tensor(state_dict[k]).float()
        if tuple(w.shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(w.shape)} does not fit {tuple(v.shape)}")
        picked[k] = w
    model.load_state_dict(picked)


def params_from_jax(tree: Mapping, model: WideResNet50Features) -> Dict[str, torch.Tensor]:
    """The state dict for `model` from the JAX package's WRN params tree
    (`{'params': {'conv1': {'kernel'}, 'bn1': {...}, 'layer{s}_block{b}':
    {'conv1', 'bn1', ..., 'ds_conv', 'ds_bn'}}}`, numpy arrays): kernels
    HWIO → OIHW, BatchNorm (scale, bias, mean, var) → (weight, bias,
    running_mean, running_var).  Raises KeyError on a leaf left over or a
    parameter no leaf fills."""
    params = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose=False):
        a = np.asarray(arr, np.float32)
        out[name] = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if transpose else a))

    def bn(prefix, leaves):
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            put(f"{prefix}.{dst}", leaves[src])
        if set(leaves) != {"scale", "bias", "mean", "var"}:
            raise KeyError(f"{prefix}: BatchNorm leaves {sorted(leaves)}")

    names = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2", "conv3": "conv3",
             "bn3": "bn3", "ds_conv": "downsample.0", "ds_bn": "downsample.1"}
    for mod, leaves in params.items():
        if mod in ("conv1", "bn1"):
            tp, sub = "", {mod: leaves}
        else:
            stage, block = mod.split("_block")
            tp, sub = f"{stage}.{int(block)}.", leaves
        for name, lv in sub.items():
            dst = tp + names[name]
            if name.startswith(("conv", "ds_conv")):
                if set(lv) != {"kernel"}:
                    raise KeyError(f"{mod}/{name}: conv leaves {sorted(lv)}")
                put(f"{dst}.weight", lv["kernel"], transpose=True)
            else:
                bn(dst, lv)
    expected = model.state_dict()
    extra = sorted(set(out) - set(expected))
    missing = sorted(set(expected) - set(out))
    if extra or missing:
        raise KeyError(f"JAX WRN params: leaves with no parameter {extra[:5]}, parameters "
                       f"with no leaf {missing[:5]}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not fit {tuple(expected[k].shape)}")
    return out


def build_wrn(layers: Tuple[str, ...], device="cuda", state_dict: Optional[Mapping] = None,
              generator: Optional[torch.Generator] = None) -> WideResNet50Features:
    """A WRN50-2 through the deepest of `layers` on `device`, in eval mode,
    with `state_dict` (torchvision names) or seeded weights from
    `generator` (default: seed 0)."""
    model = WideResNet50Features(layers)
    if state_dict is not None:
        load_torchvision_state_dict(model, state_dict)
    else:
        model.init_seeded(generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(device).eval().requires_grad_(False)
