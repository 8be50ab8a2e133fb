"""The reference's PyTorch checkpoint → the port's UNet weights.

Port of `localdiffusion_tpu/utils/reference_ckpt.py`, numpy only.  The
reference trainer saves `{'step', 'model', 'opt', 'ema', 'scaler'}`:
`model` is the GaussianDiffusion state dict (schedule buffers and the UNet
under `model.*`), `ema` the ema_pytorch one (the EMA UNet under
`ema_model.model.*`).  `convert_unet_state_dict` maps a reference UNet
state dict onto the JAX package's flat params tree ('params/<module>/…',
the layout of the slim npz snapshots), and `params_from_jax` carries that
onto the port's UNet, so a converted checkpoint is written, read and
served like every other npz.

Layout rules (the JAX module's):

  * Conv2d  [O, I, kh, kw] → kernel [kh, kw, I, O]
  * Linear  [O, I]         → kernel [I, O]
  * GroupNorm weight/bias  → scale/bias (eps stays 1e-5)
  * RMSNorm g [1, C, 1, 1] → g [C]
  * the Downsample's space-to-depth keeps the '(c p1 p2)' channel order,
    so its 1×1 conv carries over as it is;
  * `conv_fusion.mlp` is ZEROED, not copied: the reference builds that
    FiLM mlp but calls `conv_fusion(x)` without a time embedding, so its
    weights are untrained; the UNet passes t there, and a zero mlp makes
    the FiLM x·(scale + 1) + shift the identity, as the reference's call.

`reference_state_dict` is the inverse (a params tree → reference keys,
with the reference's shapes), for building a checkpoint of the
reference's layout from known weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from localdiffusion_tpu_torch.config import ModelConfig

_SEP = "/"


def _np(v) -> np.ndarray:
    """torch.Tensor | np.ndarray → float32 numpy (host)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _conv(sd, key) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _dense(sd, key) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{key}.weight"]).T, "bias": _np(sd[f"{key}.bias"])}


def _gn(sd, key) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _rms(sd, key) -> Dict[str, np.ndarray]:
    return {"g": _np(sd[f"{key}.g"]).reshape(-1)}


def _resnet_block(sd, prefix, zero_mlp: bool = False) -> Dict[str, Any]:
    """Reference ResnetBlock (ddpm.py:188-212)."""
    out: Dict[str, Any] = {
        "block1": {"proj": _conv(sd, f"{prefix}.block1.proj"),
                   "norm": _gn(sd, f"{prefix}.block1.norm")},
        "block2": {"proj": _conv(sd, f"{prefix}.block2.proj"),
                   "norm": _gn(sd, f"{prefix}.block2.norm")},
    }
    if f"{prefix}.mlp.1.weight" in sd:
        mlp = _dense(sd, f"{prefix}.mlp.1")
        if zero_mlp:
            mlp = {k: np.zeros_like(v) for k, v in mlp.items()}
        out["mlp"] = mlp
    if f"{prefix}.res_conv.weight" in sd:
        out["res_conv"] = _conv(sd, f"{prefix}.res_conv")
    return out


def _attention(sd, prefix, full: bool) -> Dict[str, Any]:
    """Attention (ddpm.py:253-282) / LinearAttention (ddpm.py:214-251)."""
    out: Dict[str, Any] = {
        "norm": _rms(sd, f"{prefix}.norm"),
        "to_qkv": {"kernel": _np(sd[f"{prefix}.to_qkv.weight"]).transpose(2, 3, 1, 0)},
    }
    if full:
        out["to_out"] = _conv(sd, f"{prefix}.to_out")
    else:
        out["to_out"] = _conv(sd, f"{prefix}.to_out.0")
        out["out_norm"] = _rms(sd, f"{prefix}.to_out.1")
    return out


def _basic_block(sd, prefix) -> Dict[str, Any]:
    """ResUnet BasicBlock (unet_model.py:8-51) → the condition encoder's."""
    out: Dict[str, Any] = {
        "conv1": _conv(sd, f"{prefix}.convblock.0"),
        "gn1": _gn(sd, f"{prefix}.convblock.1"),
        "conv2": _conv(sd, f"{prefix}.convblock.3"),
        "gn2": _gn(sd, f"{prefix}.convblock.4"),
    }
    if f"{prefix}.identity.0.weight" in sd:
        out["id_conv"] = _conv(sd, f"{prefix}.identity.0")
        out["id_gn"] = _gn(sd, f"{prefix}.identity.1")
    return out


_COND_BLOCKS = ("residual_conv1", "residual_conv2", "residual_conv3", "mid_conv")


def convert_unet_state_dict(sd: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A reference `Unet.state_dict()` (keys like `init_conv.weight`,
    `downs.0.0.block1.proj.weight`, `cond_model.residual_conv1.0...`) →
    the nested params tree `{"params": ...}` of numpy float32 arrays for a
    UNet of the same ModelConfig."""
    num_stages = len(cfg.dim_mults)
    p: Dict[str, Any] = {"init_conv": _conv(sd, "init_conv")}

    tm: Dict[str, Any] = {}
    if "time_mlp.0.weights" in sd:  # learned/random Fourier variant (ddpm.py:151-166)
        tm["pos_emb"] = {"weights": _np(sd["time_mlp.0.weights"])}
    tm["fc1"] = _dense(sd, "time_mlp.1")
    tm["fc2"] = _dense(sd, "time_mlp.3")
    p["time_mlp"] = tm

    for i in range(num_stages):
        is_last = i >= num_stages - 1
        p[f"down{i}_block1"] = _resnet_block(sd, f"downs.{i}.0")
        p[f"down{i}_block2"] = _resnet_block(sd, f"downs.{i}.1")
        p[f"down{i}_attn"] = _attention(sd, f"downs.{i}.2", cfg.full_attn[i])
        # the deepest stage's plain 3×3 conv, else Sequential(Rearrange, Conv2d)
        p[f"down{i}_down"] = (_conv(sd, f"downs.{i}.3") if is_last
                              else {"conv": _conv(sd, f"downs.{i}.3.1")})

    p["mid_block1"] = _resnet_block(sd, "mid_block1")
    p["mid_attn"] = _attention(sd, "mid_attn", True)
    p["mid_block2"] = _resnet_block(sd, "mid_block2")
    p["conv_fusion"] = _resnet_block(sd, "conv_fusion", zero_mlp=True)

    for j in range(num_stages):
        stage = num_stages - 1 - j
        is_last = j == num_stages - 1
        p[f"up{j}_block1"] = _resnet_block(sd, f"ups.{j}.0")
        p[f"up{j}_block2"] = _resnet_block(sd, f"ups.{j}.1")
        p[f"up{j}_attn"] = _attention(sd, f"ups.{j}.2", cfg.full_attn[stage])
        # Upsample = Sequential(nn.Upsample, Conv2d) → keys '...3.1'
        p[f"up{j}_up"] = (_conv(sd, f"ups.{j}.3") if is_last
                          else {"conv": _conv(sd, f"ups.{j}.3.1")})

    p["final_res_block"] = _resnet_block(sd, "final_res_block")
    p["final_conv"] = _conv(sd, "final_conv")

    cm: Dict[str, Any] = {}
    for b, tp in enumerate(_COND_BLOCKS):
        if f"cond_model.{tp}.0.convblock.0.weight" in sd:
            cm[f"block{b + 1}"] = _basic_block(sd, f"cond_model.{tp}.0")
    p["cond_model"] = cm
    return {"params": p}


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_trainer_checkpoint(data: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A whole reference `Trainer.save` dict → {'step', 'params',
    'ema_params'} (params trees; ema_params None without an EMA).  The
    schedule buffers beside the UNet under `model.` are recomputed from
    the configuration and skipped."""
    params = convert_unet_state_dict(_strip_prefix(data["model"], "model."), cfg)
    ema_params: Optional[Dict[str, Any]] = None
    if data.get("ema"):
        ema_sd = _strip_prefix(data["ema"], "ema_model.model.")
        if ema_sd:
            ema_params = convert_unet_state_dict(ema_sd, cfg)
    return {"step": int(data.get("step", 0)), "params": params, "ema_params": ema_params}


def load_reference_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, Any]:
    """`torch.load` a reference `model-<milestone>.pt` (its own pickle, with
    an optimizer and a grad scaler: read it only from a source you trust)
    and convert it."""
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    return convert_trainer_checkpoint(data, cfg)


def flat_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested params tree as {'params/…/leaf': array}, keys sorted (the
    order of the JAX package's `save_params_npz`)."""
    out: Dict[str, np.ndarray] = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}{k}{_SEP}")
        else:
            out[pre[: -len(_SEP)]] = np.asarray(t)

    walk(tree, prefix)
    return out


def save_tree_npz(path: str, tree: Any, dtype=np.float32) -> None:
    """A params tree as one compressed npz (flat '/' keys, each leaf stored
    as `dtype`): the JAX package's `save_params_npz` of the same tree."""
    np.savez_compressed(path, **{k: v.astype(dtype) for k, v in flat_params(tree).items()})


# ---------------------------------------------------------------------------
# the inverse: a params tree in the reference's keys and shapes
# ---------------------------------------------------------------------------

def reference_state_dict(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The reference `Unet.state_dict()` whose conversion is `tree` (a
    nested `{"params": ...}`, or its flat 'params/…/leaf' keys, as
    `utils.params_io.params_to_jax` gives them): every rule above run
    backwards, RMSNorm gains [1, C, 1, 1], the Sequential indices of the
    reference's modules.  `conv_fusion.mlp` keeps the tree's values (the
    conversion zeroes it)."""
    if "params" not in tree:
        nested: Dict[str, Any] = {}
        for k, v in tree.items():
            node = nested
            for part in k.split(_SEP)[:-1]:
                node = node.setdefault(part, {})
            node[k.split(_SEP)[-1]] = v
        tree = nested
    p = tree["params"]
    sd: Dict[str, np.ndarray] = {}

    def conv(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in leaf:
            sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    def dense(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["kernel"]).T
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    def gn(key, leaf):
        sd[f"{key}.weight"] = np.asarray(leaf["scale"])
        sd[f"{key}.bias"] = np.asarray(leaf["bias"])

    def rms(key, leaf):
        sd[f"{key}.g"] = np.asarray(leaf["g"]).reshape(1, -1, 1, 1)

    def resnet(prefix, leaf):
        for blk in ("block1", "block2"):
            conv(f"{prefix}.{blk}.proj", leaf[blk]["proj"])
            gn(f"{prefix}.{blk}.norm", leaf[blk]["norm"])
        if "mlp" in leaf:
            dense(f"{prefix}.mlp.1", leaf["mlp"])
        if "res_conv" in leaf:
            conv(f"{prefix}.res_conv", leaf["res_conv"])

    def attention(prefix, leaf, full):
        rms(f"{prefix}.norm", leaf["norm"])
        sd[f"{prefix}.to_qkv.weight"] = np.asarray(leaf["to_qkv"]["kernel"]).transpose(3, 2, 0, 1)
        if full:
            conv(f"{prefix}.to_out", leaf["to_out"])
        else:
            conv(f"{prefix}.to_out.0", leaf["to_out"])
            rms(f"{prefix}.to_out.1", leaf["out_norm"])

    n = len(cfg.dim_mults)
    conv("init_conv", p["init_conv"])
    if "pos_emb" in p["time_mlp"]:
        sd["time_mlp.0.weights"] = np.asarray(p["time_mlp"]["pos_emb"]["weights"])
    dense("time_mlp.1", p["time_mlp"]["fc1"])
    dense("time_mlp.3", p["time_mlp"]["fc2"])
    for i in range(n):
        resnet(f"downs.{i}.0", p[f"down{i}_block1"])
        resnet(f"downs.{i}.1", p[f"down{i}_block2"])
        attention(f"downs.{i}.2", p[f"down{i}_attn"], cfg.full_attn[i])
        if i == n - 1:
            conv(f"downs.{i}.3", p[f"down{i}_down"])
        else:
            conv(f"downs.{i}.3.1", p[f"down{i}_down"]["conv"])
    resnet("mid_block1", p["mid_block1"])
    attention("mid_attn", p["mid_attn"], True)
    resnet("mid_block2", p["mid_block2"])
    resnet("conv_fusion", p["conv_fusion"])
    for j in range(n):
        resnet(f"ups.{j}.0", p[f"up{j}_block1"])
        resnet(f"ups.{j}.1", p[f"up{j}_block2"])
        attention(f"ups.{j}.2", p[f"up{j}_attn"], cfg.full_attn[n - 1 - j])
        if j == n - 1:
            conv(f"ups.{j}.3", p[f"up{j}_up"])
        else:
            conv(f"ups.{j}.3.1", p[f"up{j}_up"]["conv"])
    resnet("final_res_block", p["final_res_block"])
    conv("final_conv", p["final_conv"])
    for b, tp in enumerate(_COND_BLOCKS):
        leaf = p["cond_model"].get(f"block{b + 1}")
        if leaf is None:
            continue
        pre = f"cond_model.{tp}.0"
        conv(f"{pre}.convblock.0", leaf["conv1"])
        gn(f"{pre}.convblock.1", leaf["gn1"])
        conv(f"{pre}.convblock.3", leaf["conv2"])
        gn(f"{pre}.convblock.4", leaf["gn2"])
        if "id_conv" in leaf:
            conv(f"{pre}.identity.0", leaf["id_conv"])
            gn(f"{pre}.identity.1", leaf["id_gn"])
    return sd
