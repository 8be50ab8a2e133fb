"""Weights from the JAX package into the port.

The JAX package's parameters are a flax tree `params/<module>/…/<leaf>`,
stored in slim npz snapshots as flat keys joined by '/' (fp16 storage).
`params_from_jax` maps such a tree, as numpy arrays, onto the port's
`state_dict`:

  * conv kernels HWIO → OIHW, Dense kernels [in, out] → [out, in];
  * `kernel` → `weight`, GroupNorm `scale` → `weight`, `bias` and RMSNorm
    `g` keep their names;
  * the module path keeps its names ('/' → '.').

A module with another layout passes its own leaf rule (the SegUNet's
transposed convs, `models/seg_unet.py`).  It raises on any leaf left over
and on any parameter of the model missing.

`params_to_jax` is the inverse for the denoiser (`torch_leaf`'s rules
backwards), and `save_params_npz` writes its result as
`localdiffusion_tpu/utils/params_io.py::save_params_npz` does: flat '/'
keys, fp16 by default, compressed, so a port-trained model serves through
`factory.load_params` and loads into the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested mapping of arrays as {'a/b/leaf': array}."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[: -len(_SEP)]: np.asarray(tree)}


def torch_leaf(path: str, arr: np.ndarray):
    """(state-dict name, array) of one '/'-joined flax leaf."""
    parts = path.split(_SEP)
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":
        leaf = "weight"
        if arr.ndim == 4:  # conv HWIO → OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # Dense [in, out] → [out, in]
            arr = arr.T
    elif leaf == "scale":  # GroupNorm
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), arr


def params_from_jax(tree: Any, model: torch.nn.Module,
                    leaf=torch_leaf) -> Dict[str, torch.Tensor]:
    """The `state_dict` for `model` from a JAX params tree (nested mapping or
    flat '/'-joined keys) of numpy arrays, as float32; `leaf(path, array)`
    maps one leaf (default `torch_leaf`).

    Raises KeyError on a leaf the model has no parameter for or a parameter
    no leaf fills, ValueError on a shape that does not match.
    """
    flat = _flatten(tree)
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name, arr = leaf(path, np.asarray(arr))
        if name not in expected:
            raise KeyError(f"JAX leaf {path} has no parameter in the port ({name})")
        if tuple(arr.shape) != tuple(expected[name].shape):
            raise ValueError(
                f"{path}: shape {arr.shape} does not fit {name} "
                f"{tuple(expected[name].shape)}"
            )
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"parameters with no JAX leaf: {missing}")
    return out


def load_params_npz(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A slim npz snapshot (flat '/'-joined keys, fp16 or f32 storage) as
    the `state_dict` for `model`, cast back to float32."""
    with np.load(path) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files}
    return params_from_jax(flat, model)


def jax_leaf(name: str, arr: np.ndarray):
    """('/'-joined flax path, array) of one state-dict entry: the inverse
    of `torch_leaf`.  A 1-D `weight` is a GroupNorm's `scale`."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        if arr.ndim == 4:  # conv OIHW → HWIO
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:  # Dense [out, in] → [in, out]
            leaf, arr = "kernel", arr.T
        else:
            leaf = "scale"
    return _SEP.join(["params"] + parts[:-1] + [leaf]), arr


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A denoiser's `state_dict` as the JAX package's flat params
    {'params/…/leaf': float32 array} (`jax_leaf` per entry)."""
    out = {}
    for name, t in state_dict.items():
        path, arr = jax_leaf(name, t.detach().float().cpu().numpy())
        out[path] = np.ascontiguousarray(arr)
    return out


def save_params_npz(path: str, state_dict: Mapping[str, torch.Tensor],
                    dtype=np.float16) -> None:
    """`params_to_jax(state_dict)` as one compressed npz, each leaf stored
    as `dtype` (fp16 by default, as the JAX package's snapshots)."""
    flat = {k: v.astype(dtype) for k, v in params_to_jax(state_dict).items()}
    np.savez_compressed(path, **flat)
