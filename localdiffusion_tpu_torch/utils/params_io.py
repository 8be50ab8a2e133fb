"""Weights from the JAX package into the port.

The JAX package's parameters are a flax tree `params/<module>/…/<leaf>`,
stored in slim npz snapshots as flat keys joined by '/' (fp16 storage).
`params_from_jax` maps such a tree, as numpy arrays, onto the port's
`state_dict`:

  * conv kernels HWIO → OIHW, Dense kernels [in, out] → [out, in];
  * `kernel` → `weight`, GroupNorm `scale` → `weight`, `bias` and RMSNorm
    `g` keep their names;
  * the module path keeps its names ('/' → '.').

It raises on any leaf left over and on any parameter of the model missing.
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


def _torch_leaf(path: str, arr: np.ndarray):
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


def params_from_jax(tree: Any, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The `state_dict` for `model` from a JAX params tree (nested mapping or
    flat '/'-joined keys) of numpy arrays, as float32.

    Raises KeyError on a leaf the model has no parameter for or a parameter
    no leaf fills, ValueError on a shape that does not match.
    """
    flat = _flatten(tree)
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name, arr = _torch_leaf(path, np.asarray(arr))
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
