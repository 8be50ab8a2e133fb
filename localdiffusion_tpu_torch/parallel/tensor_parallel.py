"""Tensor parallelism over the mesh's 'model' axis: the parameters stay
sharded while the network computes.

Port of `localdiffusion_tpu/parallel/fsdp.py::tp_param_shardings` and of
the sharded compute that GSPMD derives from it.  `tp_param_shardings`
applies the JAX rule (`fsdp.spec_for_shape`: the last dimension divisible
by the axis size) to each parameter's JAX leaf shape, so a rank holds the
elements the JAX device holds: a conv kernel's HWIO O is dimension 0 of
torch's OIHW, a dense kernel's (I, O) O is dimension 0 of torch's (O, I).
`shard_tensor_parallel` cuts each parameter to this rank's share in place.

The compute, per layer, as GSPMD partitions it:
  * a `Conv2d` or `Linear` whose weight is sharded on its output dimension
    computes its share of the output channels from the whole input, then
    all-gathers them over 'model' (column-parallel);
  * one sharded on its input dimension computes a partial product from its
    share of the input channels, summed over 'model' by an all-reduce in
    float32, then adds the bias (row-parallel);
  * at a kernel site (the fused ResnetBlock's passes, both GroupNorm
    kernels, flash attention's surroundings and the linear-attention pair)
    and at every other layer that reads its leaves whole (RMSNorm, the
    condition encoder's GroupNorm, Fourier time features), the layer's
    leaves are all-gathered over 'model' for the call and dropped after
    (`full_width`).  A `pallas_call` cannot be GSPMD-partitioned, so the
    JAX package sends the fused ResnetBlock and the linear attention to
    their XLA paths on more than one device; here a rank is a process with
    one device, so every rank launches each kernel at full width, as one
    process does, and the result is held to the same numbers.

Forward only: no gradient crosses the collectives.  Every rank of a
'model' group must call the network together with the same input.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from localdiffusion_tpu_torch.parallel.fsdp import spec_for_shape
from localdiffusion_tpu_torch.parallel.multihost import collective_device

AXIS = "model"


def jax_shape(t: torch.Tensor) -> tuple:
    """The JAX leaf shape of a port parameter: a 4-D conv weight OIHW as
    HWIO, a 2-D dense weight (O, I) as (I, O), anything else as it is."""
    s = tuple(t.shape)
    if len(s) == 4:
        return (s[2], s[3], s[1], s[0])
    if len(s) == 2:
        return (s[1], s[0])
    return s


def torch_dim(ndim: int, jax_dim: int) -> int:
    """The torch dimension of dimension `jax_dim` of the JAX leaf shape."""
    if ndim == 4:
        return (2, 3, 1, 0)[jax_dim]
    if ndim == 2:
        return (1, 0)[jax_dim]
    return jax_dim


@dataclass(frozen=True)
class LeafShard:
    """One parameter's tensor-parallel sharding: `spec`, JAX's
    PartitionSpec of its JAX leaf as a tuple (() replicated); `dim`, the
    torch dimension cut into `parts` contiguous shares (None: whole)."""

    spec: tuple
    dim: Optional[int]
    parts: int


def tp_param_shardings(model: nn.Module, mesh, axis_name: str = AXIS) -> Dict[str, LeafShard]:
    """{parameter name: LeafShard} over the mesh's `axis_name` axis, from
    each parameter's JAX leaf shape alone (`fsdp.spec_for_shape`)."""
    size = mesh[axis_name].size()
    out = {}
    for name, p in model.named_parameters():
        spec = spec_for_shape(jax_shape(p), axis_name, size)
        dim = torch_dim(p.ndim, spec.index(axis_name)) if spec else None
        out[name] = LeafShard(spec, dim, size)
    return out


def shard_tensor_parallel(model: nn.Module, mesh, axis_name: str = AXIS) -> nn.Module:
    """Cut every parameter of `model` to this rank's share over the mesh's
    `axis_name` axis (`tp_param_shardings`), in place, and set the model
    up for sharded compute (see the module docstring); returns it.  Every
    rank must hold the same full parameters when it is called."""
    from localdiffusion_tpu_torch.models.blocks import Conv2d, Linear

    specs = tp_param_shardings(model, mesh, axis_name)
    group = mesh.get_group(axis_name)
    rank = mesh.get_local_rank(axis_name)
    for mod_name, mod in model.named_modules():
        owned = {}
        for pname, p in mod.named_parameters(recurse=False):
            sh = specs[f"{mod_name}.{pname}" if mod_name else pname]
            if sh.dim is None:
                continue
            n = p.shape[sh.dim] // sh.parts
            if p.ndim == 4 and not p.is_contiguous():  # put back so by unshard
                mod.__dict__.setdefault("_tp_channels_last", set()).add(pname)
            with torch.no_grad():
                p.data = p.data.narrow(sh.dim, rank * n, n).contiguous()
            owned[pname] = sh.dim
        mod._tensor_parallel = True
        if owned:
            mod._tp = owned
            mod._tp_group = group
            mod._tp_rank = rank
            if not isinstance(mod, (Conv2d, Linear)):
                _gather_for_calls(mod)  # a layer that reads its leaves whole
    # the linear attention reads its convolutions' weights directly (the
    # kernel pair or its plain version): the whole module is one site
    from localdiffusion_tpu_torch.models.blocks import LinearAttention

    for mod in model.modules():
        if isinstance(mod, LinearAttention):
            _gather_for_calls(mod)
    model._tp_mesh = mesh
    return model


def _gather_for_calls(mod: nn.Module) -> None:
    """Hooks that gather `mod`'s leaves before each call and drop the full
    tensors after it."""
    mod._tp_hooks = [mod.register_forward_pre_hook(lambda m, _args: _gather_into(m)),
                     mod.register_forward_hook(lambda m, _args, _out: _restore(m))]


def is_tensor_parallel(model: nn.Module) -> bool:
    return getattr(model, "_tp_mesh", None) is not None


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Each rank's equal share of `t` along `dim`, gathered in rank order,
    contiguous on `t`'s device (gloo gathers on the CPU)."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    dev = collective_device(group)
    src = t.movedim(dim, 0).contiguous().to(dev)
    out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=dev)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous().to(t.device)


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    dev = collective_device(group)
    buf = t.to(dev)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def _gather_into(mod: nn.Module) -> None:
    """Put the full tensors of every sharded leaf of `mod` and its children
    in place of their shards (a module already gathered is left alone)."""
    stack = mod.__dict__.setdefault("_tp_saved", [])
    saved = []
    for m in mod.modules():
        if not getattr(m, "_tp", None) or getattr(m, "_tp_full", 0):
            continue
        for pname, dim in m._tp.items():
            p = getattr(m, pname)
            saved.append((m, p, p.data))
            p.data = all_gather_dim(p.data, dim, m._tp_group)
        m._tp_full = 1
    stack.append(saved)


def _restore(mod: nn.Module) -> None:
    for m, p, shard in mod.__dict__["_tp_saved"].pop():
        p.data = shard
        m._tp_full = 0


@contextlib.contextmanager
def full_width(*modules):
    """The sharded leaves of `modules` (None skipped) gathered for the
    block and their shards put back after."""
    mods = [m for m in modules if m is not None]
    for m in mods:
        _gather_into(m)
    try:
        yield
    finally:
        for m in reversed(mods):
            _restore(m)


def sharded_forward(mod: nn.Module, x: torch.Tensor, op, channel_dim: int) -> torch.Tensor:
    """A `Conv2d` or `Linear` (`op(x, weight, bias)` in its compute type)
    on its shards: column-parallel where the weight is cut on its output
    dimension, row-parallel where on its input dimension, at full width
    after a gather otherwise."""
    dim = mod._tp.get("weight")
    dt = mod.compute_dtype
    group, rank = mod._tp_group, mod._tp_rank
    bias = mod.bias
    if dim == 0:
        n = mod.weight.shape[0]
        if bias is not None and "bias" not in mod._tp:
            bias = bias.narrow(0, rank * n, n)
        y = op(x.to(dt), mod.weight.to(dt), None if bias is None else bias.to(dt))
        out = all_gather_dim(y, channel_dim % y.ndim, group)
        if y.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out
    if dim == 1:
        n = mod.weight.shape[1]
        xs = x.narrow(channel_dim % x.ndim, rank * n, n)
        # the partial products in float32 from the compute type's values
        # (exact products, float32 sums), summed over the ranks, then the
        # bias, rounded to the compute type once
        y = _sum_over(op(xs.to(dt).float(), mod.weight.to(dt).float(), None), group)
        if bias is not None:
            if "bias" in mod._tp:
                bias = all_gather_dim(bias, 0, group)
            shape = [1] * y.ndim
            shape[channel_dim % y.ndim] = -1
            y = y + bias.to(dt).float().view(shape)
        return y.to(dt)
    with full_width(mod):
        return op(x.to(dt), mod.weight.to(dt), None if mod.bias is None else mod.bias.to(dt))


def conv_forward(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return sharded_forward(mod, x, mod._conv_forward, 1)


def linear_forward(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return sharded_forward(mod, x, F.linear, -1)


def unshard_tensor_parallel(model: nn.Module) -> nn.Module:
    """Gather every shard of a tensor-parallel model back to its full
    tensor, in place, and drop its sharded compute (a replicated model, as
    a pipeline on a mesh holds it).  Collective: every rank calls it."""
    if not is_tensor_parallel(model):
        return model
    for mod in model.modules():
        for pname, dim in (getattr(mod, "_tp", None) or {}).items():
            p = getattr(mod, pname)
            with torch.no_grad():
                p.data = all_gather_dim(p.data, dim, mod._tp_group)
                if pname in mod.__dict__.get("_tp_channels_last", ()):
                    p.data = p.data.contiguous(memory_format=torch.channels_last)
        for h in mod.__dict__.get("_tp_hooks", ()):
            h.remove()
        for attr in ("_tp", "_tp_group", "_tp_rank", "_tp_full", "_tp_saved", "_tp_hooks",
                     "_tp_channels_last", "_tensor_parallel"):
            mod.__dict__.pop(attr, None)
    model.__dict__.pop("_tp_mesh", None)
    return model


def tp_info(model: nn.Module) -> dict:
    """Global (full) against this rank's resident bytes of the model's
    parameters, and their ratio."""
    glob = loc = 0
    for mod in model.modules():
        owned = getattr(mod, "_tp", None) or {}
        for pname, p in mod.named_parameters(recurse=False):
            parts = 1
            if pname in owned:
                parts = dist.get_world_size(mod._tp_group)
            loc += p.numel() * p.element_size()
            glob += p.numel() * parts * p.element_size()
    return {"global_bytes": int(glob), "per_device_bytes": int(loc),
            "memory_scaling": glob / max(loc, 1)}
