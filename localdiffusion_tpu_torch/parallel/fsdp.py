"""FSDP of the training state on `torch.distributed.fsdp.fully_shard`.

Port of `localdiffusion_tpu/parallel/fsdp.py`.  The JAX package annotates
every leaf of the training state with a sharding over the 'data' axis and
lets XLA insert the all-gathers and reduce-scatters; here FSDP2
(`fully_shard`) does the same to the UNet: each of its blocks and its root
become a unit whose parameters are sharded at rest and all-gathered for
the unit's forward and backward, the gradients reduce-scattered after it.
Parameters, gradients and Adam's moments are then sharded (Adam runs on
the DTensor shards), and so is the EMA copy (`Trainer` shards it the same
way).

The shard layout differs: FSDP2 shards dimension 0 of every parameter
(`torch.chunk`, padded), where the JAX rule (`spec_for_shape`, kept here
for `shard_info`'s report) takes the last divisible dimension.  The tests
compare numbers, not layouts.  The tensor-parallel shardings over the
'model' axis, `tp_param_shardings`, apply the JAX rule itself and live
with their sharded compute in `parallel.tensor_parallel`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
from torch import nn


def spec_for_shape(shape, axis_name: str, axis_size: int, min_elems: int = 2) -> tuple:
    """The JAX package's PartitionSpec as a tuple: the LAST dimension
    divisible by axis_size sharded over `axis_name`; () (replicated) when
    none is, or for scalars and leaves under min_elems·axis_size."""
    if axis_size <= 1 or len(shape) == 0:
        return ()
    total = 1
    for d in shape:
        total *= d
    if total < min_elems * axis_size:
        return ()
    for i in range(len(shape) - 1, -1, -1):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec = [None] * len(shape)
            spec[i] = axis_name
            return tuple(spec)
    return ()


def fsdp_units(model: nn.Module) -> list:
    """The modules `shard_model` makes FSDP units, innermost first: every
    direct child of the UNet whose forward the UNet calls (the blocks, the
    attentions, the up/down convolutions, the time MLP, the condition
    encoder), then the UNet itself, which keeps the rest (the init and final
    convolutions)."""
    return [m for m in model.children() if any(True for _ in m.parameters())] + [model]


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """`fully_shard` every unit of `fsdp_units(model)` over `mesh` (a 1-D
    device mesh, the 'data' axis); the model is sharded in place and
    returned.  FSDP2 shards contiguous parameters only: a channels_last
    convolution weight is made contiguous first (the same values).

    FSDP2 makes the first unit to run forward the root, and refuses the
    real root after a child ran first; a sampler calls the condition
    encoder before the UNet, so the root is set up here, once every unit
    is sharded (FSDP2's own lazy set-up, which its first forward would
    run)."""
    from torch.distributed.fsdp import fully_shard

    for p in model.parameters():
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    model._get_fsdp_state()._lazy_init()
    return model


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view of its storage); a plain
    tensor as it is."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on dimension 0 (FSDP2's `torch.chunk` layout)
    all-gathered to a full tensor on its device with one c10d
    `all_gather_into_tensor` (gloo's collectives run on the CPU); a plain
    tensor as it is; any other layout raises.  Collective.
    (`DTensor.full_tensor` goes through the functional collectives, which
    did not return over gloo with CUDA tensors.)"""
    if not is_sharded(t):
        return t
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from localdiffusion_tpu_torch.parallel.multihost import collective_device

    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"only FSDP2's Shard(0) layout is gathered, not {t.placements}")
    group = t.device_mesh.get_group()
    world = dist.get_world_size(group)
    loc = t.to_local()
    n = t.shape[0]
    chunk = -(-n // world)
    dev = collective_device(group)
    pad = torch.zeros((chunk,) + tuple(t.shape[1:]), dtype=loc.dtype, device=dev)
    pad[: loc.shape[0]] = loc.to(dev)
    out = torch.empty((chunk * world,) + tuple(t.shape[1:]), dtype=loc.dtype, device=dev)
    dist.all_gather_into_tensor(out, pad, group=group)
    return out[:n].to(loc.device)


def gather_tree(tensors) -> Dict[str, torch.Tensor]:
    """Each DTensor of `tensors` (a module, whose `state_dict` is taken, or
    a mapping) all-gathered to a full tensor (`full`); plain tensors as
    they are.  Collective: every rank calls it."""
    sd = tensors.state_dict() if isinstance(tensors, nn.Module) else tensors
    return {k: full(v) for k, v in sd.items()}


def load_full(module: nn.Module, full: Dict[str, torch.Tensor]) -> None:
    """Load full tensors (a gathered or single-process state dict) into a
    module whose parameters may be sharded: each rank copies its own shard
    (no communication; every rank holds the same full values)."""
    from torch.distributed.tensor import distribute_tensor

    with torch.no_grad():
        for name, t in module.state_dict().items():
            src = full[name].to(device=t.device, dtype=t.dtype)
            if is_sharded(t):
                src = distribute_tensor(src, t.device_mesh, t.placements, src_data_rank=None)
                t.to_local().copy_(src.to_local())
            else:
                t.copy_(src)
        missing = sorted(set(full) - set(module.state_dict()))
        if missing:
            raise KeyError(f"no parameter for {missing}")


def shard_info(tensors: Iterable[torch.Tensor]) -> dict:
    """Global against this rank's bytes of a set of tensors (DTensors count
    their local shard), and their ratio."""
    glob = loc = 0
    for t in tensors:
        glob += t.numel() * t.element_size()
        loc += local(t).numel() * t.element_size()
    return {"global_bytes": int(glob), "per_device_bytes": int(loc),
            "memory_scaling": glob / max(loc, 1)}


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` with each DTensor gathered to a full tensor
    (collective), the single-process layout."""
    sd = optimizer.state_dict()
    state = {k: {n: full(v) for n, v in s.items()} for k, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state(optimizer: torch.optim.Optimizer, full: dict,
                              params: Tuple[torch.Tensor, ...]) -> None:
    """Load a full (single-process layout) optimizer state into an optimizer
    over sharded `params`: each tensor of a parameter's state sharded as
    the parameter (no communication), step counts as they are."""
    from torch.distributed.tensor import distribute_tensor

    state = {}
    for k, s in full["state"].items():
        p = params[int(k)]
        state[k] = {}
        for n, v in s.items():
            if is_sharded(p) and v.shape == p.shape:
                v = distribute_tensor(v.to(p.device), p.device_mesh, p.placements,
                                      src_data_rank=None)
            state[k][n] = v
    optimizer.load_state_dict({"state": state, "param_groups": full["param_groups"]})
