"""The device mesh and the row selections a rank keeps.

Port of `localdiffusion_tpu/parallel/mesh.py` over
`torch.distributed.device_mesh`.  Axes, as in the JAX package:

  data  - batch data parallelism; with `Trainer(fsdp=True)` the training
          state is also sharded over it (`parallel.fsdp`);
  patch - the patch axis of patch-parallel sampling (`parallel.patch`);
  model - tensor parallelism: the parameters stay sharded while the network
          computes (`parallel.tensor_parallel`); only present when model > 1.

A JAX sharding places each shard of a global array on its device; here
every rank holds the global array and keeps its share, so a sharding is a
row selection (`Rows`): for each leading dimension, the mesh axis whose
coordinate picks the contiguous share (`multihost.row_range`), and a
sharded result is gathered back where a step needs it whole
(`multihost.all_gather_rows`).  `BranchSplit` is the counterpart of the
JAX samplers' `branch_sharding`: the flat [2B] branch pair over 'patch'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from localdiffusion_tpu_torch.parallel.multihost import all_gather_rows, row_range, sum_over

AXES = ("data", "patch")
MODEL_AXES = ("data", "patch", "model")


def make_mesh(data: int = -1, patch: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """A ('data', 'patch') mesh over the ranks of the process group, one
    device a rank (data = -1: every rank not on the patch and model axes);
    with model > 1 a ('data', 'patch', 'model') mesh, as the JAX package's
    (the model axis innermost: the ranks of a 'model' group are
    consecutive).  In a single process without a group it first joins a
    group of one rank (gloo over an in-memory store), so a one-device mesh
    works as in JAX."""
    if model < 1:
        raise ValueError(f"model={model} must be at least 1")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if data == -1:
        if n % (patch * model):
            raise ValueError(f"{n} ranks are not divisible by patch*model={patch * model}")
        data = n // (patch * model)
    if data * patch * model != n:
        raise ValueError(f"mesh data={data} x patch={patch} x model={model} != {n} ranks")
    kind = torch.device(device).type
    if model == 1:
        return init_device_mesh(kind, (data, patch), mesh_dim_names=AXES)
    return init_device_mesh(kind, (data, patch, model), mesh_dim_names=MODEL_AXES)


@dataclass(frozen=True)
class Rows:
    """A row selection: dimension i of an array is cut into the mesh's
    `axes[i]` size of contiguous shares and the rank keeps the one at its
    coordinate on that axis (dimensions past `axes` are whole)."""

    mesh: DeviceMesh
    axes: Tuple[str, ...] = ()

    def bounds(self, dim: int, n: int) -> Tuple[int, int]:
        axis = self.axes[dim]
        return row_range(n, self.mesh.get_local_rank(axis), self.mesh[axis].size())

    def select(self, x):
        for dim in range(len(self.axes)):
            lo, hi = self.bounds(dim, x.shape[dim])
            idx = (slice(None),) * dim + (slice(lo, hi),)
            x = x[idx]
        return x


def replicated(mesh: DeviceMesh) -> Rows:
    return Rows(mesh, ())


def batch_sharding(mesh: DeviceMesh) -> Rows:
    """The leading (batch) dimension over 'data' (NHWC batches)."""
    return Rows(mesh, ("data",))


def branch_batch_sharding(mesh: DeviceMesh) -> Rows:
    """[branch/patch, batch, H, W, C]: the first dimension over 'patch',
    the batch over 'data'."""
    return Rows(mesh, ("patch", "data"))


def shard_batch(mesh: DeviceMesh, *arrays):
    """Each array's rows of this rank under `batch_sharding`."""
    sh = batch_sharding(mesh)
    out = tuple(sh.select(a) for a in arrays)
    return out if len(out) > 1 else out[0]


class BranchSplit:
    """How the ranks of a mesh share a branched chain's flat [2B] pair (the
    OOD half first): this rank steps rows `bounds(2B)` of it, its share
    over 'patch' (with patch = 2 one rank steps the OOD half and the other
    the IND half), for its own 'data' rows of the batch.  `gather` puts the
    pair back together over 'patch' where the chain needs both halves (the
    fusion, a gated retry); `any` is a flag OR-ed over every rank (a gated
    chain's latch, so every rank takes the same steps)."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("patch")
        self.index = mesh.get_local_rank("patch")
        self.count = mesh["patch"].size()

    def bounds(self, n: int) -> Tuple[int, int]:
        return row_range(n, self.index, self.count)

    def gather(self, part, n: int):
        return part if self.count == 1 else all_gather_rows(part, n, self.group)

    @staticmethod
    def any(flag: bool) -> bool:
        return sum_over([float(bool(flag))])[0] > 0.0
