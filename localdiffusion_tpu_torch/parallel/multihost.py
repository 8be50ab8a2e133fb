"""Multi-process runtime on `torch.distributed`: joining the ranks, the
rank's device, barriers and the rows a rank keeps.

Port of `localdiffusion_tpu/parallel/multihost.py`.  Every process runs the
same script and joins one process group over TCP at the coordinator's
address (NCCL for CUDA tensors, gloo for the CPU; no launcher's environment
variables are read).  Data feeding keeps the JAX package's contract: every
rank loads the same, seeded, global batch and keeps its own rows
(`put_tree` over a row selection of `parallel.mesh`), so a step does not
depend on how many ranks share it.

A rank's device is `cuda:{rank % device_count}`.  Everything degrades to a
no-op, or to the whole batch, in a single process.  Every collective stages
through `collective_device` (the CPU under gloo, which two ranks on one
card need: NCCL refuses a device twice).
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None) -> None:
    """Join this process into the process group at `coordinator_address`
    (`host:port` of rank 0).  A no-op for `num_processes` None or 1 with no
    coordinator (a single process, the default everywhere).  The backend is
    NCCL for a CUDA device and gloo for the CPU unless `backend` names one
    (gloo also carries CUDA tensors: two ranks that share one card, which
    NCCL refuses).  Call before any tensor reaches the card."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator address (host:port)")
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside [0, {world})")
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:{rank % device_count}` for a CUDA device,
    the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0)."""
    return process_index() == 0


def sync(name: str = "sync") -> None:
    """A barrier across the processes (no-op in a single process)."""
    if is_multiprocess():
        dist.barrier()


def warmup_collectives(group=None) -> None:
    """One all-reduce of ones over `group` (default: every process), checked
    against its size: it sets the communicators up while the ranks are
    still in step and surfaces a broken connection at once.  No-op in a
    single process."""
    if not is_multiprocess():
        return
    n = dist.get_world_size(group)
    ones = torch.ones(1, device=collective_device(group))
    dist.all_reduce(ones, group=group)
    if float(ones) != float(n):
        raise RuntimeError(f"warm-up all-reduce gave {float(ones)}, expected {n}")


def row_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """[lo, hi) of share `index` of `count` contiguous shares of n rows, the
    first n % count shares one row longer."""
    base, extra = divmod(int(n), int(count))
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


def collective_device(group=None) -> torch.device:
    """Where a tensor must lie for a collective of `group`: the rank's card
    under NCCL, the CPU under gloo."""
    if "nccl" in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The n rows of which each rank of `group` holds its `row_range` share
    (`t`), gathered in rank order on every rank, on `t`'s device."""
    count, index = dist.get_world_size(group), dist.get_rank(group)
    lo, hi = row_range(n, index, count)
    if t.shape[0] != hi - lo:
        raise ValueError(f"rank {index} holds {t.shape[0]} rows, its share is {hi - lo}")
    width = row_range(n, 0, count)[1]
    dev = collective_device(group)
    pad = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
    pad[: t.shape[0]] = t.to(dev)
    parts = [torch.empty_like(pad) for _ in range(count)]
    dist.all_gather(parts, pad, group=group)
    sizes = [row_range(n, i, count) for i in range(count)]
    return torch.cat([p[: b - a] for p, (a, b) in zip(parts, sizes)]).to(t.device)


def broadcast_first(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` as the first rank of `group` holds it, on every rank of the
    group, on `t`'s device (`t` itself in a group of one)."""
    if not is_multiprocess() or dist.get_world_size(group) == 1:
        return t
    buf = t.to(collective_device(group)).contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, 0) if group is not None else 0,
                   group=group)
    return buf.to(t.device)


def broadcast_object(obj: Any = None, group=None) -> Any:
    """The first rank's `obj` (any picklable value) on every rank of
    `group`; the others pass None.  `obj` itself in a single process."""
    if not is_multiprocess():
        return obj
    box = [obj]
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dist.broadcast_object_list(box, src=src, group=group, device=collective_device(group))
    return box[0]


def check_replicated(tensors: Iterable[torch.Tensor], what: str = "parameters",
                     group=None) -> str:
    """Raise unless every rank of `group` holds the same tensors, compared
    by a sha256 of their shapes, types and bytes in order; returns it.  A
    no-op check in one process."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        flat = t.detach().cpu().reshape(-1).clone()  # dense, whatever the layout
        h.update(flat.view(torch.uint8).numpy().tobytes())
    mine = h.hexdigest()
    if not is_multiprocess():
        return mine
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    if len(set(every)) != 1:
        raise ValueError(f"the ranks hold different {what}: digests {every}")
    return mine


class RowsNoise:
    """A noise source for some rows of an n-row batch (`rows`: a slice, as
    a rank's [lo, hi), or row indices): every draw is taken for the whole
    batch and the rows kept, so a chain over those rows draws what the
    whole batch's chain draws for them."""

    def __init__(self, noise, n: int, rows):
        self.noise, self.n = noise, n
        self.rows = rows if isinstance(rows, slice) else torch.as_tensor(np.asarray(rows))
        self.count = len(range(n)[rows]) if isinstance(rows, slice) else len(self.rows)

    def check(self, b: int) -> None:
        if b != self.count:
            raise ValueError(f"a draw of {b} rows, the share is {self.count}")

    def keep(self, full: torch.Tensor) -> torch.Tensor:
        """The kept rows of a draw for the whole batch."""
        rows = self.rows if isinstance(self.rows, slice) else self.rows.to(full.device)
        return full[rows]

    def __call__(self, shape):
        self.check(shape[0])
        return self.keep(self.noise((self.n,) + tuple(shape[1:])))


def put_tree(tree: Any, sharding) -> Any:
    """The rows of `tree` (an array or tensor, or a tuple or list of them)
    that this rank keeps under `sharding` (`parallel.mesh.replicated`,
    `batch_sharding`, ...): the replicated global batch in, the rank's
    share out.  Every rank must hold the same full values."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(put_tree(x, sharding) for x in tree)
    return sharding.select(tree)


def sum_over(values: Sequence[float], group=None) -> list:
    """Each value summed over the ranks of `group` (as float64 on the
    collective's device); the values as they are in a single process."""
    if not is_multiprocess():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=collective_device(group))
    dist.all_reduce(t, group=group)
    return t.tolist()
