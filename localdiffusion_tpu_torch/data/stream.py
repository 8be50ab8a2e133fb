"""Streaming input: lazily loaded shards behind a bounded worker thread,
and batches prefetched to the card on a side CUDA stream.

Port of `localdiffusion_tpu/data/stream.py`, numpy only but for
`device_prefetch`.  `StreamLoader` draws its orders as the JAX loader does
(the shard order from `default_rng((seed, epoch))`, each shard's rows from
`default_rng((seed, epoch, k))`), so its batches are the JAX loader's bit
for bit.  One background thread decodes the next shards while the current
one is consumed; it gives up when the consumer abandons the epoch, and a
decode error is raised in the consumer.

`device_prefetch` keeps the next batches on their way to the card: each is
staged in pinned host memory, copied with `non_blocking=True` on a side
stream, and handed out with an event the consumer's stream waits on;
`record_stream` tells the caching allocator that the consumer's stream
uses the buffer, so it is not reused before that work is done.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

ShardFn = Callable[[], Tuple[np.ndarray, ...]]


def npy_shard(*paths: str) -> ShardFn:
    """Shard loader reading parallel .npy files (one per stream)."""

    def load() -> Tuple[np.ndarray, ...]:
        return tuple(np.load(p) for p in paths)

    return load


class StreamLoader:
    """Deterministic epoch batches over lazily loaded shards.

    `shards` is a sequence of zero-argument callables, each returning a
    tuple of parallel arrays (e.g. (hr, lr)); `sizes` gives each shard's
    length up front, so `len` and the batch count need no IO.  Per epoch
    the shard order is shuffled (seed, epoch), each shard's rows with its
    own substream (seed, epoch, k), and rows left over at a shard boundary
    carry into the next shard's batches, so the batch sizes are
    `ArrayLoader`'s.  `epoch_batches` is `ArrayLoader.epoch_batches`: a
    drop-in for `Trainer.train_epoch_step` and `train_batch_step`."""

    def __init__(self, shards: Sequence[ShardFn], sizes: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 42, drop_last: bool = False,
                 prefetch_shards: int = 2):
        if len(shards) != len(sizes) or not shards:
            raise ValueError(f"{len(shards)} shards and {len(sizes)} sizes")
        self.shards = list(shards)
        self.sizes = [int(s) for s in sizes]
        self.n = sum(self.sizes)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_shards = max(1, prefetch_shards)
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def _shard_iter(self, e: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """The loaded and shuffled shards in the epoch's order, decoded
        ahead by a bounded background thread."""
        order = np.arange(len(self.shards))
        if self.shuffle:
            np.random.default_rng((self.seed, e)).shuffle(order)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch_shards)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has abandoned
            # the epoch (the generator closed mid-iteration): otherwise the
            # worker would block for ever, holding decoded shards
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for k in order:
                    if stop.is_set():
                        return
                    arrays = self.shards[k]()
                    n = len(arrays[0])
                    if n != self.sizes[k]:
                        raise ValueError(f"shard {k} declared {self.sizes[k]} rows, loaded {n}")
                    if self.shuffle:
                        idx = np.arange(n)
                        np.random.default_rng((self.seed, e, int(k))).shuffle(idx)
                        arrays = tuple(a[idx] for a in arrays)
                    if not put(arrays):
                        return
                put(sentinel)
            except Exception as exc:  # a decode error: raised in the consumer
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def epoch_batches(self, epoch: Optional[int] = None) -> Iterator[Tuple]:
        e = self.epoch if epoch is None else epoch
        bs = self.batch_size
        pending: Optional[Tuple[np.ndarray, ...]] = None
        for arrays in self._shard_iter(e):
            if pending is not None:
                arrays = tuple(np.concatenate([p, a]) for p, a in zip(pending, arrays))
                pending = None
            n = len(arrays[0])
            full = (n // bs) * bs
            for i in range(0, full, bs):
                yield tuple(a[i:i + bs] for a in arrays)
            if full < n:
                pending = tuple(a[full:] for a in arrays)
        if pending is not None and not self.drop_last:
            yield pending
        if epoch is None:
            self.epoch += 1


def device_prefetch(batches, size: int = 2, device="cuda") -> Iterator[Tuple]:
    """Keep `size` batches already on their way to `device` ahead of the
    consumer.  Each batch (a tuple of numpy arrays or CPU tensors) is
    staged in pinned memory and copied with `non_blocking=True` on a side
    CUDA stream; the consumer's stream waits on the batch's event before
    it is handed out, and every tensor is recorded on the consumer's
    stream.  On the CPU the batches pass as tensors, unchanged."""
    import torch

    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for b in it:
            yield tuple(torch.as_tensor(a) for a in b)
        return
    side = torch.cuda.Stream(device=device)
    pending = []

    def launch():
        try:
            host = next(it)
        except StopIteration:
            return False
        staged = [torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a)
                  .pin_memory() for a in host]
        with torch.cuda.stream(side):
            out = tuple(t.to(device, non_blocking=True) for t in staged)
            done = torch.cuda.Event()
            done.record(side)
        # the pinned sources stay referenced until the copy has run
        pending.append((out, done, staged))
        return True

    for _ in range(size):
        if not launch():
            break
    while pending:
        out, done, _ = pending.pop(0)
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        launch()
        yield out
