"""Host batching: a seeded-epoch numpy batcher.

A copy of `localdiffusion_tpu/data/loader.py` (`ArrayLoader`, `cycle`),
numpy only, kept here because the port imports nothing of the JAX package.
Batches are NHWC numpy arrays; the trainer copies each to the device once.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


class ArrayLoader:
    """Batches over pre-materialized arrays with per-epoch seeded shuffles.

    The reference seeds its shuffles with np.random.seed(42)
    (ddpm.py:1310, 1336); here the epoch index folds into the seed so every
    epoch's order is reproducible independently.
    """

    def __init__(
        self,
        *arrays: np.ndarray,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = False,
    ):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError(f"arrays of different lengths: {[len(a) for a in arrays]}")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch_batches(self, epoch: Optional[int] = None) -> Iterator[Tuple]:
        e = self.epoch if epoch is None else epoch
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + e)
            rng.shuffle(idx)
        bs = self.batch_size
        stop = (self.n // bs) * bs if self.drop_last else self.n
        for i in range(0, stop, bs):
            sel = idx[i : i + bs]
            yield tuple(a[sel] for a in self.arrays)
        if epoch is None:
            self.epoch += 1

    def __iter__(self):
        return self.epoch_batches()


def cycle(loader: ArrayLoader) -> Iterator[Tuple]:
    """Endless batch stream (reference ddpm.py:83-86)."""
    while True:
        yield from loader.epoch_batches()
