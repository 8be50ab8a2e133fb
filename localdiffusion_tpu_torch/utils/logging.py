"""Run logs: an append-only CSV of metrics and a phase timer.

Copies of `CsvLogger` and `Timer` of `localdiffusion_tpu/utils/logging.py`.
The timer takes a `sync` callable where the JAX one blocks on arrays: pass
`torch.cuda.synchronize` to time work on the card to its end.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, List


class CsvLogger:
    """Append-style metric logger (one CSV per stream): a header when the
    file is new, then one flushed row per `log`."""

    def __init__(self, path: str, fields: List[str]):
        self.path = path
        self.fields = fields
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fresh = not os.path.exists(path)
        self._fh = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=fields)
        if self._fresh:
            self._writer.writeheader()
            self._fh.flush()

    def log(self, **row):
        self._writer.writerow({k: row.get(k, "") for k in self.fields})
        self._fh.flush()

    def close(self):
        self._fh.close()


class Timer:
    """Wall-clock phase timer; `sync` (e.g. `torch.cuda.synchronize`) runs
    before the clock stops."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        xs = self.records.get(name, [])
        return sum(xs) / len(xs) if xs else float("nan")

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.records}
