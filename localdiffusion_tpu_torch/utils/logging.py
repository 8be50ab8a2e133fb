"""Run logs: an append-only CSV of metrics, a phase timer and profiler
traces.

Copies of `CsvLogger` and `Timer` of `localdiffusion_tpu/utils/logging.py`,
and its `profile_trace` on `torch.profiler`.  The timer takes a `sync`
callable where the JAX one blocks on arrays: pass `torch.cuda.synchronize`
to time work on the card to its end.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
import warnings
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


def device_event_count(prof) -> int:
    """The card's activities (kernels, copies, sets) that a finished
    `torch.profiler.profile` session recorded."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        return sum(1 for e in results.events() if e.device_type() == DeviceType.CUDA)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Record the block under `torch.profiler` (CPU activity, and the card's
    when CUDA is available) and write it as a Chrome trace,
    `<log_dir>/trace.json`, when the block ends; yields the profiler (its
    `key_averages()` and `events()`), or None with `enabled=False`, which
    records nothing.

    A session that asked for the card's activity and recorded none warns
    (a RuntimeWarning naming the trace).  On an H100 machine the card's
    timestamps drifted from the host clock as the process aged, and the
    profiler drops device activity stamped outside the session's host-clock
    window: from ~30 s of age on, a session of a few milliseconds kept no
    device event, where the same work with 0.5 s of host time on either
    side kept every one.  Trace a long block, or a fresh
    process."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities and device_event_count(prof) == 0:
        warnings.warn(f"profile_trace asked for the card's activity and {path} holds none "
                      f"(device timestamps outside the session's window: trace a longer "
                      f"block, or a fresh process)", RuntimeWarning, stacklevel=3)
