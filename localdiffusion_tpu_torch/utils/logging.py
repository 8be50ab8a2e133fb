"""Run logs: an append-only CSV of metrics, a phase timer and profiler
traces.

Copies of `CsvLogger` and `Timer` of `localdiffusion_tpu/utils/logging.py`,
and its `profile_trace` on `torch.profiler`.  The timer takes a `sync`
callable where the JAX one blocks on arrays: pass `torch.cuda.synchronize`
to time work on the card to its end.

While a `profile_trace` session records, `profiling()` is true, and the
UNet marks each stage with a `torch.profiler.record_function` scope of its
JAX module path (`stage_scope`), which `scripts.profile_attr` reads back;
outside a session the scopes are not entered and cost nothing.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import tempfile
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np


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


# the host's calls that launch work on the card, as a Chrome trace files
# them: the CUDA runtime API's (cudaLaunchKernel) and the CUDA driver API's
# (cuLaunchKernel, which cuBLAS uses)
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def launch_gaps_us(events) -> List[float]:
    """Each kernel's start less its launch's host start, in microseconds,
    from the events of a Chrome trace (`traceEvents`): a kernel and its
    runtime call share `args.correlation`.  The card's timestamps are
    mapped onto the host clock; a gap of some microseconds is the launch's
    latency, anything more is the mapping's error."""
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    return [float(e["ts"]) - float(launches[c]) for e in events
            if e.get("cat") == "kernel" and (c := e.get("args", {}).get("correlation")) in launches]


def lost_kernels(events) -> Tuple[int, int]:
    """(kernel launches whose kernel is not in the trace, kernel launches)
    of a Chrome trace's events: the host's launch calls are always kept, so
    a launch without its kernel is device activity the profiler dropped."""
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "Launch" in e.get("name", "")
                and "correlation" in e.get("args", {})}
    kept = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return len(launched - kept), len(launched)


# the least length of a session with a card.  On an H100 machine the
# profiler kept a session's device activity with a chance that fell as the
# process aged and rose with the session's length: from ~50 s of age on, a
# session of a few milliseconds kept none most times, one of 1 s 1 time in
# 24, of 2 s about half, of 4 s 22 in 24 and of 8 s 24 in 24 (ages 85-948
# s); a forced CUPTI flush, padding one side only, or a warm-up phase did
# not help.  The loss was all or nothing, not at a window's edges.
MIN_SESSION_S = 8.0
_SESSIONS = [0]  # profile_trace sessions recording now


def profiling() -> bool:
    """Whether a `profile_trace` session is recording."""
    return _SESSIONS[0] > 0


def stage_scope(name: str):
    """A `record_function` scope named `name` while `profile_trace`
    records, else a context that does nothing."""
    if not _SESSIONS[0]:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Record the block under `torch.profiler` (CPU activity, and the card's
    when CUDA is available) and write it as a Chrome trace,
    `<log_dir>/trace.json`, when the block ends; yields the profiler (its
    `key_averages()` and `events()`), or None with `enabled=False`, which
    records nothing.

    With a card the session lasts at least `MIN_SESSION_S` (see there):
    the card drained, the host sleeps half of it before the block and the
    rest after it, so a block of a few
    milliseconds keeps its device activity in an aged process too.  The
    profiler gets `session_s`, and `lost_kernels` and `launched_kernels`
    read from the trace; a session that lost any kernel it launched, or
    recorded no device activity, warns (a RuntimeWarning naming the
    trace)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    length = 0.0
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        length = MIN_SESSION_S
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        time.sleep(length / 2)
        _SESSIONS[0] += 1
        try:
            yield prof
        finally:
            _SESSIONS[0] -= 1
        if cuda:
            torch.cuda.synchronize()
            time.sleep(max(0.0, length - (time.perf_counter() - t0)))
        prof.session_s = time.perf_counter() - t0
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        with open(path) as f:
            prof.lost_kernels, prof.launched_kernels = lost_kernels(json.load(f)["traceEvents"])
        if device_event_count(prof) == 0:
            lost = "holds none"
        elif prof.lost_kernels:
            lost = f"lost {prof.lost_kernels} of the {prof.launched_kernels} kernels launched"
        else:
            return
        warnings.warn(f"profile_trace asked for the card's activity and {path} {lost} (a "
                      f"session of {prof.session_s:.2f} s)", RuntimeWarning, stacklevel=3)


def read_device_clock() -> Optional[float]:
    """The median offset, in seconds, of a marker kernel's timestamp from
    its launch's in a `profile_trace` session (see `launch_gaps_us`): the
    mapping of the card's clock onto the host's, read now.  None without a
    card, or when the session kept no kernel."""
    import torch

    if not torch.cuda.is_available():
        return None
    marker = torch.zeros(1, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d):
            marker.add_(1.0)
        with open(os.path.join(d, "trace.json")) as f:
            gaps = launch_gaps_us(json.load(f)["traceEvents"])
    return float(np.median(gaps)) * 1e-6 if gaps else None
