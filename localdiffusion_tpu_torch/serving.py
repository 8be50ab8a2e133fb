"""Serving runtime: dynamic batching over the pipeline.

Port of `localdiffusion_tpu/serving.py`:

  * one static batch shape: partial batches are padded by repeating the
    last real row, and the padding is dropped on output;
  * dynamic batching: a worker collects up to `batch_size` requests,
    waiting at most `max_wait_ms` after the first;
  * overlapped detection (`overlap_detect=True`): Stage A of batch N+1 runs
    on the collecting thread while batch N samples on a second thread;
  * uniform/branched partitioning: rows whose mask is uniform ones take the
    plain chain; a mixed batch is merged into one branched dispatch (a plain
    row rides it under its uniform mask) unless `merge_mixed=False`;
  * deterministic noise: batch i samples with the seed `batch_seed(base_seed,
    i)`, so a served result is reproducible by replaying the same rows in
    the same slots.

Stage A is the caller's mask or the pipeline's front end (`detect`: the
PatchCore detector, or the manual and none masks), run on the padded rows
of the requests that brought no mask.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


def batch_seed(base_seed: int, index: int) -> int:
    """The noise seed of batch `index`."""
    return int(np.random.SeedSequence([base_seed, index]).generate_state(1)[0])


@dataclass(eq=False)  # identity equality: requests are queue tickets
class _Request:
    lr: np.ndarray  # [H, W, C]
    mask: Optional[np.ndarray]  # [H, W, 1] or None → detector decides
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.perf_counter)


class InferenceServer:
    """Dynamic-batching front over a LocalDiffusionPipeline.

        srv = InferenceServer(pipe, batch_size=8, max_wait_ms=50).start()
        out = srv.submit(lr_image).result()   # {"pred": [H,W,C], "branched": bool, ...}
        srv.stop()

    `noise_for_batch(i)` gives the noise of batch i (an int seed or a noise
    source); it defaults to `batch_seed(base_seed, i)`.  It is called once
    per dispatch, so a batch split into two dispatches gives each the same
    noise stream.
    """

    def __init__(self, pipeline, batch_size: int = 8, max_wait_ms: float = 50.0,
                 base_seed: int = 0, merge_mixed: bool = True,
                 overlap_detect: bool = True,
                 noise_for_batch: Optional[Callable[[int], object]] = None):
        self.pipe = pipeline
        self.batch_size = int(batch_size)
        self.max_wait = max_wait_ms / 1e3
        self.merge_mixed = bool(merge_mixed)
        self.overlap_detect = bool(overlap_detect)
        self.noise_for_batch = noise_for_batch or (lambda i: batch_seed(base_seed, i))
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # detect→sample handoff, bounded: detection runs one batch ahead
        self._sq: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._sampler_thread: Optional[threading.Thread] = None
        self._sampling = threading.Event()  # Stage B in flight
        self._batch_index = 0
        self._lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "requests": 0,
            "batches": 0,
            "plain_dispatches": 0,
            "branched_dispatches": 0,
            "merged_dispatches": 0,
            "padded_slots": 0,
            "overlap_batches": 0,
            "latency_sum_s": 0.0,
            "latency_max_s": 0.0,
        }

    def start(self):
        self._stop.clear()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        if self.overlap_detect:
            self._sampler_thread = threading.Thread(target=self._sample_loop, daemon=True)
            self._sampler_thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=60)
            self._worker = None
        if self._sampler_thread is not None:
            self._sq.put(None)  # sentinel: drain and exit
            self._sampler_thread.join(timeout=120)
            self._sampler_thread = None
        # requests still queued are never processed: fail their futures
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, lr: np.ndarray, mask: Optional[np.ndarray] = None) -> Future:
        """Enqueue one [H, W, C] conditioning image; resolves to a dict with
        'pred' [H, W, C], 'mask', 'branched', 'latency_s'."""
        lr = np.asarray(lr, np.float32)
        if lr.ndim != 3:
            raise ValueError(f"submit expects one [H,W,C] image, got {lr.shape}")
        req = _Request(lr=lr, mask=None if mask is None else np.asarray(mask, np.float32))
        self._q.put(req)
        return req.future

    def _collect(self) -> List[_Request]:
        """Block for the first request, then fill the batch for max_wait."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        """Collect and run Stage A; hand the batch to the sampler thread, or
        run Stage B inline without overlap_detect."""
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            index = self._batch_index
            self._batch_index += 1
            try:
                overlapped = self._sampling.is_set()
                self._stage_a(batch)
                if overlapped:
                    with self._lock:
                        self.stats["overlap_batches"] += 1
            except Exception as e:  # resolve the futures, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                continue
            if self.overlap_detect:
                self._sq.put((batch, index))
            else:
                self._run_stage_b(batch, index)

    def _sample_loop(self):
        while True:
            item = self._sq.get()
            if item is None:
                return
            self._run_stage_b(*item)

    def _run_stage_b(self, batch: List[_Request], index: int):
        self._sampling.set()
        try:
            self._stage_b(batch, index)
        except Exception as e:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self._sampling.clear()

    def _pad(self, rows: List[np.ndarray]) -> np.ndarray:
        arr = np.stack(rows)
        pad = self.batch_size - len(rows)
        if pad > 0:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
        return arr

    def _stage_a(self, batch: List[_Request]):
        """Masks for the rows that did not bring one."""
        need = [r for r in batch if r.mask is None]
        if need and self.pipe.config.sampler.ood_ad:
            masks, _, _ = self.pipe.detect(self._pad([r.lr for r in need]))
            for r, m in zip(need, masks):
                r.mask = m
        for r in batch:
            if r.mask is None:
                r.mask = np.ones((*r.lr.shape[:2], 1), np.float32)

    def _stage_b(self, batch: List[_Request], index: int):
        scfg = self.pipe.config.sampler
        plain = [r for r in batch if np.all(r.mask == 1.0) or not scfg.branch_out]
        branched = [r for r in batch if r not in plain]
        if plain and branched and self.merge_mixed:
            groups = [(batch, "merged_dispatches")]
        else:
            groups = [(plain, "plain_dispatches"), (branched, "branched_dispatches")]

        outs: Dict[int, Dict] = {}
        for group, stat_key in groups:
            if not group:
                continue
            res = self.pipe.translate(
                self._pad([r.lr for r in group]),
                noise=self.noise_for_batch(index),
                mask=self._pad([r.mask for r in group]),
            )
            with self._lock:
                self.stats[stat_key] += 1
                self.stats["padded_slots"] += self.batch_size - len(group)
            for i, r in enumerate(group):
                outs[id(r)] = {
                    "pred": res["pred"][i],
                    "mask": np.asarray(r.mask),
                    # a plain row riding a merged dispatch was served the
                    # plain trajectory
                    "branched": bool(res["branched"]) and not bool(np.all(r.mask == 1.0)),
                }

        now = time.perf_counter()
        with self._lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
        for r in batch:
            out = outs[id(r)]
            lat = now - r.t_enqueue
            out["latency_s"] = lat
            with self._lock:
                self.stats["latency_sum_s"] += lat
                self.stats["latency_max_s"] = max(self.stats["latency_max_s"], lat)
            r.future.set_result(out)

    def snapshot_stats(self) -> Dict[str, float]:
        with self._lock:
            s = dict(self.stats)
        if s["requests"]:
            s["latency_mean_s"] = s["latency_sum_s"] / s["requests"]
            s["mean_batch_fill"] = s["requests"] / max(s["batches"], 1)
        return s
