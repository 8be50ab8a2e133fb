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
    i)` (a gated chain's retries with the stream the sampler derives from
    it), so a served result is reproducible by replaying the same rows in
    the same slots.

Stage A is the caller's mask or the pipeline's front end (`detect`: the
PatchCore or seg detector, or the manual and none masks), run on the padded
rows of the requests that brought no mask.

Over a mesh pipeline (`LocalDiffusionPipeline(mesh=...)`, one process a
rank where the JAX server has one controller) the first rank serves: it
runs Stage A, and broadcasts each dispatch (the padded images and masks,
the batch's seeds) to the other ranks, which run `follow()` until `stop()`
sends the end; every rank then runs the dispatch's `translate` on its
share.  `batch_size` must be divisible by the mesh's 'data' width, and
`noise_for_batch` must give seeds (int or None), which cross to the other
ranks.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from localdiffusion_tpu_torch.parallel import multihost as H
from localdiffusion_tpu_torch.pipeline import batch_seed


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

    `noise_for_batch(i)` gives the noise of batch i: an int seed, a noise
    source, or a pair (noise, retry_noise) whose second item feeds a gated
    chain's retries (see diffusion.sampler: with a noise source alone a
    gated batch fails at its first gated step).  It defaults to
    `batch_seed(base_seed, i)`.  It is called once per dispatch, so a batch
    split into two dispatches gives each the same noise streams.
    """

    def __init__(self, pipeline, batch_size: int = 8, max_wait_ms: float = 50.0,
                 base_seed: int = 0, merge_mixed: bool = True,
                 overlap_detect: bool = True,
                 noise_for_batch: Optional[Callable[[int], object]] = None):
        self.pipe = pipeline
        self.batch_size = int(batch_size)
        mesh = getattr(pipeline, "mesh", None)
        if mesh is not None and self.batch_size % mesh["data"].size():
            raise ValueError(f"batch_size {self.batch_size} not divisible by mesh data width "
                             f"{mesh['data'].size()}")
        # over a mesh of several ranks, each dispatch is broadcast first
        self._broadcast = mesh is not None and H.is_multiprocess()
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

    def start(self, warmup: bool = False):
        """Start the batching worker.  `warmup` first runs each chain the
        server dispatches once (`_warmup`), so the first request does not
        pay the first launch of each kernel and cuDNN's first calls.  On a
        pipeline that compiles (`pipeline.translate` on the card without a
        mesh) that run captures every program the server dispatches before
        the worker threads start, and the first request replays; without
        it the first dispatch of each program captures on the sampling
        thread while Stage A may run on the other (the capture is
        thread-local, and the port waits on streams there, never on the
        whole device, which a capture forbids; both threads' kernels,
        warm-up steps and replays alike, run on the default stream, in the
        order they were launched)."""
        if warmup:
            self._warmup()
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
        if self._broadcast and H.is_primary():
            H.broadcast_object(None)  # the followers' end
        # requests still queued are never processed: fail their futures
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

    def follow(self) -> int:
        """On a rank other than the first of a mesh pipeline's: run every
        dispatch the first rank's server broadcasts, until its `stop()`;
        returns the number of dispatches."""
        if not self._broadcast or H.is_primary():
            raise RuntimeError("follow() runs on the other ranks of a mesh pipeline's server")
        count = 0
        while (d := H.broadcast_object()) is not None:
            self.pipe.translate(d["lr"], noise=d["noise"], retry_noise=d["retry_noise"],
                                mask=d["mask"])
            count += 1
        return count

    def _translate(self, lr: np.ndarray, mask: np.ndarray, index: int) -> Dict:
        """`translate` of one dispatch with batch `index`'s noise, the
        dispatch broadcast first over a mesh."""
        noise, retry_noise = self._noise(index)
        if self._broadcast:
            H.broadcast_object(dict(lr=lr, mask=mask, noise=noise, retry_noise=retry_noise))
        return self.pipe.translate(lr, noise=noise, retry_noise=retry_noise, mask=mask)

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

    def _warmup(self):
        """One `translate` of zeros at the static batch shape with a uniform
        mask (the plain chain) and, with `sampler.branch_out`, one with half
        the columns at 0.5 (the branched chain, gated where the pipeline
        gates: the gate runs at its first post-fusion step, so the plain
        and retry steps are captured too), both with batch 0's noise.
        It leaves the batch index and the stats as they were, so the first
        real batch gets the same noise with or without it."""
        b, s = self.batch_size, self.pipe.gd.image_size
        zeros = np.zeros((b, s, s, self.pipe.gd.model_cfg.channels), np.float32)
        masks = [np.ones((b, s, s, 1), np.float32)]
        if self.pipe.config.sampler.branch_out:
            half = np.ones((b, s, s, 1), np.float32)
            half[:, :, : s // 2] = 0.5
            masks.append(half)
        for mask in masks:
            self._translate(zeros, mask, 0)

    def _noise(self, index: int):
        """(noise, retry_noise) of batch `index` (see `noise_for_batch`)."""
        noise = self.noise_for_batch(index)
        return noise if isinstance(noise, tuple) else (noise, None)

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
            res = self._translate(self._pad([r.lr for r in group]),
                                  self._pad([r.mask for r in group]), index)
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
