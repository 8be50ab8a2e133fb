"""Port parity: the streaming loader (`data/stream.py`), the native data
kernels (`native/`) and `utils.logging.profile_trace`.

`StreamLoader` against the JAX loader on the same shards, bit for bit
(batches, order, sizes) over several epochs, with and without shuffle and
drop_last; a decode error raised in the consumer; an abandoned epoch stops
the worker; the trainer's epoch step fed by it equals the one fed by
`ArrayLoader` on the same rows in the same order; `device_prefetch` on the
CPU; `profile_trace` writes its trace, lasts `MIN_SESSION_S` around the
block with a card, and warns when a session that asked for the card's
activity recorded none or lost a kernel it launched; a trace's launch
gaps and lost kernels are read from its events.  The native kernels against the JAX module's numpy route: gather +
normalize bit for bit, the degradation within its 1e-4.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch

from localdiffusion_tpu import native as jnative
from localdiffusion_tpu.data.stream import StreamLoader as JStreamLoader
from localdiffusion_tpu_torch import native
from localdiffusion_tpu_torch.data.loader import ArrayLoader
from localdiffusion_tpu_torch.data.stream import StreamLoader, device_prefetch, npy_shard
from localdiffusion_tpu_torch.utils.logging import profile_trace


def _shards(sizes, dim=3):
    """In-memory shards of distinct rows: (x, y), x[i, 0] a unique id."""
    shards, offset = [], 0
    for n in sizes:
        x = np.arange(offset, offset + n, dtype=np.float32)[:, None] * np.ones((1, dim), np.float32)
        shards.append(lambda x=x: (x, -x))
        offset += n
    return shards


@pytest.mark.parametrize("shuffle,drop_last,bs", [(True, False, 4), (True, True, 4),
                                                  (False, False, 3), (False, True, 5),
                                                  (True, False, 7)])
def test_batches_match_jax_bit_for_bit(shuffle, drop_last, bs):
    sizes = [7, 5, 11, 2]
    kw = dict(batch_size=bs, shuffle=shuffle, seed=3, drop_last=drop_last)
    port = StreamLoader(_shards(sizes), sizes, **kw)
    jax_ld = JStreamLoader(_shards(sizes), sizes, **kw)
    assert len(port) == len(jax_ld)
    for e in range(3):  # explicit epochs and the loaders' own counters
        for got, want in zip(list(port.epoch_batches(e)) + list(port.epoch_batches()),
                             list(jax_ld.epoch_batches(e)) + list(jax_ld.epoch_batches())):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert port.epoch == jax_ld.epoch == 3


def test_npy_shards_and_trainer_epoch_match_array_loader(tmp_path):
    """Unshuffled .npy shards stream the rows ArrayLoader batches without a
    shuffle; the trainer's epoch step over either takes the same step."""
    from localdiffusion_tpu_torch import config as tcfg
    from localdiffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from localdiffusion_tpu_torch.train.trainer import Trainer
    from test_torch_support import small_model_cfg

    rng = np.random.default_rng(0)
    hr = rng.uniform(0, 2, (10, 8, 8, 1)).astype(np.float32)
    lr = rng.uniform(0, 2, (10, 8, 8, 1)).astype(np.float32)
    shards = []
    for i, (a, b) in enumerate(((0, 6), (6, 10))):
        np.save(tmp_path / f"hr{i}.npy", hr[a:b])
        np.save(tmp_path / f"lr{i}.npy", lr[a:b])
        shards.append(npy_shard(str(tmp_path / f"hr{i}.npy"), str(tmp_path / f"lr{i}.npy")))
    stream = StreamLoader(shards, [6, 4], batch_size=4, shuffle=False)
    array = ArrayLoader(hr, lr, batch_size=4, shuffle=False)
    for a, b in zip(stream.epoch_batches(0), array.epoch_batches(0)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    losses, states = [], []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for batches in (stream.epoch_batches(0),
                        device_prefetch(array.epoch_batches(0), device="cpu")):
            tr = Trainer(GaussianDiffusion(small_model_cfg(), tcfg.DiffusionConfig(
                image_size=8, timesteps=10), device="cpu"), tcfg.TrainConfig(batch_size=4))
            losses.append(tr.train_epoch_step(batches, torch.Generator().manual_seed(0)))
            states.append(tr.model.state_dict())
    finally:
        torch.set_num_threads(n)
    assert losses[0] == losses[1]
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_decode_error_and_size_mismatch_raise_in_the_consumer():
    def bad():
        raise OSError("corrupt shard")

    with pytest.raises(OSError, match="corrupt shard"):
        list(StreamLoader([bad], [3], batch_size=2).epoch_batches(0))
    with pytest.raises(ValueError, match="declared 5 rows"):
        list(StreamLoader(_shards([4]), [5], batch_size=2).epoch_batches(0))
    with pytest.raises(ValueError):
        StreamLoader(_shards([4]), [4, 4], batch_size=2)


def test_abandoned_epoch_stops_worker():
    """Closing the generator mid-epoch stops the decode thread instead of
    leaving it blocked on the bounded queue with shards pinned."""
    loads = []

    def make_shard(i):
        def load():
            loads.append(i)
            x = np.full((4, 3), float(i), np.float32)
            return (x, -x)
        return load

    ld = StreamLoader([make_shard(i) for i in range(6)], [4] * 6, batch_size=2,
                      prefetch_shards=1, shuffle=False)
    it = ld.epoch_batches(0)
    next(it)
    it.close()
    time.sleep(0.6)
    n_after_close = len(loads)
    time.sleep(0.6)
    assert len(loads) == n_after_close < 6


def test_device_prefetch_on_the_cpu_keeps_the_batches():
    sizes = [5, 6]
    ld = StreamLoader(_shards(sizes), sizes, batch_size=4, seed=1)
    plain = list(ld.epoch_batches(0))
    pre = list(device_prefetch(ld.epoch_batches(0), size=2, device="cpu"))
    assert len(plain) == len(pre) == 3
    for a, b in zip(plain, pre):
        assert isinstance(b[0], torch.Tensor)
        np.testing.assert_array_equal(b[0].numpy(), a[0])


def test_native_builds_and_matches_the_jax_numpy_route():
    assert native.have_native(), native.build_error()
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (20, 28, 28), dtype=np.uint8)
    idx = np.asarray([3, 0, 19, 7])
    want = imgs[idx].astype(np.float32) * np.float32(2.0 / 255.0)
    for use_native in (True, False):
        np.testing.assert_array_equal(native.gather_normalize(imgs, idx, 2.0 / 255.0, use_native),
                                      want)
    with pytest.raises(IndexError):
        native.gather_normalize(imgs, np.asarray([20]), 1.0)
    for h_only in (True, False):
        from localdiffusion_tpu.data.mnist import degrade as jdegrade

        ref = np.stack([jdegrade(imgs[i].astype(np.float32), "h_only" if h_only else "full")
                        for i in range(5)]) * (2.0 / 255.0)
        numpy_route = native.degrade_batch(imgs[:5], h_only, 2.0 / 255.0, use_native=False)
        np.testing.assert_array_equal(numpy_route, ref)
        np.testing.assert_allclose(native.degrade_batch(imgs[:5], h_only, 2.0 / 255.0), ref,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(native.degrade_batch(imgs[:5], h_only, 2.0 / 255.0),
                                   jnative.degrade_batch(imgs[:5], h_only, 2.0 / 255.0),
                                   rtol=1e-4, atol=1e-4)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None and not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    names = {e.name for e in prof.events()}
    assert any("matmul" in n or "mm" in n for n in names)
    text = (tmp_path / "on" / "trace.json").read_text()
    assert '"traceEvents"' in text


class _Kineto:
    def __init__(self, kinds):
        self.kinds = kinds

    def events(self):
        return [type("E", (), {"device_type": lambda self, k=k: k})() for k in self.kinds]


class _Session:
    """A stand-in `torch.profiler.profile` whose finished session holds the
    given device types and writes the given trace events (a CUDA session
    cannot run on the CPU-only build)."""

    def __init__(self, kinds, events):
        self.kinds, self.trace = kinds, events

    def __call__(self, activities):
        self.activities = activities
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.profiler = type("P", (), {"kineto_results": _Kineto(self.kinds)})()
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.trace}, f)


def _launch(c):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.0 * c,
            "args": {"correlation": c}}


def _kernel(c):
    return {"cat": "kernel", "name": "k", "ts": 10.0 * c + 5, "args": {"correlation": c}}


@pytest.mark.parametrize("device_events,trace,warned", [
    (0, [], "holds none"),
    (2, [_launch(1), _kernel(1), _launch(2), _kernel(2)], None),
    (1, [_launch(1), _kernel(1), _launch(2)], "lost 1 of the 2 kernels launched"),
], ids=["0", "2", "1-lost"])
def test_profile_trace_warns_when_the_card_recorded_nothing(tmp_path, monkeypatch,
                                                            device_events, trace, warned):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from localdiffusion_tpu_torch.utils import logging as L

    session = _Session([DeviceType.CPU] + [DeviceType.CUDA] * device_events, trace)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", session)
    # the session lasts MIN_SESSION_S: half of it before the block, the rest
    # after it (the host's sleep stood in for)
    sleeps = []
    monkeypatch.setattr(L.time, "sleep", sleeps.append)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        with profile_trace(str(tmp_path)) as prof:
            sleeps.append("block")
    assert sleeps[:2] == [L.MIN_SESSION_S / 2, "block"]
    assert L.MIN_SESSION_S / 2 < sleeps[2] <= L.MIN_SESSION_S
    assert ProfilerActivity.CUDA in session.activities
    assert (prof.lost_kernels, prof.launched_kernels) == L.lost_kernels(trace)
    said = [str(w.message) for w in record if w.category is RuntimeWarning]
    assert [m for m in said if "profile_trace" in m] == (
        [] if warned is None else [m for m in said if warned in m])
    assert warned is None or len(said) == 1
    assert (tmp_path / "trace.json").exists()


def test_launch_gaps_read_the_device_clock_drift():
    """A kernel's start less its runtime call's, matched by correlation id;
    unmatched events and other categories are left out; a launch without
    its kernel counts as lost."""
    from localdiffusion_tpu_torch.utils.logging import launch_gaps_us, lost_kernels

    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 100.0, "args": {"correlation": 7}},
        {"cat": "kernel", "name": "k", "ts": 112.5, "args": {"correlation": 7}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 200.0, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "k", "ts": 150.0, "args": {"correlation": 8}},
        {"cat": "kernel", "name": "orphan", "ts": 5.0, "args": {"correlation": 9}},
        {"cat": "gpu_memcpy", "ts": 300.0, "args": {"correlation": 7}},
        {"cat": "cpu_op", "name": "aten::add_", "ts": 99.0, "args": {}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 400.0,
         "args": {"correlation": 11}},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 450.0,
         "args": {"correlation": 13}},
        {"cat": "kernel", "name": "gemm", "ts": 460.0, "args": {"correlation": 13}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 500.0,
         "args": {"correlation": 12}},
    ]
    assert launch_gaps_us(events) == [12.5, -50.0, 10.0]
    assert launch_gaps_us([]) == []
    assert lost_kernels(events) == (1, 4)
    assert lost_kernels([]) == (0, 0)
