"""Stage B as compiled programs: each step body of a sampler captured once
as a CUDA graph and replayed step by step.

The JAX pipeline jit-compiles its samplers (`localdiffusion_tpu/pipeline.py`
`_compile_branched`, `_compile_plain`): each phase is one `lax.scan` whose
body is traced once and looped on the device.  Here a sampler hands each
step to a step runner (`diffusion.sampler`), and `GraphSteps` is the
compiled runner: at a body's first step it runs the body eagerly on the
current stream (that step is the warm-up: it loads the kernels' libraries,
fixes cuDNN's and cuBLAS's plans and grows the linear attention's row
counters, and its result is the step's), then captures the body into a
`torch.cuda.CUDAGraph` on static inputs; every later step writes the step's
timestep, state and noise into those inputs and replays the graph.  A host
loop over the timesteps drives the replays, and the noise is drawn there,
from the chain's own source, never inside a graph, so a compiled chain
draws what the eager one draws and gives the same output, bit for bit.

A body's graph is one UNet call and its update (~1,000 kernels at 256px),
not a whole chain, which would be a graph of ~245,000 nodes.

Every launch that runs on the card, a warm-up's or a replay's, goes on
the current stream, as the eager chain's do; only the capture, which runs
nothing, is on a side stream.  The serving threads launch on the same
(default) stream, so their kernels stay in one order there: the linear
attention's kv kernel shares one counter buffer among all its launches on
a device (`ops.linear_attention._row_counters`), and two of them running
at once would interleave their tickets.

Graphs of one pipeline (`Programs`) share one private memory pool and one
capture stream.  They may replay in any order (a gated chain replays the
fusion step between phase-B steps), since every replay's outputs are
copied out before another graph replays: a graph's temporaries may lie
where another graph's outputs lie, but no graph's inputs, which are
allocated outside the pool.

A graph reads the weights by address: an in-place `load_state_dict` or
`copy_` is seen by it, a rebound parameter is not.  `Programs.get` checks
the model's fingerprint (`weights_fingerprint`: the address, shape, dtype
and strides of every parameter and buffer) before each chain and drops
every program when it has changed, so the next chain captures anew.  The
in-place writes, which bump a tensor's `_version`, are left out of it:
they need no recapture.

Launch counts: the launches of a capture are recorded (`ops._build.
recording_launches`), not counted, and each replay adds them, so a compiled
chain counts what the eager chain counts.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
import time
from typing import Dict, Optional

import torch

from localdiffusion_tpu_torch.ops import _build


# one capture at a time in the process (PyTorch's rule for CUDA graphs)
_capture_lock = threading.Lock()


def kernel_routes(model) -> tuple:
    """Each kernel-bearing module's route (`use_kernel`), in module order:
    a graph replays the route it captured."""
    return tuple(m.use_kernel for m in model.modules() if hasattr(m, "use_kernel"))


def weights_fingerprint(model) -> tuple:
    """(name, address, shape, dtype, strides) of every parameter and buffer
    of `model`."""
    return tuple((name, t.data_ptr(), tuple(t.shape), t.dtype, t.stride())
                 for name, t in itertools.chain(model.named_parameters(),
                                                model.named_buffers()))


def graph_nodes(graph) -> Optional[int]:
    """The node count of a graph captured with `keep_graph=True`, by the
    CUDA library's `cuGraphGetNodes` (libcuda); None where it refuses."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def _map(fn, out):
    return tuple(fn(o) for o in out) if isinstance(out, tuple) else fn(out)


class _Body:
    """One captured step body: its static step inputs, its graph and
    static outputs (None with capture left out), and the launches a replay
    counts."""

    def __init__(self, body, inputs: Dict[str, torch.Tensor]):
        self.body = body
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        self.launches: dict = {}
        self.nodes: Optional[int] = None


class GraphSteps:
    """The compiled step runner of one program (see the module docstring;
    `diffusion.sampler.EagerSteps` is the eager one).

    `begin(**tensors)` copies a chain's tensors into static buffers (made at
    the first chain, from its tensors' shapes, dtypes and strides; a later
    chain must match them).  `steps(name, body, t, **step)` writes t into
    the static device timestep and the step's tensors into the body's
    static inputs, then replays the body's graph and returns copies of its
    outputs; at a body's first step it runs the body eagerly (on the
    current stream) and captures it (on the capture stream).  On the CPU, which has no CUDA graphs,
    every step runs the first chain's body on the static buffers: the same
    plumbing with the capture left out.
    """

    compiled = True

    def __init__(self, device, pool=None, stream=None, label: str = ""):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.pool = pool
        self.stream = stream
        self.label = label
        self.t = torch.zeros((), dtype=torch.long, device=self.device)
        self.chain: Optional[Dict[str, torch.Tensor]] = None
        self.bodies: Dict[str, _Body] = {}
        self.capture_s = 0.0
        self.instantiate_s = 0.0
        self.replays = 0

    def begin(self, **tensors) -> None:
        if self.chain is None:
            self.chain = {k: v.clone() for k, v in tensors.items()}
            return
        if set(tensors) != set(self.chain):
            raise ValueError(f"{self.label}: chain tensors {sorted(tensors)}, the program "
                             f"holds {sorted(self.chain)}")
        for k, v in tensors.items():
            _copy_into(self.chain[k], v, f"{self.label} chain tensor {k!r}")

    def __call__(self, name: str, body, t: int, **step):
        if self.chain is None:
            raise RuntimeError(f"{self.label}: begin() a chain before its steps")
        self.t.fill_(int(t))
        entry = self.bodies.get(name)
        if entry is None:
            entry = _Body(body, {k: v.clone() for k, v in step.items()})
            self.bodies[name] = entry
            return self._first(name, entry)
        if set(step) != set(entry.inputs):
            raise ValueError(f"{self.label} {name}: step tensors {sorted(step)}, the body "
                             f"holds {sorted(entry.inputs)}")
        for k, v in step.items():
            _copy_into(entry.inputs[k], v, f"{self.label} {name} input {k!r}")
        if entry.graph is None:
            return entry.body(self._state(entry))
        entry.graph.replay()
        _build.add_launches(entry.launches)
        self.replays += 1
        return _map(torch.clone, entry.outputs)

    def _state(self, entry: _Body) -> dict:
        return {**self.chain, **entry.inputs, "t": self.t}

    def _first(self, name: str, entry: _Body):
        """The body's first step, eager on the current stream, then its
        capture on the side stream, which runs nothing on the card."""
        state = self._state(entry)
        out = entry.body(state)
        if not self.capture:
            return out
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # instantiated below
        t0 = time.perf_counter()
        with _capture_lock, _build.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                outputs = entry.body(state)
        t1 = time.perf_counter()
        entry.nodes = graph_nodes(graph)
        graph.instantiate()
        self.capture_s += t1 - t0
        self.instantiate_s += time.perf_counter() - t1
        entry.graph, entry.outputs, entry.launches = graph, outputs, launches
        return out

    def summary(self) -> dict:
        """Graphs, nodes by body, capture and instantiation seconds and
        replays of this program."""
        return dict(graphs=sum(e.graph is not None for e in self.bodies.values()),
                    nodes={k: e.nodes for k, e in self.bodies.items()},
                    capture_s=self.capture_s, instantiate_s=self.instantiate_s,
                    replays=self.replays)


def _copy_into(static: torch.Tensor, v: torch.Tensor, what: str) -> None:
    if static.shape != v.shape or static.dtype != v.dtype:
        raise ValueError(f"{what}: {tuple(v.shape)} {v.dtype}, the program holds "
                         f"{tuple(static.shape)} {static.dtype}")
    static.copy_(v)


class Programs:
    """A pipeline's compiled programs by key (`get`), on one device: one
    graph pool and one capture stream for all, every program dropped when
    the model's weights move (`weights_fingerprint`).  `lock` is held by a
    chain that runs a program, whose static buffers it owns meanwhile."""

    def __init__(self, model, device):
        self.model = model
        self.device = torch.device(device)
        self.lock = threading.RLock()
        self._programs: Dict[tuple, GraphSteps] = {}
        self._fingerprint = None
        self._pool = None
        self._stream = None
        self.recaptures = 0

    def get(self, key: tuple) -> GraphSteps:
        with self.lock:
            fp = weights_fingerprint(self.model)
            if fp != self._fingerprint:
                if self._programs:
                    self.recaptures += 1
                self._programs = {}
                self._fingerprint = fp
                if self.device.type == "cuda":
                    self._pool = torch.cuda.graph_pool_handle()
                    self._stream = torch.cuda.Stream(self.device)
            prog = self._programs.get(key)
            if prog is None:
                prog = GraphSteps(self.device, pool=self._pool, stream=self._stream,
                                  label=str(key[0]))
                self._programs[key] = prog
            return prog

    def summary(self) -> dict:
        """Each program's `GraphSteps.summary` by key, and the recaptures."""
        with self.lock:
            return dict(programs={k: p.summary() for k, p in self._programs.items()},
                        recaptures=self.recaptures)
