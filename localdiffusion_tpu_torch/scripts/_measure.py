"""What the measuring scripts share: the card they ran on, device time by
CUDA events over CUDA-graph replays, and their JSON under `results_torch/`.

A measurement needs the card: `require_card` raises without one, so no
script times the CPU under a device metric's name.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

import torch

RESULTS = Path(__file__).resolve().parents[2] / "results_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, the same sheet
INT8_OPS_PER_S = 1979e12


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA device; torch.cuda.is_available() "
                           "is False")


def card_record() -> dict:
    """The card's name and power limit as nvidia-smi gives them (printed),
    with torch's device name, count and versions."""
    require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return {"device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                     "matmul": torch.backends.cuda.matmul.allow_tf32}}


def graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device milliseconds of one fn() call: `iters` calls captured in a
    CUDA graph, replayed `reps` times between two CUDA events, so the card
    never waits for the host (the counterpart of the JAX scripts'
    `_amortized_ms`, a scan of calls in one compiled program).  Warmed up
    on a side stream first, as capture needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 20) -> float:
    """Device-clock milliseconds of one fn() call launched from Python
    back to back (host overhead included where it bounds the card)."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def write_json(name: str, record: dict, out_dir=None) -> Path:
    """`record` as `<out_dir or results_torch>/<name>.json`; prints the path."""
    out = Path(out_dir) if out_dir else RESULTS
    os.makedirs(out, exist_ok=True)
    path = out / f"{name}.json"
    path.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {path}", flush=True)
    return path
