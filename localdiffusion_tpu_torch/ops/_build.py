"""Builds the port's CUDA sources with plain nvcc, loads them with ctypes,
and counts the wrappers' launches.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers), so
one nvcc call builds it in seconds.  The shared library goes to `build/`
beside the package (ignored by git), named by a hash of the source, of
every local header it includes (`#include "…"`, followed through headers)
and of the flags, so an edit to any of them rebuilds it at its next first
use and an unchanged one is not rebuilt.  A failed build raises with
nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_loaded: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to `fn.launches`, a kernel wrapper's launch count.  Under a
    lock: the serving threads (Stage A of one batch, Stage B of another)
    launch kernels at once, and `+=` on an attribute is a read and a write
    that another thread may come between."""
    with _count_lock:
        fn.launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def sources(name: str) -> list:
    """csrc/<name>.cu and the local headers it includes, directly or through
    another header, in a fixed order."""
    seen = set()
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text(encoding="utf-8")):
            dep = path.parent / inc
            if dep.exists():
                todo.append(dep)
    return sorted(seen)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library of the same hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
