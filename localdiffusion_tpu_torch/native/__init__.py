"""Host-side data kernels in C++ through ctypes, with a numpy route.

The port's copy of `localdiffusion_tpu/native`: `dataops.cc` (gather +
normalize, the MNIST degradation of a batch) is built with the system g++
at first use into `build/native/` beside the package (ignored by git),
named by a hash of the source and the flags, so an edit rebuilds it and a
copy built elsewhere is never loaded with other flags.  The flags carry no
`-march=native`: a library built on one host runs on another.  Without a
compiler every entry point takes its numpy route (`have_native()` says
which).  These are host helpers for the data pipeline, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "dataops.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_state: dict = {}


def library_path() -> Path:
    h = hashlib.sha256((" ".join(CXX_FLAGS) + "\0").encode() + SRC.read_bytes())
    return BUILD_DIR / f"libdataops_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile dataops.cc unless a library of the same hash exists; raises
    with g++'s stderr when the build fails, RuntimeError without g++."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at first use; None (the numpy route) when it
    cannot be built."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _state["lib"], _state["error"] = None, str(e)
            return None
        i64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_normalize_u8.argtypes = [u8p, i64p, i64, i64, ctypes.c_float, f32p]
        lib.gather_normalize_u8.restype = None
        lib.degrade_batch_u8.argtypes = [u8p, i64, i64, i64, ctypes.c_int, ctypes.c_float, f32p]
        lib.degrade_batch_u8.restype = None
        _state["lib"] = lib
        return lib


def have_native() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (None if it was, or was not tried)."""
    return _state.get("error")


def gather_normalize(images: np.ndarray, idx: np.ndarray, scale: float,
                     use_native: bool = True) -> np.ndarray:
    """uint8 [N, H, W] gathered by idx → float32 [K, H, W] scaled."""
    images = np.ascontiguousarray(images, np.uint8)
    idx = np.ascontiguousarray(idx, np.int64)
    k = len(idx)
    n, h, w = images.shape[:3]
    if k and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"indices outside [0, {n})")
    lib = _load() if use_native else None
    if lib is None:
        return (images[idx].astype(np.float32) * scale).reshape(k, h, w)
    out = np.empty((k, h * w), np.float32)
    lib.gather_normalize_u8(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        k, h * w, scale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out.reshape(k, h, w)


def degrade_batch(images: np.ndarray, h_only: bool, scale: float,
                  use_native: bool = True) -> np.ndarray:
    """Batch LR degradation (subsample + bilinear-up + normalize) of
    uint8 [N, H, W] → float32 [N, H, W]."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w = images.shape
    lib = _load() if use_native else None
    if lib is None:
        from localdiffusion_tpu_torch.data.mnist import degrade

        out = np.stack([degrade(images[i].astype(np.float32), "h_only" if h_only else "full")
                        for i in range(n)])
        return out * scale
    out = np.empty((n, h, w), np.float32)
    lib.degrade_batch_u8(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, int(h_only), scale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
