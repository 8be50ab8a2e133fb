"""Minimal MetaImage (.mha / .mhd) volume reader — no medpy/SimpleITK needed.

A copy of `localdiffusion_tpu/data/mha.py` (numpy and zlib only), kept here
because the port imports nothing of the JAX package.

The reference loads BRATS volumes with `medpy.io.load` (reference
data.py:444-604); medpy is absent from this environment, so this module
implements the MetaImage container directly: an ASCII key = value header
followed by (optionally zlib-compressed) raw voxel data, either inline
(ElementDataFile = LOCAL) or in a sibling .raw/.zraw file.

Covers the subset BRATS 2015-style volumes use: scalar element types,
NDims ≤ 4, MSB/LSB byte order, CompressedData via zlib.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Tuple

import numpy as np

_ELEMENT_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


def _parse_header(fh) -> Tuple[Dict[str, str], int]:
    """Read `Key = Value` lines until ElementDataFile; return (header,
    offset-of-data) — ElementDataFile is by spec the last header line."""
    header: Dict[str, str] = {}
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("truncated MetaImage header (no ElementDataFile)")
        text = line.decode("ascii", errors="replace").strip()
        if "=" not in text:
            raise ValueError(f"malformed MetaImage header line: {text!r}")
        key, value = (s.strip() for s in text.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            return header, fh.tell()


def load_mha(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """→ (volume array [..., z, y, x] C-ordered as stored, header dict).

    Matches medpy.io.load's data layout for BRATS .mha (reference
    data.py:478: volumes indexed [slice, :, :] after transpose handling —
    the caller decides axis order; this returns the raw C-order array with
    shape DimSize reversed, i.e. [dimN-1, ..., dim0]).
    """
    with open(path, "rb") as fh:
        header, offset = _parse_header(fh)

        etype = header.get("ElementType", "MET_FLOAT")
        if etype not in _ELEMENT_TYPES:
            raise ValueError(f"unsupported ElementType {etype}")
        dtype = np.dtype(_ELEMENT_TYPES[etype])
        dims = [int(d) for d in header["DimSize"].split()]
        count = int(np.prod(dims))
        byte_order_msb = header.get(
            "ElementByteOrderMSB", header.get("BinaryDataByteOrderMSB", "False")
        )
        if byte_order_msb.lower() == "true":
            dtype = dtype.newbyteorder(">")
        compressed = header.get("CompressedData", "False").lower() == "true"

        datafile = header["ElementDataFile"]
        if datafile == "LOCAL":
            fh.seek(offset)
            raw = fh.read()
        else:
            sibling = os.path.join(os.path.dirname(path), datafile)
            with open(sibling, "rb") as dfh:
                raw = dfh.read()

    if compressed:
        raw = zlib.decompress(raw)
    expected = count * dtype.itemsize
    if len(raw) < expected:
        raise ValueError(
            f"MetaImage data too short: {len(raw)} < {expected} bytes"
        )
    arr = np.frombuffer(raw[:expected], dtype=dtype)
    # C-order with the fastest-varying dimension first in DimSize
    return arr.reshape(tuple(reversed(dims))), header


def save_mha(path: str, volume: np.ndarray, compressed: bool = False) -> None:
    """Write a LOCAL-data .mha (used by tests and round-trip checks)."""
    dtype_name = {v: k for k, v in _ELEMENT_TYPES.items()}[
        np.dtype(volume.dtype).type
    ]
    dims = " ".join(str(d) for d in reversed(volume.shape))
    header = (
        f"ObjectType = Image\n"
        f"NDims = {volume.ndim}\n"
        f"BinaryData = True\n"
        f"BinaryDataByteOrderMSB = False\n"
        f"CompressedData = {compressed}\n"
        f"DimSize = {dims}\n"
        f"ElementType = {dtype_name}\n"
        f"ElementDataFile = LOCAL\n"
    )
    raw = np.ascontiguousarray(volume).tobytes()
    if compressed:
        raw = zlib.compress(raw)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(raw)
