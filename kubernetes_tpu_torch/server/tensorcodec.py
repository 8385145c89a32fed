"""Columnar tensor wire format for the bulk gRPC path (SURVEY §6.8).

One message = one 4-byte little-endian header length, a JSON header, then
the raw array bytes back-to-back. The header carries request metadata plus
an array directory (name, dtype, shape, byte offset/length into the
payload). This keeps the hot 50k-pod path free of per-pod JSON — a pod
batch is three arrays, not 50k objects — while staying dependency-free
(grpcio's generic handlers carry opaque bytes; no protoc codegen needed
in this image).

Only little-endian scalar dtypes cross the wire (int8..int64, uint*,
float32/64, bool) — shapes and dtypes are validated on decode so a
malformed message errors instead of shearing memory.

Copied from ``kubernetes_tpu/server/tensorcodec.py``.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_ALLOWED_DTYPES = {
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float32", "float64", "bool",
}


def encode(meta: dict, arrays: dict[str, np.ndarray] | None = None) -> bytes:
    arrays = arrays or {}
    directory = []
    chunks = []
    off = 0
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        dt = a.dtype.name
        if dt not in _ALLOWED_DTYPES:
            raise ValueError(f"dtype {dt} not wire-safe for array {name!r}")
        raw = a.tobytes()
        directory.append(
            {
                "name": name,
                "dtype": dt,
                "shape": list(a.shape),
                "offset": off,
                "nbytes": len(raw),
            }
        )
        chunks.append(raw)
        off += len(raw)
    header = json.dumps({"meta": meta, "arrays": directory}).encode()
    return struct.pack("<I", len(header)) + header + b"".join(chunks)


def decode(data: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    if len(data) < 4:
        raise ValueError("truncated message")
    (hlen,) = struct.unpack_from("<I", data, 0)
    if 4 + hlen > len(data):
        raise ValueError("truncated header")
    header = json.loads(data[4 : 4 + hlen].decode())
    payload = memoryview(data)[4 + hlen :]
    arrays: dict[str, np.ndarray] = {}
    for ent in header.get("arrays") or []:
        dt = ent["dtype"]
        if dt not in _ALLOWED_DTYPES:
            raise ValueError(f"dtype {dt} not wire-safe")
        shape = tuple(int(s) for s in ent["shape"])
        dtype = np.dtype(dt)
        expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if ent["nbytes"] != expect:
            raise ValueError(
                f"array {ent['name']!r}: {ent['nbytes']} bytes != shape {shape}"
            )
        start = int(ent["offset"])
        if start < 0 or start + expect > len(payload):
            raise ValueError(
                f"array {ent['name']!r}: offset {start} out of payload bounds"
            )
        buf = payload[start : start + expect]
        arrays[ent["name"]] = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return header.get("meta") or {}, arrays
