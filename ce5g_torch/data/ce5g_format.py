"""`.ce5g` dataset container: JSON header + threaded block-compressed arrays.

Port of ``ce5g_tpu.data.ce5g_format``, with the same magic, header and
block layout, so files are cross-readable between the two packages in
both directions. Layout:

    bytes 0-7    magic b"CE5Gv1\\n\\0"
    bytes 8-15   little-endian uint64 header length H
    bytes 16-16+H  UTF-8 JSON header
    then per array, in header order, its packed compressed blocks

Header: {"arrays": [{name, dtype, shape, raw_bytes, block_size, itemsize,
backend, block_sizes}], "writer": backend}. Compression is the native
threaded zstd+byteshuffle codec (ce5g_torch/native/codec.cpp) with a
GIL-released threaded zlib fallback, chosen per file and recorded in the
header so readers never guess. Unicode arrays (channel_type) round-trip
via UTF-8 bytes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from ..native import compress_blocks, decompress_blocks, DEFAULT_BLOCK

_MAGIC = b"CE5Gv1\n\0"


def _encode(arr: np.ndarray):
    """ndarray → (raw bytes, dtype tag, itemsize for shuffle)."""
    a = np.ascontiguousarray(arr)
    if a.dtype.kind == "U":
        b = a.astype(bytes)  # UTF-8-safe for ASCII channel names
        return b.tobytes(), f"S{b.dtype.itemsize}|U", b.dtype.itemsize
    return a.tobytes(), a.dtype.str, a.dtype.itemsize


def _decode(raw: bytes, dtype_tag: str, shape) -> np.ndarray:
    if dtype_tag.endswith("|U"):
        a = np.frombuffer(raw, dtype=dtype_tag[:-2]).reshape(shape)
        return a.astype(str)
    return np.frombuffer(raw, dtype=np.dtype(dtype_tag)).reshape(shape).copy()


def write_ce5g(path, arrays: Dict[str, np.ndarray], *, level: int = 3) -> None:
    metas, payloads = [], []
    writer = None
    for name, arr in arrays.items():
        raw, dtype_tag, itemsize = _encode(arr)
        packed, sizes, backend = compress_blocks(
            raw, level=level, itemsize=itemsize
        )
        writer = writer or backend
        metas.append(
            {
                "name": name,
                "dtype": dtype_tag,
                "shape": list(np.asarray(arr).shape),
                "raw_bytes": len(raw),
                "block_size": DEFAULT_BLOCK,
                "itemsize": itemsize,
                "backend": backend,
                "block_sizes": sizes,
            }
        )
        payloads.append(packed)
    header = json.dumps({"arrays": metas, "writer": writer}).encode()
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for p in payloads:
            f.write(p)
    tmp.replace(path)


def read_ce5g(path) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a .ce5g file")
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode())
        out = {}
        for meta in header["arrays"]:
            packed = f.read(sum(meta["block_sizes"]))
            raw = decompress_blocks(
                packed,
                meta["block_sizes"],
                meta["raw_bytes"],
                block_size=meta["block_size"],
                itemsize=meta["itemsize"],
                backend=meta["backend"],
            )
            out[meta["name"]] = _decode(bytes(raw), meta["dtype"], meta["shape"])
    return out
