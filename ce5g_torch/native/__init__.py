"""Native (C++) runtime components of the port, loaded via ctypes.

A copy of ``ce5g_tpu.native``: the threaded block codec (``codec.cpp``)
behind :func:`compress_blocks` / :func:`decompress_blocks`. The shared
library is built on first use with g++ into ``ce5g_torch/_build/``
(hash-keyed, so an edited source rebuilds; written to a temporary file
and renamed, so concurrent test workers never load half a file). If no
toolchain or zstd is available, the pure-Python fallback (zlib on a
thread pool — zlib releases the GIL, so it still scales with cores) keeps
every caller working with the same file format semantics: the container
records which backend wrote it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "codec.cpp"
_BUILD = _HERE.parent / "_build"

# zstd is linked by its versioned runtime name: hosts with the runtime
# library but not the development package (no zstd.h, no libzstd.so) build
# the codec too (codec.cpp declares the four functions it calls)
_CFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-l:libzstd.so.1", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build_lib() -> Optional[ctypes.CDLL]:
    """Compile codec.cpp → libce5gcodec-<srchash>.so (cached) and load it."""
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src + " ".join(_CFLAGS + _LIBS).encode()).hexdigest()[:16]
    so = _BUILD / f"libce5gcodec-{tag}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = ["g++", *_CFLAGS, str(_SRC), *_LIBS, "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.ce5g_bound.restype = ctypes.c_int64
    lib.ce5g_bound.argtypes = [ctypes.c_int64]
    lib.ce5g_compress.restype = ctypes.c_int64
    lib.ce5g_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ce5g_decompress.restype = ctypes.c_int64
    lib.ce5g_decompress.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use (None if
    unavailable — callers fall back to the Python backend)."""
    global _lib, _lib_tried
    with _lock:
        if not _lib_tried:
            _lib = _build_lib()
            _lib_tried = True
        return _lib


def have_native() -> bool:
    return get_lib() is not None


DEFAULT_BLOCK = 1 << 20  # 1 MiB blocks: enough parallelism, low header cost


def _nthreads() -> int:
    return max(os.cpu_count() or 1, 1)


def compress_blocks(
    data: bytes | memoryview,
    *,
    block_size: int = DEFAULT_BLOCK,
    level: int = 3,
    itemsize: int = 1,
    nthreads: Optional[int] = None,
) -> Tuple[bytes, List[int], str]:
    """Compress a buffer in independent blocks.

    Returns (packed_compressed_bytes, per_block_sizes, backend) where
    backend is 'zstd-shuffle' (native) or 'zlib' (fallback). ``itemsize``
    enables the byte-shuffle filter for fixed-size numeric items (native
    backend only; block_size is rounded to a multiple of itemsize).
    """
    data = memoryview(data).cast("B")
    n = len(data)
    if itemsize > 1:
        block_size -= block_size % itemsize or 0
        block_size = max(block_size, itemsize)
    nblocks = (n + block_size - 1) // block_size if n else 0
    nthreads = nthreads or _nthreads()

    lib = get_lib()
    if lib is not None:
        bound = lib.ce5g_bound(block_size)
        dst = ctypes.create_string_buffer(max(nblocks * bound, 1))
        sizes = (ctypes.c_int64 * max(nblocks, 1))()
        # Zero-copy input: wrap the caller's buffer directly instead of
        # materializing bytes(data) (hundreds of MB of memcpy per chunk).
        if data.readonly:
            base = data.obj
            src = base if isinstance(base, bytes) and len(base) == n else bytes(data)
        else:
            src = (ctypes.c_char * n).from_buffer(data)
        total = lib.ce5g_compress(
            src, n, block_size, level, itemsize, nthreads, dst, sizes
        )
        if total >= 0:
            # string_at copies exactly `total` bytes once (dst.raw[:total]
            # would copy the full nblocks·bound staging buffer first).
            return (
                ctypes.string_at(dst, total),
                list(sizes[:nblocks]),
                "zstd-shuffle",
            )
        # fall through to Python backend on native error

    import zlib

    blocks = [bytes(data[i * block_size:(i + 1) * block_size]) for i in range(nblocks)]
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        comp = list(ex.map(lambda b: zlib.compress(b, level), blocks))
    return b"".join(comp), [len(c) for c in comp], "zlib"


def decompress_blocks(
    packed: bytes | memoryview,
    block_sizes: List[int],
    raw_total: int,
    *,
    block_size: int = DEFAULT_BLOCK,
    itemsize: int = 1,
    backend: str = "zstd-shuffle",
    nthreads: Optional[int] = None,
) -> bytearray:
    """Inverse of :func:`compress_blocks`; raises ValueError on a corrupt
    stream or when the native backend is required but unavailable."""
    if itemsize > 1:
        block_size -= block_size % itemsize or 0
        block_size = max(block_size, itemsize)
    nthreads = nthreads or _nthreads()
    out = bytearray(raw_total)
    if raw_total == 0:
        return out

    if backend == "zstd-shuffle":
        lib = get_lib()
        if lib is None:
            raise ValueError(
                "file was written by the native zstd codec but the native "
                "library is unavailable on this host (no g++/zstd)"
            )
        sizes = (ctypes.c_int64 * max(len(block_sizes), 1))(*block_sizes)
        pk = memoryview(packed).cast("B")
        if pk.readonly:
            base = pk.obj
            src = base if isinstance(base, bytes) and len(base) == len(pk) else bytes(pk)
        else:
            src = (ctypes.c_char * len(pk)).from_buffer(pk)
        rc = lib.ce5g_decompress(
            src, sizes, len(block_sizes), block_size, raw_total,
            itemsize, nthreads,
            (ctypes.c_char * raw_total).from_buffer(out),
        )
        if rc != raw_total:
            raise ValueError(f"native decompress failed (rc={rc})")
        return out

    if backend == "zlib":
        import zlib

        packed = memoryview(packed)
        offs = [0]
        for s in block_sizes:
            offs.append(offs[-1] + s)
        pieces = [bytes(packed[offs[i]:offs[i + 1]]) for i in range(len(block_sizes))]
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            raw = list(ex.map(zlib.decompress, pieces))
        pos = 0
        for r in raw:
            out[pos:pos + len(r)] = r
            pos += len(r)
        if pos != raw_total:
            raise ValueError(f"zlib stream length mismatch ({pos} != {raw_total})")
        return out

    raise ValueError(f"unknown codec backend: {backend!r}")
