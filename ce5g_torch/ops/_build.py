"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on first use
into its own shared library, ``ce5g_torch/_build/<name>-<hash>.so``, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The hash covers the source and the flags, so an edited source rebuilds
and an unchanged one loads in milliseconds. The library is loaded with
``ctypes``: no PyTorch headers, so a build takes seconds, not minutes.
A missing ``nvcc`` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
KERNELS = ("hpd_solve", "interp_fused")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns name → path."""
    names = list(names)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
        if errors:
            raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            path = build([name])[name]
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code. Every
    library exports ``ce5g_error_string`` (cudaGetErrorString)."""
    if status != 0:
        fn = lib.ce5g_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} ({fn(status).decode()})")
