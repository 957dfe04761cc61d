"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on first use
into its own shared library, ``ce5g_torch/_build/<name>-<hash>.so``, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The hash covers the source and the flags, so an edited source rebuilds
and an unchanged one loads in milliseconds. The library is loaded with
``ctypes``: no PyTorch headers, so a build takes seconds, not minutes.
A missing ``nvcc`` or a failed build raises; there is no fallback. Each
library loaded counts ``kernels.loaded`` (``utils.profiling``).

Every kernel wrapper goes through one seam: :func:`launch` and :func:`call`
bind a C entry point on its first call and check its status on every
call, and :func:`run` is the device rule (the plain version on the CPU,
the kernel on CUDA).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple, TypeVar

import torch

from ..utils.profiling import annotate, counters

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
KERNELS = ("hpd_solve", "interp_fused", "interp", "nmse", "pilot_select", "channel",
           "profile_gram")

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Callable] = {}  # (kernel, symbol) → bound C function
_lock = threading.Lock()
_T = TypeVar("_T")


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
            counters["kernels.loaded"] += 1
        return _loaded[name]


def _bind(kernel: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int) -> Callable:
    """``symbol`` of ``kernel``'s library, its argument and result types set
    once a process (the cache is keyed by both: every library exports
    ``ce5g_error_string``)."""
    key = (kernel, symbol)
    fn = _bound.get(key)
    if fn is None:
        lib = library(kernel)
        with _lock:
            fn = _bound.get(key)
            if fn is None:
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = list(argtypes), restype
                _bound[key] = fn
    return fn


def call(kernel: str, symbol: str, argtypes: Sequence, *args) -> None:
    """Call ``symbol`` of ``kernel``'s library, a C function that returns a
    CUDA error code. The library is built, loaded and bound (the argument
    types set once) on the first call, not at import. A status that is not
    zero raises RuntimeError naming the kernel and the CUDA error string
    (every library exports ``ce5g_error_string``)."""
    status = _bind(kernel, symbol, argtypes)(*args)
    if status != 0:
        what = _bind(kernel, "ce5g_error_string", (ctypes.c_int,), ctypes.c_char_p)(status)
        raise RuntimeError(f"{kernel} kernel: CUDA error {status} ({what.decode()})")


def launch(kernel: str, route: str, device: torch.device, argtypes: Sequence, *args) -> None:
    """One launch through ``<kernel>_launch`` by route ``route``, on
    ``device``'s current stream (the entry's last argument), in the span
    ``ops.<kernel>.<route>``, which counts it."""
    name = f"ops.{kernel}.{route}"
    with annotate(name):
        call(kernel, f"{kernel}_launch", argtypes, *args,
             torch.cuda.current_stream(device).cuda_stream)
    counters[name] += 1


def run(kernel: str, device: torch.device, plain: Callable[[], _T], card: Callable[[], _T]) -> _T:
    """The device rule of every kernel wrapper, in the span ``ops.<kernel>``:
    on the CPU ``plain()`` in the span ``ops.<kernel>.plain``, which counts
    it; on CUDA ``card()``, which launches the kernel; on any other device
    ValueError."""
    with annotate(f"ops.{kernel}"):
        if device.type == "cpu":
            name = f"ops.{kernel}.plain"
            counters[name] += 1
            with annotate(name):
                return plain()
        if device.type != "cuda":
            raise ValueError(f"{kernel} runs on CPU or CUDA tensors, not {device}")
        return card()
