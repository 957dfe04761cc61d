"""Tracing and timing harness.

Port of ``ce5g_tpu.utils.profiling`` (the reference only takes
``time.time()`` deltas, test_phase2_comparison.py:76-99, and logs
samples/s, run_phase3_robust.py:232-234):

  * :func:`trace` — ``torch.profiler`` around a block, written as a
    TensorBoard trace (the ``tensorboard_trace_handler`` layout, which
    Perfetto and chrome://tracing also open);
  * :class:`Stopwatch` — wall-clock timing that keeps the first call
    apart (build and warm-up) and synchronises the card after each call,
    as the JAX package's waits with ``block_until_ready``;
  * :func:`annotate` — a named ``record_function`` scope, shown on the
    trace's timeline.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from .tree import leaves_with_path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card when there is one) and write
    the trace under ``log_dir``. Usage::

        with profiling.trace("logs/profile"):
            step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield


def annotate(name: str):
    """Named scope that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


def _wait(out) -> None:
    """Synchronise the card if ``out`` holds a CUDA tensor."""
    for _, leaf in leaves_with_path(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class Stopwatch:
    """Timing of a callable that keeps its first call (kernel builds,
    allocator and cuDNN warm-up) apart from the steady state, waiting for
    the card after every call."""

    def __init__(self):
        self.records: Dict[str, Dict[str, float]] = {}

    def measure(
        self,
        name: str,
        fn: Callable,
        *args,
        iters: int = 5,
        make_args: Optional[Callable[[int], tuple]] = None,
        **kwargs,
    ) -> Dict[str, float]:
        """Time ``fn``: one first call + ``iters`` steady-state calls.

        ``make_args(i)`` (optional) builds fresh positional args per
        iteration."""
        t0 = time.perf_counter()
        _wait(fn(*args, **kwargs))
        compile_s = time.perf_counter() - t0

        times: List[float] = []
        for i in range(iters):
            a = make_args(i) if make_args is not None else args
            t0 = time.perf_counter()
            _wait(fn(*a, **kwargs))
            times.append(time.perf_counter() - t0)
        times.sort()
        rec = {
            "compile_s": compile_s,
            "median_s": times[len(times) // 2],
            "best_s": times[0],
            "iters": float(iters),
        }
        self.records[name] = rec
        return rec

    def report(self) -> str:
        lines = [f"{'stage':<28} {'compile':>9} {'median':>9} {'best':>9}"]
        for name, r in self.records.items():
            lines.append(
                f"{name:<28} {r['compile_s']:>8.2f}s {r['median_s'] * 1e3:>7.1f}ms"
                f" {r['best_s'] * 1e3:>7.1f}ms"
            )
        return "\n".join(lines)
