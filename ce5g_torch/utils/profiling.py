"""Tracing and timing harness.

Port of ``ce5g_tpu.utils.profiling`` (the reference only takes
``time.time()`` deltas, test_phase2_comparison.py:76-99, and logs
samples/s, run_phase3_robust.py:232-234):

  * :func:`annotate` — the port's span, one at each layer boundary of the
    timed entry (``physics.simulate`` and its stages, ``estimators.
    estimate`` and the estimators' stages, ``ops.<kernel>``,
    ``metrics.nmse``; inside each ``ops.<kernel>``, ``ops.<kernel>.<route>``
    around its kernel's launch, named as the route's counter, and
    ``ops.<kernel>.plain`` around the plain version: ``ops._build``).
    Off by default:
    a span then costs one check of a module flag and returns one shared
    null context. Inside
    :func:`recording` each span keeps, in memory, its name, the index of
    the span that opened it (−1 at the top) and its start and end from
    ``time.time_ns()`` (Unix ns: the clock of a profiler trace's ``ts`` µs
    + ``baseTimeNanoseconds``), and opens a ``record_function`` of its
    name, shown on the trace's timeline. A span records no CUDA event and
    makes no CUDA call;
  * :data:`counters` — the port's counters, always on, each incremented
    where its work happens:

      - ``ops.hpd_solve.<route>`` (``registers``, ``cluster``,
        ``blocked``), ``ops.interp_fused.<route>`` (``shared``,
        ``global``), ``ops.interp.<route>`` (``frame``, ``tile``),
        ``ops.nmse.<route>`` (``pairs``, ``strided``),
        ``ops.pilot_select.<route>`` (``block``, ``cluster``, ``global``),
        ``ops.channel.<route>`` (``common``, ``per_tx``): kernel launches
        by route (an interpolation route, ``nmse`` and ``channel`` may be
        two CUDA launches); ``ops.<kernel>.plain``: calls on CPU
        tensors, which run the plain PyTorch version (:func:`launches`
        sums a kernel's routes);
      - ``time_rank.computed``: runs of
        ``estimators.time_prior.auto_time_rank``'s host loop;
      - ``tables.built``: misses of ``physics.profiles.cached`` (device
        tables built from a profile table);
      - ``kernels.loaded``: CUDA libraries loaded by ``ops._build.library``
        (built by nvcc first where needed);
      - ``mmse_full.profile_tables``: profile tables that
        ``mmse_full_estimate`` contracts every frame's E and D sums
        against (all of them at each call with ``f_tables``, whatever
        the batch's mix of profiles);

  * :func:`trace` — ``torch.profiler`` around a block, written as a
    TensorBoard trace (the ``tensorboard_trace_handler`` layout, which
    Perfetto and chrome://tracing also open), with the spans recorded
    in the block beside it;
  * :class:`Stopwatch` — wall-clock timing that keeps the first call
    apart (build and warm-up) and synchronises the card after each call,
    as the JAX package's waits with ``block_until_ready``;
  * :func:`timed_windows` — the measuring tools' clock (``cli.bench`` and
    the rest): windows of batches whose results are summed on the card and
    read once at each window's end;
  * :data:`CARD_PEAKS` — each card's published peaks, by
    ``torch.cuda.get_device_name``, for rooflines and bounds
    (:func:`card_peaks`, :func:`work_bound`, :func:`roofline`). A card
    missing from the table gets no roofline: another card's peaks are
    never borrowed.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from .tree import leaves_with_path


#: the port's counters (see the module note); never reset, read as differences
counters: "collections.Counter[str]" = collections.Counter()


def launches(kernel: str, counts: Optional[Dict[str, int]] = None) -> int:
    """Launches of the kernel ``ops.<kernel>`` in ``counts`` (the registry
    by default): the sum of its routes' counters, the plain version's
    calls left out."""
    counts = counters if counts is None else counts
    prefix = f"ops.{kernel}."
    return sum(n for key, n in counts.items()
               if key.startswith(prefix) and key != prefix + "plain")


@dataclasses.dataclass
class Span:
    """One recorded span. ``parent`` is the index in the buffer of the
    span that opened it, −1 at the top; ``start_ns`` and ``end_ns`` are
    ``time.time_ns()`` (``end_ns`` 0 while the span is open)."""

    name: str
    parent: int
    start_ns: int
    end_ns: int = 0


_recording = False
_spans: List[Span] = []
_open: List[int] = []  # buffer indices of the spans open now, innermost last
_NULL = contextlib.nullcontext()


class _Recorded:
    """A span while recording is on."""

    __slots__ = ("name", "span", "scope")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        self.span = Span(self.name, _open[-1] if _open else -1, time.time_ns())
        _open.append(len(_spans))
        _spans.append(self.span)
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        return self.span

    def __exit__(self, *exc) -> None:
        self.scope.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        _open.pop()


def annotate(name: str):
    """The port's span ``name``: a context manager that records the block
    inside :func:`recording` and does nothing outside it."""
    if not _recording:
        return _NULL
    return _Recorded(name)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Turn the spans on for the block and yield the buffer they fill, a
    new list, in the order the spans opened. Spans are recorded from one
    thread; recording does not nest."""
    global _recording, _spans, _open
    if _recording:
        raise RuntimeError("spans are already recording")
    _spans, _open = [], []
    _recording = True
    try:
        yield _spans
    finally:
        _recording = False


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card when there is one) and write
    the trace under ``log_dir``, with the port's spans recorded in the
    block beside it as ``spans.<pid>.<ns>.json`` (``{"clock":
    "time_ns", "spans": [{name, parent, start_ns, end_ns}, ...]}``: Unix
    ns, the trace's ``ts`` µs + ``baseTimeNanoseconds``). Usage::

        with profiling.trace("logs/profile"):
            step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording() as spans, torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ):
        yield
    path = os.path.join(str(log_dir), f"spans.{os.getpid()}.{time.time_ns()}.json")
    with open(path, "w") as fh:
        json.dump({"clock": "time_ns", "spans": [dataclasses.asdict(sp) for sp in spans]}, fh)


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


#: published peaks of each card, keyed by ``torch.cuda.get_device_name``:
#: float32 outside the tensor cores (the port keeps TF32 off,
#: ``device.resolve_device``), dense bf16 on the tensor cores (no
#: sparsity), and the memory rate. The rates assume the card's full power
#: limit; a card set below it runs slower under load.
CARD_PEAKS: Dict[str, Dict] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_Bps": 3.35e12,
                              "source": "NVIDIA H100 data sheet, SXM5"},
    "NVIDIA H100 PCIe": {"fp32_flops": 51e12, "bf16_flops": 756e12, "hbm_Bps": 2.0e12,
                         "source": "NVIDIA H100 data sheet, PCIe"},
    "NVIDIA H100 NVL": {"fp32_flops": 60e12, "bf16_flops": 835e12, "hbm_Bps": 3.9e12,
                        "source": "NVIDIA H100 data sheet, NVL"},
    "NVIDIA H200": {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_Bps": 4.8e12,
                    "source": "NVIDIA H200 data sheet, SXM"},
}


def card_peaks(device="cuda") -> Optional[Dict]:
    """The peaks of the card behind ``device`` from :data:`CARD_PEAKS`,
    with its ``name``; None for the CPU and for a card not in the table."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    peaks = CARD_PEAKS.get(name)
    return None if peaks is None else {"name": name, **peaks}


def no_roofline_note(device) -> str:
    """Why a result on ``device`` carries no roofline fields."""
    dev = torch.device(device)
    what = "the CPU" if dev.type != "cuda" else f"{torch.cuda.get_device_name(dev)!r}"
    return (f"no roofline: {what} is not in ce5g_torch.utils.profiling.CARD_PEAKS, and no "
            "other card's peaks are used")


def work_bound(nbytes: float, flops: float, peaks: Dict,
               dtype: str = "fp32") -> Tuple[float, str]:
    """(ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``flops`` of ``dtype`` ('fp32' or 'bf16'), the
    larger of bytes over the memory rate and operations over the peak."""
    t_bytes = nbytes / peaks["hbm_Bps"] * 1e3
    t_ops = flops / peaks[f"{dtype}_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline(seconds: float, flops: float, nbytes: Optional[float], peaks: Dict,
             dtype: str = "fp32") -> Dict:
    """The share of the card's peaks that ``flops`` operations of ``dtype``
    (and ``nbytes`` moved, where known) reach in ``seconds``: ``mfu``, and
    ``hbm_util`` and ``bound`` only where the bytes are known."""
    out = {"mfu": flops / seconds / peaks[f"{dtype}_flops"]}
    if nbytes:
        out["hbm_util"] = nbytes / seconds / peaks["hbm_Bps"]
        out["bound"] = "bytes" if out["hbm_util"] >= out["mfu"] else "operations"
    return out


def timed_windows(batch: Callable[[], torch.Tensor], iters: int,
                  repeats: int) -> Tuple[float, List[Tuple[float, float]]]:
    """Time ``batch()``, which returns a 0-d tensor, in windows of
    ``iters`` calls: the results are summed where they lie and read once
    at the window's end, so the host waits for the card once a window and
    never inside it. The first window (kernel builds, allocator and cuDNN
    warm-up) is kept apart. Returns (its seconds, [(seconds, sum) of each
    of the ``repeats`` windows that follow])."""
    def window():
        t0 = time.perf_counter()
        total = batch()
        for _ in range(iters - 1):
            total = total + batch()
        value = float(total)  # the one read of the window
        return time.perf_counter() - t0, value

    first_s = window()[0]
    return first_s, [window() for _ in range(repeats)]
