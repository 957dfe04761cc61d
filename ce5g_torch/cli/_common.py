"""What every command of the port shares: ``--config`` and ``--device``,
the config loader and the path of a split.

The JAX package's ``scripts/_common.py`` also sets a persistent XLA
compile cache and reads ``CE5G_PLATFORM``; neither has a counterpart
here. The kernels build once into ``ce5g_torch/_build/``, and the device
is ``--device``: ``cuda`` by default, which raises without a card
(``device.resolve_device``), or ``cpu`` when asked for.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import ExperimentConfig, load_config
from ..device import resolve_device
from ..utils.profiling import timed_windows


def add_config_arg(parser: argparse.ArgumentParser, default: Optional[str] = None):
    parser.add_argument(
        "--config",
        type=str,
        default=default,
        help="YAML config (reference experiment_config.yaml schema); defaults built-in",
    )
    return parser


def make_parser(doc: str, config: Optional[str] = None) -> argparse.ArgumentParser:
    """A parser with the module's docstring, ``--config`` and ``--device``."""
    parser = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    add_config_arg(parser, config)
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda, which needs a card; 'cpu' on request)",
    )
    return parser


def parse(parser: argparse.ArgumentParser,
          argv: Optional[Sequence[str]]) -> Tuple[argparse.Namespace, torch.device]:
    """The parsed arguments and the device, resolved before any work so
    that a run without a card stops at once."""
    args = parser.parse_args(argv)
    return args, resolve_device(args.device)


def sync(dev: torch.device) -> None:
    """Wait for the card, so that a host clock read after it times the work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_cfg(args: argparse.Namespace) -> ExperimentConfig:
    return load_config(args.config)


def split_path(data_dir, split: str) -> str:
    """A split's merged ``<split>.npz`` where one exists, else its manifest."""
    d = Path(data_dir)
    merged = d / f"{split}.npz"
    return str(merged if merged.exists() else d / f"{split}_manifest.json")


def torchrun_mesh(device: torch.device):
    """``--shard``: start the process group that ``torchrun``'s environment
    describes (NCCL on the card, gloo on the CPU) and a ('data', 'model')
    mesh with every rank on 'data'. Returns this rank's device and the
    mesh. Raises outside ``torchrun``."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--shard runs one process per card under torchrun (missing {', '.join(missing)}): "
            "torchrun --nproc-per-node N -m ce5g_torch.cli.<name> --shard ..."
        )
    from ..parallel import init_process_group, make_mesh

    dev = init_process_group(device)
    return dev, make_mesh(device=dev)


def end_process_group() -> None:
    """Destroy the default process group that :func:`torchrun_mesh` started."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def card_label(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, for a result
    taken on ``dev``; ``cpu`` on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return out.splitlines()[0]


def profile_row(name: str, batch: Callable[[], torch.Tensor], b: int, iters: int,
                repeats: int = 3, width: int = 28) -> Dict[str, float]:
    """One row of a profiler: ``batch()`` (fresh inputs each call, a 0-d
    result) timed in ``repeats`` windows of ``iters`` calls after a first
    window (``utils.profiling.timed_windows``), printed to stderr in the
    JAX profile scripts' layout."""
    first_s, windows = timed_windows(batch, iters, repeats)
    dt = sum(s for s, _ in windows) / repeats / iters
    print(f"{name:{width}s} {dt * 1e3:8.2f} ms/batch({b})  ({b / dt:9.0f} fr/s)  "
          f"compile {first_s:6.1f}s", file=sys.stderr, flush=True)
    return {"ms_per_batch": dt * 1e3, "frames_per_s": b / dt, "first_window_s": first_s}


def profile_parser(doc: str, batch: int, iters: int) -> argparse.ArgumentParser:
    """A profiler's parser: ``--config``, ``--device`` and its depth."""
    parser = make_parser(doc)
    parser.add_argument("--batch", type=int, default=batch, help="frames a batch")
    parser.add_argument("--iters", type=int, default=iters, help="batches a timed window")
    parser.add_argument("--repeats", type=int, default=3, help="timed windows")
    return parser


def print_rows(rows: Dict, dev: torch.device) -> None:
    """A profiler's rows as one JSON line on stdout, with the card."""
    print(json.dumps({"card": card_label(dev), "rows": rows}))
