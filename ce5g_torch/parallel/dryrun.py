"""The multi-card dry run: the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``, at the world size of the started process group."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..config import ExperimentConfig, TrainingConfig
from ..data.generator import draw_params
from ..device import resolve_device
from ..physics.simulate import draw_frames
from .mesh import make_mesh
from .sharded import sharded_eval_stats_fn
from .train_sharded import run_one_sharded_step


def dryrun_multichip(device="cuda", cfg: Optional[ExperimentConfig] = None) -> Dict[str, float]:
    """One sharded train step of each model family and the sharded
    ``mmse_full`` evaluation on a ('data', 'model') mesh over every rank,
    'model' 2 wide when the world size is even, else 1.

    cnn, resnet and transformer run at ``cfg``'s full grid (default: the
    14 × 599 grid and default widths, without mixed precision); lstm and
    hybrid at 64 subcarriers, the JAX dry run's own cut (the recurrent
    parameters' shapes do not depend on K). The evaluation takes
    max(world, 4) frames. Raises ``RuntimeError`` on a non-finite loss or
    an NMSE that is not positive; returns the losses and the NMSE."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    model_axis = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = make_mesh(data=world // model_axis, model=model_axis, device=dev)
    if cfg is None:
        cfg = ExperimentConfig(training=TrainingConfig(batch_size=world, mixed_precision=False))
    grid = (cfg.ofdm.num_symbols, cfg.ofdm.num_used_subcarriers)
    batch = max(world, 4)
    out = {}
    for model_type, g in (("cnn", grid), ("resnet", grid), ("transformer", grid),
                          ("lstm", (grid[0], min(grid[1], 64))),
                          ("hybrid", (grid[0], min(grid[1], 64)))):
        loss = run_one_sharded_step(cfg, mesh, batch_size=batch, grid=g,
                                    model_type=model_type, device=dev)
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} in the sharded {model_type} train step")
        out[model_type] = loss

    gen = torch.Generator(device=dev).manual_seed(0)
    params = draw_params(cfg, batch, gen, device=dev)
    stats = sharded_eval_stats_fn(cfg, mesh, estimator="mmse_full", device=dev)(
        params, draw_frames(gen, params, cfg, device=dev))
    out["nmse"] = float(stats["nmse"])
    if not out["nmse"] > 0:
        raise RuntimeError(f"sharded mmse_full NMSE {out['nmse']} is not positive")
    return out
