"""Sharded end-to-end steps: evaluation statistics and dataset generation
over the mesh's 'data' axis. Port of ``ce5g_tpu.parallel.sharded``.

Each rank simulates and estimates its own slice of the global batch with
no communication; the statistics are sums all-reduced over the 'data'
group, so every rank returns the global batch's result.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..data.generator import generate_chunk
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..physics.simulate import FrameDraws, FrameParams, simulate_batch, table_for
from ..utils.metrics import ber_approximation
from .mesh import shard_batch


def sharded_eval_stats_fn(cfg: ExperimentConfig, mesh, estimator: str = "mmse_full",
                          device="cuda") -> Callable[[FrameParams, FrameDraws], Dict]:
    """``fn(params, draws)`` of the global batch → {'mse', 'nmse',
    'nmse_db', 'ber'} (0-d tensors), equal on every rank to the one-rank
    result: the per-frame MSE, NMSE and BER proxy of ``estimator``, each
    averaged over the global batch (``ce5g_tpu`` sharded.py:26-54)."""
    dev = resolve_device(device)
    table = table_for(cfg)
    group = mesh.get_group("data")

    def pipeline(params: FrameParams, draws: FrameDraws) -> Dict[str, torch.Tensor]:
        p, d = shard_batch((params, draws), mesh)
        frames = simulate_batch(d, p, cfg=cfg, table=table, device=dev)
        h = estimate_batch(frames, cfg=cfg, estimator=estimator, table=table, device=dev)
        err = (frames.channel - h).abs().pow(2).mean(dim=(1, 2, 3, 4))
        power = frames.channel.abs().pow(2).mean(dim=(1, 2, 3, 4))
        nmse = err / (power + 1e-12)
        sums = torch.stack([err.sum(), nmse.sum(), ber_approximation(p.snr_db, nmse).sum()])
        dist.all_reduce(sums, group=group)
        mse, nmse_mean, ber = sums / params.profile_idx.shape[0]
        return {"mse": mse, "nmse": nmse_mean, "nmse_db": 10.0 * torch.log10(nmse_mean + 1e-12),
                "ber": ber}

    return pipeline


def sharded_generate_fn(cfg: ExperimentConfig, mesh,
                        device="cuda") -> Callable[[FrameParams, FrameDraws], Dict]:
    """``fn(params, draws)`` of a whole chunk → this rank's slice of
    ``data.generator.generate_chunk`` (the same math; each rank simulates
    only its own frames). Writing the slices is the factory's writers'
    work (``DatasetGenerator.generate_split(writer_id=, num_writers=)``)."""
    dev = resolve_device(device)
    table = table_for(cfg)

    def generate(params: FrameParams, draws: FrameDraws) -> Dict[str, torch.Tensor]:
        p, d = shard_batch((params, draws), mesh)
        return generate_chunk(cfg, p, d, table=table, device=dev)

    return generate
