"""Multi-card training step: data parallel over 'data' and the weights
sharded over 'model'. Port of ``ce5g_tpu.parallel.train_sharded``.

JAX's GSPMD step is one program over the mesh; here each rank runs the
step on its slice of the batch, FSDP2 (``fully_shard`` over the 2-D mesh:
replicated over 'data', sharded over 'model') gathers the weights for the
forward and backward and averages the gradients over every rank, and
BatchNorm takes its statistics over the global batch through the 'data'
group (``models.cnn.set_batchnorm_group``). Ranks that share a 'data'
coordinate hold the same slice, so averaging over 'model' leaves their
identical gradients as they are, and the result is the global step.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import ExperimentConfig
from ..convert import model_state_from_numpy
from ..device import resolve_device
from ..models.cnn import set_batchnorm_group
from ..models.factory import get_model
from ..models.inputs import apply_output_residual
from ..models.loss import channel_estimation_loss
from .mesh import model_axis_for, psum_mean, seed_data_slice, shard_batch


def make_sharded_train_state(cfg: ExperimentConfig, mesh, model_type: Optional[str] = None,
                             state: Optional[Mapping[str, np.ndarray]] = None,
                             device="cuda") -> Tuple[nn.Module, torch.optim.Optimizer]:
    """(model, optimizer) with the weights sharded over the mesh.

    The model is built whole (``get_model`` with the config's seed),
    filled from ``state`` when given (a flat flax mapping, through
    ``convert.model_state_from_numpy``), and handed to ``fully_shard``.
    Each parameter is sharded over 'model' along the axis that JAX's rule
    picks for its shape (``mesh.model_axis_for``, applied to the port's
    layout). FSDP2 has no replicated placement: a parameter that JAX
    replicates (1-D, or no divisible axis) is sharded on dim 0, unevenly
    where it must be. That changes the layout, not the numbers.

    The optimizer is AdamW with the config's learning rate and weight
    decay (``train.make_optimizer``'s 'adamw'), as ``ce5g_tpu``
    train_sharded.py:35-38; the step clips by global norm. The process's
    RNG is seeded by its 'data' coordinate (``mesh.seed_data_slice``).
    """
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..train.trainer import make_optimizer  # the trainer imports this package

    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.training.mixed_precision else torch.float32
    model = get_model(model_type or cfg.model.type, cfg.model, dtype=dtype, seed=cfg.seed,
                      device=dev)
    if state is not None:
        model_state_from_numpy(state, model)
    set_batchnorm_group(model, mesh.get_group("data"))
    seed_data_slice(mesh, cfg.seed)
    m = mesh["model"].size()

    def placement(param):
        ax = model_axis_for(tuple(param.shape), m)
        return Shard(0 if ax is None else ax)

    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    adamw = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, optimizer="adamw"))
    optimizer = make_optimizer(adamw, [p for p in model.parameters() if p.requires_grad])
    return model, optimizer


def _clip_by_global_norm_(params, max_norm: float, group) -> None:
    """optax's ``clip_by_global_norm`` on sharded gradients: the squared
    norms of the local shards summed over the 'model' group."""
    from torch.distributed.tensor import DTensor

    grads = [p.grad for p in params if p.grad is not None]
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    sq = torch.stack([torch.linalg.vector_norm(g) ** 2 for g in local]).sum()
    dist.all_reduce(sq, group=group)
    norm = sq.sqrt()
    torch._foreach_mul_(local, torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm))


def make_sharded_train_step(cfg: ExperimentConfig):
    """``step(model, optimizer, inputs, targets, mask)`` → this rank's loss
    on its slice: the forward with ``apply_output_residual`` and
    ``channel_estimation_loss`` (``ce5g_tpu`` train_sharded.py:50-61),
    backward, clip by global norm (``gradient_clip or 1.0``), AdamW. The
    mean of the returned losses over 'data' is the global batch's loss."""
    tr = cfg.training

    def step(model, optimizer, inputs, targets, mask) -> torch.Tensor:
        model.train()
        pred = apply_output_residual(model(inputs), inputs)
        loss = channel_estimation_loss(pred, targets, mask, tr.loss, tr.channel_weight,
                                       tr.pilot_weight)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for group in optimizer.param_groups for p in group["params"]]
        with torch.no_grad():  # the 'model' group of the mesh the parameters live on
            _clip_by_global_norm_(params, tr.gradient_clip or 1.0,
                                  params[0].device_mesh.get_group("model"))
        optimizer.step()
        return loss.detach()

    return step


def _synthetic_batch(cfg: ExperimentConfig, batch_size: int, grid: Tuple[int, int],
                    model_type: str, generator: torch.Generator, device="cuda"):
    """(inputs, targets, mask) of standard normals from ``generator``, as
    ``ce5g_tpu`` train_sharded.py:74-88 makes them: the grid layout with
    an all-zero mask, or for the LSTM the (B, S·K, 4) sequence with none."""
    s, k = grid
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    if model_type == "lstm":
        return normal(batch_size, s * k, 4), normal(batch_size, s * k, 2), None
    return (normal(batch_size, s, k, cfg.model.input_channels), normal(batch_size, s, k, 2),
            torch.zeros((batch_size, s, k), device=dev))


def run_one_sharded_step(cfg: ExperimentConfig, mesh, batch_size: int = 8,
                         grid: Tuple[int, int] = (14, 599), model_type: str = "cnn",
                         batch=None, state=None, device="cuda"):
    """Build the sharded state, take this rank's slice of a global batch
    and run one train step; returns the global batch's loss.

    ``batch`` is the global (inputs, targets, mask), the same on every
    rank; by default a synthetic one from ``torch.Generator`` seed 0
    (:func:`_synthetic_batch`). ``state`` is a flat flax mapping of initial
    weights. Used by the dry run and the tests."""
    dev = resolve_device(device)
    model, optimizer = make_sharded_train_state(cfg, mesh, model_type, state=state, device=dev)
    if batch is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        batch = _synthetic_batch(cfg, batch_size, grid, model_type, gen, device=dev)
    x, y, m = shard_batch(tuple(batch), mesh)
    loss = make_sharded_train_step(cfg)(model, optimizer, x, y, m)
    return float(psum_mean(loss, mesh.get_group("data")))
