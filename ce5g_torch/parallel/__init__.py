"""The multi-card layer on ``torch.distributed``, one process per card.
Port of ``ce5g_tpu.parallel``; start the process group with
:func:`init_process_group` (or ``torchrun``) before :func:`make_mesh`."""
from .mesh import (
    data_sharding,
    init_process_group,
    make_mesh,
    mesh_shape,
    model_axis_for,
    psum_mean,
    replicated,
    seed_data_slice,
    shard_batch,
    shard_model_state,
)
from .sharded import sharded_eval_stats_fn, sharded_generate_fn
from .time_sharded import reference_time_domain_apply, sharded_time_domain_apply
from .train_sharded import (
    make_sharded_train_state,
    make_sharded_train_step,
    run_one_sharded_step,
)
from .dryrun import dryrun_multichip

__all__ = [
    "data_sharding",
    "make_mesh",
    "psum_mean",
    "replicated",
    "shard_batch",
    "shard_model_state",
    "sharded_eval_stats_fn",
    "reference_time_domain_apply",
    "sharded_time_domain_apply",
    "sharded_generate_fn",
    "make_sharded_train_state",
    "make_sharded_train_step",
    "run_one_sharded_step",
    "dryrun_multichip",
    "init_process_group",
    "mesh_shape",
    "model_axis_for",
    "seed_data_slice",
]
