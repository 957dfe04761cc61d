"""Process group, device mesh and sharding helpers on ``torch.distributed``.

Port of ``ce5g_tpu.parallel.mesh``. JAX runs one program over every
device; torch runs one process per card. So a ('data', 'model') mesh here
is a 2-D ``DeviceMesh`` over the ranks of the default process group,
started by :func:`init_process_group` (or by ``torchrun``'s environment):

  * JAX ``Mesh``            → ``DeviceMesh`` named ("data", "model");
  * ``NamedSharding`` specs → placements, (Shard(0), Replicate()) for a
    batch and (Replicate(), Replicate()) for a replicated value;
  * ``device_put`` of a batch → each rank keeps its own slice of dim 0
    (:func:`shard_batch`); ranks that share a 'data' coordinate keep the
    same slice, as JAX's ``P("data")`` gives them;
  * ``pmean`` → a sum over the 'data' group divided by its size (gloo has
    no average).
"""
from __future__ import annotations

import os
import socket
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.tree import tree_map

#: the mesh's axes, outer to inner
AXES = ("data", "model")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device="cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None) -> torch.device:
    """Start the default process group for one process per card and
    return this process's device.

    On CUDA the backend is NCCL and the process takes card
    ``LOCAL_RANK`` (else ``rank`` modulo the cards); it raises when NCCL
    or the card is missing, and never carries on with gloo. gloo serves
    only ``device="cpu"``. ``rank``, ``world_size`` and ``init_method``
    default to ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``env://``); a single process without it gets a free port on
    localhost. A group already started is kept."""
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this build of torch")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        if dev.type == "cuda" and dist.get_backend() != "nccl":
            raise RuntimeError(f"a {dist.get_backend()} process group is running; the card "
                               "needs NCCL")
        return dev
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError("init_method is needed for more than one process outside torchrun")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world_size)
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1, device="cuda"):
    """A ('data', 'model') ``DeviceMesh`` over the started process group,
    all ranks on 'data' by default. Every rank must call it. Raises
    ``ValueError`` when data·model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_process_group(...) first")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    return init_device_mesh(resolve_device(device).type, (data, model), mesh_dim_names=AXES)


def mesh_shape(mesh) -> dict:
    """{'data': size, 'model': size}, as a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_sharding(mesh) -> Tuple:
    """Placements of a batch: dim 0 over 'data', replicated over 'model'."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> Tuple:
    """Placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def shard_batch(tree, mesh):
    """This rank's slice of dim 0 of every tensor in ``tree``, by its
    'data' coordinate, on the mesh's device; other leaves pass through.
    The leading dim must divide by the 'data' size."""
    d, i = mesh["data"].size(), mesh.get_local_rank("data")
    dev = torch.device(mesh.device_type)

    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % d:
            raise ValueError(f"leading dim {x.shape[0]} does not divide over {d} data ranks")
        n = x.shape[0] // d
        return x[i * n:(i + 1) * n].to(dev)

    return tree_map(take, tree)


def seed_data_slice(mesh, seed: int) -> None:
    """Seed this process's torch RNG with ``seed`` plus its 'data'
    coordinate, so that the ranks of one data slice draw the same dropout
    masks (and compute the same gradients, as JAX's one program does) and
    different slices draw different ones."""
    torch.manual_seed(seed + mesh.get_local_rank("data"))


def model_axis_for(shape: Sequence[int], m: int, min_size: int = 2) -> Optional[int]:
    """The axis that JAX's tensor-parallel rule shards over a 'model' axis
    of size ``m`` (``ce5g_tpu`` mesh.py:53-77): for a tensor of at least
    ``min_size`` dims the last axis if it divides by m, else the first
    that does; None (replicated) otherwise."""
    nd = len(shape)
    if m == 1 or nd < min_size:
        return None
    for ax in [nd - 1] + list(range(nd - 1)):
        if shape[ax] % m == 0 and shape[ax] >= m:
            return ax
    return None


def shard_model_state(state: Mapping[str, torch.Tensor], mesh, min_size: int = 2):
    """Every tensor of ``state`` as a DTensor on ``mesh``: replicated over
    'data', sharded over 'model' along :func:`model_axis_for` of its shape,
    else replicated. Every rank passes the same values."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m = mesh["model"].size()
    dev = torch.device(mesh.device_type)
    out = {}
    for name, x in state.items():
        ax = model_axis_for(tuple(x.shape), m, min_size)
        placement = Replicate() if ax is None else Shard(ax)
        out[name] = distribute_tensor(x.to(dev), mesh, (Replicate(), placement))
    return out


def psum_mean(value: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``value`` over the ranks of ``group`` (the 'data'
    group: ``mesh.get_group("data")``), on every rank; a new tensor."""
    out = value.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)
