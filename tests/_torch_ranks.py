"""One rank of the multi-process checks of tests/test_torch_parallel.py.

    python tests/_torch_ranks.py RANK WORLD WORKDIR

Reads WORKDIR/inputs.pkl (written by the test: the port's configs and the
JAX package's draws, weights and batches as numpy), starts a gloo process
group of WORLD ranks on WORKDIR/store, runs every check of the parallel
layer at this world size and writes what it measured to
WORKDIR/out_RANK.pkl. It imports torch and ce5g_torch only, never JAX.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ce5g_torch.parallel import (  # noqa: E402
    dryrun_multichip,
    init_process_group,
    make_mesh,
    make_sharded_train_state,
    make_sharded_train_step,
    mesh_shape,
    psum_mean,
    shard_batch,
    shard_model_state,
    sharded_eval_stats_fn,
    sharded_generate_fn,
    sharded_time_domain_apply,
)
from ce5g_torch.physics import FrameDraws, FrameParams  # noqa: E402


def _numpy(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()  # a collective: every rank calls it
    return x.detach().numpy()


def _t(x):
    return torch.as_tensor(np.asarray(x))


def mesh_checks(world):
    out = {"mesh": mesh_shape(make_mesh(device="cpu"))}
    if world == 4:
        m = make_mesh(data=2, model=2, device="cpu")
        out["mesh_2x2"] = mesh_shape(m)
        state = {"w": torch.ones(6, 16), "b": torch.ones(7), "odd": torch.ones(3, 5)}
        out["placements"] = {k: [f"Shard({p.dim})" if p.is_shard() else "Replicate"
                                 for p in v.placements]
                             for k, v in shard_model_state(state, m).items()}
        out["psum_mean"] = float(psum_mean(torch.tensor(float(dist.get_rank())),
                                           m.get_group("data")))
    try:
        make_mesh(data=3, model=2, device="cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    return out


def eval_checks(inp):
    mesh = make_mesh(device="cpu")
    params = FrameParams(*map(_t, inp["params"]))
    draws = FrameDraws(*map(_t, inp["draws"]))
    stats = sharded_eval_stats_fn(inp["cfg"], mesh, "mmse_full", device="cpu")(params, draws)
    chunk = sharded_generate_fn(inp["cfg"], mesh, device="cpu")(params, draws)
    return {"stats": {k: float(v) for k, v in stats.items()},
            "generate": {k: chunk[k].numpy() for k in ("H_ls", "rx_symbols", "H_true")}}


def time_sharded_checks(inp):
    mesh = make_mesh(device="cpu")
    out = {}
    for name, c in inp["td"].items():
        y = sharded_time_domain_apply(
            mesh, _t(c["x"]), _t(c["angles"]), _t(c["phases"]), c["doppler"], _t(c["amp"]),
            _t(c["delays"]), _t(c["valid"]), c["fs"], c["nrx"], c["ntx"], halo=c["halo"])
        out[name] = y.numpy()
    return out


def train_step_checks(inp, world):
    """One sharded step: 2 data × 2 model at world 4, data parallel at 2."""
    model_axis = 2 if world == 4 else 1
    mesh = make_mesh(data=world // model_axis, model=model_axis, device="cpu")
    cfg = inp["train_cfg"]
    model, opt = make_sharded_train_state(cfg, mesh, "cnn", state=inp["jax_state"],
                                          device="cpu")
    x, y, m = shard_batch(tuple(map(_t, inp["batch"])), mesh)
    loss = make_sharded_train_step(cfg)(model, opt, x, y, m)
    return {
        "loss": float(psum_mean(loss, mesh.get_group("data"))),
        "grads": {n: _numpy(p.grad) for n, p in model.named_parameters()},
        "buffers": {n: b.numpy() for n, b in model.named_buffers()
                    if "num_batches" not in n},
        "mesh": mesh_shape(mesh),
    }


def trainer_checks(inp, world, rank, workdir):
    """Two steps of the Trainer: meshless at world 1, data parallel at 2."""
    from ce5g_torch.train import ChannelDataset, Trainer

    mesh = make_mesh(device="cpu") if world > 1 else None
    model_dir = os.path.join(workdir, f"trainer_{rank}")
    trainer = Trainer(inp["train_cfg"], model_type="cnn", log=lambda *a: None, device="cpu",
                      mesh=mesh)
    res = trainer.train(ChannelDataset(inp["train_split"]), ChannelDataset(inp["val_split"]),
                        epochs=2, model_dir=model_dir)
    return {"history": res["history"], "wrote": os.path.isdir(model_dir)}


def main(rank, world, workdir):
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    init_process_group("cpu", rank=rank, world_size=world,
                       init_method="file://" + os.path.join(workdir, "store"))
    out = mesh_checks(world)
    out["eval"] = eval_checks(inp)
    out["td"] = time_sharded_checks(inp)
    out["step"] = train_step_checks(inp, world)
    if world <= 2:
        out["trainer"] = trainer_checks(inp, world, rank, workdir)
    if world == 4:
        out["dryrun"] = dryrun_multichip("cpu", cfg=inp["cfg"])
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
