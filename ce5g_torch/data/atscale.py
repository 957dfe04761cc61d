"""At-scale single-card generation. Port of ``ce5g_tpu.data.atscale``.

Two paths, both sized for ≥ 100k frames on one card:

1. **Digest-manifest materialization** (:func:`generate_digest_split`) —
   the full factory pipeline (parameter draws → Jakes fading → OFDM →
   measured-power AWGN → LS/interpolation feature) runs chunk after chunk
   with no host synchronisation between chunks; what reaches the host is
   a 3-scalar digest per array and chunk, fetched once at the end, in
   place of ~0.8 MB a frame of tensors. The manifest records the key
   schedule (seed, split, fingerprint, chunk grid) and the digests: every
   sample is a pure function of (seed, split, chunk size, index, device
   type) (``data.generator``), so any writer can later materialize any
   chunk alone and check it against its digest.
   :func:`verify_digest_chunk` regenerates one chunk and compares its
   digest exactly (the same program on the same device gives bitwise
   equal sums).

2. **Fused generate → train** (:func:`online_train`) — the data never
   leaves the card: each step simulates a fresh batch, LS-estimates it and
   feeds it straight into the model's optimizer step, with no host copy.
   Samples/s here is end to end (data production → consumed gradient).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from .generator import CHUNK_KEYS, DatasetGenerator, chunk_draws, generate_chunk


def _array_digest(v: torch.Tensor) -> torch.Tensor:
    """(3,) float32 digest on ``v``'s device: sum|x|, sum|x|², and the
    alternating-sign sum of |x| over the flattened array.

    The alternating-sign component makes the digest order-sensitive (a
    permutation of samples changes it), which plain moments are not. The
    same shapes on the same device reduce in the same order, so exact
    comparison is valid for regenerate-and-verify. The sign follows the
    element's integer index (the JAX package forms it from a float32 iota,
    which loses parity beyond 2²⁴ elements; below that the two agree).
    """
    va = v.abs() if v.is_complex() else v
    va = va.to(torch.float32).reshape(-1)
    alt = va[0::2].sum() - va[1::2].sum()
    return torch.stack([va.sum(), (va * va).sum(), alt])


def _chunk_digest(cfg: ExperimentConfig, split: str, chunk_idx: int, chunk_size: int,
                  device) -> torch.Tensor:
    """(len(CHUNK_KEYS), 3) digests of chunk ``chunk_idx`` at ``chunk_size``
    (the chunk ``DatasetGenerator`` makes), left on the device; the chunk's
    tensors are freed when this returns."""
    arrays = generate_chunk(cfg, *chunk_draws(cfg, split, chunk_idx, chunk_size, device),
                            device=device)
    return torch.stack([_array_digest(arrays[k]) for k in CHUNK_KEYS])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def generate_digest_split(
    cfg: ExperimentConfig,
    output_dir,
    split: str = "atscale",
    num_samples: int = 131072,
    chunk_size: int = 2048,
    log=print,
    device="cuda",
) -> Dict:
    """Run the factory over ``num_samples`` frames on ``device``, fetching
    only per-chunk digests; write ``{split}_digest_manifest.json``.

    ``num_samples`` must be a multiple of ``chunk_size``: a digest covers a
    whole chunk, so a partial one would digest differently from its
    materialized counterpart."""
    if num_samples % chunk_size:
        raise ValueError("num_samples must be a multiple of chunk_size")
    dev = resolve_device(device)
    out = Path(output_dir)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, chunk_size=chunk_size))
    fingerprint = DatasetGenerator(cfg, out, device=dev)._fingerprint()
    num_chunks = num_samples // chunk_size

    # warm-up: the kernels' libraries load and the allocator fills (not
    # counted in the sustained rate)
    d0 = _chunk_digest(cfg, split, 0, chunk_size, dev)
    _sync(dev)
    # synchronous single-chunk time: corroborates the sustained rate below
    ts = time.perf_counter()
    _chunk_digest(cfg, split, 0, chunk_size, dev)
    _sync(dev)
    sync_chunk_s = time.perf_counter() - ts

    # enqueue every chunk, keep the digests on the device, synchronise once
    t0 = time.perf_counter()
    digests = [d0]
    for i in range(1, num_chunks):
        digests.append(_chunk_digest(cfg, split, i, chunk_size, dev))
    _sync(dev)
    elapsed = time.perf_counter() - t0
    rate = (num_chunks - 1) * chunk_size / max(elapsed, 1e-9)

    host = torch.stack(digests).cpu().numpy()  # (chunks, keys, 3), one fetch
    manifest = {
        "split": split,
        "total": num_samples,
        "chunk_size": chunk_size,
        "num_chunks": num_chunks,
        "seed": cfg.seed,
        "fingerprint": fingerprint,
        "device_samples_per_second": rate,
        "sync_chunk_s": sync_chunk_s,
        "sync_samples_per_second": chunk_size / max(sync_chunk_s, 1e-9),
        "elapsed_s": elapsed,
        "backend": dev.type,
        "device_name": _device_name(dev),
        "digest_keys": list(CHUNK_KEYS),
        "digests": {
            k: [[float(x) for x in host[c, j]] for c in range(num_chunks)]
            for j, k in enumerate(CHUNK_KEYS)
        },
        "note": "digest-manifest materialization: samples are pure "
        "functions of (seed, split, chunk size, index, device type); any "
        "writer can materialize any chunk independently "
        "(generator.generate_split) and verify it against these digests "
        "(atscale.verify_digest_chunk).",
    }
    (out / f"{split}_digest_manifest.json").write_text(json.dumps(manifest, indent=2))
    log(
        f"[{split}] {num_samples} frames digested in {elapsed:.1f}s "
        f"({rate:.0f} samples/s device rate)"
    )
    return manifest


def verify_digest_chunk(
    cfg: ExperimentConfig, manifest: Dict, chunk_idx: int, device="cuda"
) -> bool:
    """Regenerate one chunk on ``device`` and compare its digest exactly."""
    dev = resolve_device(device)
    got = _chunk_digest(cfg, manifest["split"], chunk_idx, manifest["chunk_size"],
                        dev).cpu().numpy()
    for j, k in enumerate(CHUNK_KEYS):
        want = np.asarray(manifest["digests"][k][chunk_idx], np.float32)
        if not np.array_equal(got[j], want):
            return False
    return True


def online_batch(cfg: ExperimentConfig, split: str, w: int, batch_size: int,
                 stats: Dict[str, float], wiener_estimator: Optional[str] = None,
                 table=None, device="cuda"):
    """Batch ``w`` of the online stream on ``device``: chunk ``w`` of
    ``split`` at ``chunk_size = batch_size``, simulated and LS-estimated
    as ``generate_chunk`` does, in the model's layout → (inputs, targets,
    pilot mask). With ``wiener_estimator`` the inputs gain its estimate of
    the first antenna pair as channels 5-6 (the 7-channel
    residual-on-Wiener layout of ``ChannelDataset(wiener=...)``)."""
    from ..estimators.api import estimate_batch
    from ..models.inputs import grid_inputs
    from ..physics.simulate import simulate_batch

    dev = resolve_device(device)
    params, draws = chunk_draws(cfg, split, w, batch_size, dev)
    frames = simulate_batch(draws, params, cfg=cfg, table=table, device=dev)
    h_ls = estimate_batch(frames, cfg=cfg, estimator="ls", method=cfg.pilots.interpolation,
                          table=table, device=dev)
    batch = grid_inputs(frames.rx_symbols, h_ls, frames.channel, frames.pilot_mask, stats)
    inputs = batch.inputs
    if wiener_estimator:
        hw = estimate_batch(frames, cfg=cfg, estimator=wiener_estimator, table=table,
                            device=dev)[:, :, 0, 0, :]
        wiener = torch.stack([hw.real / stats["h_std"], hw.imag / stats["h_std"]], dim=-1)
        inputs = torch.cat([inputs, wiener.to(torch.float32)], dim=-1)
    return inputs, batch.targets, batch.pilot_mask


def online_train(
    cfg: ExperimentConfig,
    model_type: str = "cnn",
    total_samples: int = 131072,
    batch_size: int = 512,
    steps_per_dispatch: int = 16,
    stats: Optional[Dict[str, float]] = None,
    seed_split: str = "online",
    dtype: torch.dtype = torch.float32,
    wiener_estimator: Optional[str] = None,
    loss_type: Optional[str] = None,
    lr_schedule: str = "constant",
    checkpoint_dir=None,
    log=print,
    device="cuda",
) -> Dict:
    """Fused generate → train on ``device``: batch ``w`` is chunk ``w`` of
    ``seed_split`` at ``chunk_size = batch_size`` (:func:`online_batch`),
    simulated, LS-estimated and consumed on the card with no host copy;
    the data never repeats.

    Each step is one ``train.Trainer`` step (``make_optimizer``'s
    optimizer, ``clip_by_global_norm_``, the models' autocast for a bf16
    ``dtype``), with ``loss_type`` (default ``cfg.training.loss``) and a
    per-step LR: constant, or 'cosine' decaying to 0 over the run. The
    losses stay on the device for ``steps_per_dispatch`` steps, then the
    host reads them in one fetch. The first window warms up and is not
    timed.

    ``wiener_estimator`` (e.g. ``"mmse_full_est"``, the fully blind
    Wiener) switches to the 7-channel residual-on-Wiener layout, the
    feature computed from the same fresh frames, so no sidecar is needed.
    ``checkpoint_dir`` saves the final model (``train.checkpoint`` layout,
    ``online=True`` in its metadata). The LSTM takes a sequence layout, not
    grid inputs, so ``model_type='lstm'`` raises ``ValueError``.

    Returns the sustained end-to-end samples/s and the loss trajectory.
    """
    from ..models.factory import get_model
    from ..physics.simulate import table_for
    from ..train.checkpoint import save_checkpoint
    from ..train.trainer import Trainer

    if model_type.lower() == "lstm":
        raise ValueError("online_train feeds grid inputs; the lstm takes the (S·K, 4) "
                         "sequence layout (train it from a materialized split)")
    dev = resolve_device(device)
    st = stats or {"rx_std": 1.0, "hls_std": 1.0, "h_std": 1.0}
    tr = cfg.training
    loss_type = loss_type or tr.loss
    model_cfg = cfg.model
    if wiener_estimator:
        model_cfg = dataclasses.replace(model_cfg, input_channels=7)
    model = get_model(model_type, model_cfg, dtype=dtype, seed=cfg.seed, device=dev)
    train_cfg = dataclasses.replace(cfg, training=dataclasses.replace(tr, loss=loss_type))
    trainer = Trainer(train_cfg, model=model, model_type=model_type, device=dev, log=log)
    model.train()
    table = table_for(cfg)

    num_steps = max(total_samples // batch_size, 2 * steps_per_dispatch)
    num_windows = num_steps // steps_per_dispatch
    num_steps = num_windows * steps_per_dispatch

    def lr_at(step: int) -> float:
        if lr_schedule == "cosine":
            return tr.learning_rate * 0.5 * (1 + math.cos(math.pi * step / num_steps))
        return tr.learning_rate

    def window(win: int) -> np.ndarray:
        losses = []
        for step in range(win * steps_per_dispatch, (win + 1) * steps_per_dispatch):
            for group in trainer.optimizer.param_groups:
                group["lr"] = lr_at(step)
            x, y, m = online_batch(cfg, seed_split, step, batch_size, st, wiener_estimator,
                                   table, dev)
            losses.append(trainer._step(x, y, m))
        return torch.stack(losses).float().cpu().numpy()

    l0 = window(0)  # warm-up, not timed
    t0 = time.perf_counter()
    losses = [l0] + [window(win) for win in range(1, num_windows)]
    elapsed = time.perf_counter() - t0
    rate = (num_windows - 1) * steps_per_dispatch * batch_size / max(elapsed, 1e-9)
    all_losses = np.concatenate(losses)
    out = {
        "model": model_type,
        "total_samples": num_steps * batch_size,
        "batch_size": batch_size,
        "steps": num_steps,
        "steps_per_dispatch": steps_per_dispatch,
        "dtype": str(dtype).replace("torch.", ""),
        "wiener_estimator": wiener_estimator,
        "loss_type": loss_type,
        "lr_schedule": lr_schedule,
        "end_to_end_samples_per_second": rate,
        "elapsed_s": elapsed,
        "first_loss": float(all_losses[0]),
        "last_loss": float(all_losses[-1]),
        "loss_every_16_steps": [float(x) for x in all_losses[::16]],
        "backend": dev.type,
        "device_name": _device_name(dev),
    }
    if checkpoint_dir is not None:
        save_checkpoint(
            checkpoint_dir, model, trainer.optimizer,
            epoch=num_steps,  # step count; online training has no epochs
            online=True,
            **{k: out[k] for k in (
                "total_samples", "batch_size", "wiener_estimator",
                "loss_type", "last_loss",
            )},
        )
        out["checkpoint"] = str(checkpoint_dir)
    log(
        f"[online {model_type}] {out['total_samples']} samples in "
        f"{elapsed:.1f}s ({rate:.0f} samples/s end-to-end), loss "
        f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}"
    )
    return out
