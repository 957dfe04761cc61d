"""Full-Wiener sidecars for generated splits. Port of
``ce5g_tpu.data.wiener``.

Precompute a classical estimate per sample and store its first antenna
pair (S, K) complex64 as sidecar chunks beside the split, with a
``<split>_<tag>_manifest.json``. ``ChannelDataset(manifest, wiener=tag)``
joins them to emit the 7-channel residual-on-Wiener layout
(``models.inputs.apply_output_residual``).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np


def compute_wiener_sidecar(
    cfg,
    manifest_path,
    batch_size: int = 64,
    log=print,
    estimator: str = "mmse_full",
    tag: str = "wiener",
    device="cuda",
) -> Optional[dict]:
    """Compute Wiener-estimate sidecars for one split manifest on
    ``device``. Returns the sidecar manifest dict (also written next to the
    split manifest).

    ``estimator='mmse_full'`` (oracle priors, default) writes
    ``<split>_wiener_*``; ``estimator='mmse_full_est', tag='bwiener'``
    writes the blind-prior sidecars (``<split>_bwiener_*``), whose feature
    inherits no genie information (``estimators.blind``). Each sidecar
    chunk holds one array, ``H_wiener``, whatever the tag, as the JAX
    package's do; frames are estimated in batches of ``batch_size``, the
    last one shorter (each frame's estimate is its own).
    """
    from ..device import resolve_device
    from ..estimators.api import estimate_batch
    from ..eval.evaluate import _frames_from_arrays
    from ..physics.simulate import table_for
    from .ce5g_format import write_ce5g
    from .generator import read_chunk

    dev = resolve_device(device)
    mp = Path(manifest_path)
    manifest = json.loads(mp.read_text())
    split = manifest.get("split", mp.stem)
    table = table_for(cfg)

    out_files = []
    t_split = time.time()
    n_done = 0
    for f in manifest["files"]:
        src = mp.parent / f
        dst = mp.parent / (
            f.replace("_chunk_", f"_{tag}_").rsplit(".", 1)[0] + ".ce5g"
        )
        arrays = read_chunk(src)
        n = len(arrays["rx_symbols"])
        n_sym, n_sc = arrays["pilot_mask"].shape[1:]
        out = np.empty((n, n_sym, n_sc), np.complex64)
        t0 = time.time()
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            frames = _frames_from_arrays(arrays, idx, cfg, dev)
            h = estimate_batch(frames, cfg=cfg, estimator=estimator, table=table, device=dev)
            out[idx] = h[:, :, 0, 0, :].cpu().numpy()  # (B, S, R, T, K), equal along T
            n_done += len(idx)
        write_ce5g(dst, {"H_wiener": out})
        out_files.append(dst.name)
        log(f"{split}: {dst.name} ({n} samples, {time.time() - t0:.1f}s)")

    wm = {
        "split": split,
        "estimator": estimator,
        "files": out_files,
        "source_fingerprint": manifest.get("fingerprint"),
        "samples_per_second": n_done / max(time.time() - t_split, 1e-9),
    }
    (mp.parent / f"{split}_{tag}_manifest.json").write_text(
        json.dumps(wm, indent=2)
    )
    return wm
