"""A generated split in host memory, batched into the models' inputs.

Port of ``ce5g_tpu.train.datasets.ChannelDataset`` (reference
src/train.py:22-94, run_phase4_training.py:33-112): a merged file or a
manifest of chunks (npz, h5 or ``.ce5g``), GLOBAL normalisation stats over
the first antenna pair (std of the complex magnitude,
run_phase4_training.py:62-71), the Wiener feature joined from sidecar
manifests (``data.wiener``), and NHWC numpy batches that the caller moves
to its device; and ``DeviceDataset``, a whole split resident on the card
as NHWC tensors.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..data.generator import read_chunk
from ..device import resolve_device
from ..models.inputs import MLBatch
from ..physics.profiles import PROFILE_NAMES


class ChannelDataset:
    """In-memory dataset over a merged file or manifest-described chunks."""

    def __init__(self, path, normalize: bool = True, wiener: "bool | str" = False):
        """``wiener`` joins a Wiener feature and emits 7-channel inputs
        [rx_re, rx_im, ls_re, ls_im, mask, wiener_re, wiener_im] for the
        residual-on-Wiener models (``models.inputs.apply_output_residual``).
        An ``H_wiener`` array in the split wins for any tag; otherwise
        ``True`` (or ``"wiener"``) loads the oracle-prior sidecar
        (``<split>_wiener_manifest.json``) and ``"bwiener"`` the
        blind-prior one, both written by ``data.wiener.compute_wiener_sidecar``.
        Raises ``ValueError`` for a merged file without ``H_wiener``, a
        sidecar computed from another split (fingerprint) or of another
        length, and ``FileNotFoundError`` for a missing sidecar manifest."""
        p = Path(path)
        manifest = None
        if p.suffix == ".json":
            manifest = json.loads(p.read_text())
            parts = [read_chunk(p.parent / f) for f in manifest["files"]]
            self.arrays = {
                k: np.concatenate([q[k] for q in parts], axis=0) for k in parts[0]
            }
        else:
            self.arrays = read_chunk(p)
        self.wiener = bool(wiener)
        if wiener and "H_wiener" not in self.arrays:
            tag = "wiener" if wiener is True else str(wiener)
            if manifest is None:
                raise ValueError(
                    "wiener sidecars require a manifest-backed split "
                    f"(got {p}); pass the <split>_manifest.json path"
                )
            wp = p.parent / f"{p.name.replace('_manifest.json', '')}_{tag}_manifest.json"
            if not wp.exists():
                raise FileNotFoundError(
                    f"wiener sidecar manifest {wp} not found — run "
                    "data.wiener.compute_wiener_sidecar first"
                )
            wm = json.loads(wp.read_text())
            src_fp = wm.get("source_fingerprint")
            split_fp = manifest.get("fingerprint")
            if src_fp is not None and split_fp is not None and src_fp != split_fp:
                raise ValueError(
                    f"wiener sidecar {wp.name} was computed from a dataset "
                    f"with fingerprint {src_fp}, but this split's "
                    f"fingerprint is {split_fp} — regenerate the sidecars "
                    "(data.wiener.compute_wiener_sidecar)"
                )
            hw = np.concatenate(
                [read_chunk(wp.parent / f)["H_wiener"] for f in wm["files"]],
                axis=0,
            )
            if len(hw) != len(self.arrays["rx_symbols"]):
                raise ValueError(
                    f"wiener sidecar has {len(hw)} samples, dataset has "
                    f"{len(self.arrays['rx_symbols'])}"
                )
            self.arrays["H_wiener"] = hw
        self.normalize = normalize
        self.stats = self._compute_stats() if normalize else None

    def _compute_stats(self) -> Dict[str, float]:
        """Global magnitude-std stats over the first antenna pair
        (reference run_phase4_training.py:62-71)."""
        rx = self.arrays["rx_symbols"][:, :, 0, :]
        hls = self.arrays["H_ls"][:, :, 0, 0, :]
        ht = self.arrays["H_true"][:, :, 0, 0, :]
        return {
            "rx_std": float(np.std(np.abs(rx)) + 1e-8),
            "hls_std": float(np.std(np.abs(hls)) + 1e-8),
            "h_std": float(np.std(np.abs(ht)) + 1e-8),
        }

    def __len__(self) -> int:
        return self.arrays["rx_symbols"].shape[0]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        _, s, _, k = self.arrays["rx_symbols"].shape
        return s, k

    def make_batch(self, idx: np.ndarray) -> MLBatch:
        """A normalised 5- (or 7-) channel numpy batch of the given samples."""
        rx = self.arrays["rx_symbols"][idx][:, :, 0, :]
        hls = self.arrays["H_ls"][idx][:, :, 0, 0, :]
        ht = self.arrays["H_true"][idx][:, :, 0, 0, :]
        mask = self.arrays["pilot_mask"][idx].astype(np.float32)
        st = self.stats or {"rx_std": 1.0, "hls_std": 1.0, "h_std": 1.0}
        chans = [
            rx.real / st["rx_std"],
            rx.imag / st["rx_std"],
            hls.real / st["hls_std"],
            hls.imag / st["hls_std"],
            mask,
        ]
        if self.wiener:
            # normalised like the TARGET, so the residual head's sum
            # (pred + wiener) lives on the target's scale
            hw = self.arrays["H_wiener"][idx]
            chans += [hw.real / st["h_std"], hw.imag / st["h_std"]]
        inputs = np.stack(chans, axis=-1).astype(np.float32)
        targets = np.stack(
            [ht.real / st["h_std"], ht.imag / st["h_std"]], axis=-1
        ).astype(np.float32)
        return MLBatch(inputs, targets, mask, st)

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = True,
    ) -> Iterator[MLBatch]:
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, stop, batch_size):
            yield self.make_batch(order[i : i + batch_size])

    def metadata_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Per-sample SNR, profile name, Doppler and pilot density. Chunk
        files store the profile as ``profile_idx`` and merged files as
        ``channel_type`` names; both give names here (the JAX package's
        version reads ``channel_type`` only and fails on chunks)."""
        out = {k: self.arrays[k][idx] for k in ("snr_db", "doppler_hz", "pilot_density")}
        if "channel_type" in self.arrays:
            out["channel_type"] = self.arrays["channel_type"][idx]
        else:
            out["channel_type"] = np.asarray(PROFILE_NAMES)[self.arrays["profile_idx"][idx]]
        return out


class DeviceDataset:
    """A whole split resident on ``device`` as NHWC float32 tensors:
    ``inputs`` (N, S, K, 5 or 7) and ``targets`` (N, S, K, 2), built on
    the host in chunks of ``build_chunk`` frames through
    ``ChannelDataset.make_batch`` (port of the JAX package's
    ``DeviceDataset``). A trainer gathers its batches on the card by index,
    so no step moves data from the host. The pilot mask is channel 4 of
    ``inputs``; consumers slice ``inputs[..., 4]``."""

    def __init__(self, ds: ChannelDataset, build_chunk: int = 1024, device="cuda"):
        dev = resolve_device(device)
        n = len(ds)
        s, k = ds.grid_shape
        c_in = 7 if ds.wiener else 5
        self.inputs = torch.empty((n, s, k, c_in), dtype=torch.float32, device=dev)
        self.targets = torch.empty((n, s, k, 2), dtype=torch.float32, device=dev)
        for start in range(0, n, build_chunk):
            idx = np.arange(start, min(start + build_chunk, n))
            b = ds.make_batch(idx)
            self.inputs[start:start + len(idx)] = torch.from_numpy(b.inputs)
            self.targets[start:start + len(idx)] = torch.from_numpy(b.targets)
        self.stats = ds.stats

    def __len__(self) -> int:
        return self.inputs.shape[0]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        _, s, k, _ = self.inputs.shape
        return s, k
