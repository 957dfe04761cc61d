"""The dataset factory: per-frame parameter draws → simulation → LS
feature → chunk files with JSON manifests. Port of
``ce5g_tpu.data.generator`` (reference dataset_generator.py:66-180,
run_phase3_robust.py:95-310).

The JAX package draws every frame from a PRNG key; here the parameters
come from a ``torch.Generator`` (:func:`draw_params`) and the frame's
random numbers arrive as ``physics.FrameDraws``, so a test can inject the
JAX package's own draws into :func:`generate_chunk`.

:class:`DatasetGenerator` draws chunk ``i`` of a split from its own
generator (``utils.rng.chunk_generator``), always at the full chunk size,
then slices: a sample is a pure function of (seed, split, chunk size,
index, device type). Any chunk can be regenerated alone on any writer,
bitwise; the manifest's checkpoint is a count, not RNG state. Files are
npz, h5 (``h5py``, imported when used) or the ``.ce5g`` container
(``data.ce5g_format``), with the JAX package's keys and dtypes.
"""
from __future__ import annotations

import functools
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..physics.profiles import PROFILE_INDEX, PROFILE_NAMES, ProfileTable
from ..physics.simulate import (FrameDraws, FrameParams, draw_frames, simulate_batch,
                                table_for)
from ..utils.rng import chunk_generator

#: arrays stored per split (reference sample dict, dataset_generator.py:77-87)
CHUNK_KEYS = (
    "rx_symbols",
    "tx_symbols",
    "H_true",
    "H_ls",
    "pilot_mask",
    "snr_db",
    "doppler_hz",
    "pilot_density",
    "profile_idx",
)


@functools.lru_cache(maxsize=64)
def _value_table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A config list as a tensor on ``device``, made once: a fresh copy from
    the host would synchronise the card's stream on every chunk."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def draw_params(cfg: ExperimentConfig, n: int, generator: torch.Generator,
                device="cuda") -> FrameParams:
    """``n`` frames' parameters, each drawn uniformly and independently from
    the config lists (reference dataset_generator.py:114-117). The
    generator must live on ``device``."""
    dev = resolve_device(device)

    def pick(values, dtype):
        table = _value_table(tuple(values), dtype, dev)
        return table[torch.randint(len(values), (n,), generator=generator, device=dev)]

    return FrameParams(
        profile_idx=pick([PROFILE_INDEX[m] for m in cfg.channel.models], torch.int32),
        doppler_hz=pick(cfg.channel.doppler_hz, torch.float32),
        snr_db=pick(cfg.simulation.snr_range_db, torch.float32),
        pilot_density=pick(cfg.pilots.density, torch.float32),
    )


def chunk_draws(cfg: ExperimentConfig, split: str, chunk_idx: int, chunk_size: int,
                device="cuda") -> Tuple[FrameParams, FrameDraws]:
    """The parameters and random numbers of all ``chunk_size`` frames of
    chunk ``chunk_idx`` of ``split``, from the chunk's own generator: the
    parameters first, then the frames' draws."""
    dev = resolve_device(device)
    gen = chunk_generator(cfg.seed, split, chunk_idx, chunk_size, dev)
    params = draw_params(cfg, chunk_size, gen, device=dev)
    return params, draw_frames(gen, params, cfg, device=dev)


def generate_chunk(cfg: ExperimentConfig, params: FrameParams, draws: FrameDraws,
                   table: Optional[ProfileTable] = None,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Simulate the frames of ``params``/``draws`` and their LS feature
    (``cfg.pilots.interpolation``): the chunk dict of ``CHUNK_KEYS``, every
    tensor on ``device``."""
    dev = resolve_device(device)
    frames = simulate_batch(draws, params, cfg=cfg, table=table, device=dev)
    h_ls = estimate_batch(frames, cfg=cfg, estimator="ls", method=cfg.pilots.interpolation,
                          table=table, device=dev)
    p = frames.params
    return {
        "rx_symbols": frames.rx_symbols,
        "tx_symbols": frames.tx_symbols,
        "H_true": frames.channel,
        "H_ls": h_ls,
        "pilot_mask": frames.pilot_mask,
        "snr_db": p.snr_db,
        "doppler_hz": p.doppler_hz,
        "pilot_density": p.pilot_density,
        "profile_idx": p.profile_idx,
    }


# ----------------------------------------------------------------- file I/O
#: save_format value → file extension ('ce5g' is the fast native-codec
#: container, data/ce5g_format.py; npz/h5 are reference-parity formats)
FORMAT_EXT = {"npz": "npz", "h5": "h5", "ce5g": "ce5g"}


def _write_npz(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **arrays)


def _write_h5(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            if v.dtype.kind == "U":  # channel_type → S10 (reference :171-176)
                f.create_dataset(k, data=v.astype("S10"))
            else:
                f.create_dataset(k, data=v, compression="gzip")


def _read_h5(path: Path) -> Dict[str, np.ndarray]:
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for k in f:
            v = f[k][()]
            if v.dtype.kind == "S":
                v = v.astype("U10")
            out[k] = v
    return out


def _write_chunk(path: Path, arrays: Dict[str, np.ndarray], fmt: str) -> None:
    if fmt == "h5":
        _write_h5(path, arrays)
    elif fmt == "ce5g":
        from .ce5g_format import write_ce5g

        write_ce5g(path, arrays)
    else:
        _write_npz(path, arrays)


def read_chunk(path) -> Dict[str, np.ndarray]:
    """The arrays of one chunk or merged split: .npz, .h5 or .ce5g."""
    p = Path(path)
    if p.suffix == ".h5":
        return _read_h5(p)
    if p.suffix == ".ce5g":
        from .ce5g_format import read_ce5g

        return read_ce5g(p)
    with np.load(p, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def read_split(path) -> Dict[str, np.ndarray]:
    """Load a merged file or a manifest (concatenating its chunks)."""
    p = Path(path)
    if p.suffix == ".json":
        manifest = json.loads(p.read_text())
        parts = [read_chunk(p.parent / f) for f in manifest["files"]]
        return {k: np.concatenate([q[k] for q in parts], axis=0) for k in parts[0]}
    return read_chunk(p)


def chunk_range_for_writer(
    num_chunks: int, num_writers: int, writer_id: int
) -> "tuple[int, int]":
    """Balanced contiguous chunk block [lo, hi) owned by ``writer_id``."""
    if not (0 <= writer_id < num_writers):
        raise ValueError(f"writer_id {writer_id} outside [0, {num_writers})")
    base, extra = divmod(num_chunks, num_writers)
    lo = writer_id * base + min(writer_id, extra)
    return lo, lo + base + (1 if writer_id < extra else 0)


def _process_writers() -> Tuple[int, int]:
    """(writer_id, num_writers): torch.distributed's rank and world size
    when a process group is up, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ---------------------------------------------------------------- generator
class DatasetGenerator:
    """Chunked, resumable, multi-writer dataset factory on ``device``."""

    def __init__(self, cfg: ExperimentConfig, output_dir, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.out = Path(output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.table = table_for(cfg)

    # -- paths
    def _ext(self) -> str:
        return FORMAT_EXT.get(self.cfg.dataset.save_format, "npz")

    def _chunk_path(self, split: str, chunk_idx: int) -> Path:
        return self.out / f"{split}_chunk_{chunk_idx:05d}.{self._ext()}"

    def _manifest_path(
        self, split: str, writer_id: int = 0, num_writers: int = 1
    ) -> Path:
        if num_writers > 1:
            return self.out / f"{split}_manifest_w{writer_id:03d}.json"
        return self.out / f"{split}_manifest.json"

    def _fingerprint(self) -> str:
        """Identity of everything that determines sample content + file
        format: the JAX package's fields, the generator family that draws
        the numbers (``rng``: ``torch-cuda`` or ``torch-cpu``) and the
        chunk size (a port sample depends on it). Resume is only valid when
        this matches the previous run, so neither package resumes the
        other's split, and a sidecar made for one split is refused by
        another."""
        c = self.cfg
        return json.dumps(
            {
                "seed": c.seed,
                "format": c.dataset.save_format,
                "models": list(c.channel.models),
                "doppler": list(map(float, c.channel.doppler_hz)),
                "snr": list(map(float, c.simulation.snr_range_db)),
                "density": list(map(float, c.pilots.density)),
                "interp": c.pilots.interpolation,
                "ofdm": [c.ofdm.fft_size, c.ofdm.cp_length, c.ofdm.num_symbols,
                         c.ofdm.num_used_subcarriers],
                "mimo": [c.mimo.num_tx, c.mimo.num_rx],
                "rng": f"torch-{self.device.type}",
                "chunk_size": c.dataset.chunk_size,
            },
            sort_keys=True,
        )

    # -- core
    def chunk_tensors(self, split: str, chunk_idx: int) -> Dict[str, torch.Tensor]:
        """All ``chunk_size`` frames of chunk ``chunk_idx`` as the
        ``CHUNK_KEYS`` tensors on the device."""
        params, draws = chunk_draws(self.cfg, split, chunk_idx, self.cfg.dataset.chunk_size,
                                    self.device)
        return generate_chunk(self.cfg, params, draws, self.table, device=self.device)

    def _run_chunk(self, split: str, chunk_idx: int, n: int) -> Dict[str, np.ndarray]:
        """The first ``n`` frames of chunk ``chunk_idx`` on the host, with
        ``channel_type`` names in place of ``profile_idx``. The whole chunk
        is simulated (as the JAX package pads), so a trailing partial chunk
        is the prefix of the full one."""
        out = {k: v[:n].cpu().numpy() for k, v in self.chunk_tensors(split, chunk_idx).items()}
        out["channel_type"] = np.asarray(PROFILE_NAMES, dtype="<U10")[
            out.pop("profile_idx").astype(np.int64) % len(PROFILE_NAMES)
        ]
        return out

    def generate_split(
        self,
        split: str,
        num_samples: int,
        resume: bool = False,
        log=print,
        writer_id: Optional[int] = None,
        num_writers: Optional[int] = None,
    ) -> Dict:
        """Generate `num_samples` frames for `split` in chunk files.

        Resumable: the manifest records completed chunks; samples are pure
        functions of (seed, split, chunk size, index), so restarting never
        changes the data (reference run_phase3_robust.py:144-156 semantics
        without RNG-state fragility).

        Chunk i always covers the fixed index range
        [i·chunk_size, min((i+1)·chunk_size, num_samples)). On resume with
        a different ``num_samples``, only the contiguous prefix of FULL
        chunks valid under both the old and new totals is reused; the
        trailing partial chunk (and anything after it) is regenerated —
        identical, since a chunk is always drawn whole — so growing or
        shrinking a split never drops or duplicates samples.

        Multi-writer: with ``num_writers`` > 1 (default: torch.distributed's
        world size when a process group is up), writer ``writer_id``
        generates only its contiguous block of chunks and writes a
        per-writer manifest. Because chunk content is a pure function of
        its index, the union over writers is bit-identical to a
        single-writer run. After all writers finish (callers should
        barrier), :meth:`write_global_manifest` assembles the standard
        manifest.
        """
        if num_writers is None:
            writer_id, num_writers = _process_writers()
        writer_id = writer_id or 0
        chunk_size = self.cfg.dataset.chunk_size
        num_chunks = -(-num_samples // chunk_size) if num_samples else 0
        chunk_lo, chunk_hi = chunk_range_for_writer(
            num_chunks, num_writers, writer_id
        )
        owned_samples = max(
            0,
            min(chunk_hi * chunk_size, num_samples) - chunk_lo * chunk_size,
        )
        fingerprint = self._fingerprint()
        mpath = self._manifest_path(split, writer_id, num_writers)
        manifest = {
            "split": split,
            "total": num_samples,
            "completed": 0,
            "chunk_size": chunk_size,
            "files": [],
            "samples_per_second": 0.0,
            "seed": self.cfg.seed,
            "format": self.cfg.dataset.save_format,
            "fingerprint": fingerprint,
            "writer_id": writer_id,
            "num_writers": num_writers,
            "chunk_range": [chunk_lo, chunk_hi],
            "owned_samples": owned_samples,
        }
        if resume and mpath.exists():
            prev = json.loads(mpath.read_text())
            if (
                prev.get("chunk_size") == chunk_size
                and prev.get("fingerprint") == fingerprint
            ):
                # Chunk i is reusable iff its fixed index range under the
                # previous total equals its range under the new total AND it
                # was fully written; keep the contiguous on-disk prefix of
                # reusable chunks in the owned range. A trailing chunk that
                # was partial under a different total is regenerated, never
                # silently kept or overwritten.
                prev_total = prev.get("total", prev.get("completed", 0))
                prev_done = min(prev.get("completed", 0), prev_total)
                # prev 'completed' counted prev-owned samples; convert to a
                # global sample bound for the full-chunk check
                prev_lo = prev.get("chunk_range", [0, 0])[0]
                prev_bound = prev_lo * chunk_size + prev_done
                files: List[str] = []
                completed, i = 0, chunk_lo
                while i < chunk_hi:
                    prev_end = min((i + 1) * chunk_size, prev_total)
                    new_end = min((i + 1) * chunk_size, num_samples)
                    p = self._chunk_path(split, i)
                    if (
                        prev_end != new_end
                        or prev_end > prev_bound
                        or p.name not in prev.get("files", [])
                        or not p.exists()
                    ):
                        break
                    files.append(p.name)
                    completed = new_end - chunk_lo * chunk_size
                    i += 1
                manifest.update(
                    completed=completed,
                    files=files,
                    samples_per_second=prev.get("samples_per_second", 0.0),
                )
        # a single writer owns the whole namespace: prune stale chunks beyond
        # a shrunk total too; a multi-writer run prunes only its own
        # contiguous block, so writers never race on each other's files
        prune_hi = None if num_writers == 1 else chunk_hi
        if manifest["completed"] >= owned_samples:
            manifest["completed"] = owned_samples
            mpath.write_text(json.dumps(manifest, indent=2))
            self._prune_stale_chunks(split, manifest, chunk_lo, prune_hi)
            return manifest

        t0 = time.perf_counter()
        done_this_session = 0
        start = chunk_lo * chunk_size + manifest["completed"]
        stop = min(chunk_hi * chunk_size, num_samples)
        while start < stop:
            end = min(start + chunk_size, stop)
            arrays = self._run_chunk(split, start // chunk_size, end - start)
            cpath = self._chunk_path(split, start // chunk_size)
            _write_chunk(cpath, arrays, self.cfg.dataset.save_format)
            if cpath.name not in manifest["files"]:
                manifest["files"].append(cpath.name)
            done_this_session += end - start
            manifest["completed"] = end - chunk_lo * chunk_size
            elapsed = time.perf_counter() - t0
            manifest["samples_per_second"] = done_this_session / max(elapsed, 1e-9)
            mpath.write_text(json.dumps(manifest, indent=2))
            log(
                f"[{split}"
                + (f" w{writer_id}/{num_writers}" if num_writers > 1 else "")
                + f"] {end}/{stop} "
                f"({manifest['samples_per_second']:.1f} samples/s)"
            )
            start = end
        self._prune_stale_chunks(split, manifest, chunk_lo, prune_hi)
        return manifest

    def write_global_manifest(self, split: str, num_writers: int) -> Dict:
        """Assemble the standard `{split}_manifest.json` from per-writer
        manifests after a multi-writer run. Validates that every writer
        finished with the same fingerprint/total; prunes chunk files not
        referenced by any writer. The result is read by `read_split`/
        `verify_dataset` exactly like a single-writer manifest."""
        parts = []
        for w in range(num_writers):
            p = self._manifest_path(split, w, num_writers)
            if not p.exists():
                raise FileNotFoundError(f"missing per-writer manifest: {p}")
            parts.append(json.loads(p.read_text()))
        fp = parts[0]["fingerprint"]
        total = parts[0]["total"]
        for m in parts:
            if m["fingerprint"] != fp or m["total"] != total:
                raise ValueError(
                    f"inconsistent per-writer manifests for split {split!r}"
                )
            if m["completed"] < m["owned_samples"]:
                raise ValueError(
                    f"writer {m['writer_id']} incomplete: "
                    f"{m['completed']}/{m['owned_samples']}"
                )
        files = [f for m in parts for f in m["files"]]
        manifest = {
            "split": split,
            "total": total,
            "completed": total,
            "chunk_size": parts[0]["chunk_size"],
            "files": sorted(files),
            "samples_per_second": sum(m["samples_per_second"] for m in parts),
            "seed": parts[0]["seed"],
            "format": parts[0]["format"],
            "fingerprint": fp,
            "num_writers": num_writers,
        }
        self._manifest_path(split).write_text(json.dumps(manifest, indent=2))
        self._prune_stale_chunks(split, manifest)
        return manifest

    def _prune_stale_chunks(
        self,
        split: str,
        manifest: Dict,
        chunk_lo: int = 0,
        chunk_hi: Optional[int] = None,
    ) -> None:
        """Delete this split's chunk files in [chunk_lo, chunk_hi) that are
        no longer referenced by the manifest (left behind when a resume
        shrank ``num_samples``). Multi-writer runs prune only their owned
        range so writers never race on each other's files."""
        keep = set(manifest["files"])
        for p in self.out.glob(f"{split}_chunk_*.*"):
            try:
                idx = int(p.name.split("_chunk_")[1].split(".")[0])
            except (IndexError, ValueError):
                continue
            if chunk_hi is not None and not (chunk_lo <= idx < chunk_hi):
                continue
            if p.name not in keep:
                p.unlink()

    def merge_split(self, split: str) -> str:
        """Concatenate chunk files into one `{split}.npz`/`.h5`/`.ce5g`
        (reference run_phase3_robust.py:261-288)."""
        arrays = read_split(str(self._manifest_path(split)))
        out = self.out / f"{split}.{self._ext()}"
        _write_chunk(out, arrays, self.cfg.dataset.save_format)
        return str(out)
