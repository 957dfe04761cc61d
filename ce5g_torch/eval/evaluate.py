"""Evaluation: baselines, classical estimators and neural estimators on a
test split. Port of ``ce5g_tpu.eval.evaluate`` (reference
src/evaluate.py:35-235, run_phase5_evaluation.py:71-386):

  * ``evaluate_baselines``: LS NMSE from the stored H_ls feature and the
    phase-5 simplified scalar MMSE α·H_ls, α = 1/(1+σ²);
  * ``evaluate_estimators``: the real classical estimators re-run on the
    split's frames, timed;
  * ``ModelEvaluator``: checkpoint load → batched forward → denormalise →
    NMSE/MSE/MAE and per-sample latency; ``snr_sweep`` per SNR with the
    analytic BER proxy.

Latencies are host clock around work that ends in a device synchronise.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..models.factory import MODEL_TYPES, count_parameters, get_model
from ..models.inputs import apply_output_residual, lstm_inputs
from ..physics.profiles import PROFILE_INDEX
from ..physics.simulate import Frame, FrameParams, table_for
from ..train.checkpoint import load_checkpoint
from ..train.datasets import ChannelDataset
from ..utils.metrics import ber_approximation


def _nmse_per_sample(h_true: np.ndarray, h_est: np.ndarray) -> np.ndarray:
    axes = tuple(range(1, h_true.ndim))
    err = np.mean(np.abs(h_true - h_est) ** 2, axis=axes)
    pwr = np.mean(np.abs(h_true) ** 2, axis=axes)
    return err / (pwr + 1e-12)


def _mse_per_sample(h_true: np.ndarray, h_est: np.ndarray) -> np.ndarray:
    axes = tuple(range(1, h_true.ndim))
    return np.mean(np.abs(h_true - h_est) ** 2, axis=axes)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate_baselines(ds: ChannelDataset, num_samples: Optional[int] = None) -> Dict:
    """LS (stored) + simplified scalar MMSE (phase-5 parity), on the host."""
    n = min(num_samples or len(ds), len(ds))
    h_true = ds.arrays["H_true"][:n]
    h_ls = ds.arrays["H_ls"][:n]
    snr_db = ds.arrays["snr_db"][:n].astype(np.float64)

    ls_nmse = _nmse_per_sample(h_true, h_ls)
    ls_slice = _nmse_per_sample(h_true[:, :, 0, 0, :], h_ls[:, :, 0, 0, :])

    # phase-5 simplified MMSE: α = 1/(1+σ²), σ² = 1/SNR_lin  (:246-253)
    sigma2 = 10 ** (-snr_db / 10)
    alpha = (1.0 / (1.0 + sigma2)).reshape(-1, *([1] * (h_ls.ndim - 1)))
    mmse_nmse = _nmse_per_sample(h_true, alpha * h_ls)
    mmse_slice = _nmse_per_sample(h_true[:, :, 0, 0, :], (alpha * h_ls)[:, :, 0, 0, :])

    return {
        "LS": {
            "nmse": float(ls_nmse.mean()),
            "nmse_db": float(10 * np.log10(ls_nmse.mean() + 1e-12)),
            "nmse_db_slice": float(10 * np.log10(ls_slice.mean() + 1e-12)),
            "mse": float(_mse_per_sample(h_true, h_ls).mean()),
            "source": "stored H_ls feature (no compute — latency n/a)",
        },
        "MMSE": {
            "nmse": float(mmse_nmse.mean()),
            "nmse_db": float(10 * np.log10(mmse_nmse.mean() + 1e-12)),
            "nmse_db_slice": float(10 * np.log10(mmse_slice.mean() + 1e-12)),
            "mse": float(_mse_per_sample(h_true, alpha * h_ls).mean()),
            "source": "simplified α·H_ls on stored arrays "
            "(run_phase5_evaluation.py:246-253 parity)",
        },
        "num_samples": n,
        "per_sample": {"LS": ls_nmse.tolist(), "MMSE": mmse_nmse.tolist()},
    }


def _frames_from_arrays(arrays: Dict, idx: np.ndarray, cfg: ExperimentConfig,
                        device="cuda") -> Frame:
    """Frames rebuilt from stored split arrays on ``device``, so the real
    estimators can run on the test split. The split stores the pilot mask;
    the slot table is rebuilt here (row-major argwhere order is the
    generator's linear-index order)."""
    dev = resolve_device(device)
    s = cfg.ofdm.num_symbols
    k = cfg.ofdm.num_used_subcarriers
    p_max = int(s * k * cfg.pilots.max_density)
    b = len(idx)
    masks = np.asarray(arrays["pilot_mask"][idx], np.float32)
    positions = np.zeros((b, p_max, 2), np.int32)
    valid = np.zeros((b, p_max), np.float32)
    counts = np.zeros((b,), np.int32)
    for i in range(b):
        pos = np.argwhere(masks[i] > 0).astype(np.int32)
        n = min(len(pos), p_max)
        positions[i, :n] = pos[:n]
        valid[i, :n] = 1.0
        counts[i] = n
    if "profile_idx" in arrays:
        prof = np.asarray(arrays["profile_idx"][idx], np.int32)
    else:  # merged npz stores channel_type strings (reference parity format)
        prof = np.asarray([PROFILE_INDEX[str(c)] for c in arrays["channel_type"][idx]],
                          np.int32)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    params = FrameParams(
        profile_idx=t(prof),
        doppler_hz=t(arrays["doppler_hz"][idx], np.float32),
        snr_db=t(arrays["snr_db"][idx], np.float32),
        pilot_density=t(arrays["pilot_density"][idx], np.float32),
    )
    return Frame(
        tx_symbols=t(arrays["tx_symbols"][idx], np.complex64),
        rx_symbols=t(arrays["rx_symbols"][idx], np.complex64),
        channel=t(arrays["H_true"][idx], np.complex64),
        pilot_mask=t(masks),
        pilot_positions=t(positions),
        pilot_valid=t(valid),
        num_pilots=t(counts),
        params=params,
    )


def evaluate_estimators(
    ds: ChannelDataset,
    cfg: ExperimentConfig,
    estimators=("ls", "mmse", "mmse_full"),
    num_samples: Optional[int] = None,
    batch_size: int = 64,
    method: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Re-run the real classical estimators on the test split with timing
    (reference src/evaluate.py:60-80). Latency is steady state: the first
    batch is left out. A short last batch is realigned to end at the last
    sample, so every batch has one shape; only its new samples count."""
    dev = resolve_device(device)
    method = method or cfg.pilots.interpolation
    n = min(num_samples or len(ds), len(ds))
    table = table_for(cfg)
    h_true_all = ds.arrays["H_true"][:n]
    results: Dict[str, Dict] = {}
    for est in estimators:
        nmses: List[float] = []
        mses: List[float] = []
        slices: List[float] = []
        lat_ms: List[float] = []
        for start in range(0, n, batch_size):
            take = min(batch_size, n - start)  # new samples this batch
            idx = np.arange(start, start + take)
            if take < batch_size and n >= batch_size:
                idx = np.arange(n - batch_size, n)  # realign: keep one shape
            frames = _frames_from_arrays(ds.arrays, idx, cfg, dev)
            _sync(dev)
            t0 = time.perf_counter()
            h_est = estimate_batch(frames, cfg=cfg, estimator=est, method=method,
                                   table=table, device=dev)
            _sync(dev)
            lat_ms.append((time.perf_counter() - t0) * 1000 / len(idx))
            h_np = h_est.cpu().numpy().astype(np.complex128)
            nm = _nmse_per_sample(h_true_all[idx], h_np)
            nmses.extend(nm[-take:].tolist())
            mses.extend(_mse_per_sample(h_true_all[idx], h_np)[-take:].tolist())
            slices.extend(
                _nmse_per_sample(h_true_all[idx][:, :, 0, 0, :], h_np[:, :, 0, 0, :])[-take:]
                .tolist()
            )
        nmse = float(np.mean(nmses))
        results[est] = {
            "nmse": nmse,
            "nmse_db": float(10 * np.log10(nmse + 1e-12)),
            "nmse_db_slice": float(10 * np.log10(np.mean(slices) + 1e-12)),
            "mse": float(np.mean(mses)),
            "latency_ms_per_sample": float(np.median(lat_ms[1:] or lat_ms)),
            "num_samples": len(nmses),
            "per_sample": nmses,
            "source": "estimator re-run on test frames (timed)",
        }
    return results


class ModelEvaluator:
    """Loads the JAX package's checkpoints into the port's models and
    evaluates them on a test split, on ``device``."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        model_dir: str,
        results_dir: Optional[str] = None,
        device="cuda",
    ):
        """Only the ``results_dir`` given here is created and written
        (``save_results``); without one nothing is written."""
        self.cfg = cfg
        self.model_dir = Path(model_dir)
        self.device = resolve_device(device)
        self.results_dir = None if results_dir is None else Path(results_dir)
        if self.results_dir is not None:
            self.results_dir.mkdir(parents=True, exist_ok=True)

    def load_model(self, model_type: str, checkpoint: str = "best"):
        """``model_type`` is ``<arch>[_wiener][_<tag>]``: a ``_wiener``
        token anywhere after the arch selects the 7-channel input layout
        (the residual-on-Wiener head); any trailing tag (e.g.
        ``cnn_wiener_blind``) only names the checkpoint directory."""
        arch = model_type
        mcfg = self.cfg.model
        if "_wiener" in model_type:
            arch = model_type.split("_wiener", 1)[0]
            mcfg = dataclasses.replace(mcfg, input_channels=7)
        if arch not in MODEL_TYPES:
            # strip a trailing run tag (cnn_tuned → cnn); longest match so
            # cnn_lstm resolves before cnn
            for t in sorted(MODEL_TYPES, key=len, reverse=True):
                if arch.startswith(t + "_"):
                    arch = t
                    break
            else:
                raise ValueError(
                    f"cannot resolve architecture from {model_type!r}; "
                    f"known types: {MODEL_TYPES}"
                )
        model = get_model(arch, mcfg, seed=self.cfg.seed, device=self.device)
        meta = load_checkpoint(self.model_dir / f"{model_type}_{checkpoint}", model)
        return model, meta

    def evaluate_model(
        self,
        model_type: str,
        ds: ChannelDataset,
        num_samples: Optional[int] = None,
        batch_size: int = 32,
        checkpoint: str = "best",
    ) -> Dict:
        model, meta = self.load_model(model_type, checkpoint)
        is_lstm = model_type == "lstm"
        # a wiener-enabled dataset serves every model: plain 5-channel
        # models just slice the parity layout off the front
        wants_wiener = "_wiener" in model_type
        dev = self.device

        n = min(num_samples or len(ds), len(ds))
        h_std = (ds.stats or {"h_std": 1.0})["h_std"]
        nmses: List[float] = []
        maes: List[float] = []
        mses: List[float] = []
        latency_ms: List[float] = []

        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            batch = ds.make_batch(idx)
            if is_lstm:
                x, y = lstm_inputs(batch)
            else:
                x, y = batch.inputs, batch.targets
                if not wants_wiener:
                    x = x[..., :5]
                elif x.shape[-1] < 7:
                    raise ValueError(
                        f"{model_type} needs a wiener-enabled dataset "
                        "(ChannelDataset(wiener=True))"
                    )
            x = torch.as_tensor(x).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                # residual-on-Wiener head when the inputs carry the
                # 7-channel wiener layout
                pred = apply_output_residual(model(x), x)
            _sync(dev)
            latency_ms.append((time.perf_counter() - t0) * 1000 / len(idx))
            pred = pred.cpu().numpy().astype(np.float64) * h_std
            target = np.asarray(y, np.float64) * h_std
            err = pred - target
            axes = tuple(range(1, err.ndim))
            sq = np.mean(err**2, axis=axes)
            pwr = np.mean(target**2, axis=axes)
            nmses.extend((sq / (pwr + 1e-12)).tolist())
            mses.extend(sq.tolist())
            maes.extend(np.mean(np.abs(err), axis=axes).tolist())

        nmse = float(np.mean(nmses))
        return {
            "model": model_type,
            "checkpoint_epoch": meta.get("epoch"),
            "params": count_parameters(model),
            "nmse": nmse,
            "nmse_db": float(10 * np.log10(nmse + 1e-12)),
            "mse": float(np.mean(mses)),
            "mae": float(np.mean(maes)),
            # the first batch pays the card's warm-up; steady-state median
            "latency_ms_per_sample": float(np.median(latency_ms[1:] or latency_ms)),
            "num_samples": n,
            "per_sample_nmse": nmses,
            "source": "checkpoint forward pass (timed)",
            "basis": "slice (rx0, tx0)",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        }

    def snr_sweep(
        self,
        ds: ChannelDataset,
        model_types: List[str],
        num_samples: Optional[int] = None,
        estimators=("mmse_full",),
    ) -> Dict:
        """Per-SNR NMSE + BER proxy for baselines and models
        (run_phase5_evaluation.py:264-312). ``estimators`` adds the re-run
        classical estimators next to the stored-H_ls baselines."""
        n = min(num_samples or len(ds), len(ds))
        snr = ds.arrays["snr_db"][:n]
        baselines = evaluate_baselines(ds, n)
        results: Dict[str, Dict] = {}
        per_method = {
            "LS": np.asarray(baselines["per_sample"]["LS"]),
            "MMSE": np.asarray(baselines["per_sample"]["MMSE"]),
        }
        if estimators:
            full = evaluate_estimators(ds, self.cfg, estimators, n, device=self.device)
            for est, r in full.items():
                per_method[est] = np.asarray(r["per_sample"])
        for mt in model_types:
            r = self.evaluate_model(mt, ds, n)
            per_method[mt] = np.asarray(r["per_sample_nmse"])

        for method, vals in per_method.items():
            by_snr = {}
            for s in sorted(set(snr.tolist())):
                m = snr == s
                mean_nmse = float(vals[m].mean())
                by_snr[str(s)] = {
                    "nmse_db": float(10 * np.log10(mean_nmse + 1e-12)),
                    "ber": float(ber_approximation(s, vals[m]).mean()),
                }
            results[method] = by_snr
        return results

    def save_results(self, results: Dict, name: str = "evaluation_results.json") -> Path:
        if self.results_dir is None:
            raise ValueError("ModelEvaluator was given no results_dir to write to")
        path = self.results_dir / name
        path.write_text(json.dumps(results, indent=2, default=float))
        return path
