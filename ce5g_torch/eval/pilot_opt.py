"""Pilot-density study: estimator NMSE (and, with the trained models,
measured BER) over a density × SNR grid, and the density to recommend.

Port of ``ce5g_tpu.eval.pilot_opt`` (reference
run_phase8_pilot_optimization.py:40-303): one batched call per (estimator,
density, SNR) cell, as the JAX package jits one per cell.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ExperimentConfig
from ..device import resolve_device
from ..estimators.api import estimate_batch
from ..physics.profiles import PROFILE_INDEX
from ..physics.simulate import (
    FrameDraws,
    FrameParams,
    draw_frames,
    frame_params,
    simulate_batch,
    table_for,
)
from .ber import QAMDraws, bit_errors, draw_qam_frames, simulate_qam_batch


def _db(x: float) -> float:
    return float(10 * np.log10(x + 1e-12))


def _recommend(avg: Dict[str, float]) -> float:
    """The smallest density whose average NMSE is within 1 dB of the best
    density's (pilot overhead against quality; pilot_opt.py:73-82)."""
    best = min(avg.values())
    return min(float(d) for d, v in avg.items() if v <= best + 1.0)


class PilotOptimizer:
    def __init__(self, cfg: ExperimentConfig, results_dir: Optional[str] = None, device="cuda"):
        """The study on ``device``. Cell i of a sweep (counted over
        estimators, then densities, then SNRs in :meth:`sweep`, over
        densities then SNRs in :meth:`model_sweep`, as the JAX package
        counts its keys) draws its frames with a ``torch.Generator``
        seeded ``seed + i``, where the JAX package keys it ``key(seed +
        i)``: the numbers differ, their laws do not (:meth:`draws` and
        :meth:`qam_draws`). Only the ``results_dir`` given here is
        created and written (:meth:`save`)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.table = table_for(cfg)
        self.results_dir = None if results_dir is None else Path(results_dir)
        if self.results_dir is not None:
            self.results_dir.mkdir(parents=True, exist_ok=True)

    def _generator(self, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(index)

    def draws(self, index: int, params: FrameParams) -> FrameDraws:
        """The draws of cell ``index`` (its seed) of :meth:`sweep`."""
        return draw_frames(self._generator(index), params, self.cfg, device=self.device)

    def qam_draws(self, index: int, params: FrameParams, modulation: int) -> QAMDraws:
        """The draws of cell ``index`` (its seed) of :meth:`model_sweep`."""
        return draw_qam_frames(self._generator(index), params, self.cfg, modulation, self.device)

    def _cell_sums(self, index: int, params: FrameParams, estimator: str):
        """Per-frame mean |H − Ĥ|² and mean |H|² of cell ``index``."""
        cfg = self.cfg
        frames = simulate_batch(self.draws(index, params), params, cfg=cfg, table=self.table,
                                device=self.device)
        h = estimate_batch(frames, cfg=cfg, estimator=estimator, table=self.table,
                           device=self.device)
        err = ((frames.channel - h).abs() ** 2).flatten(1).mean(dim=1)
        pwr = (frames.channel.abs() ** 2).flatten(1).mean(dim=1)
        return err, pwr

    def sweep(
        self,
        densities: Sequence[float] = (0.05, 0.08, 0.10, 0.12, 0.15),
        snrs_db: Sequence[float] = (5.0, 10.0, 15.0, 20.0),
        estimators: Sequence[str] = ("ls", "mmse", "mmse_full"),
        channel_type: str = "EVA",
        doppler_hz: float = 50.0,
        frames_per_cell: int = 64,
        seed: int = 0,
        per_frame: bool = False,
    ) -> Dict:
        """Returns {estimator: {density: {snr: nmse_db}}} + recommendation.
        A cell's NMSE is a ratio of batch means (pilot_opt.py:43-45),
        Σ|H − Ĥ|² / Σ|H|². With ``per_frame`` the result also holds each
        cell's per-frame means under "per_frame": {estimator: {density:
        {snr: {"err": [...], "pwr": [...]}}}}, for the spread."""
        results: Dict[str, Dict] = {e: {} for e in estimators}
        spread: Dict[str, Dict] = {e: {} for e in estimators}
        profile_idx = PROFILE_INDEX[channel_type]
        i = 0
        for est in estimators:
            for d in densities:
                row = {}
                for s in snrs_db:
                    params = frame_params(frames_per_cell, profile_idx, doppler_hz, s, d,
                                          self.device)
                    err, pwr = self._cell_sums(seed + i, params, est)
                    row[str(s)] = _db(float(err.mean() / (pwr.mean() + 1e-12)))
                    if per_frame:
                        spread[est].setdefault(str(d), {})[str(s)] = {
                            "err": err.tolist(), "pwr": pwr.tolist()}
                    i += 1
                results[est][str(d)] = row

        rec = {}
        for est in estimators:
            avg = {d: float(np.mean(list(row.values()))) for d, row in results[est].items()}
            rec[est] = {"best_density": _recommend(avg), "avg_nmse_db": avg}
        out = {
            "results": results,
            "recommendation": rec,
            "config": {
                "densities": list(densities),
                "snrs_db": list(snrs_db),
                "channel_type": channel_type,
                "doppler_hz": doppler_hz,
                "frames_per_cell": frames_per_cell,
            },
        }
        if per_frame:
            out["per_frame"] = spread
        return out

    def model_sweep(
        self,
        model_types: Sequence[str],
        model_dir: str,
        stats: Dict[str, float],
        densities: Sequence[float] = (0.01, 0.02, 0.05, 0.08, 0.10),
        snrs_db: Sequence[float] = (5.0, 10.0, 15.0, 20.0),
        estimators: Sequence[str] = ("ls", "mmse_full"),
        channel_type: str = "EVA",
        doppler_hz: float = 50.0,
        frames_per_cell: int = 64,
        modulation: int = 4,
        seed: int = 0,
        per_frame: bool = False,
    ) -> Dict:
        """The study WITH the trained models (reference
        run_phase8_pilot_optimization.py:113-160; pilot_opt.py:95-292).

        Per (density, SNR) cell: QAM frames, then for every method —
        classical estimators and trained models —
          * NMSE on the (rx0, tx0) slice, the models' basis, per sample
            then averaged (a mean of ratios; classical estimates are
            sliced the same way), and
          * measured BER on the rx-0 chain after per-RE scalar Wiener
            equalisation against the TX-superposition channel (σ² from
            rx 0 alone); a model's superposition estimate is T times its
            slice prediction.

        ``stats`` are the TRAINING split's normalisers: the models must
        see the feature scaling they were trained with. A model whose
        checkpoint is missing from ``model_dir`` is left out. With
        ``per_frame`` each cell also holds its "per_sample_nmse" list.
        """
        from ..models.inputs import apply_output_residual
        from .evaluate import ModelEvaluator

        cfg, dev, table = self.cfg, self.device, self.table
        num_tx = cfg.mimo.num_tx
        profile_idx = PROFILE_INDEX[channel_type]

        ev = ModelEvaluator(cfg, model_dir, device=dev)
        models = {}
        for mt in model_types:
            try:
                models[mt], _ = ev.load_model(mt)
            except FileNotFoundError:
                continue
            models[mt].eval()

        def slice_cell(h_slice, h_true_slice, h_sum0, frames, bits) -> Dict:
            err = ((h_true_slice - h_slice).abs() ** 2).mean(dim=(1, 2))
            pwr = (h_true_slice.abs() ** 2).mean(dim=(1, 2))
            per_sample = err / (pwr + 1e-12)
            cell = {"nmse_db_slice": _db(float(per_sample.mean())),
                    "ber": ber_rx0(h_sum0, frames, bits)}
            if per_frame:
                cell["per_sample_nmse"] = per_sample.tolist()
            return cell

        def ber_rx0(h_sum0, frames, bits) -> float:
            """Batch BER on rx chain 0 (pilot_opt.py:174-195): the errors of
            every frame over the data bits of every frame."""
            errors, counted = bit_errors(h_sum0[:, :, None, :], frames.rx_symbols[:, :, :1, :],
                                         frames.pilot_mask, frames.params.snr_db, bits,
                                         modulation)
            return float(errors.sum() / torch.clamp(counted.sum(), min=1.0))

        def model_pred(mt, frames, h_ls, hw):
            rx0 = frames.rx_symbols[:, :, 0, :]
            hls0 = h_ls[:, :, 0, 0, :]
            chans = [
                rx0.real / stats["rx_std"], rx0.imag / stats["rx_std"],
                hls0.real / stats["hls_std"], hls0.imag / stats["hls_std"],
                frames.pilot_mask,
            ]
            if "_wiener" in mt:
                chans += [hw.real / stats["h_std"], hw.imag / stats["h_std"]]
            x = torch.stack(chans, dim=-1).to(torch.float32)
            with torch.inference_mode():
                pred = apply_output_residual(models[mt](x), x) * stats["h_std"]
            return torch.complex(pred[..., 0], pred[..., 1])  # (B, S, K)

        out: Dict[str, Dict] = {}
        i = 0
        for d in densities:
            for s in snrs_db:
                params = frame_params(frames_per_cell, profile_idx, doppler_hz, s, d, dev)
                # The JAX package simulates the cell once per estimator from
                # the same keys, so every estimator sees the same frames; here
                # the cell is simulated once and its frames reused.
                frames, bits = simulate_qam_batch(self.qam_draws(seed + i, params, modulation),
                                                  params, cfg=cfg, table=table,
                                                  modulation=modulation, device=dev)
                i += 1
                h_true0 = frames.channel[:, :, 0, 0, :]
                h_ls = estimate_batch(frames, cfg=cfg, estimator="ls", table=table, device=dev)
                cells, hw = {}, None
                for est in estimators:
                    h_est = h_ls if est == "ls" else estimate_batch(
                        frames, cfg=cfg, estimator=est, table=table, device=dev)
                    cells[est] = slice_cell(h_est[:, :, 0, 0, :], h_true0,
                                            h_est[:, :, 0, :, :].sum(dim=2), frames, bits)
                    if est == "mmse_full":
                        hw = h_est[:, :, 0, 0, :]
                if hw is None and any("_wiener" in m for m in models):
                    hw = estimate_batch(frames, cfg=cfg, estimator="mmse_full", table=table,
                                        device=dev)[:, :, 0, 0, :]
                for mt in models:
                    pred = model_pred(mt, frames, h_ls, hw)
                    # superposition estimate = T · slice prediction
                    cells[mt] = slice_cell(pred, h_true0, num_tx * pred, frames, bits)
                for name, vals in cells.items():
                    out.setdefault(name, {}).setdefault(str(d), {})[str(s)] = vals

        rec = {}
        for name, dd in out.items():
            avg = {
                d: float(np.mean([v["nmse_db_slice"] for v in row.values()]))
                for d, row in dd.items()
            }
            rec[name] = {"best_density": _recommend(avg), "avg_nmse_db_slice": avg}
        return {
            "results": out,
            "recommendation": rec,
            "basis": "slice (rx0, tx0) — the models' native basis; classical "
            "estimates sliced identically. BER measured on the rx-0 chain, "
            "QPSK, per-RE scalar Wiener equalization vs the superposition "
            "channel (see results/PLATEAU_DIAGNOSIS.md for why quirk-mode "
            "BER floors).",
            "config": {
                "densities": list(densities),
                "snrs_db": list(snrs_db),
                "channel_type": channel_type,
                "doppler_hz": doppler_hz,
                "frames_per_cell": frames_per_cell,
                "modulation": modulation,
                "models": list(models),
            },
        }

    def save(self, sweep_result: Dict, name: str = "pilot_optimization_results.json") -> Path:
        if self.results_dir is None:
            raise ValueError("PilotOptimizer was given no results_dir to write to")
        p = self.results_dir / name
        p.write_text(json.dumps(sweep_result, indent=2))
        return p
