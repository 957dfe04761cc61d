#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ce5g_torch) on one NVIDIA card.

    python3 path/to/chip_smoke.py      (from any directory)

Phases, one line each; any failure exits non-zero:
  1. setup: the card's name and power limit; build the three CUDA kernels;
  2. the HPD-solve kernel against its plain PyTorch version, on random
     systems and on the hard cases of ce5g_torch.ops.hard_cases;
  3. the grid-interpolation kernel against its plain PyTorch version, at
     256 frames and on the hard cases of ce5g_torch.ops.hard_cases;
  4. the slot-interpolation kernel against its plain PyTorch version,
     likewise;
  5. the main path — draw_frames → simulate_batch → estimate_batch for
     'ls', 'mmse' and 'mmse_full' (linear) and 'ls' with 'cubic' at the
     bench config (4×4 ETU, 200 Hz, 10 dB, 10% pilots, 256 frames) — with
     NMSE, launch counts, and a check against the same path run on the
     CPU on a small batch (which also covers 'mmse' with 'cubic'); the
     card's and the CPU's mmse_full are each held to the float64 plain
     path on their own frames, for three seeds;
  6. the Phase-2 parity path — ce5g_torch.eval.parity.Phase2Parity at 256
     frames per cell, its comparison and interpolation tables held to the
     JAX package's results and orderings, launch counts, and the
     scipy.griddata cross-check;
  7. each kernel held against its plain version again on the inputs each
     path gave it, then times at those inputs. A kernel's ``ms`` is device
     time that the host cannot stretch: 20 calls of its wrapper captured
     in one CUDA graph, the replay bracketed by two CUDA events, the median
     of 5 replays with the least and the largest. ``call_ms`` is the same
     20 calls made back to back from Python (the larger of device time and
     the wrapper's host time a call); the plain version and the library
     yardstick, which cannot all be captured, are timed that way too. The
     empty-launch floor is ``ms`` of the smallest launch (hpd_solve at
     B = n = R = 1): what "0" is for this method. Then each kernel against
     the recorded times of the body it replaced (HPD at four shapes by
     ``ms``; the interpolation kernels at 1% and 20% pilots by back-to-back
     calls, as their recorded times were taken), and pipeline frames/s;
  8. where a batch goes: a torch.profiler trace of three warm batches of
     the pipeline for 'mmse_full', 'ls' and 'ls:cubic' — the ten device
     operations with the most time, the device's idle share of the window
     and the launches per batch;
  9. the serving path at full width — the 1×2 SIMO config
     (configs/simo_identifiable.yaml), a 2000-frame test split made by the
     dataset factory (DatasetGenerator, .ce5g chunks of 512, as
     data_simo/test_manifest.json) with its mmse_full Wiener sidecar
     (compute_wiener_sidecar), opened as ChannelDataset(manifest,
     wiener=True); evaluate_baselines, evaluate_estimators ('ls', 'mmse',
     'mmse_full'), and ModelEvaluator.evaluate_model for the models_simo
     checkpoints of cnn, resnet, hybrid, transformer and cnn_wiener (lstm
     on 64 frames) — each anchored mean NMSE with its σ held to the JAX
     package's results, the orderings, launch counts, each kernel the path
     launched held against its plain version on the inputs the path gave
     it, every model's forward on the card against the CPU, and latency
     per sample;
 10. where a serving batch goes: a torch.profiler trace of three warm
     evaluate_model batches of 'cnn' and of 'cnn_wiener';
 11. blind serving on phase 9's split: its blind Wiener sidecar ('bwiener',
     compute_wiener_sidecar with mmse_full_est on the frames rebuilt from
     the stored arrays), evaluate_estimators('mmse_full_est') and the
     models_simo cnn_wiener_blind and cnn_wiener_blind_online served from
     ChannelDataset(manifest, wiener='bwiener'), each held to the JAX
     package's result, the ordering mmse_full < cnn_wiener_blind* <
     mmse_full_est, the blind priors against the split's true parameters,
     hpd_solve at n = 75 against its plain version and timed, and the
     blind fit timed at 64 frames;
 12. training: 10 000 + 1000-frame SIMO train and val splits made by the
     dataset factory on the card, the cnn trained 3 epochs with the JAX
     run's settings from a device-resident split, its validation losses
     held to models_simo/cnn_history.json, ms a step in bf16 and float32, a
     torch.profiler trace of three warm steps, and the _best checkpoint
     served on phase 9's split;
 13. the dataset factory at scale, on the physics of
     configs/experiment_config.yaml (2×2): (a) a 131 072-frame digest run
     in chunks of 2048 (the size of data_atscale/atscale_digest_manifest.json),
     no host synchronisation in the chunk program, chunk 32 regenerated
     and compared exactly, and chunk 32 materialized by a writer of 64 and
     held to its digest; (b) an 8192-frame split in chunks of 2048 by one
     writer, a deleted chunk regenerated and two writers with the global
     manifest, bitwise equal, verify_dataset on each; (c) online_train of
     the cnn at batch 512, float32 and bf16 for 32 steps and the blind
     7-channel layout (mmse_full_est) for 8, samples/s and losses, and a
     torch.profiler trace of three warm online steps; (d) the codec that
     wrote and its MB/s on a 256-frame chunk; (e) each kernel that phase 13
     launched held against its plain version on the inputs it gave it;
 14. the evaluation path at full width, each part held to the JAX package's
     study files: (a) PilotOptimizer.sweep at the study's settings (2x2 EVA
     50 Hz, 5-15% pilots, 5-20 dB, 64 frames a cell; 'ls', 'mmse',
     'mmse_full') against results/pilot_optimization_results.json, mmse_full
     on the 2-TX floor and the ordering; (b) model_sweep with models/cnn_best
     and models/cnn_wiener_best (1-10% pilots, QPSK) against its
     "model_sweep", the models >= 3 dB below ls and mmse_full's measured BER
     below ls's; (c) ber_sweep on the SIMO config ('ls', 'mmse_full',
     'mmse_full_est'; 0-30 dB) against its "ber_identifiable"; (d)
     HyperparameterTuner.random_search, the first 3 of
     results_simo/random_search_results.json's 20 trials on quick datasets
     of phase 12's splits; (e) comb and block pilots on the main path at the
     bench config, each against the CPU on 8 frames; each kernel the phase
     launched held against its plain version on the inputs (a)-(d) and (e)
     gave it; and the evaluation and final reports written.
Each phase prints its wall time. Then the wall time, one JSON line of
per-kernel numbers, and last the device line.

Imports neither JAX nor ce5g_tpu. Needs a CUDA card: without one it exits
non-zero and prints no result.
"""
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BATCH = 256
NMSE_ANCHOR_DB = -1.25  # 4-TX superposition floor (T−1)/T of mmse_full
NMSE_SLACK_DB = 0.15
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
PARITY_FRAMES = 256
# Times of the kernel bodies that the present interpolation kernels replaced,
# on an NVIDIA H100 80GB HBM3 at 700 W, at the inputs of slower_than_replaced()
# (one block per frame, one thread per output point; median of 5 rounds of 20
# back-to-back calls, the least of four runs). The present kernels, timed
# the same way, must not be slower.
REPLACED_GRID_MS_AT_1PCT = 0.4667
REPLACED_SLOT_MS_AT_20PCT = 0.5292
# Times of the HPD-solve body that the present kernel replaced (one block of
# 256 threads a system, Cholesky and two substitutions in shared memory, six
# barriers a column), on an NVIDIA H100 80GB HBM3 at 700 W, timed as ``ms``
# is here (20 launches in a CUDA graph, median of 5 replays; the least of
# four runs) at (systems, n, right-hand sides). The present kernel must not
# be slower.
REPLACED_HPD_MS = {(256, 45, 4): 0.0728, (256, 45, 2): 0.0722, (64, 72, 4): 0.1417,
                   (16, 126, 4): 0.4008}
# Quality anchors of the parity path: the JAX package's own study at 256
# frames per cell (results/parity_phase2.json), mean NMSE dB and the band
# the port's average must fall in. The draws differ (torch.Generator vs
# threefry): the JAX per-SNR LS column alone scatters by σ ≈ 0.26 dB per
# 256-frame cell, so each band is ≥ 4σ of a 5- or 12-cell mean.
PARITY_ANCHORS_DB = {
    ("comparison", "ls:cubic"): (0.09, 0.75),
    ("comparison", "mmse:linear"): (-0.31, 0.75),
    ("comparison", "mmse_full:linear"): (-3.05, 0.3),
    ("interpolation", "nearest"): (0.46, 0.75),
    ("interpolation", "linear"): (0.21, 0.75),
    ("interpolation", "cubic"): (-0.00, 0.75),
}
# Phase 5: mmse_full of the card and of the CPU, each held to the float64
# plain path on its own frames (8 frames of the bench config per seed), max
# error over the rms. Each bound is 1.5 times the largest of these three
# seeds' errors on an H100 (card 8.72e-4, CPU 7.90e-4; PERF.md §6).
MMSE_FULL_SEEDS = (3, 4, 5)
MMSE_FULL_BOUND = {"card": 1.3e-3, "cpu": 1.2e-3}
# Phase 9, the serving path: the 1x2 SIMO split at the JAX package's test size.
SERVING_FRAMES = 2000
MODEL_BATCH = 32  # evaluate_model's default, as the anchors were taken
LSTM_FRAMES = 64  # the pure LSTM has no anchor: its SIMO run stopped at epoch 5
SERVING_MODELS = ("cnn", "resnet", "hybrid", "transformer", "cnn_wiener")
# The JAX package's mean NMSE dB on its own 2000-frame SIMO test split
# (results_simo/*_test_results.json; mmse from results_simo/ORTHOGONAL_STUDY.md).
# mmse_full is the JAX package's estimator on that split in float32 on the
# CPU (tests/test_torch_anchors.py): the study's −16.26 was taken on a TPU,
# whose matmul precision lifts mmse_full at 20-30 dB SNR (−20.44 dB at 30 dB,
# against −33.35 in float32). The port draws its own split from the same
# laws, so each mean must land within SERVING_BAND_DB, or within 4σ of the
# port's mean where that is wider.
SERVING_ANCHORS_DB = {"cnn": -9.64, "resnet": -10.94, "hybrid": -9.22, "transformer": -12.47,
                      "cnn_wiener": -16.06, "mmse_full": -16.49, "mmse": -6.56}
SERVING_BAND_DB = 0.5
MODEL_CHECK_TOL = 1e-4  # card vs CPU forward, max |diff| over the output rms
# Phase 11, blind serving: the JAX package's mean NMSE dB on its SIMO test
# split (results_simo/cnn_wiener_blind*_test_results.json; mmse_full_est, as
# mmse_full above, in float32 on the CPU, tests/test_torch_anchors.py: the
# TPU's −13.16 reads −23.78 dB at 30 dB SNR against −29.23), held as phase
# 9's anchors are.
BLIND_ANCHORS_DB = {"mmse_full_est": -13.20, "cnn_wiener_blind": -14.12,
                    "cnn_wiener_blind_online": -14.31}
BLIND_BATCH = 64  # the JAX package's sidecar batch (data/wiener.py)
# Phase 12, training: the JAX package's SIMO cnn run (models_simo/
# cnn_history.json), validation loss of epochs 1-3. Epochs 2 and 3 must each
# lie within TRAIN_BAND of the JAX mean of those two epochs; the port draws
# its own split from the same laws.
JAX_CNN_VAL_LOSS = (0.5683314800262451, 0.3038650453090668, 0.31445953249931335)
TRAIN_BAND = 0.25
TRAIN_FRAMES, VAL_FRAMES = 10000, 1000
TRAIN_EPOCHS = 3
# configs/simo_identifiable.yaml as a literal (yaml is not promised on the
# card's machine); tests/test_torch_serving.py holds it equal to the file.
SIMO_CONFIG = {
    "ofdm": {"fft_size": 1024, "cp_length": 72, "num_symbols": 14,
             "useful_subcarriers": 600, "subcarrier_spacing": 15000},
    "mimo": {"num_tx_antennas": 1, "num_rx_antennas": 2},
    "channel": {"models": ["EPA", "EVA", "ETU"], "doppler_hz": [10, 50, 100, 200],
                "carrier_freq": 2.0e9, "max_delay_spread": 5.0e-6},
    "pilots": {"density": [0.01, 0.02, 0.05, 0.10], "pattern": "scattered",
               "interpolation": "linear"},
    "simulation": {"snr_range": [-5, 0, 5, 10, 15, 20, 25, 30], "num_frames": 1000,
                   "modulation": "QPSK"},
    "dataset": {"train_samples": 10000, "val_samples": 1000, "test_samples": 2000,
                "save_format": "ce5g", "normalize": True, "augmentation": False},
    "training": {"epochs": 100, "batch_size": 64},
}

# configs/experiment_config.yaml as a literal (phase 13's physics: 2×2, EPA/EVA/
# ETU, 10-200 Hz, −5…30 dB, 1-10% pilots, linear); tests/test_torch_factory.py
# holds it equal to the file.
EXPERIMENT_CONFIG = {
    "ofdm": {"fft_size": 1024, "cp_length": 72, "num_symbols": 14,
             "useful_subcarriers": 600, "subcarrier_spacing": 15000},
    "mimo": {"num_tx_antennas": 2, "num_rx_antennas": 2},
    "channel": {"models": ["EPA", "EVA", "ETU"], "doppler_hz": [10, 50, 100, 200],
                "carrier_freq": 2.0e9, "max_delay_spread": 5.0e-6},
    "pilots": {"density": [0.01, 0.02, 0.05, 0.10], "pattern": "scattered",
               "interpolation": "linear"},
    "simulation": {"snr_range": [-5, 0, 5, 10, 15, 20, 25, 30], "num_frames": 1000,
                   "modulation": "QPSK"},
    "dataset": {"train_samples": 50000, "val_samples": 5000, "test_samples": 10000,
                "save_format": "npz", "normalize": True, "augmentation": False},
    "model": {"type": "CNN",
              "cnn": {"hidden_channels": [64, 128, 256, 128, 64], "kernel_size": 3,
                      "dropout": 0.1},
              "lstm": {"hidden_size": 256, "num_layers": 3, "bidirectional": True,
                       "dropout": 0.2},
              "hybrid": {"cnn_channels": [32, 64, 128], "lstm_hidden": 256, "lstm_layers": 2}},
    "training": {"epochs": 100, "batch_size": 64, "learning_rate": 0.001, "optimizer": "adam",
                 "lr_scheduler": "cosine", "weight_decay": 1.0e-5, "gradient_clip": 1.0,
                 "loss": "mse", "loss_weights": {"channel_mse": 1.0, "ber_penalty": 0.0},
                 "early_stopping": {"enabled": True, "patience": 15, "min_delta": 1.0e-4},
                 "checkpoint": {"save_best": True, "save_freq": 5}},
    "compute": {"mixed_precision": True},
    "seed": 42,
}
# Phase 13, the dataset factory at scale. The digest run has the size of the
# JAX package's data_atscale/atscale_digest_manifest.json run; its chunk 32 is
# verified (as results/at_scale_generation.json's was). The online runs keep
# that study's model, batch and 2x2 frames, cut in depth from its 256 steps.
ATSCALE_FRAMES, ATSCALE_CHUNK, ATSCALE_VERIFY_CHUNK = 131072, 2048, 32
WRITERS_FRAMES = 8192
ONLINE_BATCH, ONLINE_STEPS, ONLINE_WINDOW = 512, 32, 16
BLIND_ONLINE_STEPS = 8
CODEC_FRAMES = 256
# The JAX package's tolerance for a materialized chunk against its digest
# (tests/test_atscale.py:62-64): relative, and absolute by the |x| sum.
DIGEST_RTOL, DIGEST_ATOL = 3e-5, 1e-4
# Phase 14, the evaluation path. Its anchors are the JAX package's study files,
# read at run time: results/pilot_optimization_results.json (the classical
# sweep, "model_sweep" and "ber_identifiable") and
# results_simo/random_search_results.json. A per-density average is held
# within EVAL_BAND_DB of the study's, or 4σ of the port's average where that
# is wider, as phase 9's means are.
PILOT_STUDY = os.path.join(REPO, "results", "pilot_optimization_results.json")
TUNING_STUDY = os.path.join(REPO, "results_simo", "random_search_results.json")
EVAL_BAND_DB = 0.5
STUDY_FRAMES = 64  # frames a cell, as the JAX study ran
FLOOR_2TX_DB, FLOOR_SLACK_DB = -3.01, 0.3  # mmse_full at 2 TX: (T−1)/T
MODEL_MARGIN_DB = 3.0  # cnn and cnn_wiener below ls at every density
# The models' normalisers come from a factory split of EXPERIMENT_CONFIG:
# the data/ split whose stats normalised the JAX study is not committed.
STATS_FRAMES = 1024
BER_SNRS = (0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
BER_FRAMES, BER_DENSITY, BER_BAND = 32, 0.05, 0.25
BER_HELD_TO_DB = 15.0  # above it the TPU may have lifted the Wiener anchors
# The tuner: the JAX default of 5 epochs a trial on 2000 / 500-frame quick
# datasets of phase 12's splits, cut in depth from 20 trials to the first 3.
TUNE_TRIALS, TUNE_EPOCHS, TUNE_TRAIN, TUNE_VAL, TUNE_BAND = 3, 5, 2000, 500, 0.30
# Comb and block pilots on the main path: (pattern, density).
REGULAR_CASES = (("comb", 0.10), ("block", 0.01), ("block", 0.10), ("block", 0.15))


def quiet(*_):
    pass


def fail_unless(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _event_ms(run, rounds, iters, warmup):
    """(median, least, largest) of ``rounds`` timings of ``run()``, each
    between two CUDA events and divided by ``iters``."""
    import torch

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times), max(times)


def cuda_ms(fn, rounds=5, iters=20):
    """Time of ``fn()`` called back to back: (median, least, largest) over
    ``rounds`` rounds, each the mean of ``iters`` calls. The larger of the
    device time and the host time a call."""
    def run():
        for _ in range(iters):
            fn()
    return _event_ms(run, rounds, iters, warmup=1)


def graph_ms(fn, rounds=5, iters=20):
    """Device time of ``fn()`` that the host cannot stretch: ``iters``
    calls captured in one CUDA graph, (median, least, largest) of
    ``rounds`` replays over ``iters``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _event_ms(graph.replay, rounds, iters, warmup=2)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hpd_problem(gen, dev, b, n, r, cond=100.0):
    import torch

    def cn(*shape):
        re = torch.randn(*shape, generator=gen, device=dev)
        im = torch.randn(*shape, generator=gen, device=dev)
        return torch.complex(re, im)

    x = cn(b, n, n)
    eye = torch.eye(n, dtype=torch.complex64, device=dev)
    gram = x @ x.mH + (n / cond) * eye
    return gram, cn(b, n, r)


def rel(a, b):
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_hpd(dev):
    import torch
    from ce5g_torch.ops import hard_cases
    from ce5g_torch.ops import hpd_solve as hpd_mod

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for b, n, r in [(256, 45, 4), (37, 12, 3), (64, 72, 4), (16, 126, 4)]:
        gram, rhs = hpd_problem(gen, dev, b, n, r)
        x = hpd_mod.hpd_solve(gram, rhs)
        err = rel(x, hpd_mod.hpd_solve_plain(gram, rhs))
        fail_unless(err < 1e-4, f"hpd_solve {b}x{n}x{r} relative error {err:.2e} < 1e-4")
        worst = max(worst, err)
    gram, rhs = hpd_problem(gen, dev, 64, 45, 4, cond=1e4)
    x = hpd_mod.hpd_solve(gram, rhs)
    resid = rel(gram @ x, rhs)
    fail_unless(resid < 1e-3, f"hpd_solve residual {resid:.2e} < 1e-3 at cond 1e4")
    gram[5] = -torch.eye(45, dtype=gram.dtype, device=dev)
    x = hpd_mod.hpd_solve(gram, rhs)
    fail_unless(bool(torch.isnan(x[5]).all()), "non-PD system gives NaN")
    fail_unless(bool(torch.isfinite(torch.cat([x[:5], x[6:]])).all()), "PD systems finite")
    print(f"hpd_solve vs plain: worst relative error {worst:.3e}, residual {resid:.3e} "
          f"at cond 1e4, non-PD -> NaN: ok")
    worst = 0.0
    for case in hard_cases.HPD_CASES:
        gram, rhs, bad = hard_cases.hpd_case(case)
        gram, rhs = gram.to(dev), rhs.to(dev)
        is_bad = torch.zeros(gram.shape[0], dtype=torch.bool, device=dev)
        is_bad[list(bad)] = True
        ref = hpd_mod.hpd_solve_plain(gram, rhs)
        fail_unless(bool(torch.isnan(ref[is_bad]).all()), f"plain version NaN on hard case {case}")
        x = hpd_mod.hpd_solve(gram, rhs)
        where = f"hpd_solve on hard case {case}"
        fail_unless(bool(torch.isnan(x[is_bad]).all()), f"{where}: non-PD systems NaN")
        fail_unless(bool(torch.isfinite(x[~is_bad]).all()), f"{where}: PD systems finite")
        err = rel(x[~is_bad], ref[~is_bad])
        fail_unless(err < 1e-4, f"{where}: relative error {err:.2e} < 1e-4")
        worst = max(worst, err)
    print(f"hpd_solve vs plain on the hard cases ({', '.join(hard_cases.HPD_CASES)}): "
          f"worst relative error {worst:.3e}, NaN pattern equal")


def random_masks(gen, dev, b, s, k, density):
    import torch
    from ce5g_torch.physics.pilots import scattered_pattern

    u = torch.rand(b, s * k, generator=gen, device=dev)
    return scattered_pattern(u, s, k, density).mask


def check_interp(dev, b):
    import torch
    from ce5g_torch.ops import hard_cases
    from ce5g_torch.ops import interp_fused as interp_mod

    gen = torch.Generator(device=dev).manual_seed(2)
    r, s, k = 4, 14, 599
    worst = 0.0
    for density in (0.10, 0.01):
        mask = random_masks(gen, dev, b, s, k, density)
        v = torch.complex(torch.randn(b, r, s, k, generator=gen, device=dev),
                          torch.randn(b, r, s, k, generator=gen, device=dev))
        v = v * mask[:, None]
        scale = float(v.abs().max())
        for method in ("nearest", "linear"):
            out = interp_mod.interpolate_grid_fused(v, mask, method)
            err = float((out - interp_mod.interpolate_grid_plain(v, mask, method)).abs().max())
            fail_unless(err <= 1e-5 * scale,
                        f"interp {method} at {density:.0%}: max abs error {err:.2e} "
                        f"<= 1e-5 x value scale {scale:.2f}")
            worst = max(worst, err / scale)
    zero = torch.zeros(b, s, k, device=dev)
    for method in ("nearest", "linear"):
        out = interp_mod.interpolate_grid_fused(torch.zeros_like(v), zero, method)
        fail_unless(bool((out == 0).all()), f"empty mask gives zeros ({method})")
    print(f"interp_fused vs plain: {b} frames x ({r}, {s}, {k}) at 10% and 1%, "
          f"nearest+linear, worst max abs error {worst:.3e} of value scale; "
          f"empty mask -> 0: ok")
    worst = 0.0
    for case in hard_cases.GRID_CASES:
        for rr in (4, 3):  # 3 takes the body with R at run time
            v, mask = (x.to(dev) for x in hard_cases.grid_case(case, rr))
            scale = float(v.abs().max())
            for method in ("nearest", "linear"):
                out = interp_mod.interpolate_grid_fused(v, mask, method)
                err = float((out - interp_mod.interpolate_grid_plain(v, mask, method))
                            .abs().max())
                fail_unless(err <= 1e-5 * scale,
                            f"interp {method} on hard case {case} (R = {rr}): max abs error "
                            f"{err:.2e} <= 1e-5 x value scale {scale:.2f}")
                worst = max(worst, err / scale)
    print(f"interp_fused vs plain on the hard cases ({', '.join(hard_cases.GRID_CASES)}; "
          f"R = 4 and 3, nearest+linear): worst max abs error {worst:.3e} of value scale")


def slot_inputs(gen, dev, b, r, s, k, density, max_density):
    """Scattered pilot slots of ``b`` frames and random complex values,
    zero at invalid slots."""
    import torch
    from ce5g_torch.physics.pilots import scattered_pattern

    pat = scattered_pattern(torch.rand(b, s * k, generator=gen, device=dev), s, k, density,
                            max_density)
    p = pat.positions.shape[1]
    v = torch.complex(torch.randn(b, r, p, generator=gen, device=dev),
                      torch.randn(b, r, p, generator=gen, device=dev))
    return v * pat.valid[:, None], pat.positions, pat.valid


def check_slot_interp(dev, b):
    import torch
    from ce5g_torch.ops import hard_cases
    from ce5g_torch.ops import interp as slot_mod

    gen = torch.Generator(device=dev).manual_seed(5)
    r, s, k = 4, 14, 599
    worst = 0.0
    cases = [(d, 0.25, (s, k), r) for d in (0.01, 0.10, 0.20)]
    cases += [(0.10, 0.15, (s, k), r), (0.10, 0.15, (6, 100), 1)]
    cases += [(0.10, 0.25, (s, k), rr) for rr in (2, 3)]
    for density, max_density, grid, rr in cases:
        v, pos, valid = slot_inputs(gen, dev, b, rr, *grid, density, max_density)
        valid[5] = 0.0  # a frame with no valid slot
        v[5] = 0.0
        scale = float(v.abs().max())
        for method in ("nearest", "linear", "cubic"):
            out = slot_mod.interpolate_slots(v, pos, valid, grid, method)
            err = float((out - slot_mod.interpolate_slots_plain(v, pos, valid, grid, method))
                        .abs().max())
            where = f"{method} at {density:.0%} (P = {pos.shape[1]}, grid {grid}, R = {rr})"
            fail_unless(err <= 1e-5 * scale,
                        f"slot interp {where}: max abs error {err:.2e} "
                        f"<= 1e-5 x value scale {scale:.2f}")
            fail_unless(bool((out[5] == 0).all()), f"slot interp {where}: empty frame -> 0")
            worst = max(worst, err / scale)
    print(f"interp (slot form) vs plain: {b} frames, R = {r} at 1%, 10%, 20% (P = 2096) and "
          f"10% (P = 1257), R = 1 on a (6, 100) grid (P = 90), R = 2 and 3 at 10% (P = 2096); "
          f"nearest+linear+cubic, worst max abs error {worst:.3e} of value scale; empty frame -> 0: ok")
    worst = 0.0
    for case in hard_cases.SLOT_CASES:
        for rr in (1, 2, 3, 4):
            c = hard_cases.slot_case(case, rr)
            v, pos, valid = (c[key].to(dev) for key in ("values", "positions", "valid"))
            scale = float(v.abs().max())
            for method in ("nearest", "linear", "cubic"):
                out = slot_mod.interpolate_slots(v, pos, valid, c["grid"], method)
                err = float((out - slot_mod.interpolate_slots_plain(v, pos, valid, c["grid"],
                                                                    method)).abs().max())
                fail_unless(err <= 1e-5 * scale,
                            f"slot interp {method} on hard case {case} (R = {rr}): max abs "
                            f"error {err:.2e} <= 1e-5 x value scale {scale:.2f}")
                fail_unless(bool((out[valid.sum(-1) == 0] == 0).all()),
                            f"slot interp {method} on hard case {case}: empty frame -> 0")
                worst = max(worst, err / scale)
    print(f"interp (slot form) vs plain on the hard cases ({', '.join(hard_cases.SLOT_CASES)}; "
          f"R = 1-4, nearest+linear+cubic): worst max abs error {worst:.3e} of value scale")


def bench_setup(dev, b):
    import torch
    from ce5g_torch import ExperimentConfig, MIMOConfig
    from ce5g_torch.physics import PROFILE_INDEX, FrameParams

    cfg = ExperimentConfig(mimo=MIMOConfig(num_tx=4, num_rx=4))
    params = FrameParams(
        torch.full((b,), PROFILE_INDEX["ETU"], dtype=torch.int32, device=dev),
        torch.full((b,), 200.0, device=dev),
        torch.full((b,), 10.0, device=dev),
        torch.full((b,), 0.1, device=dev),
    )
    return cfg, params


MAIN_PAIRS = (("ls", "linear"), ("mmse", "linear"), ("mmse_full", "linear"), ("ls", "cubic"))


def run_path(dev, cfg, params, draws, pairs=MAIN_PAIRS):
    """simulate → estimate with each (estimator, method) →
    {name: (estimate, NMSE dB)}, named by the estimator alone for 'linear'."""
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.physics import simulate_batch
    from ce5g_torch.utils import nmse_db

    frames = simulate_batch(draws, params, cfg=cfg, device=dev)
    out = {}
    for est, method in pairs:
        h = estimate_batch(frames, cfg=cfg, estimator=est, method=method, device=dev)
        name = est if method == "linear" else f"{est}:{method}"
        out[name] = (h, float(nmse_db(frames.channel, h)))
    return frames, out


class capturing:
    """Within the block, the kernel wrappers as the estimators call them
    record the first arguments each is called with (in ``self.args``,
    by kernel name)."""

    def __init__(self):
        import ce5g_torch.estimators.interpolate as interp_est
        import ce5g_torch.estimators.mmse as mmse_est

        self.sites = [(mmse_est, "hpd_solve", "hpd_solve"),
                      (interp_est, "interpolate_grid_fused", "interp_fused"),
                      (interp_est, "interpolate_slots", "interp")]
        self.args = {}

    def __enter__(self):
        self.real = [getattr(mod, attr) for mod, attr, _ in self.sites]
        for (mod, attr, name), fn in zip(self.sites, self.real):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def wrapped(*args):
            self.args.setdefault(name, args)
            return fn(*args)
        return wrapped

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.sites, self.real):
            setattr(mod, attr, fn)


def reset_launches():
    from ce5g_torch.ops import hpd_solve, interp, interp_fused

    hpd_solve.launches = interp_fused.launches = interp.launches = 0


def read_launches():
    from ce5g_torch.ops import hpd_solve, interp, interp_fused

    return {"hpd_solve": hpd_solve.launches, "interp_fused": interp_fused.launches,
            "interp": interp.launches}


def main_path(dev, b):
    """The bench-config main path with the launch counters read around it.
    Returns the counts and the kernels' main-path inputs."""
    import torch
    from ce5g_torch.physics import draw_frames

    cfg, params = bench_setup(dev, b)
    with capturing() as cap:
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_launches()
        draws = draw_frames(gen, params, cfg, device=dev)
        frames, out = run_path(dev, cfg, params, draws)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = read_launches()

    for est, (h, db) in out.items():
        fail_unless(tuple(h.shape) == tuple(frames.channel.shape), f"{est} estimate shape")
        fail_unless(bool(torch.isfinite(h).all()), f"{est} estimate finite")
    full_db = out["mmse_full"][1]
    fail_unless(abs(full_db - NMSE_ANCHOR_DB) <= NMSE_SLACK_DB,
                f"mmse_full NMSE {full_db:.3f} dB within {NMSE_SLACK_DB} dB of "
                f"{NMSE_ANCHOR_DB} dB")
    print("main path (4x4 ETU 200 Hz 10 dB 10% pilots, {} frames): NMSE dB ".format(b)
          + ", ".join(f"{est} {db:.4f}" for est, (_, db) in out.items()))
    return cfg, params, launches, cap.args


def mmse_full_float64(cfg, frames):
    """The port's plain mmse_full path on the CPU in float64, on ``frames``
    (moved to the CPU and widened): the per-frame branch of
    ``estimators.mmse.mmse_full_estimate`` with the main path's time rank."""
    import torch
    from ce5g_torch.estimators.api import auto_time_rank
    from ce5g_torch.estimators.mmse import mmse_full_estimate
    from ce5g_torch.physics.simulate import table_for, table_tensors

    cpu = torch.device("cpu")
    amp, f = table_tensors(table_for(cfg), cfg, cpu)
    pidx = frames.params.profile_idx.cpu().long()

    def wide(x):
        return x.cpu().to(torch.complex128)

    return mmse_full_estimate(
        wide(frames.rx_symbols), wide(frames.tx_symbols[:, :, 0, :]), frames.pilot_mask.cpu(),
        cfg.mimo.num_tx, frames.params.snr_db.cpu(), wide(f[pidx]), amp[pidx].double(),
        frames.params.doppler_hz.cpu(), cfg.ofdm.symbol_duration, time_rank=auto_time_rank(cfg))


def check_against_cpu(dev, b=8):
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions) with the same draws, on a small batch. Both
    float32 results of mmse_full are held instead to the float64 plain path
    on their own frames, for each of MMSE_FULL_SEEDS: card and CPU differ
    by two float32 roundings through the Woodbury cancellation, which a
    float32-against-float32 check cannot bound."""
    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams, draw_frames

    cfg, params = bench_setup(dev, b)
    cpu = torch.device("cpu")
    cpu_params = FrameParams(*(x.cpu() for x in params))
    parts, full = [], {"card": [], "cpu": []}
    for seed in MMSE_FULL_SEEDS:
        draws = draw_frames(torch.Generator(device=dev).manual_seed(seed), params, cfg, device=dev)
        pairs = ((MAIN_PAIRS + (("mmse", "cubic"),)) if seed == MMSE_FULL_SEEDS[0]
                 else (("mmse_full", "linear"),))
        card_frames, on_card = run_path(dev, cfg, params, draws, pairs)
        cpu_frames, on_cpu = run_path(cpu, cfg, cpu_params, FrameDraws(*(x.cpu() for x in draws)),
                                      pairs)
        for est in on_card:
            (h_card, db_card), (h_cpu, db_cpu) = on_card[est], on_cpu[est]
            fail_unless(abs(db_card - db_cpu) < 0.01,
                        f"{est} card vs CPU NMSE within 0.01 dB (seed {seed})")
            if est != "mmse_full":
                rms = float((h_cpu.abs() ** 2).mean().sqrt())
                err = float((h_card.cpu() - h_cpu).abs().max()) / rms
                fail_unless(err <= 1e-4, f"{est} card vs CPU max error {err:.2e} of rms <= 1e-4")
                parts.append(f"{est} {err:.2e}")
        for where, frames, h in (("card", card_frames, on_card["mmse_full"][0]),
                                 ("cpu", cpu_frames, on_cpu["mmse_full"][0])):
            ref = mmse_full_float64(cfg, frames)
            rms = float((ref.abs() ** 2).mean().sqrt())
            err = float((h.cpu().to(ref.dtype) - ref).abs().max()) / rms
            fail_unless(err <= MMSE_FULL_BOUND[where],
                        f"mmse_full on the {where} vs float64: max error {err:.2e} of rms <= "
                        f"{MMSE_FULL_BOUND[where]} (seed {seed})")
            full[where].append(err)
    print(f"card vs CPU on {b} frames, max error of rms: " + ", ".join(parts))
    print(f"mmse_full vs the float64 plain path on {b} frames, max error of rms for seeds "
          f"{', '.join(map(str, MMSE_FULL_SEEDS))}: card "
          + " ".join(f"{e:.3e}" for e in full["card"]) + f" (bound {MMSE_FULL_BOUND['card']}), "
          "CPU " + " ".join(f"{e:.3e}" for e in full["cpu"])
          + f" (bound {MMSE_FULL_BOUND['cpu']}); NMSE card vs CPU within 0.01 dB")


def parity_path(dev):
    """The Phase-2 parity study at PARITY_FRAMES frames per cell, with the
    launch counters read around it. Returns the counts, the first inputs
    of each kernel in the run (the slot kernel's is 'cubic': the study's
    first call is ls:cubic), and the study's wall time."""
    import torch
    from ce5g_torch.eval.parity import Phase2Parity, griddata_cross_check

    with capturing() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        study = Phase2Parity(frames=PARITY_FRAMES, device=dev)
        comp = study.comparison_table()
        interp = study.interpolation_table()
        torch.cuda.synchronize()
        launches = read_launches()
        wall_s = time.perf_counter() - t0

    print(f"parity path ({PARITY_FRAMES} frames/cell, 17 cells) in {wall_s:.2f} s; "
          "comparison NMSE dB per SNR: " + json.dumps(comp["per_snr"]))
    fail_unless(launches["interp"] >= 17, f"interp launched >= 17 times: {launches}")
    fail_unless(launches["interp_fused"] > 0 and launches["hpd_solve"] > 0,
                f"interp_fused and hpd_solve launched on the parity path: {launches}")
    tables = {"comparison": comp["avg_db"], "interpolation": interp["avg_db"]}
    for (table, name), (anchor, band) in PARITY_ANCHORS_DB.items():
        got = tables[table][name]
        print(f"  {table} {name}: {got:.4f} dB (JAX package {anchor:+.2f} ± {band})")
        fail_unless(abs(got - anchor) <= band,
                    f"{table} {name} {got:.3f} dB within {band} dB of {anchor} dB")
    avg = comp["avg_db"]
    fail_unless(avg["mmse_full:linear"] < avg["mmse:linear"] - 1.0,
                "mmse_full beats diagonal mmse by > 1 dB")
    ia = interp["avg_db"]
    fail_unless(ia["cubic"] < ia["linear"] < ia["nearest"],
                f"cubic < linear < nearest on the 12-cell averages: {ia}")
    print(f"  interpolation wins {json.dumps(interp['wins'])}; orderings: ok")
    cross = griddata_cross_check(study.cfg, frames=8, device=dev)
    delta = {m: r["delta_db"] for m, r in cross.items()}
    fail_unless(abs(delta["nearest"]) < 0.3 and abs(delta["linear"]) < 0.75
                and delta["cubic"] < 0.5, f"griddata cross-check deltas in bounds: {delta}")
    print("griddata cross-check (8 frames), delta dB: "
          + ", ".join(f"{m} {d:+.4f}" for m, d in delta.items()) + ": ok")
    fail_unless(cap.args["interp"][-1] == "cubic", "the parity path's first slot call is cubic")
    return launches, cap.args, wall_s


def hold_against_plain(path, captured):
    """Each kernel that ``path`` launched against its plain version on the
    inputs ``path`` gave it, at the tolerances of phases 2-4. Returns the
    max abs errors, by kernel name."""
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod

    errs, parts = {}, []
    if "hpd_solve" in captured:
        gram, rhs = captured["hpd_solve"]
        x, x_plain = hpd_mod.hpd_solve(gram, rhs), hpd_mod.hpd_solve_plain(gram, rhs)
        errs["hpd_solve"] = float((x - x_plain).abs().max())
        hpd_rel = rel(x, x_plain)
        parts.append(f"hpd_solve {tuple(gram.shape)} x {rhs.shape[-1]} relative error "
                     f"{hpd_rel:.3e} (max abs {errs['hpd_solve']:.3e})")
        fail_unless(hpd_rel < 1e-4, f"{path} hpd_solve relative error {hpd_rel:.2e} < 1e-4")
    if "interp_fused" in captured:
        vals, mask, method = captured["interp_fused"]
        errs["interp_fused"] = float((interp_mod.interpolate_grid_fused(vals, mask, method)
                                      - interp_mod.interpolate_grid_plain(vals, mask, method))
                                     .abs().max())
        fused_scale = float(vals.abs().max())
        density = mask.float().mean(dim=(-2, -1))
        parts.append(f"interp_fused {tuple(vals.shape)} {method} pilots "
                     f"{float(density.min()):.3f}-{float(density.max()):.3f} max abs "
                     f"{errs['interp_fused']:.3e} of scale {fused_scale:.3f}")
        fail_unless(errs["interp_fused"] <= 1e-5 * fused_scale,
                    f"{path} interp_fused max abs error <= 1e-5 x value scale")
    if "interp" in captured:
        slot_args = captured["interp"]
        errs["interp"] = float((slot_mod.interpolate_slots(*slot_args)
                                - slot_mod.interpolate_slots_plain(*slot_args)).abs().max())
        slot_scale = float(slot_args[0].abs().max())
        parts.append(f"interp {tuple(slot_args[0].shape)} P = {slot_args[1].shape[1]} "
                     f"{slot_args[-1]} max abs {errs['interp']:.3e} of scale {slot_scale:.3f}")
        fail_unless(errs["interp"] <= 1e-5 * slot_scale,
                    f"{path} interp max abs error <= 1e-5 x value scale")
    print(f"{path} inputs, kernel vs plain: " + "; ".join(parts))
    return errs


def kernel_row(name, source, replaces, launches, err, fn, plain, work, library=None):
    """One entry of the ``kernels`` line, every number measured here."""
    ms, ms_min, ms_max = graph_ms(fn)
    bound_ms, bound_by = bound(*work)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": ms, "ms_min": ms_min, "ms_max": ms_max, "call_ms": cuda_ms(fn)[0],
        "plain_ms": cuda_ms(plain)[0],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None if library is None else cuda_ms(library)[0],
    }


def slower_than_replaced(dev):
    """The HPD solve at four shapes, and the two interpolation kernels
    where their designs gain least: the grid form at 1% pilots (no source
    row can be pruned) and the slot form at 20% (the densest cell of the
    parity study), against the recorded times of the bodies they replaced,
    each timed as its record was."""
    import torch
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod

    from ce5g_torch.ops import hpd_solve as hpd_mod

    gen = torch.Generator(device=dev).manual_seed(6)
    parts = []
    for shape, replaced_ms in REPLACED_HPD_MS.items():
        gram, rhs = hpd_problem(gen, dev, *shape)
        ms = graph_ms(lambda: hpd_mod.hpd_solve(gram, rhs))
        parts.append(f"{shape} {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), replaced {replaced_ms}")
        fail_unless(ms[0] <= replaced_ms,
                    f"hpd_solve at {shape} no slower than the body it replaced")
    print("hpd_solve against the body it replaced: " + "; ".join(parts))
    b, r, s, k = BATCH, 4, 14, 599
    mask = (torch.rand(b, s, k, generator=gen, device=dev) < 0.01).float()
    v = torch.complex(torch.randn(b, r, s, k, generator=gen, device=dev),
                      torch.randn(b, r, s, k, generator=gen, device=dev)) * mask[:, None]
    grid_ms = cuda_ms(lambda: interp_mod.interpolate_grid_fused(v, mask, "linear"))
    sv, pos, valid = slot_inputs(gen, dev, b, 2, s, k, 0.20, 0.25)
    slot_ms = cuda_ms(lambda: slot_mod.interpolate_slots(sv, pos, valid, (s, k), "cubic"))
    print(f"back-to-back calls: interp_fused at 1% pilots {tuple(v.shape)} linear: {grid_ms[0]:.4f} ms "
          f"({grid_ms[1]:.4f}-{grid_ms[2]:.4f}), the body it replaced {REPLACED_GRID_MS_AT_1PCT} ms; "
          f"interp at 20% pilots {tuple(sv.shape)} cubic: {slot_ms[0]:.4f} ms "
          f"({slot_ms[1]:.4f}-{slot_ms[2]:.4f}), the body it replaced {REPLACED_SLOT_MS_AT_20PCT} ms")
    fail_unless(grid_ms[0] <= REPLACED_GRID_MS_AT_1PCT,
                "interp_fused at 1% pilots no slower than the body it replaced")
    fail_unless(slot_ms[0] <= REPLACED_SLOT_MS_AT_20PCT,
                "interp at 20% pilots no slower than the body it replaced")


def pipeline(dev, gen, cfg, params, estimator, method="linear"):
    """Fresh draws → simulate → estimate → NMSE dB (a host number, so the
    call ends synchronised)."""
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.physics import draw_frames, simulate_batch
    from ce5g_torch.utils import nmse_db

    draws = draw_frames(gen, params, cfg, device=dev)
    frames = simulate_batch(draws, params, cfg=cfg, device=dev)
    h = estimate_batch(frames, cfg=cfg, estimator=estimator, method=method, device=dev)
    return float(nmse_db(frames.channel, h))


PIPELINES = (("mmse_full", "linear"), ("ls", "linear"), ("ls", "cubic"))


def where_a_batch_goes(dev, gen, cfg, params, rates, batches=3):
    """A torch.profiler trace (device activity only: recording the host's
    operators as well slows the host, which is what the card waits for) of
    ``batches`` warm batches of each pipeline: the ten device operations
    with the most time, the device's idle share of the window (first
    device operation's start to the last one's end) and of a batch as
    timed without the profiler (``rates``, frames/s), and the device
    operations launched per batch."""
    for estimator, method in PIPELINES:
        name = estimator if method == "linear" else f"{estimator}:{method}"
        for _ in range(2):
            pipeline(dev, gen, cfg, params, estimator, method)
        ops, busy, window = device_trace(
            lambda: pipeline(dev, gen, cfg, params, estimator, method), batches, name)
        batch_ms = BATCH / rates[name] * 1e3
        print(f"where a batch goes, {name} ({batches} warm batches of {BATCH} frames): window "
              f"{window / batches / 1e3:.3f} ms a batch, device busy {busy / batches / 1e3:.3f} ms, "
              f"idle share {1.0 - busy / window:.3f}; a batch without the profiler "
              f"{batch_ms:.3f} ms, idle share of it {1.0 - busy / batches / 1e3 / batch_ms:.3f}; "
              f"{len(ops) / batches:.1f} device operations a batch")
        print_top_ops(ops, batches)


def device_trace(run, batches, name):
    """A torch.profiler trace of the device only around ``batches`` calls
    of ``run()``: (operations as (name, start µs, end µs), busy µs — the
    union of their intervals —, window µs from the first start to the last
    end)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    fail_unless(ops, f"the profiler recorded device operations for {name}")
    ops.sort(key=lambda o: o[1])
    busy, edge = 0.0, ops[0][1]
    for _, start, end in ops:  # the union of the operations' intervals
        if end > edge:
            busy += end - max(start, edge)
            edge = end
    return ops, busy, edge - ops[0][1]


def print_top_ops(ops, batches):
    """The ten device operations with the most time, per batch."""
    by_name = {}
    for op_name, start, end in ops:
        total, count = by_name.get(op_name, (0.0, 0))
        by_name[op_name] = (total + end - start, count + 1)
    for op_name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        short = op_name
        for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::"):
            short = short.replace(noise, "")
        print(f"    {total / batches / 1e3:8.4f} ms a batch  {count / batches:6.1f} x  "
              f"{short[:150]}")


def factory_split(dev, cfg, workdir, split, frames):
    """A split of ``frames`` frames made by the dataset factory on the card,
    as the JAX package's study made data_simo/: DatasetGenerator with
    ``cfg`` (its seed, .ce5g chunks of cfg.dataset.chunk_size) into
    ``workdir``. Returns its manifest path and the manifest."""
    from ce5g_torch.data import DatasetGenerator

    gen = DatasetGenerator(cfg, workdir, device=dev)
    manifest = gen.generate_split(split, frames, log=quiet)
    fail_unless(manifest["completed"] == frames and manifest["format"] == "ce5g",
                f"the {split} split has {frames} frames in .ce5g chunks")
    return os.path.join(workdir, f"{split}_manifest.json"), manifest


def mean_db(per_sample):
    """(mean NMSE in dB, σ of that mean in dB) from per-sample linear NMSE."""
    import math

    import numpy as np

    p = np.asarray(per_sample, np.float64)
    mean = float(p.mean())
    sigma = float(p.std(ddof=1) / math.sqrt(len(p))) if len(p) > 1 else 0.0
    return 10 * math.log10(mean + 1e-12), 10 / math.log(10) * sigma / mean


def serving_path(dev, cfg, model_dir, workdir, frames, batch, model_batch, lstm_frames):
    """The serving path driven once, as a user calls it: factory split and
    Wiener sidecar → ChannelDataset (wiener=True) → evaluate_baselines → evaluate_estimators ('ls', 'mmse',
    'mmse_full') → ModelEvaluator.evaluate_model for SERVING_MODELS on every
    frame and 'lstm' on ``lstm_frames``. Returns the dataset, the evaluator,
    {name: result} and the wall times."""
    from ce5g_torch.data import compute_wiener_sidecar
    from ce5g_torch.eval.evaluate import ModelEvaluator, evaluate_baselines, evaluate_estimators
    from ce5g_torch.train import ChannelDataset

    walls = {}
    t0 = time.perf_counter()
    path, manifest = factory_split(dev, cfg, workdir, "test", frames)
    walls["split"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compute_wiener_sidecar(cfg, path, batch_size=batch, log=quiet, device=dev)
    walls["wiener sidecar"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = ChannelDataset(path, wiener=True)
    walls["read"] = time.perf_counter() - t0
    print(f"phase 9's test split: {frames} frames in {len(manifest['files'])} .ce5g chunks of "
          f"{manifest['chunk_size']}, made and written at {manifest['samples_per_second']:.1f} "
          f"frames/s")
    t0 = time.perf_counter()
    results = {"baselines": evaluate_baselines(ds)}
    results.update(evaluate_estimators(ds, cfg, ("ls", "mmse", "mmse_full"), batch_size=batch,
                                       device=dev))
    walls["classical"] = time.perf_counter() - t0
    ev = ModelEvaluator(cfg, model_dir, results_dir=os.path.join(workdir, "results"), device=dev)
    for name in SERVING_MODELS + ("lstm",):
        t0 = time.perf_counter()
        results[name] = ev.evaluate_model(name, ds, batch_size=model_batch,
                                          num_samples=lstm_frames if name == "lstm" else None)
        walls[name] = time.perf_counter() - t0
    return ds, ev, results, walls


def check_result(name, r, card, anchors):
    """Print one evaluate_* result's mean NMSE with its σ; where
    ``anchors`` has it, hold it to the JAX package's (SERVING_BAND_DB,
    widened to 4σ of the mean where that is larger). Returns the mean dB."""
    per_sample = r.get("per_sample_nmse", r.get("per_sample"))
    fail_unless(r["num_samples"] == len(per_sample), f"{name} scored every frame it was given")
    db, sigma = mean_db(per_sample)
    line = (f"  {name}: {db:.4f} dB (σ of the mean {sigma:.4f} dB) over "
            f"{r['num_samples']} frames, {r['latency_ms_per_sample']:.4f} ms/sample on {card}")
    if "params" in r:
        line += f", {r['params']} parameters"
    if name not in anchors:
        print(line + "; no anchor")
        return db
    anchor = anchors[name]
    band = max(SERVING_BAND_DB, 4 * sigma)
    print(line + f"; JAX package {anchor:+.2f} ± {band:.3f}"
          + (" (band widened to 4σ)" if band > SERVING_BAND_DB else ""))
    fail_unless(abs(db - anchor) <= band,
                f"{name} NMSE {db:.3f} dB within {band:.3f} dB of {anchor} dB")
    return db


def check_serving(results, card):
    """Phase 9's checks: each anchored mean within its band of the JAX
    package's (``check_result``), and cnn_wiener < transformer < resnet <
    cnn."""
    base = results["baselines"]
    print(f"  stored LS feature (evaluate_baselines): {base['LS']['nmse_db']:.4f} dB, simplified "
          f"MMSE {base['MMSE']['nmse_db']:.4f} dB over {base['num_samples']} frames")
    db = {name: check_result(name, r, card, SERVING_ANCHORS_DB)
          for name, r in results.items() if name != "baselines"}
    order = ("cnn_wiener", "transformer", "resnet", "cnn")
    fail_unless(all(db[a] < db[b] for a, b in zip(order, order[1:])),
                "NMSE ordering cnn_wiener < transformer < resnet < cnn: "
                + ", ".join(f"{m} {db[m]:.3f}" for m in order))
    print("  ordering cnn_wiener < transformer < resnet < cnn: ok")


def models_card_vs_cpu(cfg, model_dir, ds, dev, frames=2):
    """Every served model's forward on ``frames`` frames of the split at the
    full grid, on the card (cuDNN, TF32 off) against the CPU, max |diff|
    within MODEL_CHECK_TOL of the output's rms."""
    import numpy as np
    import torch
    from ce5g_torch.eval.evaluate import ModelEvaluator
    from ce5g_torch.models import lstm_inputs

    batch = ds.make_batch(np.arange(frames))
    parts = []
    for name in SERVING_MODELS + ("lstm",):
        if name == "lstm":
            x = lstm_inputs(batch)[0]
        else:
            x = torch.from_numpy(batch.inputs[..., :7 if "_wiener" in name else 5].copy())
        out = {}
        for where in (dev, torch.device("cpu")):
            model, _ = ModelEvaluator(cfg, model_dir, device=where).load_model(name)
            with torch.inference_mode():
                out[where.type] = model(x.to(where)).cpu()
        rms = float(out["cpu"].pow(2).mean().sqrt())
        err = float((out["cuda"] - out["cpu"]).abs().max()) / rms
        fail_unless(err <= MODEL_CHECK_TOL,
                    f"{name} card vs CPU max error {err:.2e} of rms <= {MODEL_CHECK_TOL}")
        parts.append(f"{name} {err:.2e}")
    print(f"models card vs CPU on {frames} frames at the full grid, max error of the output "
          f"rms (bound {MODEL_CHECK_TOL}): " + ", ".join(parts))


def where_a_serving_batch_goes(ev, ds, model_batch, batches=3):
    """Phase 10: a torch.profiler trace (device activity only) of
    ``batches`` warm batches of ModelEvaluator.evaluate_model for 'cnn' and
    'cnn_wiener' (one call; it loads the checkpoint, then builds each batch
    on the host, moves it, runs the model and scores it on the host): the
    ten device operations with the most time and the idle share."""
    import torch

    n = batches * model_batch
    for name in ("cnn", "cnn_wiener"):
        def run():
            ev.evaluate_model(name, ds, num_samples=n, batch_size=model_batch)

        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ev.load_model(name)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        ops, busy, window = device_trace(run, 1, name)
        print(f"where a serving batch goes, {name} ({batches} warm batches of {model_batch} "
              f"frames in one evaluate_model call): window {window / batches / 1e3:.3f} ms a "
              f"batch, device busy {busy / batches / 1e3:.3f} ms, idle share "
              f"{1.0 - busy / window:.3f}; the call without the profiler {call_ms:.3f} ms, of "
              f"which the checkpoint load {load_ms:.3f} ms; idle share of the call "
              f"{1.0 - busy / 1e3 / call_ms:.3f}, of its batches "
              f"{1.0 - busy / 1e3 / (call_ms - load_ms):.3f}; "
              f"{len(ops) / batches:.1f} device operations a batch")
        print_top_ops(ops, batches)


def serving_phase(dev, card, workdir):
    """Phase 9 at full width, with its checks, its split and results in
    ``workdir``; returns the kernels' launches on the path, the evaluator,
    the dataset and the results for phases 10-12."""
    import torch
    from ce5g_torch.config import config_from_dict

    cfg = config_from_dict(SIMO_CONFIG)
    model_dir = os.path.join(REPO, "models_simo")
    with capturing() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        ds, ev, results, walls = serving_path(dev, cfg, model_dir, workdir, SERVING_FRAMES,
                                              BATCH, MODEL_BATCH, LSTM_FRAMES)
        torch.cuda.synchronize()
        launches = read_launches()
        wall_s = time.perf_counter() - t0
    print(f"serving path (1x2 SIMO, {SERVING_FRAMES} frames in batches of {BATCH}, models in "
          f"batches of {MODEL_BATCH}, lstm on {LSTM_FRAMES}) in {wall_s:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    print("kernels launched on the serving path: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(launches["interp_fused"] > 0 and launches["hpd_solve"] > 0,
                f"interp_fused and hpd_solve launched on the serving path: {launches}")
    fail_unless(set(cap.args) == {k for k, v in launches.items() if v > 0},
                f"the serving path's inputs captured for each kernel it launched: {sorted(cap.args)}")
    hold_against_plain("serving path", cap.args)
    check_serving(results, card)
    models_card_vs_cpu(cfg, model_dir, ds, dev)
    return launches, ev, ds, results


def blind_priors_accuracy(dev, cfg, arrays):
    """The blind priors of every frame against the split's true parameters."""
    import numpy as np
    import torch
    from ce5g_torch.estimators.blind import device_tables_for, estimate_priors
    from ce5g_torch.eval.evaluate import _frames_from_arrays
    from ce5g_torch.physics.simulate import table_for

    from ce5g_torch.physics import PROFILE_INDEX

    tables = device_tables_for(cfg, table_for(cfg), dev)
    n = len(arrays["rx_symbols"])
    truth = np.asarray([PROFILE_INDEX[str(c)] for c in arrays["channel_type"]])
    got = {"profile_idx": [], "doppler_hz": [], "snr_db": []}
    for start in range(0, n, BLIND_BATCH):
        f = _frames_from_arrays(arrays, np.arange(start, min(start + BLIND_BATCH, n)), cfg, dev)
        pri = estimate_priors(f.rx_symbols, f.tx_symbols[:, :, 0, :], f.pilot_mask, tables,
                              cfg.mimo.num_tx)
        for k in got:
            got[k].append(getattr(pri, k).cpu())
    got = {k: torch.cat(v).numpy() for k, v in got.items()}
    fail_unless(all(np.isfinite(v).all() for v in got.values()), "blind priors finite")
    hit = float((got["profile_idx"] == truth).mean())
    fd_err = np.abs(got["doppler_hz"] - arrays["doppler_hz"])
    snr_err = np.abs(got["snr_db"] - arrays["snr_db"])
    print(f"  blind priors against the split's truth over {n} frames: profile hit rate "
          f"{hit:.4f}, median |Doppler error| {np.median(fd_err):.3f} Hz, SNR error mean "
          f"{snr_err.mean():.4f} dB, max {snr_err.max():.4f} dB")


def blind_timings(dev, cfg, arrays, card):
    """estimate_priors a frame at BLIND_BATCH frames, where its device
    time goes (a torch.profiler trace of one warm call), and its ridge
    solve alone (the library Cholesky and solve of ``estimators.blind``)
    beside ``torch.linalg.solve`` of the same systems."""
    import numpy as np
    import torch
    import ce5g_torch.estimators.blind as blind_mod
    from ce5g_torch.eval.evaluate import _frames_from_arrays
    from ce5g_torch.physics.simulate import table_for

    tables = blind_mod.device_tables_for(cfg, table_for(cfg), dev)
    f = _frames_from_arrays(arrays, np.arange(BLIND_BATCH), cfg, dev)
    args = (f.rx_symbols, f.tx_symbols[:, :, 0, :], f.pilot_mask, tables, cfg.mimo.num_tx)
    seen = []
    real = blind_mod.ridge_solve

    def recording(gram, rhs):
        seen.append((gram, rhs))
        return real(gram, rhs)

    blind_mod.ridge_solve = recording
    try:
        blind_mod.estimate_priors(*args)
    finally:
        blind_mod.ridge_solve = real
    gram, rhs = seen[0]
    priors_ms = cuda_ms(lambda: blind_mod.estimate_priors(*args))
    ridge_ms = cuda_ms(lambda: blind_mod.ridge_solve(gram, rhs))
    lib_ms = cuda_ms(lambda: torch.linalg.solve(gram, rhs))
    print(f"  blind fit at {BLIND_BATCH} frames on {card}: estimate_priors {priors_ms[0]:.4f} ms "
          f"({priors_ms[0] / BLIND_BATCH:.5f} ms a frame); its ridge solve "
          f"{tuple(gram.shape)} x {rhs.shape[-1]} (Cholesky + cholesky_solve) {ridge_ms[0]:.4f} ms, "
          f"torch.linalg.solve of the same {lib_ms[0]:.4f} ms")
    ops, busy, window = device_trace(lambda: blind_mod.estimate_priors(*args), 1,
                                     "estimate_priors")
    print(f"where estimate_priors goes ({BLIND_BATCH} frames, one warm call): window "
          f"{window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1.0 - busy / window:.3f}; {len(ops)} device operations")
    print_top_ops(ops, 1)


def blind_phase(dev, card, workdir, cfg, ds, ev, serving_results):
    """Phase 11: the blind serving path on phase 9's split, with the
    launch counters read around it. Returns the launches and the
    hpd_solve row at n = 75."""
    import torch
    from ce5g_torch.data import compute_wiener_sidecar
    from ce5g_torch.eval.evaluate import evaluate_estimators
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.train import ChannelDataset

    t_phase = time.perf_counter()
    path = os.path.join(workdir, "test_manifest.json")
    walls = {}
    with capturing() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        compute_wiener_sidecar(cfg, path, batch_size=BLIND_BATCH, estimator="mmse_full_est",
                               tag="bwiener", log=quiet, device=dev)
        walls["bwiener sidecar"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        ds_b = ChannelDataset(path, wiener="bwiener")
        walls["read"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        results = evaluate_estimators(ds_b, cfg, ("mmse_full_est",), batch_size=BLIND_BATCH,
                                      device=dev)
        walls["mmse_full_est"] = time.perf_counter() - t1
        for name in ("cnn_wiener_blind", "cnn_wiener_blind_online"):
            t1 = time.perf_counter()
            results[name] = ev.evaluate_model(name, ds_b, batch_size=MODEL_BATCH)
            walls[name] = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = read_launches()
        wall_s = time.perf_counter() - t0
    print(f"blind serving path ({SERVING_FRAMES} frames of phase 9's split, estimator batches of "
          f"{BLIND_BATCH}) in {wall_s:.2f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    print("kernels launched on the blind path: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(launches["hpd_solve"] > 0, f"hpd_solve launched on the blind path: {launches}")
    gram, rhs = cap.args["hpd_solve"]
    fail_unless(tuple(gram.shape) == (BLIND_BATCH, 75, 75) and rhs.shape[-1] == 2,
                f"the blind path's Woodbury system is ({BLIND_BATCH}, 75, 75) x 2: "
                f"{tuple(gram.shape)} x {rhs.shape[-1]}")
    errs = hold_against_plain("blind path", cap.args)
    fail_unless(all(results[name]["num_samples"] == SERVING_FRAMES for name in BLIND_ANCHORS_DB),
                "the blind path scored every frame of the split")
    db = {name: check_result(name, results[name], card, BLIND_ANCHORS_DB)
          for name in BLIND_ANCHORS_DB}
    full_db = mean_db(serving_results["mmse_full"]["per_sample"])[0]
    for name in ("cnn_wiener_blind", "cnn_wiener_blind_online"):
        fail_unless(full_db < db[name] < db["mmse_full_est"],
                    f"mmse_full {full_db:.3f} < {name} {db[name]:.3f} < mmse_full_est "
                    f"{db['mmse_full_est']:.3f} dB")
    print(f"  ordering mmse_full ({full_db:.4f}) < cnn_wiener_blind*, < mmse_full_est, on the "
          "same frames: ok")
    blind_priors_accuracy(dev, cfg, ds.arrays)
    b, n, r = rhs.shape
    row = kernel_row("hpd_solve", "ce5g_torch/csrc/hpd_solve.cu",
                     "ce5g_tpu/ops/hpd_solve_pallas.py:45", launches["hpd_solve"],
                     errs["hpd_solve"], lambda: hpd_mod.hpd_solve(gram, rhs),
                     lambda: hpd_mod.hpd_solve_plain(gram, rhs), hpd_mod.work(b, n, r),
                     lambda: torch.linalg.solve(gram, rhs))
    print(f"hpd_solve at the blind path's inputs {tuple(gram.shape)} x {r}: kernel "
          f"{row['ms']:.4f} ms ({row['ms_min']:.4f}-{row['ms_max']:.4f} over 5 replays of a graph "
          f"of 20), back-to-back calls {row['call_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), library "
          f"{row['library_ms']:.4f} ms (torch.linalg.solve)")
    blind_timings(dev, cfg, ds.arrays, card)
    print(f"phase 11 wall time: {time.perf_counter() - t_phase:.1f} s")
    return launches


def training_phase(dev, card, test_ds):
    """Phase 12: the cnn trained on the card as the JAX package's SIMO run
    was, from a device-resident split, with the launch counters read
    around the path (split, staging, training). Returns the launches and
    the quick datasets of its splits for phase 14's tuner."""
    import torch
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.eval import QuickDataset
    from ce5g_torch.eval.evaluate import ModelEvaluator
    from ce5g_torch.train import ChannelDataset, DeviceDataset, Trainer

    t_phase = time.perf_counter()
    cfg = config_from_dict(SIMO_CONFIG)
    tr = cfg.training
    fail_unless((tr.batch_size, tr.optimizer, tr.lr_scheduler, tr.epochs, tr.gradient_clip,
                 tr.loss, tr.mixed_precision) == (64, "adam", "cosine", 100, 1.0, "mse", True),
                "phase 12 trains with the JAX run's settings")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_training_") as workdir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        train_path, train_man = factory_split(dev, cfg, workdir, "train", TRAIN_FRAMES)
        val_path, _ = factory_split(dev, cfg, workdir, "val", VAL_FRAMES)
        t_made = time.perf_counter() - t0
        t1 = time.perf_counter()
        train_ds, val_ds = ChannelDataset(train_path), ChannelDataset(val_path)
        dd_train = DeviceDataset(train_ds, device=dev)
        dd_val = DeviceDataset(val_ds, device=dev)
        # phase 14's tuner takes 2000 / 500-frame quick datasets of these splits
        tune_sets = (QuickDataset(train_ds, TUNE_TRAIN, cfg.seed),
                     QuickDataset(val_ds, TUNE_VAL, cfg.seed))
        del train_ds, val_ds
        torch.cuda.synchronize()
        t_staged = time.perf_counter() - t1
        model_dir = os.path.join(workdir, "models")
        trainer = Trainer(cfg, model_type="cnn", device=dev, log=lambda m: print("  " + m))
        result = trainer.train(dd_train, dd_val, epochs=TRAIN_EPOCHS, model_dir=model_dir)
        torch.cuda.synchronize()
        launches = read_launches()
        wall_s = time.perf_counter() - t0
        print(f"training path in {wall_s:.2f} s: factory splits of {TRAIN_FRAMES} + {VAL_FRAMES} "
              f"frames (.ce5g chunks of {train_man['chunk_size']}) made and written in "
              f"{t_made:.2f} s (train at {train_man['samples_per_second']:.1f} frames/s), read "
              f"and staged on the card in {t_staged:.2f} s "
              f"({(dd_train.inputs.numel() + dd_train.targets.numel() + dd_val.inputs.numel() + dd_val.targets.numel()) * 4 / 2**30:.2f} GiB); "
              f"epochs " + ", ".join(f"{t:.2f} s" for t in result["history"]["epoch_time"]))
        print("kernels launched on the training path: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        fail_unless(launches["interp_fused"] > 0, f"interp_fused launched on the training path: "
                    f"{launches}")
        val = result["history"]["val_loss"]
        ref = (JAX_CNN_VAL_LOSS[1] + JAX_CNN_VAL_LOSS[2]) / 2
        print(f"  validation loss by epoch: " + ", ".join(f"{v:.4f}" for v in val)
              + f"; JAX package " + ", ".join(f"{v:.4f}" for v in JAX_CNN_VAL_LOSS)
              + f"; epochs 2-3 within ±{TRAIN_BAND:.0%} of {ref:.4f}")
        fail_unless(len(val) == TRAIN_EPOCHS, f"{TRAIN_EPOCHS} epochs run")
        for epoch in (1, 2):
            fail_unless(abs(val[epoch] - ref) <= TRAIN_BAND * ref,
                        f"epoch {epoch + 1} validation loss {val[epoch]:.4f} within "
                        f"{TRAIN_BAND:.0%} of {ref:.4f}")
        fail_unless(val[2] < val[0], "epoch 3 validation loss below epoch 1's")

        # ms a step, bf16 (the config's) and float32, 20 steps each
        bsz = tr.batch_size
        batches = itertools.cycle(range(len(dd_train) // bsz))

        def step():
            i = next(batches)
            x, y = dd_train.inputs[i * bsz:(i + 1) * bsz], dd_train.targets[i * bsz:(i + 1) * bsz]
            return trainer._step(*trainer._layout(x, y))

        trainer.model.train()
        steps_ms = {}
        for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
            trainer.model.dtype = dtype  # the compute dtype models.cnn.computing_in reads
            steps_ms[name] = cuda_ms(step, rounds=1, iters=20)[0]
        trainer.model.dtype = torch.bfloat16
        print(f"  ms a training step at batch {bsz} on {card}: bf16 {steps_ms['bf16']:.3f}, "
              f"float32 {steps_ms['float32']:.3f} (20 steps each)")
        for _ in range(2):
            step()
        ops, busy, window = device_trace(step, 3, "training steps")
        print(f"where a training step goes (3 warm bf16 steps of {bsz} frames): window "
              f"{window / 3 / 1e3:.3f} ms a step, device busy {busy / 3 / 1e3:.3f} ms, idle share "
              f"{1.0 - busy / window:.3f}; {len(ops) / 3:.1f} device operations a step")
        print_top_ops(ops, 3)

        ev = ModelEvaluator(cfg, model_dir, device=dev)
        r = ev.evaluate_model("cnn", test_ds, batch_size=MODEL_BATCH)
        trained_db, sigma = mean_db(r["per_sample_nmse"])
        fail_unless(math.isfinite(trained_db), "the trained cnn's NMSE is finite")
        print(f"  the trained cnn's _best (epoch {r['checkpoint_epoch'] + 1}) on phase 9's split: "
              f"{trained_db:.4f} dB (σ of the mean {sigma:.4f} dB) over {r['num_samples']} frames; "
              "no anchor")
    print(f"phase 12 wall time: {time.perf_counter() - t_phase:.1f} s")
    return launches, tune_sets


def _with_dataset(cfg, **fields):
    import dataclasses

    return dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, **fields))


def digest_run(dev, cfg, workdir):
    """Phase 13 (a): the at-scale digest run, the chunk program checked for
    host synchronisation, chunk ATSCALE_VERIFY_CHUNK regenerated and
    compared exactly, then materialized by writer 32 of 64 and held to its
    digest."""
    import warnings

    import numpy as np
    import torch
    from ce5g_torch.data import CHUNK_KEYS, DatasetGenerator, atscale, read_chunk
    from ce5g_torch.physics import PROFILE_INDEX

    t0 = time.perf_counter()
    man = atscale.generate_digest_split(cfg, workdir, num_samples=ATSCALE_FRAMES,
                                        chunk_size=ATSCALE_CHUNK, log=quiet, device=dev)
    wall = time.perf_counter() - t0
    fail_unless(man["num_chunks"] == ATSCALE_FRAMES // ATSCALE_CHUNK
                and all(np.isfinite(man["digests"][k]).all() for k in CHUNK_KEYS),
                "every chunk digested, finite")
    print(f"digest run: {ATSCALE_FRAMES} frames in {man['num_chunks']} chunks of {ATSCALE_CHUNK} "
          f"(2x2, experiment config) in {wall:.2f} s: {man['device_samples_per_second']:.1f} "
          f"samples/s sustained over {man['elapsed_s']:.3f} s with one synchronise; one chunk "
          f"synchronised {man['sync_chunk_s'] * 1e3:.2f} ms "
          f"({man['sync_samples_per_second']:.1f} samples/s); on {man['device_name']}")
    # the chunk program enqueues without waiting for the card, once the first
    # chunk of a config has put its profile tables there
    dcfg = _with_dataset(cfg, chunk_size=ATSCALE_CHUNK)
    atscale._chunk_digest(dcfg, "atscale", 0, ATSCALE_CHUNK, dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(1, 4):
                atscale._chunk_digest(dcfg, "atscale", i, ATSCALE_CHUNK, dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    fail_unless(not syncs, f"no host synchronisation in the chunk program: {syncs[:2]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fail_unless(atscale.verify_digest_chunk(cfg, man, ATSCALE_VERIFY_CHUNK, device=dev),
                f"chunk {ATSCALE_VERIFY_CHUNK} regenerates to its digest exactly")
    verify_s = time.perf_counter() - t0
    writers = ATSCALE_FRAMES // ATSCALE_CHUNK
    mat = DatasetGenerator(_with_dataset(cfg, save_format="ce5g", chunk_size=ATSCALE_CHUNK),
                           os.path.join(workdir, "materialized"), device=dev)
    t0 = time.perf_counter()
    part = mat.generate_split("atscale", ATSCALE_FRAMES, log=quiet,
                              writer_id=ATSCALE_VERIFY_CHUNK, num_writers=writers)
    mat_s = time.perf_counter() - t0
    name = f"atscale_chunk_{ATSCALE_VERIFY_CHUNK:05d}.ce5g"
    fail_unless(part["files"] == [name], f"writer {ATSCALE_VERIFY_CHUNK} of {writers} wrote {name}")
    arrays = read_chunk(os.path.join(workdir, "materialized", name))
    arrays["profile_idx"] = np.asarray([PROFILE_INDEX[str(c)] for c in arrays["channel_type"]],
                                       np.int32)
    exact, worst = True, 0.0
    for k in CHUNK_KEYS:
        got = atscale._array_digest(torch.from_numpy(arrays[k]).to(dev)).cpu().numpy()
        want = np.asarray(man["digests"][k][ATSCALE_VERIFY_CHUNK], np.float32)
        atol = DIGEST_ATOL * max(float(want[0]), 1.0)
        fail_unless(np.all(np.abs(got - want) <= atol + DIGEST_RTOL * np.abs(want)),
                    f"materialized chunk's {k} digest {got} within tolerance of {want}")
        exact &= bool(np.array_equal(got, want))
        worst = max(worst, float(np.max(np.abs(got - want) / (atol + DIGEST_RTOL * np.abs(want)))))
    print(f"  chunk {ATSCALE_VERIFY_CHUNK} regenerated: digest equal exactly ({verify_s:.2f} s); "
          f"materialized by writer {ATSCALE_VERIFY_CHUNK} of {writers} ({ATSCALE_CHUNK} frames, "
          f"{part['samples_per_second']:.1f} frames/s made and written, {mat_s:.2f} s): digests "
          f"{'equal exactly' if exact else 'within tolerance'} (worst {worst:.3g} of the JAX "
          f"package's tolerance); the chunk program made no host synchronisation in 3 chunks")
    return man


def _file_hashes(root, names):
    import hashlib

    return {n: hashlib.sha256(open(os.path.join(root, n), "rb").read()).hexdigest() for n in names}


def writers_run(dev, cfg, workdir):
    """Phase 13 (b): one writer, a deleted chunk regenerated by a resume,
    then two writers and the global manifest, each split bitwise equal to
    the first and passing verify_dataset."""
    import shutil

    from ce5g_torch.data import DatasetGenerator, verify_dataset

    wcfg = _with_dataset(cfg, save_format="ce5g", chunk_size=ATSCALE_CHUNK)
    single = os.path.join(workdir, "single")
    gen = DatasetGenerator(wcfg, single, device=dev)
    t0 = time.perf_counter()
    man = gen.generate_split("train", WRITERS_FRAMES, log=quiet)
    single_s = time.perf_counter() - t0
    hashes = _file_hashes(single, man["files"])
    fail_unless(len(hashes) == WRITERS_FRAMES // ATSCALE_CHUNK, "one file a chunk")
    os.remove(os.path.join(single, man["files"][-1]))  # a resume regenerates from the gap on
    t0 = time.perf_counter()
    again = gen.generate_split("train", WRITERS_FRAMES, resume=True, log=quiet)
    resume_s = time.perf_counter() - t0
    fail_unless(_file_hashes(single, again["files"]) == hashes,
                "the resumed split is bitwise the first")
    t0 = time.perf_counter()
    checks = verify_dataset(os.path.join(single, "train_manifest.json"))
    verify_s = time.perf_counter() - t0
    fail_unless(checks["passed"] and checks["num_samples"] == WRITERS_FRAMES,
                f"verify_dataset passes on the resumed split: {checks['checks']}")
    shutil.rmtree(single)
    multi = os.path.join(workdir, "multi")
    gen = DatasetGenerator(wcfg, multi, device=dev)
    t0 = time.perf_counter()
    for w in range(2):
        gen.generate_split("train", WRITERS_FRAMES, writer_id=w, num_writers=2, log=quiet)
    merged = gen.write_global_manifest("train", num_writers=2)
    multi_s = time.perf_counter() - t0
    fail_unless(_file_hashes(multi, merged["files"]) == hashes,
                "two writers and the global manifest are bitwise one writer")
    fail_unless(verify_dataset(os.path.join(multi, "train_manifest.json"))["passed"],
                "verify_dataset passes on the two writers' split")
    shutil.rmtree(multi)
    print(f"writers: {WRITERS_FRAMES} frames in .ce5g chunks of {ATSCALE_CHUNK}: one writer "
          f"{single_s:.2f} s ({man['samples_per_second']:.1f} frames/s made and written); a "
          f"deleted chunk regenerated by a resume in {resume_s:.2f} s, bitwise; two writers and "
          f"the global manifest in {multi_s:.2f} s, bitwise one writer; verify_dataset passes on "
          f"each ({verify_s:.2f} s a split)")


def online_runs(dev, cfg, card):
    """Phase 13 (c): online_train of the cnn at ONLINE_BATCH in float32 and
    bf16 and in the blind 7-channel layout; each run's last loss must be
    below its first."""
    import torch
    from ce5g_torch.data import online_train

    # the blind run takes the loss of the JAX package's blind online run
    # (models_simo/cnn_wiener_blind_online_history.json)
    runs = [("float32", torch.float32, None, None, ONLINE_STEPS, ONLINE_WINDOW),
            ("bf16", torch.bfloat16, None, None, ONLINE_STEPS, ONLINE_WINDOW),
            ("float32 blind", torch.float32, "mmse_full_est", "nmse", BLIND_ONLINE_STEPS,
             BLIND_ONLINE_STEPS // 2)]
    for name, dtype, wiener, loss, steps, window in runs:
        t0 = time.perf_counter()
        out = online_train(cfg, "cnn", total_samples=steps * ONLINE_BATCH, batch_size=ONLINE_BATCH,
                           steps_per_dispatch=window, dtype=dtype, wiener_estimator=wiener,
                           loss_type=loss, log=quiet, device=dev)
        wall = time.perf_counter() - t0
        fail_unless(out["steps"] == steps and math.isfinite(out["last_loss"]),
                    f"online {name}: {steps} steps, finite loss")
        fail_unless(out["last_loss"] < out["first_loss"],
                    f"online {name}: last loss {out['last_loss']:.4f} below the first "
                    f"{out['first_loss']:.4f}")
        print(f"online_train cnn {name} (batch {ONLINE_BATCH}, 2x2, {out['loss_type']} loss"
              f"{', mmse_full_est' if wiener else ''}): "
              f"{steps} steps in {wall:.2f} s, {out['end_to_end_samples_per_second']:.1f} samples/s "
              f"end to end over the {steps - window} steps after the first {window}; loss "
              f"{out['first_loss']:.4f} -> {out['last_loss']:.4f} on {card}")


def online_trace(dev, cfg, steps=3):
    """Phase 13 (c): a torch.profiler trace of ``steps`` warm online steps
    (float32): each a Trainer step on online_batch, as online_train runs
    them."""
    import torch
    from ce5g_torch.data import atscale
    from ce5g_torch.models import get_model
    from ce5g_torch.physics.simulate import table_for
    from ce5g_torch.train import Trainer

    trainer = Trainer(cfg, model=get_model("cnn", cfg.model, seed=cfg.seed, device=dev),
                      model_type="cnn", device=dev, log=quiet)
    trainer.model.train()
    unit = {"rx_std": 1.0, "hls_std": 1.0, "h_std": 1.0}
    table = table_for(cfg)
    batches = itertools.count()

    def step():
        trainer._step(*atscale.online_batch(cfg, "online", next(batches), ONLINE_BATCH, unit,
                                            None, table, dev))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    ops, busy, window = device_trace(step, steps, "online steps")
    print(f"where an online step goes ({steps} warm float32 steps of {ONLINE_BATCH} frames: "
          f"simulate, LS, forward, backward, AdamW): window {window / steps / 1e3:.3f} ms a step, "
          f"device busy {busy / steps / 1e3:.3f} ms, idle share {1.0 - busy / window:.3f}; a step "
          f"without the profiler {step_ms:.3f} ms; {len(ops) / steps:.1f} device operations a step")
    print_top_ops(ops, steps)


def codec_run(dev, cfg, workdir):
    """Phase 13 (d): the backend that writes .ce5g here and its MB/s on one
    CODEC_FRAMES-frame chunk (and the read back)."""
    import json as _json

    import numpy as np
    from ce5g_torch.data import DatasetGenerator
    from ce5g_torch.data.ce5g_format import read_ce5g, write_ce5g

    gen = DatasetGenerator(_with_dataset(cfg, chunk_size=CODEC_FRAMES), workdir, device=dev)
    arrays = gen._run_chunk("codec", 0, CODEC_FRAMES)
    nbytes = sum(a.nbytes for a in arrays.values())
    path = os.path.join(workdir, "codec_chunk.ce5g")
    t0 = time.perf_counter()
    write_ce5g(path, arrays)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = read_ce5g(path)
    read_s = time.perf_counter() - t0
    fail_unless(all(np.array_equal(back[k], v) for k, v in arrays.items()),
                "the codec chunk reads back bitwise")
    with open(path, "rb") as fh:
        fh.read(8)
        writer = _json.loads(fh.read(int.from_bytes(fh.read(8), "little")))["writer"]
    size = os.path.getsize(path)
    print(f"codec: backend {writer} on {os.cpu_count()} host cores; a {CODEC_FRAMES}-frame 2x2 "
          f"chunk ({nbytes / 1e6:.1f} MB) written in {write_s:.3f} s = {nbytes / 1e6 / write_s:.1f} "
          f"MB/s, read in {read_s:.3f} s = {nbytes / 1e6 / read_s:.1f} MB/s; file "
          f"{size / 1e6:.1f} MB ({size / nbytes:.3f} of the arrays)")


def factory_phase(dev, card):
    """Phase 13: the dataset factory at scale, with the launch counters
    read around (a)-(d); then (e), each kernel the phase launched against
    its plain version on the inputs the phase gave it. Returns the
    launches."""
    import torch
    from ce5g_torch.config import config_from_dict

    t_phase = time.perf_counter()
    cfg = config_from_dict(EXPERIMENT_CONFIG)
    fail_unless((cfg.mimo.num_tx, cfg.mimo.num_rx, cfg.pilots.interpolation) == (2, 2, "linear"),
                "phase 13 runs the 2x2 experiment config with linear interpolation")
    with capturing() as cap, tempfile.TemporaryDirectory(prefix="chip_smoke_factory_") as workdir:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        digest_run(dev, cfg, workdir)
        walls = {"digest": time.perf_counter() - t0}
        t0 = time.perf_counter()
        writers_run(dev, cfg, workdir)
        walls["writers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        online_runs(dev, cfg, card)
        online_trace(dev, cfg)
        walls["online"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        codec_run(dev, cfg, workdir)
        walls["codec"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches()
    print("kernels launched on the factory path: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(launches["interp_fused"] > 0 and launches["hpd_solve"] > 0,
                f"interp_fused and hpd_solve launched on the factory path: {launches}")
    fail_unless(set(cap.args) == {k for k, v in launches.items() if v > 0},
                f"the factory path's inputs captured for each kernel it launched: {sorted(cap.args)}")
    torch.cuda.empty_cache()
    hold_against_plain("factory path", cap.args)
    print(f"phase 13 wall time: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return launches


def _ratio_sigma_db(err, pwr):
    """σ in dB of 10·log10(Σ err / Σ pwr) over a cell's frames (delta method)."""
    import numpy as np

    e, p = np.asarray(err, np.float64), np.asarray(pwr, np.float64)
    r = e.sum() / p.sum()
    return 10 / math.log(10) * math.sqrt(((e - r * p) ** 2).sum()) / p.sum() / r


def hold_average(what, got, sigma, anchor):
    """A per-density average within EVAL_BAND_DB of the study's, or 4σ of
    the port's average where that is wider."""
    band = max(EVAL_BAND_DB, 4 * sigma)
    fail_unless(abs(got - anchor) <= band,
                f"{what} {got:.3f} dB within {band:.3f} dB of the JAX study's {anchor:.3f} dB")
    return f"{got:+.3f} (σ {sigma:.3f}; JAX {anchor:+.3f})"


def pilot_sweep(opt, study):
    """Phase 14 (a): PilotOptimizer.sweep at the JAX study's settings."""
    conf = study["config"]
    res = opt.sweep(densities=conf["densities"], snrs_db=conf["snrs_db"],
                    estimators=("ls", "mmse", "mmse_full"), channel_type=conf["channel_type"],
                    doppler_hz=conf["doppler_hz"], frames_per_cell=STUDY_FRAMES, per_frame=True)
    spread = res.pop("per_frame")
    avg = {}
    for est in ("ls", "mmse", "mmse_full"):
        parts = []
        for d in map(str, conf["densities"]):
            got = res["recommendation"][est]["avg_nmse_db"][d]
            cells = spread[est][d].values()
            sigma = math.sqrt(sum(_ratio_sigma_db(c["err"], c["pwr"]) ** 2
                                  for c in cells)) / len(cells)
            anchor = study["recommendation"][est]["avg_nmse_db"][d]
            parts.append(f"{d}: " + hold_average(f"sweep {est} at {d}", got, sigma, anchor))
            avg.setdefault(d, {})[est] = got
        print(f"  (a) {est} average NMSE dB by density: " + "; ".join(parts)
              + f"; best density {res['recommendation'][est]['best_density']}")
    for d, by_est in avg.items():
        fail_unless(abs(by_est["mmse_full"] - FLOOR_2TX_DB) <= FLOOR_SLACK_DB,
                    f"sweep mmse_full at {d} {by_est['mmse_full']:.3f} dB within "
                    f"{FLOOR_SLACK_DB} dB of the 2-TX floor {FLOOR_2TX_DB} dB")
        fail_unless(by_est["mmse_full"] < by_est["mmse"] < by_est["ls"],
                    f"sweep ordering mmse_full < mmse < ls at {d}: {by_est}")
    print(f"  (a) mmse_full within {FLOOR_SLACK_DB} dB of the 2-TX floor {FLOOR_2TX_DB} dB and "
          "mmse_full < mmse < ls at every density: ok")
    return res


def model_sweep(dev, cfg, opt, study, workdir):
    """Phase 14 (b): PilotOptimizer.model_sweep with models/cnn_best and
    models/cnn_wiener_best, normalised by a factory split's stats."""
    from ce5g_torch.train import ChannelDataset

    path, _ = factory_split(dev, _with_dataset(cfg, save_format="ce5g"), workdir, "test",
                            STATS_FRAMES)
    stats = ChannelDataset(path).stats
    conf = study["config"]
    res = opt.model_sweep(("cnn", "cnn_wiener"), os.path.join(REPO, "models"), stats,
                          densities=conf["densities"], snrs_db=conf["snrs_db"],
                          channel_type=conf["channel_type"], doppler_hz=conf["doppler_hz"],
                          frames_per_cell=STUDY_FRAMES, modulation=conf["modulation"],
                          per_frame=True)
    fail_unless(res["config"]["models"] == ["cnn", "cnn_wiener"], "both models loaded")
    print(f"  (b) stats of a {STATS_FRAMES}-frame factory split: "
          + ", ".join(f"{k} {v:.5f}" for k, v in stats.items()))
    avg = {}
    for name in ("ls", "mmse_full", "cnn", "cnn_wiener"):
        parts = []
        for d in map(str, conf["densities"]):
            cells = res["results"][name][d].values()
            got = res["recommendation"][name]["avg_nmse_db_slice"][d]
            sigma = math.sqrt(sum(mean_db(c.pop("per_sample_nmse"))[1] ** 2
                                  for c in cells)) / len(cells)
            anchor = study["recommendation"][name]["avg_nmse_db_slice"][d]
            parts.append(f"{d}: " + hold_average(f"model sweep {name} at {d}", got, sigma, anchor))
            avg.setdefault(d, {})[name] = got
        print(f"  (b) {name} average slice NMSE dB by density: " + "; ".join(parts))
    for d, by_name in avg.items():
        for m in ("cnn", "cnn_wiener"):
            fail_unless(by_name[m] <= by_name["ls"] - MODEL_MARGIN_DB,
                        f"{m} beats ls by >= {MODEL_MARGIN_DB} dB at {d}: {by_name}")
    ber = res["results"]
    for d in map(str, conf["densities"]):
        for snr in map(str, conf["snrs_db"]):
            fail_unless(ber["mmse_full"][d][snr]["ber"] < ber["ls"][d][snr]["ber"],
                        f"measured BER of mmse_full below ls's at {d}, {snr} dB")
        print(f"  (b) BER at {d} by SNR " + ", ".join(map(str, conf["snrs_db"])) + ": "
              + "; ".join(f"{n} " + " ".join(f"{ber[n][d][s]['ber']:.4f}" for s in map(str, conf["snrs_db"]))
                          for n in ("ls", "mmse_full", "cnn", "cnn_wiener")))
    print(f"  (b) cnn and cnn_wiener beat ls by >= {MODEL_MARGIN_DB} dB at every density; BER of "
          "mmse_full below ls's in every cell: ok")
    return res


def ber_study(dev, study):
    """Phase 14 (c): ber_sweep on the SIMO config at the JAX study's settings."""
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.eval import ber_sweep

    simo = config_from_dict(SIMO_CONFIG)
    anchors = study["ber_vs_snr"]
    out = {}
    for est in ("ls", "mmse_full", "mmse_full_est"):
        pts = ber_sweep(simo, BER_SNRS, estimator=est, density=BER_DENSITY,
                        frames_per_point=BER_FRAMES, counts=True, device=dev)
        parts = []
        for snr in BER_SNRS:
            pt = pts[str(snr)]
            anchor = anchors[est][str(snr)]
            sigma = statistics.stdev(pt["per_frame"]) / math.sqrt(len(pt["per_frame"]))
            line = f"{snr:g} dB {pt['ber']:.5f} ({pt['errors']} of {pt['bits']} bits; JAX {anchor:.5f}"
            if snr <= BER_HELD_TO_DB:
                band = max(BER_BAND * anchor, 4 * sigma)
                fail_unless(abs(pt["ber"] - anchor) <= band,
                            f"{est} BER at {snr} dB {pt['ber']:.5f} within {band:.5f} of {anchor:.5f}")
                line += f" ± {band:.5f}"
            parts.append(line + ")")
        bers = [pts[str(snr)]["ber"] for snr in BER_SNRS]
        fail_unless(all(a > b for a, b in zip(bers, bers[1:])), f"{est} BER falls with SNR: {bers}")
        out[est] = {k: v["ber"] for k, v in pts.items()}
        print(f"  (c) {est}: " + "; ".join(parts))
    fail_unless(all(out["mmse_full"][k] <= out["ls"][k] for k in out["ls"]),
                "BER of mmse_full <= ls's at every SNR")
    print(f"  (c) held at <= {BER_HELD_TO_DB:g} dB (±{BER_BAND:.0%} or 4σ); BER falls with SNR; "
          "mmse_full <= ls: ok")
    return out


def tuning_run(dev, workdir, tune_sets):
    """Phase 14 (d): HyperparameterTuner.random_search, the first TUNE_TRIALS
    of the JAX study's 20 trials (seed 0)."""
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.eval import HyperparameterTuner
    from ce5g_torch.eval.tuning import draw_random_trials

    stored = json.loads(open(TUNING_STUDY).read())
    jax_loss = {json.dumps(r["params"]): r["val_loss"] for r in stored}
    cfg = config_from_dict(SIMO_CONFIG)
    # phase 12 handed over 2000 / 500-frame QuickDatasets of its splits, taken
    # as the tuner takes them: a QuickDataset of those is the identity
    tuner = HyperparameterTuner(cfg, *tune_sets, workdir, quick_train=TUNE_TRAIN,
                                quick_val=TUNE_VAL, epochs_per_trial=TUNE_EPOCHS,
                                log=lambda m: print("  (d) " + m), device=dev)
    results = tuner.random_search(num_trials=TUNE_TRIALS, seed=0)
    drawn = [json.dumps(json.loads(json.dumps(t))) for t in draw_random_trials(TUNE_TRIALS)]
    got = {json.dumps(json.loads(json.dumps(r["params"]))): r["val_loss"] for r in results}
    fail_unless(sorted(got) == sorted(drawn) and all(t in jax_loss for t in drawn),
                "the tuner's trials are the first of the JAX study's draw order")
    for t in drawn:
        fail_unless(abs(got[t] - jax_loss[t]) <= TUNE_BAND * jax_loss[t],
                    f"trial {t}: validation loss {got[t]:.4f} within {TUNE_BAND:.0%} of the "
                    f"JAX trial's {jax_loss[t]:.4f}")
    written = json.loads(open(os.path.join(workdir, "random_search_results.json")).read())
    losses = [r["val_loss"] for r in written]
    fail_unless(losses == sorted(losses) and len(written) == TUNE_TRIALS,
                "random_search_results.json written, sorted")
    print("  (d) validation loss by trial, in the order drawn: "
          + "; ".join(f"{got[t]:.4f} (JAX {jax_loss[t]:.4f})" for t in drawn)
          + f"; within ±{TUNE_BAND:.0%}: ok")


def regular_pilots(dev):
    """Phase 14 (e): comb and block pilots on the main path at the bench
    config, each case checked against the same path on the CPU on 8 frames."""
    import dataclasses

    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams, draw_frames

    base, params = bench_setup(dev, BATCH)
    cpu = torch.device("cpu")
    for i, (pattern, density) in enumerate(REGULAR_CASES):
        cfg = dataclasses.replace(base, pilots=dataclasses.replace(base.pilots, pattern=pattern))
        p = FrameParams(*params[:3], torch.full((BATCH,), density, device=dev))
        before = read_launches()
        draws = draw_frames(torch.Generator(device=dev).manual_seed(20 + i), p, cfg, device=dev)
        frames, out = run_path(dev, cfg, p, draws)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in read_launches().items()}
        for est, (h, _) in out.items():
            fail_unless(bool(torch.isfinite(h).all()), f"{pattern} {density} {est} finite")
        fail_unless(out["mmse_full"][1] < out["ls"][1], f"{pattern} {density}: mmse_full < ls")
        n = 8
        small = FrameDraws(*(x[:n].cpu() for x in draws))
        _, on_cpu = run_path(cpu, cfg, FrameParams(*(x[:n].cpu() for x in p)), small)
        _, on_card = run_path(dev, cfg, FrameParams(*(x[:n] for x in p)),
                              FrameDraws(*(x[:n] for x in draws)))
        errs = []
        for est in on_card:
            (h_card, db_card), (h_cpu, db_cpu) = on_card[est], on_cpu[est]
            fail_unless(abs(db_card - db_cpu) < 0.01,
                        f"{pattern} {density} {est} card vs CPU NMSE within 0.01 dB")
            rms = float((h_cpu.abs() ** 2).mean().sqrt())
            err = float((h_card.cpu() - h_cpu).abs().max()) / rms
            if est != "mmse_full":  # its Woodbury system: PERF.md, ROADMAP queue 3
                fail_unless(err <= 1e-4, f"{pattern} {density} {est} card vs CPU {err:.2e} <= 1e-4")
            errs.append(f"{est} {err:.1e}")
        print(f"  (e) {pattern} {density:.0%} ({int(frames.num_pilots[0])} pilots, {BATCH} frames): "
              "NMSE dB " + ", ".join(f"{est} {db:.4f}" for est, (_, db) in out.items())
              + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f"; card vs CPU on {n} frames, max error of rms: " + ", ".join(errs))


def evaluation_phase(dev, card, serving_results, tune_sets):
    """Phase 14: the evaluation path at full width, (a)-(e), with the launch
    counters read around it; each kernel it launched is held against its
    plain version on the inputs (a)-(d) gave it and on those (e) gave it;
    then the reports. Returns the launches."""
    import torch
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.eval import PilotOptimizer, generate_evaluation_report, generate_final_report

    t_phase = time.perf_counter()
    study = json.loads(open(PILOT_STUDY).read())
    cfg = config_from_dict(EXPERIMENT_CONFIG)
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_evaluation_") as workdir:
        torch.cuda.synchronize()
        reset_launches()
        with capturing() as cap:
            opt = PilotOptimizer(cfg, workdir, device=dev)
            t0 = time.perf_counter()
            res = pilot_sweep(opt, study)
            walls["sweep"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["model_sweep"] = model_sweep(dev, cfg, opt, study["model_sweep"], workdir)
            walls["model sweep"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res["ber_identifiable"] = {"ber_vs_snr": ber_study(dev, study["ber_identifiable"])}
            walls["ber"] = time.perf_counter() - t0
            opt.save(res)
            t0 = time.perf_counter()
            tuning_run(dev, workdir, tune_sets)
            walls["tuning"] = time.perf_counter() - t0
        with capturing() as cap_regular:
            t0 = time.perf_counter()
            regular_pilots(dev)
            walls["comb and block"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches()
        print("kernels launched on the evaluation path: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        fail_unless(all(n > 0 for n in launches.values()),
                    f"every kernel launched on the evaluation path: {launches}")
        fail_unless(set(cap.args) == {"hpd_solve", "interp_fused"}
                    and set(cap_regular.args) == set(launches),
                    f"the inputs captured: (a)-(d) {sorted(cap.args)}, (e) {sorted(cap_regular.args)}")
        hold_against_plain("evaluation path (a)-(d)", cap.args)
        hold_against_plain("comb and block path", cap_regular.args)

        text = generate_evaluation_report(serving_results, os.path.join(workdir, "report.md"),
                                          {"config": "configs/simo_identifiable.yaml",
                                           "frames": SERVING_FRAMES})
        fail_unless("## Improvement vs LS" in text and "| cnn_wiener |" in text,
                    "the evaluation report of phase 9's results")
        final = generate_final_report(workdir)
        fail_unless(all(f"## {n}" in final for n in ("pilot_optimization_results",
                                                     "random_search_results")),
                    "the final report of phase 14's results")
        print(f"  reports: evaluation report {len(text)} characters, final report "
              f"{len(final)} characters; written")
    print(f"phase 14 wall time: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    from ce5g_torch.device import resolve_device
    from ce5g_torch.ops import _build
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod

    wall_t0 = time.time()
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.time()
    _build.build()
    print(f"build: {time.time() - t0:.1f} s for {len(_build.KERNELS)} kernels (sm_90a)")

    check_hpd(dev)
    check_interp(dev, BATCH)
    check_slot_interp(dev, BATCH)
    cfg, params, launches, captured = main_path(dev, BATCH)
    fail_unless(all(n > 0 for n in launches.values()), f"kernels launched on the main path: {launches}")
    print("kernels launched on the main path: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check_against_cpu(dev)
    parity_launches, parity_args, parity_s = parity_path(dev)
    print("kernels launched on the parity path: "
          + ", ".join(f"{k} {v}" for k, v in parity_launches.items()))

    # 7. each kernel against its plain version on each path's inputs, then
    # times: hpd_solve and interp_fused at the main path's inputs, interp
    # at the parity path's (cubic, R = 2, P = 2096) and, printed apart, at
    # the main path's (cubic, R = 4, P = 1257)
    main_errs = hold_against_plain("main path", captured)
    parity_errs = hold_against_plain("parity path", parity_args)
    gram, rhs = captured["hpd_solve"]
    vals, mask, method = captured["interp_fused"]
    slot_args = parity_args["interp"]
    bench_slot = captured["interp"]
    b, n, r = rhs.shape
    kernels = [
        kernel_row("hpd_solve", "ce5g_torch/csrc/hpd_solve.cu",
                   "ce5g_tpu/ops/hpd_solve_pallas.py:45", launches["hpd_solve"],
                   main_errs["hpd_solve"], lambda: hpd_mod.hpd_solve(gram, rhs),
                   lambda: hpd_mod.hpd_solve_plain(gram, rhs), hpd_mod.work(b, n, r),
                   lambda: torch.linalg.solve(gram, rhs)),
        kernel_row("interp_fused", "ce5g_torch/csrc/interp_fused.cu",
                   "ce5g_tpu/ops/interp_fused_pallas.py:92", launches["interp_fused"],
                   main_errs["interp_fused"],
                   lambda: interp_mod.interpolate_grid_fused(vals, mask, method),
                   lambda: interp_mod.interpolate_grid_plain(vals, mask, method),
                   interp_mod.work(mask, vals.shape[1], method)),
        kernel_row("interp", "ce5g_torch/csrc/interp.cu",
                   "ce5g_tpu/ops/interp_pallas.py:49", parity_launches["interp"],
                   parity_errs["interp"], lambda: slot_mod.interpolate_slots(*slot_args),
                   lambda: slot_mod.interpolate_slots_plain(*slot_args),
                   slot_mod.work(*slot_args)),
    ]
    shapes = {"hpd_solve": tuple(gram.shape), "interp_fused": tuple(vals.shape),
              "interp": tuple(slot_args[0].shape) + (slot_args[-1],)}
    for kern in kernels:
        print(f"{kern['name']}: kernel {kern['ms']:.4f} ms ({kern['ms_min']:.4f}-"
              f"{kern['ms_max']:.4f} over 5 replays of a graph of 20), back-to-back calls "
              f"{kern['call_ms']:.4f} ms, plain {kern['plain_ms']:.4f} ms, "
              f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), library "
              f"{kern['library_ms'] if kern['library_ms'] is None else round(kern['library_ms'], 4)} ms "
              f"at {shapes[kern['name']]}")
    for kern in kernels[1:]:
        gap = kern["call_ms"] / kern["ms"] - 1.0
        print(f"{kern['name']}: back-to-back calls against graph replay {gap:+.1%} "
              f"({'within' if abs(gap) <= 0.05 else 'beyond'} 5%: the device, not the host, "
              f"sets both)")
        # The gaps between launches measured +1.8% to +3.2% over four runs. Twice
        # that fails: the host would then stretch the back-to-back times that
        # slower_than_replaced() compares with its records.
        fail_unless(abs(gap) <= 0.10,
                    f"{kern['name']} back-to-back calls within 10% of graph replay ({gap:+.1%})")
    one = hpd_problem(torch.Generator(device=dev).manual_seed(7), dev, 1, 1, 1)
    floor_ms = graph_ms(lambda: hpd_mod.hpd_solve(*one))
    print(f"empty-launch floor on {card}: {floor_ms[0]:.5f} ms ({floor_ms[1]:.5f}-"
          f"{floor_ms[2]:.5f}) a launch of hpd_solve at B = n = R = 1 in a graph of 20; "
          f"back-to-back calls {cuda_ms(lambda: hpd_mod.hpd_solve(*one))[0]:.5f} ms")
    bench_bound = bound(*slot_mod.work(*bench_slot))
    bench_ms = graph_ms(lambda: slot_mod.interpolate_slots(*bench_slot))
    print(f"interp at the main path's ls:cubic inputs {tuple(bench_slot[0].shape)} "
          f"P = {bench_slot[1].shape[1]}: kernel {bench_ms[0]:.4f} ms ({bench_ms[1]:.4f}-"
          f"{bench_ms[2]:.4f}), plain "
          f"{cuda_ms(lambda: slot_mod.interpolate_slots_plain(*bench_slot))[0]:.4f} ms, bound "
          f"{bench_bound[0]:.4f} ms ({bench_bound[1]})")
    slower_than_replaced(dev)

    # pipeline: fresh draws → simulate → estimate → NMSE, host clock
    gen = torch.Generator(device=dev).manual_seed(4)
    rates = {}
    for estimator, method in PIPELINES:
        for _ in range(3):
            pipeline(dev, gen, cfg, params, estimator, method)
        torch.cuda.synchronize()
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            pipeline(dev, gen, cfg, params, estimator, method)
        torch.cuda.synchronize()
        name = estimator if method == "linear" else f"{estimator}:{method}"
        rates[name] = BATCH * reps / (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    pipeline(dev, gen, cfg, params, "mmse_full")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"pipeline (draw+simulate+estimate+NMSE, batch {BATCH}): "
          + ", ".join(f"{e} {v:.1f} frames/s" for e, v in rates.items())
          + f"; peak memory {peak_gib:.2f} GiB")
    print(f"parity study wall time ({PARITY_FRAMES} frames/cell, 17 cells, first run): "
          f"{parity_s:.3f} s")
    where_a_batch_goes(dev, gen, cfg, params, rates)
    # the serving split (≈1.1 GB of arrays in .ce5g chunks, with its two
    # sidecars) is removed however phases 9-12 end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as workdir:
        t0 = time.perf_counter()
        serving_launches, ev, ds, serving_results = serving_phase(dev, card, workdir)
        where_a_serving_batch_goes(ev, ds, MODEL_BATCH)
        print(f"phases 9-10 wall time: {time.perf_counter() - t0:.1f} s")
        blind_launches = blind_phase(dev, card, workdir, ev.cfg, ds, ev, serving_results)
        training_launches, tune_sets = training_phase(dev, card, ds)
    factory_launches = factory_phase(dev, card)
    evaluation_launches = evaluation_phase(dev, card, serving_results, tune_sets)
    for kern in kernels:
        kern["launches_by_path"] = {"main": launches[kern["name"]],
                                    "parity": parity_launches[kern["name"]],
                                    "serving": serving_launches[kern["name"]],
                                    "blind": blind_launches[kern["name"]],
                                    "training": training_launches[kern["name"]],
                                    "factory": factory_launches[kern["name"]],
                                    "evaluation": evaluation_launches[kern["name"]]}
    print(f"wall time: {time.time() - wall_t0:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
