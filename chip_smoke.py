#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ce5g_torch) on one NVIDIA card.

    python3 path/to/chip_smoke.py      (from any directory)

Phases, one line each; any failure exits non-zero:
  1. setup: the card's name and power limit; build the seven CUDA kernels;
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
     path on their own frames, for three seeds, at the bench config and
     at 1x2 SIMO ETU frames at 30 dB;
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
     calls, as their recorded times were taken), the score's kernel
     (``nmse``) at the nr100_4x64 benchmark batch beside its bound and the
     plain chain, the pilot selection (``pilot_select``) at the batches of
     the three benchmark configurations beside its bound and its plain
     version, the channel and the received grid (``channel``) at the three
     benchmark configurations' batches by both routes, held to the plain
     chain and to float64, twice to the same bits, and timed beside its
     bound and the plain chain, the Wiener's pilot sums (``profile_gram``)
     at the four benchmark configurations' batches, held to the plain
     version, a frame's sums the same bits alone and in its batch, and timed
     beside its bound and the plain version, and pipeline frames/s;
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
     on 64 frames) — each mean NMSE with its σ held to the JAX package's
     results, the orderings, launch counts, each kernel the path
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
     gave it; and the evaluation and final reports written;
 15. the time-domain chain and the parallel layer: (a) 256 time-domain frames
     (simulate_batch_time_domain, batches of 64) at the bench config through
     'mmse_full', 'ls' and 'ls:cubic', each mean NMSE held to the JAX
     package's time-domain anchor and printed beside the frequency-domain
     path's on the same params, 2 frames held against the CPU, the time of a
     batch and the peak memory; (b) an NCCL process group started here at the
     world size of this one process (1): sharded_time_domain_apply on a full
     4x4 ETU frame against reference_time_domain_apply,
     sharded_eval_stats_fn('mmse_full') on 256 bench frames against the
     unsharded pipeline, dryrun_multichip(), and the cnn through
     Trainer(mesh=...) against the meshless Trainer on phase 12's split; (c)
     each kernel the phase launched held against its plain version on the
     inputs it gave it, with the launch counts;
 16. the command line, ``python -m ce5g_torch.cli.<name>``, at full width and
     cut in depth, every command but (a) in this process through
     ``main(argv)``: (a) quick_start at its defaults in a process of its own
     with no --device, mmse_full < mmse < ls; (b) generate_dataset --format
     ce5g --verify on a small SIMO split, compute_wiener for both tags and
     train_model --wiener --evaluate for 1 epoch; (c) evaluate_models and
     identifiable_study on the first 512 frames of phase 9's split, each
     NMSE within 0.01 dB of phases 9 and 11 on the same frames,
     mmse_full_blind above mmse_full_est; (e)
     diagnose_plateau on a 512-frame 2x2 split made by generate_dataset,
     the sum oracle within 0.1 dB of -3.01 dB; (f) pilot_optimization and
     parity_phase2 at 8 frames a cell; (g) train_online and
     generate_at_scale cut in depth, the card's name in
     at_scale_generation.json; (h) visualize_channels, and its arrays card
     against CPU on the same draws; (d) tune_hyperparameters (1 trial of 1
     epoch) and apply_tuning (1 epoch) on (b)'s split, then
     final_report over the phase's results, with no TPU number; each
     kernel the phase launched held against its plain version, with the
     launch counts; mmse_full on phase 9's first 256 frames at batches of
     256 and of 64, each frame's estimate within 1e-5 of its rms and its
     NMSE within 0.001 dB; and jax not imported;
 17. the port's demonstration notebook
     (notebooks/01_complete_demonstration_torch.ipynb), its cells that carry
     no 'plot' tag run in one namespace: on the card at its defaults with
     the launch counts and each kernel it launched held against its plain
     version; on the card and on the CPU at 4 frames a sweep point from the
     same draws, every NMSE within 0.01 dB; and its mmse_full at 25 and
     30 dB against the float64 plain path;
 18. the measuring tools of ce5g_torch.cli, each in this process through
     ``main(argv)`` at its defaults unless said: (a) bench (the bench
     config, fresh draws every batch, the median of 3 windows of 64 batches
     for mmse_full, ls and ls:cubic), its mmse_full within 0.15 dB of
     -1.25 dB and every field present, its frames/s printed beside phase
     8's synchronised rates, with the launch counts around it (the 'bench'
     path); (b) benchmark_suite --train (cnn at batch 64), no error cell, no
     MFU or HBM share above 1.05, the native codec, and hpd_solve against
     its plain version on the suite's HPD problem; (c) bench_factory into a
     temporary directory (an NCCL group of one rank started and destroyed
     by the command); (d) profile_bench, profile_fine (one batch a window)
     and profile_solve, every row printed;
 19. the envelope: the main path at three configurations past the
     kernels' former shape limits, at full width — a 100 MHz NR carrier
     (3GPP TS 38.101-1 Table 5.3.2-1, 273 PRB at 30 kHz: FFT 4096,
     K = 3275, 3.5 GHz; ETU 200 Hz, 10 dB, 10% pilots) at 4×4 (batch 64;
     ls, ls:cubic, mmse, mmse_full) and at 4 × 64 receive antennas (a
     64T64R panel, batch 16; ls, ls:cubic, mmse_full), and one LTE radio
     frame of 140 symbols at the bench numerology, 4×4 (batch 32; ls,
     ls:cubic, mmse_full), at ETU 200 Hz and 300 Hz, whose n = 135 and
     171 systems take the HPD cluster kernel — with NMSE (mmse_full within 0.15 dB of −1.249 dB and within
     1e-6 of the rms of its float64 run), card against CPU on the first 2
     frames at phase 5's tolerance, launches, each kernel held against its
     plain version on the inputs the path gave it and timed there (``ms``
     as in phase 7) beside its bound, peak memory; then each kernel, by
     each of its routes, against its plain version on the hard cases with
     9, 16 and 64 antennas, P past one block's shared memory, 140 symbols,
     slots that share a resource element and HPD systems past n = 128
     (every cluster size with an instance); the HPD solve past n = 128
     timed by every cluster size, the blocked kernel the cluster route
     replaced, the plain version and torch.linalg.solve, on the two LTE
     frames' systems and random ones at n = 243 and 300 (the plan's route
     no slower than the blocked kernel); last each interpolation route
     timed at the bench shapes.
Each phase prints its wall time. Then the wall time, one JSON line of
per-kernel numbers, and last the device line.

Imports neither JAX nor ce5g_tpu. Needs a CUDA card: without one it exits
non-zero and prints no result.
"""
import collections
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
# plain path on its own frames (8 frames per seed of the bench config and of
# the 1x2 SIMO case at 30 dB), max error over the rms. Each bound is 1.5
# times the largest of these errors on an H100 (card 6.60e-7, CPU 6.52e-7;
# PERF.md §6).
MMSE_FULL_SEEDS = (3, 4, 5)
MMSE_FULL_BOUND = {"card": 9.9e-7, "cpu": 9.8e-7}
# Phase 9, the serving path: the 1x2 SIMO split at the JAX package's test size.
SERVING_FRAMES = 2000
MODEL_BATCH = 32  # evaluate_model's default, as the anchors were taken
# evaluate_estimators' default, the batch the command line serves in. A
# frame's mmse_full is its own whatever the batch: phase 16 holds it to
# BATCH_MOVE_RMS of its rms and BATCH_MOVE_DB between batches of BATCH and of
# ESTIMATOR_BATCH.
ESTIMATOR_BATCH = 64
BATCH_MOVE_RMS, BATCH_MOVE_DB = 1e-5, 0.001
LSTM_FRAMES = 64  # the pure LSTM is served on its first frames, as its anchor was taken
SERVING_MODELS = ("cnn", "resnet", "hybrid", "transformer", "cnn_wiener")
# The JAX package's mean NMSE dB on its own 2000-frame SIMO test split
# (results_simo/*_test_results.json; mmse from results_simo/ORTHOGONAL_STUDY.md).
# mmse_full is the JAX package's estimator on that split in float32 on the
# CPU (tests/test_torch_anchors.py): the study's −16.26 was taken on a TPU.
# The JAX package finishes its Woodbury solve with a difference of nearly
# equal vectors over σ² (ce5g_tpu/estimators/mmse.py:409), which lifts
# mmse_full at 20-30 dB SNR in float32, and more on the TPU (−20.44 dB at
# 30 dB there, −33.35 on the CPU); the port solves without that difference
# (tests/test_torch_woodbury.py). lstm is the JAX package's checkpoint on the
# first LSTM_FRAMES frames of a split the port made on the CPU
# (tests/test_torch_anchors.py -m slow): its SIMO run stopped at epoch 5 and
# left no test result. The port draws its own split from the same laws, so
# each mean must land within SERVING_BAND_DB, or within 4σ of the port's
# mean where that is wider.
SERVING_ANCHORS_DB = {"cnn": -9.64, "resnet": -10.94, "hybrid": -9.22, "transformer": -12.47,
                      "cnn_wiener": -16.06, "mmse_full": -16.49, "mmse": -6.56,
                      "lstm": -11.72}
SERVING_BAND_DB = 0.5
MODEL_CHECK_TOL = 1e-4  # card vs CPU forward, max |diff| over the output rms
# Phase 11, blind serving: the JAX package's mean NMSE dB on its SIMO test
# split (results_simo/cnn_wiener_blind*_test_results.json; mmse_full_est, as
# mmse_full above, in float32 on the CPU, tests/test_torch_anchors.py: the
# same float32 cancellation lifts its 30 dB row to −23.78 dB in the TPU's
# study, whose mean is −13.16, and to −29.23 on the CPU), held as phase 9's
# anchors are.
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
# above it the Wiener anchors carry the JAX package's float32 cancellation,
# worse on the TPU
BER_HELD_TO_DB = 15.0
# The tuner: the JAX default of 5 epochs a trial on 2000 / 500-frame quick
# datasets of phase 12's splits, cut in depth from 20 trials to the first 3.
# Its trials read 11-18% below the JAX study's on an H100 (the same numbers
# in every run). Both packages train the first trial to within 0.2% of each
# other on one split on the CPU (tests/test_torch_studies.py -m slow), so
# the gap is the study's TPU or its split, not the port's trainer: the band
# covers what the card measured.
TUNE_TRIALS, TUNE_EPOCHS, TUNE_TRAIN, TUNE_VAL, TUNE_BAND = 3, 5, 2000, 500, 0.20
# Comb and block pilots on the main path: (pattern, density).
REGULAR_CASES = (("comb", 0.10), ("block", 0.01), ("block", 0.10), ("block", 0.15))
# Phase 15, the time-domain chain and the parallel layer. The anchors are the
# JAX package's simulate_frame_time_domain and estimators in float32 on the
# CPU, 256 frames at the bench config: (mean NMSE dB, σ of that mean dB), from
# tests/test_torch_time_domain.py::test_time_domain_anchors_are_the_jax_package.
# The card's mean must lie within TD_BAND_DB of the anchor, or 4σ of the
# difference of the two means where that is wider.
TD_ANCHORS_DB = {"mmse_full": (-1.248, 0.015), "ls": (4.849, 0.031),
                 "ls:cubic": (4.569, 0.032)}
TD_BAND_DB = 0.15
TD_FRAMES, TD_BATCH, TD_CPU_FRAMES = 256, 64, 2
TD_TOL = 1e-4  # card vs CPU, max |diff| over the rms, as the CPU tests hold the port to JAX
TD_PAIRS = (("mmse_full", "linear"), ("ls", "linear"), ("ls", "cubic"))
TD_HALO = 128
# Trainer(mesh=...) against the meshless Trainer: phase 12's split cut to 4
# steps of 64 frames a epoch, 2 epochs, float32 and no dropout.
MESH_TRAIN_FRAMES, MESH_VAL_FRAMES, MESH_EPOCHS = 256, 128, 2
MESH_RTOL = 1e-6
# Phase 16, the command line (ce5g_torch.cli) at full width, cut in depth:
# (b) a small SIMO split; (e) a 512-frame 2x2 split whose sum oracle is held
# to the analytic floor 10·log10(1/2) within 0.1 dB (the JAX study read
# -3.0127 dB on 4000 frames); (f) a few frames a cell; (g) short runs. The
# CLI's numbers on the first CLI_SERVE_FRAMES frames of phase 9's split (whole
# batches of phases 9 and 11, so the same batches) agree with those phases'
# per-sample results on the same frames within 0.01 dB.
CLI_SPLIT = {"train": 512, "val": 128, "test": 256}
CLI_CHUNK = 128
PLATEAU_FRAMES = 512
PLATEAU_FLOOR_DB, PLATEAU_BAND_DB = 10 * math.log10(0.5), 0.1
CLI_AGREE_DB = 0.01
CLI_SERVE_FRAMES = 512
CLI_STUDY_FRAMES = 8
CLI_ONLINE = {"samples": 2048, "batch": 256, "steps_per_dispatch": 4}
CLI_ATSCALE = {"samples": 8192, "chunk_size": 2048, "online_samples": 4096,
               "online_batch": 512, "steps_per_dispatch": 4, "codec_chunk": 256}
CLI_SERVED = ("cnn", "resnet", "hybrid", "transformer", "cnn_wiener")
CLI_STUDY_MODELS = CLI_SERVED + ("cnn_wiener_blind", "cnn_wiener_blind_online")
VIS_TOL = 1e-4  # card vs CPU, max |diff| over the rms, as phase 15's TD_TOL
# Phase 17, the port's demonstration notebook: its cells that carry no 'plot'
# tag, on the card at its defaults; then on the card and on the CPU with
# NOTEBOOK_CPU_B frames a sweep point (the same draws: the notebook draws on
# the CPU), every NMSE within NOTEBOOK_AGREE_DB; mmse_full at 25-30 dB within
# WIENER_F64_TOL of each frame's rms of the float64 plain path, the bound of
# tests/test_torch_woodbury.py.
NOTEBOOK = os.path.join(REPO, "notebooks", "01_complete_demonstration_torch.ipynb")
NOTEBOOK_CPU_B = 4
NOTEBOOK_AGREE_DB = 0.01
WIENER_F64_TOL = 1e-4
# Phase 19, the envelope: the 100 MHz NR carrier of 3GPP TS 38.101-1 Table
# 5.3.2-1 (273 PRB at 30 kHz: FFT 4096, CP 288, 3276 useful subcarriers, so
# K = 3275 without DC) at 3.5 GHz, with 4 TX antennas and 4 or 64 receive
# antennas (a 64T64R panel, 3GPP TR 38.901 §7.3); and one LTE radio frame
# (10 subframes, 140 symbols) at the bench numerology, at 200 Hz and at ETU
# 300 Hz (3GPP TS 36.104 Annex B.2), where mmse_full's time prior takes rank
# 15 and 19 and its system n = 135 and 171 the HPD cluster kernel: name →
# (receive antennas, symbols, carrier, Doppler Hz, batch, estimator pairs).
ENVELOPE_CONFIGS = {
    "nr100_4x4": (4, 14, "nr100", 200.0, 64, (("ls", "linear"), ("ls", "cubic"),
                                              ("mmse", "linear"), ("mmse_full", "linear"))),
    "nr100_4x64": (64, 14, "nr100", 200.0, 16, (("ls", "linear"), ("ls", "cubic"),
                                                ("mmse_full", "linear"))),
    "lte_frame_4x4": (4, 140, "bench", 200.0, 32, (("ls", "linear"), ("ls", "cubic"),
                                                   ("mmse_full", "linear"))),
    "lte_frame_etu300_4x4": (4, 140, "bench", 300.0, 32, (("ls", "linear"), ("ls", "cubic"),
                                                          ("mmse_full", "linear"))),
}
ENVELOPE_ANCHOR_DB = 10.0 * math.log10(3.0 / 4.0)  # mmse_full's 4-TX floor, −1.249 dB
ENVELOPE_CPU_FRAMES = 2  # card against CPU, and each against float64, on the first frames
ENVELOPE_FLOAT64_BOUND = 1e-6  # mmse_full against its float64 run, max error over the rms
ENVELOPE_HPD_CASES = ("r9", "r16", "r64", "r64_n128", "not_pd_r16", "n129", "n160_r64",
                      "n300_r9", "not_pd_n140", "nan_entry_n150", "last_pivot_n200", "n135_r4",
                      "n171_r4", "n243_r4", "n400_r4")
# The HPD solve past n = 128 timed route by route (phase 19) on the systems
# of the two LTE-frame configurations (n = 135, 171) and on random systems
# of mmse_full's size over one LTE radio frame at 500 Hz (time rank 27,
# n = 243), at n = 300, and at the benchmark's whole NR frame at 500 km/h
# (time rank 67, n = 603, the blocked route; one wave of 128 systems).
ENVELOPE_HPD_SHAPES = ((32, 243, 4), (32, 300, 4), (128, 603, 4))


def quiet(*_):
    pass


def run_notebook(path, params, replace=None):
    """Run the code cells of the notebook at ``path`` that carry no 'plot'
    tag, in order, in one namespace: ``params`` are set after the cell
    tagged 'parameters', and each name of ``replace`` after every cell
    that leaves it defined. Returns the namespace and the number of plot
    cells left out."""
    with open(path) as f:
        cells = [c for c in json.load(f)["cells"] if c["cell_type"] == "code"]
    ns = {"__name__": "__notebook__"}
    left_out = 0
    for i, cell in enumerate(cells):
        tags = cell["metadata"].get("tags", [])
        if "plot" in tags:
            left_out += 1
            continue
        exec(compile("".join(cell["source"]), f"{path} cell {cell.get('id', i)}", "exec"), ns)
        if "parameters" in tags:
            ns.update(params)
        ns.update({k: v for k, v in (replace or {}).items() if k in ns})
    return ns, left_out


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
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over its float32 peak, from the card's published
    peaks (ce5g_torch.utils.profiling.CARD_PEAKS)."""
    from ce5g_torch.utils.profiling import card_peaks, work_bound

    peaks = card_peaks("cuda")
    fail_unless(peaks is not None, "the card's peaks are in ce5g_torch.utils.profiling.CARD_PEAKS")
    return work_bound(nbytes, flops, peaks)


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


def rel_max(a, b):
    """max |a − b| over the rms of b."""
    return float((a - b).abs().max() / b.abs().pow(2).mean().sqrt())


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
        import ce5g_torch.ops.channel as channel_mod
        import ce5g_torch.ops.nmse as nmse_mod
        import ce5g_torch.physics.pilots as pilots_mod

        self.sites = [(mmse_est, "hpd_solve", "hpd_solve"),
                      (mmse_est, "profile_gram", "profile_gram"),
                      (interp_est, "interpolate_grid_fused", "interp_fused"),
                      (interp_est, "interpolate_slots", "interp"),
                      (nmse_mod, "nmse", "nmse"),
                      (pilots_mod, "pilot_select", "pilot_select"),
                      (channel_mod, "channel", "channel")]
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


_launch_base = collections.Counter()  # the port's counters at the last reset_launches()
#: the estimators' kernels; ``nmse`` launches only where a path scores with
#: ``utils.metrics.nmse``
ESTIMATOR_KERNELS = ("hpd_solve", "interp_fused", "interp")


def reset_launches():
    """Count the kernels' launches from here on (``read_launches``)."""
    from ce5g_torch.utils import profiling

    global _launch_base
    _launch_base = profiling.counters.copy()


def read_launches():
    """Each kernel's launches since the last ``reset_launches``, all routes
    (``utils.profiling.counters``)."""
    from ce5g_torch.ops import _build
    from ce5g_torch.utils import profiling

    moved = profiling.counters - _launch_base
    return {k: profiling.launches(k, moved) for k in _build.KERNELS}


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
    from ce5g_torch.estimators.time_prior import auto_time_rank
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


def simo_setup(dev, b):
    """The 1x2 SIMO config and ``b`` frames of ETU at 50 Hz, 30 dB and 10%
    pilots: one TX antenna, so no superposition floor hides mmse_full's
    float32 error at high SNR."""
    import torch
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.physics import PROFILE_INDEX, FrameParams

    params = FrameParams(
        torch.full((b,), PROFILE_INDEX["ETU"], dtype=torch.int32, device=dev),
        torch.full((b,), 50.0, device=dev),
        torch.full((b,), 30.0, device=dev),
        torch.full((b,), 0.1, device=dev),
    )
    return config_from_dict(SIMO_CONFIG), params


def check_against_cpu(dev, b=8):
    """The main path on the card against the same path on the CPU (the
    kernels' plain versions) with the same draws, on a small batch. Both
    float32 results of mmse_full are held instead to the float64 plain path
    on their own frames, at the bench config and at the SIMO case of
    :func:`simo_setup`, for each of MMSE_FULL_SEEDS: the two devices' float32
    roundings differ, and the float64 path bounds each."""
    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams, draw_frames

    cpu = torch.device("cpu")
    parts, full = [], {}
    for case, setup in (("bench", bench_setup), ("SIMO 30 dB", simo_setup)):
        cfg, params = setup(dev, b)
        cpu_params = FrameParams(*(x.cpu() for x in params))
        for seed in MMSE_FULL_SEEDS:
            draws = draw_frames(torch.Generator(device=dev).manual_seed(seed), params, cfg,
                                device=dev)
            pairs = ((MAIN_PAIRS + (("mmse", "cubic"),))
                     if case == "bench" and seed == MMSE_FULL_SEEDS[0]
                     else (("mmse_full", "linear"),))
            card_frames, on_card = run_path(dev, cfg, params, draws, pairs)
            cpu_frames, on_cpu = run_path(cpu, cfg, cpu_params,
                                          FrameDraws(*(x.cpu() for x in draws)), pairs)
            for est in on_card:
                (h_card, db_card), (h_cpu, db_cpu) = on_card[est], on_cpu[est]
                fail_unless(abs(db_card - db_cpu) < 0.01,
                            f"{est} card vs CPU NMSE within 0.01 dB ({case}, seed {seed})")
                if est != "mmse_full":
                    rms = float((h_cpu.abs() ** 2).mean().sqrt())
                    err = float((h_card.cpu() - h_cpu).abs().max()) / rms
                    fail_unless(err <= 1e-4,
                                f"{est} card vs CPU max error {err:.2e} of rms <= 1e-4")
                    parts.append(f"{est} {err:.2e}")
            for where, frames, h in (("card", card_frames, on_card["mmse_full"][0]),
                                     ("cpu", cpu_frames, on_cpu["mmse_full"][0])):
                ref = mmse_full_float64(cfg, frames)
                rms = float((ref.abs() ** 2).mean().sqrt())
                err = float((h.cpu().to(ref.dtype) - ref).abs().max()) / rms
                fail_unless(err <= MMSE_FULL_BOUND[where],
                            f"mmse_full on the {where} vs float64: max error {err:.2e} of rms "
                            f"<= {MMSE_FULL_BOUND[where]} ({case}, seed {seed})")
                full.setdefault((case, where), []).append(err)
    print(f"card vs CPU on {b} frames, max error of rms: " + ", ".join(parts))
    print(f"mmse_full vs the float64 plain path on {b} frames, max error of rms for seeds "
          f"{', '.join(map(str, MMSE_FULL_SEEDS))}: "
          + "; ".join(f"{case} {where} " + " ".join(f"{e:.3e}" for e in errs)
                      + f" (bound {MMSE_FULL_BOUND[where]})"
                      for (case, where), errs in full.items())
          + "; NMSE card vs CPU within 0.01 dB")


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
    from ce5g_torch.ops import channel as channel_mod
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as interp_mod
    from ce5g_torch.ops import nmse as nmse_mod
    from ce5g_torch.ops import pilot_select as select_mod
    from ce5g_torch.ops import profile_gram as gram_mod

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
    if "nmse" in captured:
        h, e, axes = captured["nmse"]
        got, plain = nmse_mod.nmse(h, e, axes), nmse_mod.nmse_plain(h, e, axes)
        want = nmse_float64(h, e, axes)
        errs["nmse"] = float((got - plain).abs().max())
        got_rel = float(((got.double() - want).abs() / want.abs()).max())
        plain_rel = float(((plain.double() - want).abs() / want.abs()).max())
        parts.append(f"nmse {tuple(h.shape)} axes {axes} max abs vs plain {errs['nmse']:.3e}, "
                     f"relative to float64 {got_rel:.3e} (plain {plain_rel:.3e})")
        fail_unless(got_rel <= 1e-6,
                    f"{path} nmse within 1e-6 of its float64 value ({got_rel:.2e})")
    if "pilot_select" in captured:
        u, n, s, k, p_max = captured["pilot_select"]
        got = select_mod.pilot_select(u, n, s, k, p_max)
        want = select_mod.pilot_select_plain(u, n, s, k, p_max)
        errs["pilot_select"] = sum(int((a != b).sum()) for a, b in zip(got, want))
        parts.append(f"pilot_select {tuple(u.shape)} pilots {int(n.min())}-{int(n.max())} "
                     f"elements that differ {errs['pilot_select']}")
        fail_unless(errs["pilot_select"] == 0, f"{path} pilot_select equals its plain version")
    if "channel" in captured:
        args = captured["channel"]
        (h, rx), (hp, rxp) = channel_mod.channel(*args), channel_mod.channel_plain(*args)
        e_h, e_rx = rel_max(h, hp), rel_max(rx, rxp)
        errs["channel"] = max(float((h - hp).abs().max()), float((rx - rxp).abs().max()))
        parts.append(f"channel {tuple(h.shape)} {channel_mod.route_of(args[3])} max error over "
                     f"the rms vs plain: H {e_h:.2e}, rx {e_rx:.2e}")
        fail_unless(e_h <= CHANNEL_H_LIMIT and e_rx <= CHANNEL_RX_LIMIT,
                    f"{path} channel within {CHANNEL_H_LIMIT:g} (H) and {CHANNEL_RX_LIMIT:g} "
                    f"(rx) of the plain chain")
        del h, rx, hp, rxp
    if "profile_gram" in captured:
        args = captured["profile_gram"]
        (e, d), (ep, dp) = gram_mod.profile_gram(*args), gram_mod.profile_gram_plain(*args)
        e_e, e_d = rel_max(e, ep), rel_max(d, dp)
        errs["profile_gram"] = max(float((e - ep).abs().max()), float((d - dp).abs().max()))
        parts.append(f"profile_gram {tuple(args[0].shape)} {gram_mod.plan(args[0], args[3]).route} "
                     f"max error over the rms vs plain: E {e_e:.2e}, D {e_d:.2e}")
        fail_unless(max(e_e, e_d) <= PROFILE_GRAM_LIMIT,
                    f"{path} profile_gram within {PROFILE_GRAM_LIMIT:g} of its plain version")
        del e, d, ep, dp
    print(f"{path} inputs, kernel vs plain: " + "; ".join(parts))
    return errs


def nmse_float64(h, e, axes=None):
    """The NMSE of H and Ĥ in float64: ``ops.nmse``'s plain expression on
    complex128, over every axis a frame at a time."""
    import torch
    from ce5g_torch.ops import nmse as nmse_mod

    def wide(x):
        return x.to(torch.complex128)

    if axes is not None:
        return nmse_mod.nmse_plain(wide(h), wide(e), axes)
    e = e.expand(h.shape)
    err = sum(float(((wide(hi) - wide(ei)).abs() ** 2).sum()) for hi, ei in zip(h, e))
    pwr = sum(float((wide(hi).abs() ** 2).sum()) for hi in h)
    return torch.tensor((err / h.numel()) / (pwr / h.numel() + 1e-12), dtype=torch.float64,
                        device=h.device)


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


#: the score's shape at the benchmark's nr100_4x64 batch (the main path's
#: kernel row has the bench_4x4 batch)
NMSE_NR100 = (64, 14, 64, 4, 3275)


def nmse_times(dev):
    """The score's kernel at the nr100_4x64 batch beside its bound and the
    plain chain (back to back), held to float64, on three layouts: Ĥ
    broadcast along TX from a (B, R, S, K) array as the LS estimators
    return it; a contiguous Ĥ of H's shape; one TX antenna (T = 1) with a
    contiguous (B, S, R, K) Ĥ, as mmse_full returns it on a SIMO
    configuration. In the last two everything merges into one line, which
    the plan cuts into pieces; the kernel must beat the chain on each."""
    import torch
    from ce5g_torch.ops import nmse as nmse_mod

    gen = torch.Generator(device=dev).manual_seed(18)
    b, s, r, t, k = NMSE_NR100

    def broadcast(tt):
        e = torch.randn(b, r, s, k, dtype=torch.complex64, device=dev, generator=gen)
        return e.transpose(1, 2)[:, :, :, None, :].expand(b, s, r, tt, k)

    def contiguous(tt):
        return torch.randn(b, s, r, tt, k, dtype=torch.complex64, device=dev, generator=gen)

    def one_antenna(tt):
        e = torch.randn(b, s, r, k, dtype=torch.complex64, device=dev, generator=gen)
        return e[:, :, :, None, :].expand(b, s, r, tt, k)

    for label, tt, make in (("Ĥ broadcast along TX", t, broadcast),
                            ("Ĥ contiguous", t, contiguous),
                            ("one TX antenna, Ĥ contiguous", 1, one_antenna)):
        shape = (b, s, r, tt, k)
        h = torch.randn(*shape, dtype=torch.complex64, device=dev, generator=gen)
        e = make(tt)
        pl = nmse_mod.plan(h, e)
        ms = graph_ms(lambda: nmse_mod.nmse(h, e))
        plain = cuda_ms(lambda: nmse_mod.nmse_plain(h, e))
        bound_ms, by = bound(*nmse_mod.work(h, e))
        rel = abs(float(nmse_mod.nmse(h, e)) / float(nmse_float64(h, e)) - 1.0)
        print(f"nmse at {shape}, {label}: kernel {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), "
              f"bound {bound_ms:.4f} ms ({by}), {100.0 * bound_ms / ms[0]:.1f}% of it; plain "
              f"chain {plain[0]:.4f} ms; route {pl.route}, team {pl.team}, grid {pl.grid}, "
              f"{pl.chunks} work items, {pl.pieces} pieces a line; relative to float64 "
              f"{rel:.2e}")
        fail_unless(rel <= 1e-6, f"nmse at {shape}, {label}, within 1e-6 of float64")
        fail_unless(ms[0] < plain[0], f"nmse at {shape}, {label}, faster than the plain chain")
        del h, e
        torch.cuda.empty_cache()


#: (B, S, K) of the benchmark's configurations: bench_4x4, nr100_4x64,
#: lte_frame_etu300_4x4
PILOT_SHAPES = ((256, 14, 599), (64, 14, 3275), (512, 140, 599))


def pilot_select_times(dev):
    """The pilot selection at each benchmark configuration's batch (10%
    pilots, 15% slots) beside its bound and its plain version (back to
    back), equal to the plain version and faster than it."""
    import torch
    from ce5g_torch.ops import pilot_select as select_mod
    from ce5g_torch.physics.pilots import num_pilots_for

    gen = torch.Generator(device=dev).manual_seed(20)
    for b, s, k in PILOT_SHAPES:
        u = torch.rand(b, s * k, generator=gen, device=dev)
        n = num_pilots_for(s, k, 0.1).to(dev).expand(b).contiguous()
        p_max = int(s * k * 0.15)
        pl = select_mod.plan(u)
        got = select_mod.pilot_select(u, n, s, k, p_max)
        want = select_mod.pilot_select_plain(u, n, s, k, p_max)
        differ = sum(int((a != c).sum()) for a, c in zip(got, want))
        ms = graph_ms(lambda: select_mod.pilot_select(u, n, s, k, p_max))
        plain = cuda_ms(lambda: select_mod.pilot_select_plain(u, n, s, k, p_max))
        bound_ms, by = bound(*select_mod.work(b, s * k, p_max))
        print(f"pilot_select at ({b}, {s * k}): kernel {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), "
              f"bound {bound_ms:.4f} ms ({by}), {100.0 * bound_ms / ms[0]:.1f}% of it; plain "
              f"{plain[0]:.4f} ms; route {pl.route}, cluster {pl.cluster}, {pl.threads} threads, "
              f"grid {pl.grid}; elements that differ from the plain version {differ}")
        fail_unless(differ == 0, f"pilot_select at ({b}, {s * k}) equals its plain version")
        fail_unless(ms[0] < plain[0], f"pilot_select at ({b}, {s * k}) faster than its plain version")
        del u, got, want
        torch.cuda.empty_cache()


#: (B, S, R, T, K) of the benchmark's configurations: bench_4x4, nr100_4x64,
#: lte_frame_etu300_4x4
CHANNEL_SHAPES = ((256, 14, 4, 4, 599), (64, 14, 64, 4, 3275), (512, 140, 4, 4, 599))
#: frames of each shape held to float64
CHANNEL_FLOAT64_FRAMES = 4
#: the kernel against the plain chain and against float64, max error over the
#: rms: ≈ 2.4× the largest reading at the three shapes (1.26e-6, rx at the LTE
#: frame against the plain chain, whose own error against float64 reads up
#: to 9.4e-7)
CHANNEL_H_LIMIT = 3e-6
CHANNEL_RX_LIMIT = 3e-6


def channel_inputs(gen, dev, b, s, r, t, k, route):
    """The channel's inputs at one shape: gains laid out as the Jakes stage
    returns them, the configuration's profile table and a mix of its three
    profiles, a TX grid by ``route``, SNRs of 0-30 dB and noise."""
    import torch
    from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
    from ce5g_torch.physics.simulate import table_for, table_tensors

    fft = 1 << (k + 1).bit_length()
    cfg = ExperimentConfig(ofdm=OFDMConfig(fft_size=fft, num_symbols=s, useful_subcarriers=k + 1),
                           mimo=MIMOConfig(num_tx=t, num_rx=r))
    _, f_table = table_tensors(table_for(cfg), cfg, dev)
    p = f_table.shape[1]
    raw = torch.randn(b, s, p, r, t, 2, generator=gen, device=dev)
    gains = torch.view_as_complex(raw).permute(0, 1, 3, 4, 2)  # (B, S, R, T, P)
    pidx = torch.randint(0, f_table.shape[0], (b,), generator=gen, device=dev)
    phase = 2.0 * math.pi * torch.rand(b, s, 1 if route == "common" else t, k, generator=gen,
                                       device=dev)
    tx = torch.exp(1j * phase).to(torch.complex64)
    snr = 30.0 * torch.rand(b, generator=gen, device=dev)
    nre = torch.randn(b, s, r, k, generator=gen, device=dev)
    nim = torch.randn(b, s, r, k, generator=gen, device=dev)
    return gains, f_table, pidx, tx, snr, nre, nim


def channel_float64(gains, f_table, pidx, tx, snr, nre, nim):
    """H and rx of the plain chain's formulas in float64."""
    import torch

    g = gains.to(torch.complex128)
    h = torch.einsum("bsrtp,bpk->bsrtk", g, f_table.to(torch.complex128)[pidx])
    x = tx.to(torch.complex128).expand(h.shape[0], h.shape[1], h.shape[3], h.shape[4])
    y = torch.einsum("bsrtk,bstk->bsrk", h, x)
    std = torch.sqrt((y.abs() ** 2).mean(dim=(1, 2, 3)) / 10.0 ** (snr.double() / 10.0) / 2.0)
    return h, y + torch.complex(nre.double(), nim.double()) * std[:, None, None, None]


def channel_times(dev):
    """The channel and the received grid at each benchmark configuration's
    batch by both routes: against the plain chain and, on the first frames,
    float64 (max error over the rms within CHANNEL_H_LIMIT and
    CHANNEL_RX_LIMIT), twice to the same bits, and timed beside its bound
    and the plain chain (back to back), which it must beat."""
    import torch
    from ce5g_torch.ops import channel as channel_mod

    gen = torch.Generator(device=dev).manual_seed(22)
    for shape in CHANNEL_SHAPES:
        for route in channel_mod.ROUTES:
            args = channel_inputs(gen, dev, *shape, route)
            pl = channel_mod.plan(args[0], args[3])
            h, rx = channel_mod.channel(*args)
            again = channel_mod.channel(*args)
            same = torch.equal(h, again[0]) and torch.equal(rx, again[1])
            del again
            hp, rxp = channel_mod.channel_plain(*args)
            e_h, e_rx = rel_max(h, hp), rel_max(rx, rxp)
            del hp, rxp
            f = CHANNEL_FLOAT64_FRAMES
            first = [a[:f] for a in args]
            h64, rx64 = channel_float64(*first)
            hp, rxp = channel_mod.channel_plain(*first)
            k_h, k_rx = rel_max(h[:f], h64), rel_max(rx[:f], rx64)
            p_h, p_rx = rel_max(hp, h64), rel_max(rxp, rx64)
            del h, rx, hp, rxp, h64, rx64
            torch.cuda.empty_cache()
            ms = graph_ms(lambda: channel_mod.channel(*args))
            plain = cuda_ms(lambda: channel_mod.channel_plain(*args), rounds=3, iters=5)
            bound_ms, by = bound(*channel_mod.work(args[0], args[3]))
            print(f"channel at {shape} {route}: kernel {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), "
                  f"bound {bound_ms:.4f} ms ({by}), {100.0 * bound_ms / ms[0]:.1f}% of it; plain "
                  f"chain {plain[0]:.4f} ms; {pl.threads} threads x {pl.tiles} tiles, "
                  f"{pl.group} (s, r) rows a block, grid {pl.grid}; max error over the rms: vs "
                  f"plain H {e_h:.2e}, rx {e_rx:.2e}; vs float64 on {CHANNEL_FLOAT64_FRAMES} "
                  f"frames H {k_h:.2e}, rx {k_rx:.2e} (plain {p_h:.2e}, {p_rx:.2e}); two calls "
                  f"{'equal' if same else 'DIFFER'}")
            fail_unless(same, f"channel at {shape} {route}: two calls give the same bits")
            fail_unless(max(e_h, k_h) <= CHANNEL_H_LIMIT and max(e_rx, k_rx) <= CHANNEL_RX_LIMIT,
                        f"channel at {shape} {route} within {CHANNEL_H_LIMIT:g} (H) and "
                        f"{CHANNEL_RX_LIMIT:g} (rx) of the plain chain and of float64")
            fail_unless(ms[0] < plain[0], f"channel at {shape} {route} faster than the plain chain")
            del args
            torch.cuda.empty_cache()


#: (B, S, R, K) of the benchmark's configurations: bench_4x4, nr100_4x64,
#: lte_frame_etu300_4x4, factory_2x2 (each frame its own profile there)
PROFILE_GRAM_SHAPES = ((256, 14, 4, 599), (64, 14, 64, 3275), (512, 140, 4, 599),
                       (2048, 14, 2, 599))
#: E and D of the kernel against the plain version, max error over the rms:
#: both add the same terms in float64 in other orders, and the kernel's
#: quotients may round by an ulp where the two divisions contract otherwise
PROFILE_GRAM_LIMIT = 1e-6


def profile_gram_inputs(gen, dev, b, s, r, k):
    """The pilot sums' inputs at one shape: a received grid of normals, a
    unit TX grid, 10% pilots (1-10% a frame at factory_2x2's), ETU frames
    (each frame its own profile at factory_2x2's) and the configuration's
    profile tables; and each frame's live paths and pilots for the bound."""
    import torch
    from ce5g_torch import ExperimentConfig, MIMOConfig, OFDMConfig
    from ce5g_torch.ops import profile_gram as gram_mod
    from ce5g_torch.physics.profiles import PROFILE_INDEX
    from ce5g_torch.physics.simulate import table_for, table_tensors

    fft = 1 << (k + 1).bit_length()
    cfg = ExperimentConfig(ofdm=OFDMConfig(fft_size=fft, num_symbols=s, useful_subcarriers=k + 1),
                           mimo=MIMOConfig(num_tx=r, num_rx=r))
    table = table_for(cfg)
    amp, _ = table_tensors(table, cfg, dev)
    tables = gram_mod.build_f_tables(table.freq_response, dev)
    mixed = (b, s, r, k) == PROFILE_GRAM_SHAPES[-1]
    if mixed:
        pidx = torch.randint(0, tables.num_profiles, (b,), generator=gen, device=dev)
        density = torch.tensor([0.01, 0.02, 0.05, 0.10], device=dev)[
            torch.randint(0, 4, (b,), generator=gen, device=dev)]
    else:
        pidx = torch.full((b,), PROFILE_INDEX["ETU"], dtype=torch.int64, device=dev)
        density = torch.full((b,), 0.10, device=dev)
    rx = torch.complex(torch.randn(b, s, r, k, generator=gen, device=dev),
                       torch.randn(b, s, r, k, generator=gen, device=dev))
    tx = torch.exp(2j * math.pi * torch.rand(b, s, k, generator=gen, device=dev)).to(
        torch.complex64)
    mask = (torch.rand(b, s, k, generator=gen, device=dev) < density[:, None, None]).float()
    paths = (amp[pidx] > 0).sum(-1).tolist()
    pilots = mask.sum((1, 2)).long().tolist()
    return (rx, tx, mask, tables, pidx), paths, pilots


def profile_gram_times(dev):
    """The Wiener's pilot sums at each benchmark configuration's batch:
    against the plain version (E and D within PROFILE_GRAM_LIMIT of the
    rms), a few frames summed alone to the same bits as in their batch, and
    timed beside the bound of ``work/profile_gram.py``'s count and the plain
    version (back to back), which it must beat. The first, second and last
    frame of each batch are summed again alone."""
    import torch
    from ce5g_torch.ops import profile_gram as gram_mod

    gen = torch.Generator(device=dev).manual_seed(24)
    for shape in PROFILE_GRAM_SHAPES:
        args, paths, pilots = profile_gram_inputs(gen, dev, *shape)
        rx, tx, mask, tables, pidx = args
        pl = gram_mod.plan(rx, tables)
        e, d = gram_mod.profile_gram(*args)
        ep, dp = gram_mod.profile_gram_plain(*args)
        e_e, e_d = rel_max(e, ep), rel_max(d, dp)
        del ep, dp
        alone = True
        for i in (0, 1, shape[0] - 1):
            one = gram_mod.profile_gram(rx[i:i + 1], tx[i:i + 1], mask[i:i + 1], tables,
                                        pidx[i:i + 1])
            alone = alone and torch.equal(one[0][0], e[i]) and torch.equal(one[1][0], d[i])
        del e, d
        torch.cuda.empty_cache()
        ms = graph_ms(lambda: gram_mod.profile_gram(*args))
        plain = cuda_ms(lambda: gram_mod.profile_gram_plain(*args), rounds=3, iters=5)
        torch.cuda.empty_cache()
        b, s, r, k = shape
        bound_ms, by = bound(*gram_mod.work(s, r, k, paths, pilots))
        print(f"profile_gram at {shape}: kernel {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f}), bound "
              f"{bound_ms:.4f} ms ({by}), {100.0 * bound_ms / ms[0]:.1f}% of it; plain "
              f"{plain[0]:.4f} ms; route {pl.route}, {pl.groups} tasks a row of {pl.rows} "
              f"antennas, {pl.round_rows} a round, {pl.strides} threads a path, "
              f"{pl.chunk} pilots staged, {pl.shared} B shared, {pl.tasks} tasks; pilots a frame "
              f"{min(pilots)}-{max(pilots)}, paths {min(paths)}-{max(paths)}; max error over "
              f"the rms vs plain E {e_e:.2e}, D {e_d:.2e}; frames alone "
              f"{'the same bits' if alone else 'DIFFER'}")
        fail_unless(max(e_e, e_d) <= PROFILE_GRAM_LIMIT,
                    f"profile_gram at {shape} within {PROFILE_GRAM_LIMIT:g} of its plain version")
        fail_unless(alone, f"profile_gram at {shape}: a frame's sums alone equal its batch's")
        fail_unless(ms[0] < plain[0], f"profile_gram at {shape} faster than its plain version")
        del args, rx, tx, mask
        torch.cuda.empty_cache()


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
    results.update(evaluate_estimators(ds, cfg, ("ls", "mmse", "mmse_full"),
                                       batch_size=ESTIMATOR_BATCH, device=dev))
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


def by_snr(results, names, snr_db):
    """Print each of ``names``' mean NMSE dB by SNR over the frames it
    scored (the first frames of the split, whose SNRs are ``snr_db``)."""
    import numpy as np

    for name in names:
        r = results[name]
        p = np.asarray(r.get("per_sample_nmse", r.get("per_sample")), np.float64)
        snr = np.asarray(snr_db)[:len(p)]
        print(f"  {name} by SNR, dB: " + ", ".join(
            f"{s:g}: {10 * np.log10(p[snr == s].mean()):.3f}" for s in np.unique(snr)))


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
    print(f"serving path (1x2 SIMO, {SERVING_FRAMES} frames, the sidecar in batches of {BATCH}, "
          f"the estimators of {ESTIMATOR_BATCH}, models in "
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
    by_snr(results, ("mmse_full", "cnn_wiener"), ds.arrays["snr_db"])
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
    launch counters read around it. Returns the launches and the blind
    path's results, by name."""
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
    by_snr(results, BLIND_ANCHORS_DB, ds.arrays["snr_db"])
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
    return launches, results


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
        # (e) draws regular pilots: no scattered selection
        fail_unless(set(cap.args) == {"hpd_solve", "interp_fused", "pilot_select", "channel",
                                      "profile_gram"}
                    and set(cap_regular.args) == set(launches) - {"pilot_select"},
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


def per_frame_nmse(channel, h):
    """(B,) NMSE of each frame's estimate over its own channel power."""
    axes = tuple(range(1, channel.ndim))
    return (channel - h).abs().pow(2).mean(dim=axes) / channel.abs().pow(2).mean(dim=axes)


def td_estimates(dev, cfg, frames):
    """{name: (B,) per-frame NMSE} of each of TD_PAIRS on ``frames``."""
    from ce5g_torch.estimators import estimate_batch

    out = {}
    for est, method in TD_PAIRS:
        h = estimate_batch(frames, cfg=cfg, estimator=est, method=method, device=dev)
        out[est if method == "linear" else f"{est}:{method}"] = per_frame_nmse(frames.channel, h)
    return out


def time_domain_frames(dev, card):
    """Phase 15 (a): TD_FRAMES time-domain frames at the bench config in
    batches of TD_BATCH, their NMSE held to TD_ANCHORS_DB and printed beside
    the frequency-domain path's on the same params, TD_CPU_FRAMES frames
    against the CPU, and times and peak memory."""
    import torch
    from ce5g_torch.physics import (FrameDraws, FrameParams, draw_frames, simulate_batch,
                                    simulate_batch_time_domain)

    cfg, params = bench_setup(dev, TD_BATCH)
    names = [est if m == "linear" else f"{est}:{m}" for est, m in TD_PAIRS]
    td = {n: [] for n in names}
    fd = {n: [] for n in names}
    gen = torch.Generator(device=dev).manual_seed(15)
    fd_gen = torch.Generator(device=dev).manual_seed(16)
    sim_ms, batch_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TD_FRAMES // TD_BATCH):
        draws = draw_frames(gen, params, cfg, device=dev, time_domain=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        frames = simulate_batch_time_domain(draws, params, cfg=cfg, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for n, v in td_estimates(dev, cfg, frames).items():
            td[n].append(v)
        torch.cuda.synchronize()
        sim_ms.append((t2 - t1) * 1e3)
        batch_ms.append((time.perf_counter() - t1) * 1e3)
    wall_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for _ in range(TD_FRAMES // TD_BATCH):
        frames = simulate_batch(draw_frames(fd_gen, params, cfg, device=dev), params, cfg=cfg,
                                device=dev)
        for n, v in td_estimates(dev, cfg, frames).items():
            fd[n].append(v)
    parts = []
    for n in names:
        got, sigma = mean_db(torch.cat(td[n]).cpu().numpy())
        fd_db, _ = mean_db(torch.cat(fd[n]).cpu().numpy())
        anchor, anchor_sigma = TD_ANCHORS_DB[n]
        band = max(TD_BAND_DB, 4 * math.hypot(sigma, anchor_sigma))
        fail_unless(abs(got - anchor) <= band,
                    f"time-domain {n} {got:.3f} dB within {band:.3f} dB of the JAX package's "
                    f"{anchor:.3f} dB")
        parts.append(f"{n} {got:.4f} (σ {sigma:.4f}; JAX {anchor:+.3f} ± {band:.3f}; frequency "
                     f"domain {fd_db:.4f})")
    print(f"  (a) time-domain frames, 4x4 ETU 200 Hz 10 dB 10% pilots, {TD_FRAMES} frames in "
          f"batches of {TD_BATCH}: NMSE dB " + "; ".join(parts))
    print(f"      {wall_s:.2f} s for {TD_FRAMES} frames and their estimates on {card}; a batch of "
          f"{TD_BATCH}: simulated in {statistics.median(sim_ms):.1f} ms, with the three estimates "
          f"{statistics.median(batch_ms):.1f} ms (median of {len(sim_ms)}; first "
          f"{sim_ms[0]:.1f} / {batch_ms[0]:.1f} ms); peak memory {peak_gib:.2f} GiB")

    # the same draws on the card and on the CPU
    n = TD_CPU_FRAMES
    small = FrameDraws(*(x[:n] for x in draws))
    small_params = FrameParams(*(x[:n] for x in params))
    on_card = simulate_batch_time_domain(small, small_params, cfg=cfg, device=dev)
    on_cpu = simulate_batch_time_domain(FrameDraws(*(x.cpu() for x in small)),
                                        FrameParams(*(x.cpu() for x in small_params)),
                                        cfg=cfg, device="cpu")
    errs = []
    for field in ("channel", "rx_symbols"):
        card_x, cpu_x = getattr(on_card, field).cpu(), getattr(on_cpu, field)
        err = float((card_x - cpu_x).abs().max() / cpu_x.abs().pow(2).mean().sqrt())
        fail_unless(err <= TD_TOL, f"time-domain {field} card vs CPU {err:.2e} of rms <= {TD_TOL}")
        errs.append(f"{field} {err:.2e}")
    print(f"      card vs CPU on {n} frames, max error of rms: " + ", ".join(errs)
          + f" (bound {TD_TOL})")


def parallel_layer(dev, card, tune_sets, workdir):
    """Phase 15 (b): the parallel layer in this process, an NCCL process
    group of world size 1 started here and destroyed however it ends."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.eval import QuickDataset
    from ce5g_torch.parallel import (dryrun_multichip, init_process_group, make_mesh,
                                     mesh_shape, reference_time_domain_apply,
                                     sharded_eval_stats_fn, sharded_time_domain_apply)
    from ce5g_torch.physics import (PROFILE_INDEX, FrameParams, draw_frames,
                                    jakes_oscillator_params, simulate_batch, table_for)
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.train import Trainer

    init_process_group(dev.type)
    try:
        world = dist.get_world_size()
        mesh = make_mesh(device=dev.type)
        print(f"  (b) parallel layer: {dist.get_backend()} process group, world size {world}, "
              f"mesh {mesh_shape(mesh)}; worlds 2 and 4 are held on the CPU under gloo "
              "(tests/test_torch_parallel.py)")

        cfg, params = bench_setup(dev, BATCH)
        table = table_for(cfg)
        pi = PROFILE_INDEX["ETU"]
        gen = torch.Generator(device=dev).manual_seed(17)
        r, t = cfg.mimo.num_rx, cfg.mimo.num_tx
        n = cfg.ofdm.num_symbols * cfg.ofdm.samples_per_symbol
        x = torch.complex(torch.randn((t, n), generator=gen, device=dev),
                          torch.randn((t, n), generator=gen, device=dev))
        angles, phases = jakes_oscillator_params(gen, len(table.delay_samples[pi]), r, t,
                                                 cfg.channel.num_oscillators, dev)
        amp, delays, valid = (torch.as_tensor(a, device=dev) for a in (
            table.amp_overwrite[pi], table.delay_samples[pi], table.path_valid[pi]))
        args = (angles, phases, 200.0, amp, delays, valid, cfg.ofdm.sampling_rate, r, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = sharded_time_domain_apply(mesh, x, *args, halo=TD_HALO)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        mono = reference_time_domain_apply(x, *args)
        err = float((sharded - mono).abs().max())
        fail_unless(tuple(sharded.shape) == (r, n // world) and err <= 2e-4,
                    f"sharded_time_domain_apply vs reference: shape {tuple(sharded.shape)}, max "
                    f"abs error {err:.2e} <= 2e-4")
        print(f"      sharded_time_domain_apply, one 4x4 ETU frame (N = {n}, halo {TD_HALO}): "
              f"max abs error {err:.2e} against reference_time_domain_apply (atol 2e-4); "
              f"{t_sharded * 1e3:.1f} ms")

        draws = draw_frames(gen, params, cfg, device=dev)
        t0 = time.perf_counter()
        stats = sharded_eval_stats_fn(cfg, mesh, "mmse_full", device=dev)(params, draws)
        nmse = float(stats["nmse"])
        t_stats = time.perf_counter() - t0
        frames = simulate_batch(draws, params, cfg=cfg, device=dev)
        plain = float(per_frame_nmse(frames.channel, estimate_batch(
            frames, cfg=cfg, estimator="mmse_full", device=dev)).mean())
        fail_unless(abs(nmse - plain) <= 2e-4 * plain,
                    f"sharded mmse_full NMSE {nmse:.6f} within rtol 2e-4 of {plain:.6f}")
        print(f"      sharded_eval_stats_fn(mmse_full), {BATCH} bench frames: NMSE {nmse:.6f} "
              f"({float(stats['nmse_db']):.4f} dB), unsharded {plain:.6f} (rtol 2e-4); BER "
              f"{float(stats['ber']):.3e}; {t_stats:.2f} s")

        t0 = time.perf_counter()
        dry = dryrun_multichip(dev.type)
        print(f"      dryrun_multichip: losses " + ", ".join(
            f"{k} {v:.4f}" for k, v in dry.items() if k != "nmse")
              + f"; mmse_full NMSE {dry['nmse']:.4f}; {time.perf_counter() - t0:.2f} s")

        simo = config_from_dict(SIMO_CONFIG)
        cfg_t = dataclasses.replace(
            simo, model=dataclasses.replace(simo.model, cnn_dropout=0.0),
            training=dataclasses.replace(simo.training, mixed_precision=False))
        train = QuickDataset(tune_sets[0], MESH_TRAIN_FRAMES, cfg_t.seed)
        val = QuickDataset(tune_sets[1], MESH_VAL_FRAMES, cfg_t.seed)
        # cuDNN's deterministic algorithms: at world size 1 the two trainers
        # then do the same arithmetic (the mesh's gradient average over one
        # rank divides by 1); on its default algorithms the validation loss
        # moved by 9e-5 relative between the two on an H100 (PERF.md §6)
        hist = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for name, kw in (("mesh", {"mesh": mesh}), ("meshless", {"device_data": False})):
                trainer = Trainer(cfg_t, model_type="cnn", device=dev, log=quiet, **kw)
                hist[name] = trainer.train(train, val, epochs=MESH_EPOCHS,
                                           model_dir=os.path.join(workdir, name))["history"]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        for k in ("train_loss", "val_loss"):
            a, b = np.asarray(hist["mesh"][k]), np.asarray(hist["meshless"][k])
            fail_unless(np.all(np.abs(a - b) <= MESH_RTOL * np.abs(b)),
                        f"Trainer(mesh) {k} {a} within rtol {MESH_RTOL} of the meshless {b}")
        print(f"      Trainer(mesh=...) cnn, {MESH_EPOCHS} epochs of "
              f"{MESH_TRAIN_FRAMES // cfg_t.training.batch_size} steps on phase 12's split: "
              "train loss " + " / ".join(f"{v:.6f}" for v in hist["mesh"]["train_loss"])
              + ", meshless " + " / ".join(f"{v:.6f}" for v in hist["meshless"]["train_loss"])
              + "; validation " + " / ".join(f"{v:.6f}" for v in hist["mesh"]["val_loss"])
              + ", meshless " + " / ".join(f"{v:.6f}" for v in hist["meshless"]["val_loss"]))
    finally:
        dist.destroy_process_group()


def time_domain_phase(dev, card, tune_sets):
    """Phase 15: (a) and (b) with the launch counters read around them,
    then (c), each kernel they launched against its plain version on the
    inputs (a) gave it. Returns the launches."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    with capturing() as cap:
        time_domain_frames(dev, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as workdir:
        parallel_layer(dev, card, tune_sets, workdir)
    torch.cuda.synchronize()
    launches = read_launches()
    print("  (c) kernels launched on the time-domain and parallel paths: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(all(launches[k] > 0 for k in ESTIMATOR_KERNELS)
                and set(cap.args) == {k for k, v in launches.items() if v > 0},
                f"every estimator kernel launched, and every kernel launched captured, on the "
                f"time-domain path: {launches}, {sorted(cap.args)}")
    hold_against_plain("time-domain path", cap.args)
    print(f"phase 15 wall time: {time.perf_counter() - t_phase:.1f} s")
    return launches


def cli_run(walls, name, *argv, label=None):
    """One command of ce5g_torch.cli run in this process through
    ``main(argv)``, its standard output kept (and returned) and printed
    only if it fails; its wall time goes into ``walls``."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"ce5g_torch.cli.{name}").main
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = main([str(a) for a in argv])
    except BaseException:
        print(f"  {name} failed; its output ends:\n" + out.getvalue()[-4000:])
        raise
    walls[label or name] = time.perf_counter() - t0
    fail_unless(rc == 0, f"{name} exit code {rc}")
    return out.getvalue()


def _json(path):
    with open(path) as f:
        return json.load(f)


def quick_start_subprocess(workdir):
    """(a) ``python -m ce5g_torch.cli.quick_start --no-plots --results-dir
    W`` in a process of its own with no --device: its default reaches the
    card. Returns {label: NMSE dB} and the wall time."""
    import re

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, "-m", "ce5g_torch.cli.quick_start", "--no-plots", "--results-dir",
         os.path.join(workdir, "quick_start")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        print(out.stdout[-2000:] + out.stderr[-4000:])
    fail_unless(out.returncode == 0, f"quick_start exit code {out.returncode}")
    fail_unless("device cuda" in out.stdout, "quick_start ran on the card by default")
    db = {m.group(1).strip(): float(m.group(2))
          for m in re.finditer(r"^\s*(.+?): NMSE\s+(-?[\d.]+) dB", out.stdout, re.MULTILINE)}
    fail_unless(set(db) == {"LS", "MMSE (diag)", "MMSE (Wiener)"}, f"quick_start NMSEs: {db}")
    fail_unless(db["MMSE (Wiener)"] < db["MMSE (diag)"] < db["LS"],
                f"quick_start ordering mmse_full < mmse < ls: {db}")
    return db, wall


def _prefix_db(result, n):
    """Mean NMSE in dB of the first ``n`` frames of a phase's result (an
    evaluate_* result with its per-sample NMSE, or that list itself)."""
    if isinstance(result, dict):
        result = result["per_sample"] if "per_sample" in result else result["per_sample_nmse"]
    return 10 * math.log10(sum(result[:n]) / n + 1e-12)


def _agree(what, got, phase_db, phase):
    fail_unless(abs(got - phase_db) <= CLI_AGREE_DB,
                f"{what} {got:.4f} dB within {CLI_AGREE_DB} dB of phase {phase}'s "
                f"{phase_db:.4f} dB")
    return f"{what} {got:.4f} (phase {phase} {phase_db:.4f})"


def visualize_card_vs_cpu(dev):
    """(h) visualize_channels' arrays on the card against the CPU from the
    same draws (made on the CPU), max |diff| within VIS_TOL of each
    array's rms."""
    import numpy as np
    import torch
    from ce5g_torch.cli import visualize_channels as vc
    from ce5g_torch.config import ExperimentConfig

    cpu = torch.device("cpu")
    cfg = ExperimentConfig()
    draws = {}

    def draws_for(c):
        return draws.setdefault(c, vc.seeded_draws(c, cpu))

    card, host = (vc.channel_arrays(cfg, 20.0, where, draws_for) for where in (dev, cpu))
    worst = 0.0
    for part in ("heatmaps", "doppler", "autocorrelation"):
        fail_unless(card[part].keys() == host[part].keys(), f"visualize {part} keys")
        for key, ref in host[part].items():
            rms = float(np.sqrt(np.mean(ref ** 2)))
            err = float(np.max(np.abs(card[part][key] - ref))) / rms
            fail_unless(err <= VIS_TOL, f"visualize {part} {key} card vs CPU {err:.2e} of rms")
            worst = max(worst, err)
    shapes = {part: next(iter(card[part].values())).shape for part in card}
    print(f"  (h) visualize_channels' arrays card vs CPU on the same draws: max error "
          f"{worst:.2e} of rms (bound {VIS_TOL}); shapes {shapes}")


def batch_dependence(dev, ds):
    """mmse_full on the first BATCH frames of phase 9's split, in one
    batch of BATCH and in batches of ESTIMATOR_BATCH: a frame's estimate
    may move by at most BATCH_MOVE_RMS of its rms, and its NMSE by at most
    BATCH_MOVE_DB. Run outside the launch counts."""
    import numpy as np
    from ce5g_torch.config import config_from_dict
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.eval.evaluate import _frames_from_arrays, _nmse_per_sample
    from ce5g_torch.physics.simulate import table_for

    cfg = config_from_dict(SIMO_CONFIG)
    table = table_for(cfg)
    big, small = BATCH, ESTIMATOR_BATCH

    def estimate(start, n):
        frames = _frames_from_arrays(ds.arrays, np.arange(start, start + n), cfg, dev)
        h = estimate_batch(frames, cfg=cfg, estimator="mmse_full", table=table, device=dev)
        return h.cpu().numpy().astype(np.complex128)

    h_big = estimate(0, big)
    h_small = np.concatenate([estimate(i, small) for i in range(0, big, small)])
    truth = ds.arrays["H_true"][:big]
    diff = np.abs(h_big - h_small).reshape(big, -1).max(1)
    rms = np.sqrt(np.mean(np.abs(h_small.reshape(big, -1)) ** 2, 1))
    move = float((diff / rms).max())
    db = np.abs(10 * np.log10(_nmse_per_sample(truth, h_big))
                - 10 * np.log10(_nmse_per_sample(truth, h_small)))
    worst = int(np.argmax(db))
    mean_db = 10 * np.log10(_nmse_per_sample(truth, h_big).mean()) - 10 * np.log10(
        _nmse_per_sample(truth, h_small).mean())
    print(f"  mmse_full per frame, the first {big} frames of phase 9's split in one batch of "
          f"{big} and in batches of {small}: {int((diff > 0).sum())} frames differ, the largest "
          f"|difference| {move:.2e} of a frame's rms (bound {BATCH_MOVE_RMS}); a frame's NMSE "
          f"moves up to {db[worst]:.5f} dB (bound {BATCH_MOVE_DB}; frame {worst}: "
          f"{float(ds.arrays['snr_db'][worst]):.0f} dB, density "
          f"{float(ds.arrays['pilot_density'][worst]):.2f}), the mean by {mean_db:+.5f} dB")
    fail_unless(move <= BATCH_MOVE_RMS,
                f"a frame's mmse_full moves with its batch by {move:.2e} <= {BATCH_MOVE_RMS} of "
                "its rms")
    fail_unless(db[worst] <= BATCH_MOVE_DB,
                f"a frame's mmse_full NMSE moves with its batch by {db[worst]:.5f} <= "
                f"{BATCH_MOVE_DB} dB")


def cli_phase(dev, card, workdir, ds, serving_results, blind_results):
    """Phase 16: the command line, (a)-(h), on phase 9's split ``ds`` and
    its sidecars (in ``workdir``), the committed models/ and models_simo/
    checkpoints, and splits it makes itself; every command but (a) in this
    process, with the launch counters read around them and each kernel
    they launched held against its plain version; then mmse_full held
    independent of the batch (:func:`batch_dependence`). Returns the
    launches."""
    import torch

    t_phase = time.perf_counter()
    walls = {}

    def run(name, *argv, label=None):
        return cli_run(walls, name, *argv, label=label)

    simo = os.path.join(REPO, "configs", "simo_identifiable.yaml")
    mimo = os.path.join(REPO, "configs", "experiment_config.yaml")
    models, models_simo = os.path.join(REPO, "models"), os.path.join(REPO, "models_simo")
    print("phase 16, the command line: full-width configs (14 x 599 grids, 1x2 SIMO and 2x2), "
          f"cut in depth: (b) a SIMO split of {CLI_SPLIT} frames and 1 epoch; (c) the first "
          f"{CLI_SERVE_FRAMES} of phase 9's {SERVING_FRAMES} frames, lstm left out; (d) 1 trial of 1 epoch on (b)'s split, "
          f"the winner retrained 1 epoch; (e) a 2x2 split of {PLATEAU_FRAMES} frames; (f) "
          f"{CLI_STUDY_FRAMES} frames a cell; (g) online {CLI_ONLINE}, at scale {CLI_ATSCALE}")
    qs_db, walls["quick_start (process)"] = quick_start_subprocess(workdir)
    print("  (a) quick_start (EVA 50 Hz 15 dB 10%, its own process, default device): "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in qs_db.items())
          + "; mmse_full < mmse < ls: ok")

    res = os.path.join(workdir, "cli_results")
    out_models = os.path.join(workdir, "cli_models")
    torch.cuda.synchronize()
    reset_launches()
    with capturing() as cap:
        # (b) the factory, the sidecars and training on a small SIMO split
        small = os.path.join(workdir, "cli_simo")
        text = run("generate_dataset", "--config", simo, "--output-dir", small, "--format",
                   "ce5g", "--verify", "--chunk-size", CLI_CHUNK,
                   *itertools.chain.from_iterable((f"--{k}-samples", v)
                                                  for k, v in CLI_SPLIT.items()))
        fail_unless(all(f"verify {k}: PASS" in text for k in CLI_SPLIT),
                    f"generate_dataset verified every split: {text[-300:]}")
        run("compute_wiener", "--config", simo, "--data-dir", small, label="compute_wiener wiener")
        run("compute_wiener", "--config", simo, "--data-dir", small, "--estimator",
            "mmse_full_est", "--splits", "test", label="compute_wiener bwiener")
        run("train_model", "--config", simo, "--data-dir", small, "--model-dir", out_models,
            "--model", "cnn", "--epochs", 1, "--wiener", "--evaluate", "--results-dir", res)
        trained = _json(os.path.join(res, "cnn_wiener_test_results.json"))
        fail_unless(math.isfinite(trained["nmse_db"]) and trained["num_samples"] == CLI_SPLIT["test"],
                    f"train_model --evaluate scored the test split: {trained}")
        print(f"  (b) generate_dataset {CLI_SPLIT} (.ce5g, verify PASS), compute_wiener "
              f"wiener + bwiener, train_model cnn --wiener 1 epoch: {trained['nmse_db']:.4f} dB "
              f"on {trained['num_samples']} frames")

        # (c) evaluation and the SIMO study on phase 9's split, its first frames
        n = CLI_SERVE_FRAMES
        run("evaluate_models", "--config", simo, "--data-dir", workdir, "--model-dir", models_simo,
            "--results-dir", res, "--models", *CLI_SERVED, "--num-samples", n, "--no-plots")
        ev = _json(os.path.join(res, "evaluation_results.json"))
        fail_unless(all(ev[k]["num_samples"] == n for k in ("mmse_full",) + CLI_SERVED),
                    f"evaluate_models served the first {n} frames")
        parts = [_agree(name, ev[name]["nmse_db"], _prefix_db(serving_results[name], n), 9)
                 for name in ("ls", "mmse", "mmse_full") + CLI_SERVED]
        parts.append(_agree("LS (stored)", ev["LS"]["nmse_db"],
                            _prefix_db(serving_results["baselines"]["per_sample"]["LS"], n), 9))
        print(f"  (c) evaluate_models on phase 9's first {n} frames, NMSE dB: " + ", ".join(parts))
        run("identifiable_study", "--config", simo, "--data-dir", workdir, "--model-dir",
            models_simo, "--results-dir", res, "--num-samples", n, "--models", *CLI_STUDY_MODELS)
        study = _json(os.path.join(res, "identifiable_study.json"))
        fail_unless(study["num_samples"] == n, f"identifiable_study served the first {n} frames")
        study = study["overall_db"]
        fail_unless(set(study) == {"ls_stored", "mmse", "mmse_full", "mmse_full_est",
                                   "mmse_full_blind", *CLI_STUDY_MODELS},
                    f"identifiable_study's methods: {sorted(study)}")
        parts = [_agree(name, study[name], _prefix_db(serving_results[name], n), 9)
                 for name in ("mmse", "mmse_full") + CLI_SERVED]
        parts += [_agree(name, study[name], _prefix_db(blind_results[name], n), 11)
                  for name in ("mmse_full_est", "cnn_wiener_blind", "cnn_wiener_blind_online")]
        fail_unless(study["mmse_full_blind"] > study["mmse_full_est"],
                    f"mmse_full_blind {study['mmse_full_blind']:.3f} above mmse_full_est "
                    f"{study['mmse_full_est']:.3f} dB")
        print(f"  (c) identifiable_study on phase 9's first {n} frames, NMSE dB: "
              + ", ".join(parts)
              + f"; mmse_full_blind {study['mmse_full_blind']:.4f} above mmse_full_est "
              f"{study['mmse_full_est']:.4f} (the JAX study: -5.59 against -13.16)")

        # (e) the superposition floor on a 2x2 split made by generate_dataset
        plateau = os.path.join(workdir, "cli_mimo")
        run("generate_dataset", "--config", mimo, "--output-dir", plateau, "--format", "ce5g",
            "--train-samples", 0, "--val-samples", 0, "--test-samples", PLATEAU_FRAMES,
            label="generate_dataset 2x2")
        run("compute_wiener", "--config", mimo, "--data-dir", plateau, "--splits", "test",
            label="compute_wiener 2x2")
        run("diagnose_plateau", "--config", mimo, "--data-dir", plateau, "--model-dir", models,
            "--results-dir", res, "--models", "cnn", "resnet", "cnn_wiener")
        diag = _json(os.path.join(res, "plateau_diagnosis.json"))
        oracle = diag["full_tensor_db"]["sum_oracle"]
        fail_unless(abs(oracle - PLATEAU_FLOOR_DB) <= PLATEAU_BAND_DB,
                    f"sum oracle {oracle:.4f} dB within {PLATEAU_BAND_DB} dB of "
                    f"{PLATEAU_FLOOR_DB:.4f} dB")
        fail_unless(set(diag["by_channel_type"]["sum_oracle"]) == {"EPA", "EVA", "ETU"},
                    f"by_channel_type keys: {diag['by_channel_type']['sum_oracle']}")
        print(f"  (e) diagnose_plateau on {PLATEAU_FRAMES} 2x2 frames: sum oracle {oracle:.4f} dB "
              f"(analytic {PLATEAU_FLOOR_DB:.4f}), mmse_full "
              f"{diag['full_tensor_db']['mmse_full']:.4f}, slice basis "
              + ", ".join(f"{k} {v:.3f}" for k, v in diag["slice00_db"].items()))

        # (f) the two studies at a few frames a cell
        run("pilot_optimization", "--config", mimo, "--frames", CLI_STUDY_FRAMES, "--models",
            "cnn", "cnn_wiener", "--model-dir", models, "--data-dir", plateau,
            "--simo-ber-config", simo, "--ber-frames", CLI_STUDY_FRAMES, "--results-dir", res)
        pilot = _json(os.path.join(res, "pilot_optimization_results.json"))
        fail_unless({"results", "recommendation", "model_sweep", "ber_identifiable"} <= set(pilot),
                    f"pilot_optimization's sections: {sorted(pilot)}")
        run("parity_phase2", "--frames", CLI_STUDY_FRAMES, "--results-dir", res)
        par = _json(os.path.join(res, "parity_phase2.json"))
        fail_unless(os.path.exists(os.path.join(res, "parity_phase2.md"))
                    and all(math.isfinite(v) for v in par["comparison"]["avg_db"].values()),
                    "parity_phase2 wrote its table and finite averages")
        print(f"  (f) pilot_optimization ({CLI_STUDY_FRAMES} frames a cell): best densities "
              + json.dumps({k: v["best_density"] for k, v in pilot["recommendation"].items()})
              + f"; parity_phase2 ({CLI_STUDY_FRAMES} frames a cell): averages "
              + json.dumps({k: round(v, 3) for k, v in par["comparison"]["avg_db"].items()}))

        # (g) online training and the factory at scale, cut in depth
        run("train_online", "--config", simo, "--model", "cnn", "--wiener-estimator",
            "mmse_full_est", "--loss", "nmse", "--samples", CLI_ONLINE["samples"], "--batch",
            CLI_ONLINE["batch"], "--steps-per-dispatch", CLI_ONLINE["steps_per_dispatch"],
            "--name", "cnn_wiener_blind_online", "--model-dir", out_models)
        online = _json(os.path.join(out_models, "cnn_wiener_blind_online_history.json"))
        run("generate_at_scale", "--config", mimo, "--output-dir",
            os.path.join(workdir, "cli_atscale"), "--results-dir", res,
            *itertools.chain.from_iterable((f"--{k.replace('_', '-')}", v)
                                           for k, v in CLI_ATSCALE.items()))
        ats = _json(os.path.join(res, "at_scale_generation.json"))
        fail_unless(card.split(",")[0] in ats["backend"],
                    f"at_scale_generation.json names the card: {ats['backend']}")
        fail_unless(ats["digest_run"]["verify_pass"], "the at-scale digest chunk verifies")
        fail_unless(all(math.isfinite(ats[k]["last_loss"]) for k in
                        ("online_train", "online_train_bf16")), "online losses finite")
        print(f"  (g) train_online blind, {online['total_samples']} samples: loss "
              f"{online['first_loss']:.4f} -> {online['last_loss']:.4f}; generate_at_scale on "
              f"{ats['backend']}: {ats['digest_run']['samples']} frames digested at "
              f"{ats['digest_run']['device_samples_per_second']:.0f} samples/s (verify PASS), "
              f"online float32 {ats['online_train']['end_to_end_samples_per_second']:.0f} / bf16 "
              f"{ats['online_train_bf16']['end_to_end_samples_per_second']:.0f} samples/s, codec "
              f"{ats['codec_write']['write_mb_per_s']:.0f} MB/s")

        # (h) the channel figures' arrays
        run("visualize_channels", "--results-dir", res, "--no-plots")
        visualize_card_vs_cpu(dev)

        # (d) the search, its winner and the final report over the phase's results
        run("tune_hyperparameters", "--config", simo, "--data-dir", small, "--results-dir",
            res, "--trials", 1, "--epochs", 1, "--quick-train", CLI_SPLIT["train"],
            "--quick-val", CLI_SPLIT["val"])
        run("apply_tuning", "--config", simo, "--data-dir", small, "--model-dir", out_models,
            "--results-dir", res, "--epochs", 1)
        tuned = _json(os.path.join(res, "cnn_tuned_test_results.json"))
        run("final_report", "--results-dir", res, "--model-dir", out_models, "--study-dir", res,
            "--no-plots")
        with open(os.path.join(res, "FINAL_REPORT.md")) as f:
            report = f.read()
        fail_unless("BENCH_r" not in report and "Throughput" not in report
                    and "Roofline" not in report, "the final report carries no TPU number")
        fail_unless("| cnn_tuned |" in report and "Information floor" in report,
                    "the final report's headline reads the phase's results")
        print(f"  (d) tune_hyperparameters 1 trial, apply_tuning 1 epoch: cnn_tuned "
              f"{tuned['nmse_db']:.4f} dB on {tuned['num_samples']} frames; final_report "
              f"{len(report)} characters, no BENCH_r, throughput or roofline line")
        torch.cuda.synchronize()
        launches = read_launches()
    print("  kernels launched by the command line in this process: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(all(launches[k] > 0 for k in ESTIMATOR_KERNELS)
                and set(cap.args) == {k for k, v in launches.items() if v > 0},
                f"every estimator kernel launched, and every kernel launched captured, on the "
                f"command line: {launches}, {sorted(cap.args)}")
    hold_against_plain("command line", cap.args)
    batch_dependence(dev, ds)
    fail_unless("jax" not in sys.modules, "jax is not imported")
    print(f"  commands: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"phase 16 wall time: {time.perf_counter() - t_phase:.1f} s; jax not imported")
    return launches


def notebook_phase(dev, card):
    """Phase 17: the port's demonstration notebook (NOTEBOOK), its cells
    that carry no 'plot' tag in one namespace: (a) on the card at its
    defaults, with the launch counters read around it and each kernel it
    launched held against its plain version; (b) on the card and on the
    CPU at NOTEBOOK_CPU_B frames a sweep point, the same draws, every NMSE
    within NOTEBOOK_AGREE_DB; (c) mmse_full at the sweep's 25 and 30 dB
    points of (a) against the float64 plain path. Returns the launches."""
    import contextlib
    import io

    import torch
    from ce5g_torch.estimators import estimate_batch
    from ce5g_torch.physics import simulate_batch

    t_phase = time.perf_counter()
    with capturing() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launches()
        ns, left_out = run_notebook(NOTEBOOK, {"DEVICE": "cuda"})
        torch.cuda.synchronize()
        launches = read_launches()
        wall = time.perf_counter() - t0
    print(f"  (a) the notebook's cells on {card} at B = {ns['B']}, SNRs {ns['SNRS']}: {wall:.2f} s; "
          f"left out {left_out} cells tagged 'plot' (matplotlib), not run")
    print("  kernels launched by the notebook: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    fail_unless(launches["hpd_solve"] > 0 and launches["interp_fused"] > 0,
                f"hpd_solve and interp_fused launched by the notebook: {launches}")
    fail_unless(set(cap.args) == {k for k, v in launches.items() if v > 0},
                f"the notebook's inputs captured for each kernel it launched: {sorted(cap.args)}")
    hold_against_plain("notebook", cap.args)

    small = {"B": NOTEBOOK_CPU_B}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # (a) printed the notebook's lines
        on_card, _ = run_notebook(NOTEBOOK, {"DEVICE": "cuda", **small})
        on_cpu, _ = run_notebook(NOTEBOOK, {"DEVICE": "cpu", **small})
    both_s = time.perf_counter() - t0
    worst = 0.0
    for est, db in on_cpu["frame_db"].items():
        worst = max(worst, abs(on_card["frame_db"][est] - db))
        for got, ref in zip(on_card["curves"][est], on_cpu["curves"][est]):
            worst = max(worst, abs(got - ref))
    fail_unless(worst <= NOTEBOOK_AGREE_DB,
                f"the notebook's NMSEs card vs CPU within {NOTEBOOK_AGREE_DB} dB: {worst:.5f}")
    print(f"  (b) the notebook at B = {NOTEBOOK_CPU_B} on the card and on the CPU (same draws, "
          f"{both_s:.2f} s): the single frame's three NMSEs and all "
          f"{3 * len(on_cpu['SNRS'])} sweep points within {worst:.5f} dB "
          f"(bound {NOTEBOOK_AGREE_DB})")

    parts = []
    for snr in (25.0, 30.0):
        i = ns["SNRS"].index(snr)
        params = ns["eva_params"](ns["B"], snr)
        frames = simulate_batch(ns["draw"](params, 100 + i), params, cfg=ns["cfg"],
                                table=ns["table"], device=dev)
        h = estimate_batch(frames, cfg=ns["cfg"], estimator="mmse_full", table=ns["table"],
                           device=dev).cpu()
        ref = mmse_full_float64(ns["cfg"], frames)
        err = (h.to(ref.dtype) - ref).abs().flatten(1).max(1).values
        rms = (ref.abs() ** 2).flatten(1).mean(1).sqrt()
        move = float((err / rms).max())
        fail_unless(move <= WIENER_F64_TOL,
                    f"the notebook's mmse_full at {snr:g} dB vs float64: {move:.2e} of a "
                    f"frame's rms <= {WIENER_F64_TOL}")
        parts.append(f"{snr:g} dB {move:.2e} (NMSE {ns['curves']['mmse_full'][i]:.4f} dB)")
    print(f"  (c) the notebook's mmse_full against the float64 plain path on its {ns['B']} "
          f"frames, max error of a frame's rms (bound {WIENER_F64_TOL}): " + ", ".join(parts))
    print(f"phase 17 wall time: {time.perf_counter() - t_phase:.1f} s")
    return launches


MEASURING_SLACK = 1.05  # largest share of a peak that phase 18 accepts


def _rows(out):
    """The rows of a profiler's JSON line (the last line of its output)."""
    return json.loads(out.strip().splitlines()[-1])["rows"]


def measuring_phase(dev, card, rates):
    """Phase 18: the measuring tools of ce5g_torch.cli, in this process,
    into a temporary directory removed however the phase ends: (a) bench
    with the launch counters read around it, (b) benchmark_suite --train,
    (c) bench_factory, (d) the three profilers. Returns the bench path's
    launches."""
    import torch
    from ce5g_torch.cli import bench as bench_mod
    from ce5g_torch.cli import benchmark_suite as suite_mod
    from ce5g_torch.cli import profile_bench, profile_fine, profile_solve
    from ce5g_torch.ops import hpd_solve as hpd_mod

    t_phase = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_measuring_") as workdir:
        torch.cuda.synchronize()
        reset_launches()
        out = cli_run(walls, "bench", "--out", os.path.join(workdir, "bench.json"))
        torch.cuda.synchronize()
        launches = read_launches()
        line = json.loads(out.strip().splitlines()[-1])
        fail_unless(line == _json(os.path.join(workdir, "bench.json")),
                    "bench --out holds the printed line")
        missing = {"metric", "value", "unit", "spread", "nmse_db", "compile_s", "init_s", "card",
                   "estimators"} - set(line)
        fail_unless(not missing, f"bench prints every field: missing {sorted(missing)}")
        fail_unless(line["metric"] == bench_mod.METRIC and line["card"] == card,
                    f"bench's metric and card: {line['metric']}, {line['card']}")
        fail_unless(bench_mod.within_gate(line["nmse_db"]),
                    f"bench mmse_full NMSE {line['nmse_db']:.4f} dB within {bench_mod.SLACK_DB} "
                    f"dB of {bench_mod.ANCHOR_DB}")
        parts = []
        for name, r in line["estimators"].items():
            fail_unless(r["frames_per_s"] > 0 and math.isfinite(r["nmse_db"]),
                        f"bench {name} rate and NMSE")
            parts.append(f"{name} {r['frames_per_s']:.1f} frames/s ({r['frames_per_s_min']:.1f}-"
                         f"{r['frames_per_s_max']:.1f}; phase 8, synchronised every batch: "
                         f"{rates[name]:.1f}), NMSE {r['nmse_db']:.4f} dB")
        fail_unless(set(line["estimators"]) == set(rates),
                    f"bench measures {sorted(rates)}: {sorted(line['estimators'])}")
        print(f"  (a) bench (median of {line['repeats']} windows of {line['iters']} batches of "
              f"{line['batch']}; init {line['init_s']:.2f} s, first window {line['compile_s']:.2f} "
              f"s): " + "; ".join(parts))
        print("  kernels launched by bench: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
        fail_unless(all(launches[k] > 0 for k in ESTIMATOR_KERNELS),
                    f"every estimator kernel launched by bench: {launches}")

        suite_path = os.path.join(workdir, "benchmark_suite.json")
        cli_run(walls, "benchmark_suite", "--train", "--train-models", "cnn",
                "--train-batches", "64", "--out", suite_path)
        suite = _json(suite_path)
        cells = {k: v for k, v in suite.items() if isinstance(v, dict) and k != "peaks"}
        errors = {k: v["error"] for k, v in cells.items() if "error" in v}
        fail_unless(not errors, f"benchmark_suite has no error cell: {errors}")
        fail_unless("peaks" in suite, f"benchmark_suite has the card's peaks: {suite.get('roofline_note')}")
        over = {k: (v.get("mfu"), v.get("hbm_util")) for k, v in cells.items()
                if max(v.get("mfu", 0.0), v.get("hbm_util", 0.0)) > MEASURING_SLACK}
        fail_unless(not over, f"no MFU or HBM share above {MEASURING_SLACK}: {over}")
        fail_unless(suite["codec"]["native"], "benchmark_suite's codec is the native one")
        fail_unless(cells.get("hpd_solve/kernel", {}).get("rel_err_vs_plain", 1.0) < 1e-4,
                    f"benchmark_suite's hpd_solve/kernel against its plain version: "
                    f"{cells.get('hpd_solve/kernel')}")
        gram, rhs = suite_mod.hpd_problem(BATCH, suite_mod.HPD_N, 4, dev)
        hpd_rel = rel(hpd_mod.hpd_solve(gram, rhs), hpd_mod.hpd_solve_plain(gram, rhs))
        fail_unless(hpd_rel < 1e-4, f"hpd_solve on the suite's problem, relative error "
                                    f"{hpd_rel:.2e} < 1e-4")
        print("  (b) benchmark_suite: " + "; ".join(
            f"{k} {v['ms_per_batch']:.3f} ms/batch {v['frames_per_s']:.0f} frames/s"
            + (f" MFU {v['mfu']:.2e}" if "mfu" in v else "")
            + (f" HBM {v['hbm_util']:.2e}" if "hbm_util" in v else "")
            for k, v in cells.items() if "frames_per_s" in v))
        print("      " + "; ".join(f"{k} {v['ms_per_batch']:.3f} ms" for k, v in cells.items()
                                   if k.startswith("hpd_solve/"))
              + f"; kernel vs plain on the suite's problem {tuple(gram.shape)} relative error "
              f"{hpd_rel:.2e}; codec native write {suite['codec']['write_MBps']:.1f} MB/s, read "
              f"{suite['codec']['read_MBps']:.1f} MB/s, npz {suite['codec']['npz_write_MBps']:.1f} MB/s")
        print("      " + "; ".join(
            f"{k} {v['ms_per_step']:.2f} ms/step, MFU {v['mfu']:.4f}"
            + (f", host-staged {v['staged_ms_per_step']:.2f} ms ({v['staging_overhead']:+.1%})"
               if "staged_ms_per_step" in v else "")
            for k, v in cells.items() if k.startswith("train_step")))

        cli_run(walls, "bench_factory", "--results-dir", workdir)
        fac = _json(os.path.join(workdir, "factory_throughput.json"))
        fail_unless(fac["card"] == card and fac["world_size"] == 1
                    and fac["device_samples_per_s"] > 0 and fac["end_to_end_samples_per_s"] > 0,
                    f"bench_factory's result: {fac}")
        print(f"  (c) bench_factory: device {fac['device_samples_per_s']:.1f} samples/s, end to end "
              f"{fac['end_to_end_samples_per_s']:.1f} samples/s, chunk {fac['chunk_mb']:.1f} MB, "
              f"fetch-bound fraction {fac['fetch_bound_fraction']:.3f}")

    gen = torch.Generator(device=dev)
    cfg = bench_mod.bench_config(bench_setup(dev, 1)[0])
    expected = {
        "profile_bench": set(profile_bench.stages(cfg, 1, gen, dev)),
        "profile_fine": set(profile_fine.fine_rows(cfg, 1, gen, dev))
        | {f"full @{b}" for b in profile_fine.SWEEP},
        "profile_solve": set(profile_solve.solver_rows(gen, 1, dev))
        | set(profile_solve.freqresp_rows(cfg, gen, 1, dev)),
    }
    # profile_fine's per-frame bisection rows take ≈0.4-0.9 s a batch on an
    # H100 80GB HBM3 at 700 W: one batch a window keeps the phase near 30 s
    depth = {"profile_fine": ("--iters", "1")}
    for name, want in expected.items():
        rows = _rows(cli_run(walls, name, *depth.get(name, ())))
        fail_unless(set(rows) == want and all(r["ms_per_batch"] > 0 for r in rows.values()),
                    f"{name} printed every row: {sorted(rows)}")
        print(f"  (d) {name}: " + "; ".join(f"{k} {v['ms_per_batch']:.3f} ms" for k, v in rows.items()))
    print(f"  commands: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    print(f"phase 18 wall time: {time.perf_counter() - t_phase:.1f} s")
    return launches


def envelope_config(num_rx, num_symbols, carrier, doppler):
    """A configuration of ENVELOPE_CONFIGS: 4 TX and ``num_rx`` RX antennas,
    ``num_symbols`` symbols, on the 100 MHz NR carrier or at the bench
    numerology (FFT 1024, 15 kHz, K = 599), ``doppler`` Hz the largest
    Doppler configured (mmse_full's time rank follows it)."""
    from ce5g_torch import ChannelConfig, ExperimentConfig, MIMOConfig, OFDMConfig

    if carrier == "nr100":
        ofdm = OFDMConfig(fft_size=4096, cp_length=288, num_symbols=num_symbols,
                          useful_subcarriers=3276, subcarrier_spacing=30000.0)
        channel = ChannelConfig(carrier_freq=3.5e9, doppler_hz=(doppler,))
    else:
        ofdm, channel = OFDMConfig(num_symbols=num_symbols), ChannelConfig(doppler_hz=(doppler,))
    return ExperimentConfig(ofdm=ofdm, channel=channel,
                            mimo=MIMOConfig(num_tx=4, num_rx=num_rx))


def envelope_against_cpu(dev, cfg, params, draws, pairs, n=ENVELOPE_CPU_FRAMES):
    """The path on the card and on the CPU from the first ``n`` frames'
    draws, at phase 5's tolerance (NMSE within 0.01 dB; the estimates
    within 1e-4 of the rms, and mmse_full on each device within
    ENVELOPE_FLOAT64_BOUND of the rms of its float64 run). Returns the
    printed parts."""
    import torch
    from ce5g_torch.physics import FrameDraws, FrameParams

    first = FrameParams(*(x[:n] for x in params))
    drawn = FrameDraws(*(x[:n] for x in draws))
    card_frames, on_card = run_path(dev, cfg, first, drawn, pairs)
    cpu_frames, on_cpu = run_path(torch.device("cpu"), cfg, FrameParams(*(x.cpu() for x in first)),
                                  FrameDraws(*(x.cpu() for x in drawn)), pairs)
    parts = []
    for est in on_card:
        (h_card, db_card), (h_cpu, db_cpu) = on_card[est], on_cpu[est]
        fail_unless(abs(db_card - db_cpu) < 0.01, f"{est} card vs CPU NMSE within 0.01 dB")
        if est == "mmse_full":
            for where, frames, h in (("card", card_frames, h_card), ("cpu", cpu_frames, h_cpu)):
                ref = mmse_full_float64(cfg, frames)
                rms = float((ref.abs() ** 2).mean().sqrt())
                err = float((h.cpu().to(ref.dtype) - ref).abs().max()) / rms
                fail_unless(err <= ENVELOPE_FLOAT64_BOUND,
                            f"mmse_full on the {where} vs float64: max error {err:.2e} of rms "
                            f"<= {ENVELOPE_FLOAT64_BOUND}")
                parts.append(f"mmse_full {where} vs float64 {err:.2e}")
        else:
            rms = float((h_cpu.abs() ** 2).mean().sqrt())
            err = float((h_card.cpu() - h_cpu).abs().max()) / rms
            fail_unless(err <= 1e-4, f"{est} card vs CPU max error {err:.2e} of rms <= 1e-4")
            parts.append(f"{est} {err:.2e}")
    return parts


def envelope_hard_cases(dev):
    """Each kernel, by each of its routes (forced through the module's
    private ``_launch``), against its plain version on the hard cases with
    WIDE_R antennas (and 4 for the slot form's), every slot case past one
    block's shared memory, 140 symbols, slots that share a resource element,
    and the HPD systems of ENVELOPE_HPD_CASES (NaN pattern, both kernels)."""
    import torch
    from ce5g_torch.ops import hard_cases
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as grid_mod
    from ce5g_torch.utils import profiling

    worst = {"interp_fused": 0.0, "interp": 0.0, "hpd_solve": 0.0}
    for case in hard_cases.GRID_CASES:
        for r in hard_cases.WIDE_R:
            v, mask = (x.to(dev) for x in hard_cases.grid_case(case, r))
            scale = float(v.abs().max())
            for method in ("nearest", "linear"):
                ref = grid_mod.interpolate_grid_plain(v, mask, method)
                for route in grid_mod.ROUTES:
                    pl = grid_mod._plan(r, *mask.shape[1:], route)
                    err = float((grid_mod._launch(pl, v, mask, method) - ref).abs().max()) / scale
                    fail_unless(err <= 1e-5, f"interp_fused {method} route {route} on hard case "
                                             f"{case} (R = {r}): max abs error {err:.2e} of scale")
                    worst["interp_fused"] = max(worst["interp_fused"], err)
    for case in hard_cases.SLOT_CASES:
        for r in (4,) + hard_cases.WIDE_R:
            c = hard_cases.slot_case(case, r)
            v, pos, valid = (c[key].to(dev) for key in ("values", "positions", "valid"))
            scale = float(v.abs().max())
            routes = [route for route in slot_mod.ROUTES if route == "tile"
                      or slot_mod.plan(r, v.shape[-1], *c["grid"]).route == "frame"]
            for method in ("nearest", "linear", "cubic"):
                ref = slot_mod.interpolate_slots_plain(v, pos, valid, c["grid"], method)
                for route in routes:
                    pl = slot_mod._plan(r, v.shape[-1], *c["grid"], route)
                    out = slot_mod._launch(pl, v, pos, valid, c["grid"], method)
                    err = float((out - ref).abs().max()) / scale
                    fail_unless(err <= 1e-5, f"interp {method} route {route} on hard case {case} "
                                             f"(R = {r}): max abs error {err:.2e} of scale")
                    fail_unless(bool((out[valid.sum(-1) == 0] == 0).all()),
                                f"interp {method} route {route} on hard case {case}: empty frame -> 0")
                    worst["interp"] = max(worst["interp"], err)
    for case in ENVELOPE_HPD_CASES:
        gram, rhs, bad = hard_cases.hpd_case(case)
        gram, rhs = gram.to(dev), rhs.to(dev)
        before = profiling.counters.copy()
        x = hpd_mod.hpd_solve(gram, rhs)
        moved = profiling.counters - before
        route = f"ops.hpd_solve.{hpd_mod.plan(*rhs.shape[1:]).route}"
        fail_unless(profiling.launches("hpd_solve", moved) == moved[route] == 1,
                    f"hpd_solve on hard case {case} launched once by its plan's route: {moved}")
        ref = hpd_mod.hpd_solve_plain(gram, rhs)
        is_bad = torch.zeros(gram.shape[0], dtype=torch.bool, device=dev)
        is_bad[list(bad)] = True
        n, r = rhs.shape[1:]
        outs = {"plan": x}
        outs.update({f"cluster {c}": hpd_mod._launch(hpd_mod._plan(n, r, c), gram, rhs)
                     for c in hpd_mod.CLUSTER_SIZES
                     if n > hpd_mod.MAX_N and hpd_mod._instance(n, r, c) is not None})
        for route, x in outs.items():
            fail_unless(bool(torch.isnan(x[is_bad]).all()) and bool(torch.isfinite(x[~is_bad]).all()),
                        f"hpd_solve {route} on hard case {case}: NaN exactly for the systems "
                        f"not positive definite")
            err = rel(x[~is_bad], ref[~is_bad])
            fail_unless(err < 1e-4, f"hpd_solve {route} on hard case {case}: relative error "
                                    f"{err:.2e} < 1e-4")
            worst["hpd_solve"] = max(worst["hpd_solve"], err)
    print(f"  hard cases, every route against the plain version: interp_fused "
          f"({', '.join(hard_cases.GRID_CASES)}; R = {', '.join(map(str, hard_cases.WIDE_R))}) "
          f"worst {worst['interp_fused']:.3e} of scale; interp ({', '.join(hard_cases.SLOT_CASES)}; "
          f"R = 4, {', '.join(map(str, hard_cases.WIDE_R))}) worst {worst['interp']:.3e} of scale; "
          f"hpd_solve ({', '.join(ENVELOPE_HPD_CASES)}; past n = 128 every cluster size with an "
          f"instance) worst relative error "
          f"{worst['hpd_solve']:.3e}, NaN pattern equal")


def hpd_cluster_times(problems):
    """The HPD solve on each {label: (gram, rhs)} of ``problems`` (n > 128):
    the plan's route, every other cluster size with an instance (one block
    where it has one), the blocked kernel the cluster route replaced (the
    plan's route past every instance), the
    plain version, torch.linalg.solve and the bound (kernels: a graph of
    20, median of 5 replays; plain and library back to back). Each kernel
    is held to the plain version first, and the plan's route may be no
    slower than the blocked kernel."""
    import torch
    from ce5g_torch.ops import hpd_solve as hpd_mod

    for what, (gram, rhs) in problems.items():
        b, n, r = rhs.shape
        ref = hpd_mod.hpd_solve_plain(gram, rhs)
        chosen = hpd_mod.plan(n, r)
        plans = {f"cluster {c}": hpd_mod._plan(n, r, c) for c in hpd_mod.CLUSTER_SIZES
                 if hpd_mod._instance(n, r, c) is not None}
        plans["blocked"] = chosen if chosen.route == "blocked" else hpd_mod.Plan("blocked")
        times, parts = {}, []
        for label, pl in plans.items():
            err = rel(hpd_mod._launch(pl, gram, rhs), ref)
            fail_unless(err < 1e-4, f"hpd_solve {label} at {(b, n, r)}: relative error "
                                    f"{err:.2e} < 1e-4")
            ms = graph_ms(lambda: hpd_mod._launch(pl, gram, rhs))
            times[label] = ms[0]
            mark = " (plan)" if pl == chosen else ""
            parts.append(f"{label}{mark} {ms[0]:.4f} ({ms[1]:.4f}-{ms[2]:.4f}) err {err:.1e}")
        times["plain"] = cuda_ms(lambda: hpd_mod.hpd_solve_plain(gram, rhs))[0]
        times["library"] = cuda_ms(lambda: torch.linalg.solve(gram, rhs))[0]
        bound_ms, bound_by = bound(*hpd_mod.work(b, n, r))
        print(f"  hpd_solve on {what} {(b, n, n)} x {r}, ms: " + "; ".join(parts)
              + f"; plain {times['plain']:.4f}; library (torch.linalg.solve) "
              f"{times['library']:.4f}; bound {bound_ms:.4f} ({bound_by})")
        planned = next(label for label, pl in plans.items() if pl == chosen)
        fail_unless(times[planned] <= times["blocked"],
                    f"hpd_solve at {(b, n, r)}: the plan's {planned} no slower than the blocked "
                    f"kernel it replaced")


def hpd_random_times(dev, shapes=ENVELOPE_HPD_SHAPES):
    """hpd_cluster_times on phase 1's random systems at each (B, n, R) of
    ``shapes``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(15)
    hpd_cluster_times({f"random systems n = {n}": hpd_problem(gen, dev, b, n, r)
                       for b, n, r in shapes})


def route_times(main_args, parity_args):
    """Each route of the two interpolation kernels, forced through the
    module's private ``_launch``, timed on the bench shapes' inputs: the
    grid form on the main path's, the slot form on the parity path's
    (cubic, R = 2, P = 2096) and on the main path's ls:cubic ones (R = 4,
    P = 1257). Each route is held to the plain version first."""
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as grid_mod

    vals, mask, method = main_args["interp_fused"]
    ref = grid_mod.interpolate_grid_plain(vals, mask, method)
    parts = []
    for route in grid_mod.ROUTES:
        pl = grid_mod._plan(vals.shape[1], *mask.shape[1:], route)
        err = float((grid_mod._launch(pl, vals, mask, method) - ref).abs().max())
        fail_unless(err <= 1e-5 * float(vals.abs().max()), f"interp_fused route {route} on the "
                                                          f"main path's inputs: {err:.2e}")
        ms = graph_ms(lambda: grid_mod._launch(pl, vals, mask, method))
        parts.append(f"interp_fused {route} {ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f})")
    for what, args in (("parity", parity_args["interp"]), ("main", main_args["interp"])):
        v, pos, valid, grid, method = args
        ref = slot_mod.interpolate_slots_plain(*args)
        for route in slot_mod.ROUTES:
            pl = slot_mod._plan(v.shape[1], v.shape[2], *grid, route)
            err = float((slot_mod._launch(pl, *args) - ref).abs().max())
            fail_unless(err <= 1e-5 * float(v.abs().max()), f"interp route {route} on the "
                                                            f"{what} path's inputs: {err:.2e}")
            ms = graph_ms(lambda: slot_mod._launch(pl, *args))
            parts.append(f"interp {route} at the {what} path's {tuple(v.shape)} {method} "
                         f"{ms[0]:.4f} ms ({ms[1]:.4f}-{ms[2]:.4f})")
    print("  routes at the bench shapes (graph of 20, median of 5 replays): " + "; ".join(parts))


def envelope_phase(dev, card, main_args, parity_args):
    """Phase 19: the main path at each of ENVELOPE_CONFIGS with the launch
    counters read around it, its checks and its kernels' times; then the
    hard cases, and each interpolation route at the bench shapes. Returns
    the launches of the configurations' runs."""
    import torch
    from ce5g_torch.ops import hpd_solve as hpd_mod
    from ce5g_torch.ops import interp as slot_mod
    from ce5g_torch.ops import interp_fused as grid_mod
    from ce5g_torch.physics import PROFILE_INDEX, FrameParams, draw_frames

    t_phase = time.perf_counter()
    total = dict.fromkeys(read_launches(), 0)
    for name, (num_rx, num_symbols, carrier, doppler, b, pairs) in ENVELOPE_CONFIGS.items():
        cfg = envelope_config(num_rx, num_symbols, carrier, doppler)
        params = FrameParams(
            torch.full((b,), PROFILE_INDEX["ETU"], dtype=torch.int32, device=dev),
            torch.full((b,), doppler, device=dev),
            torch.full((b,), 10.0, device=dev),
            torch.full((b,), 0.1, device=dev),
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with capturing() as cap:
            reset_launches()
            draws = draw_frames(torch.Generator(device=dev).manual_seed(19), params, cfg, device=dev)
            frames, out = run_path(dev, cfg, params, draws, pairs)
            torch.cuda.synchronize()
            launches = read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        for est, (h, _) in out.items():
            fail_unless(tuple(h.shape) == tuple(frames.channel.shape), f"{name} {est} estimate shape")
            fail_unless(bool(torch.isfinite(h).all()), f"{name} {est} estimate finite")
        full_db = out["mmse_full"][1]
        fail_unless(abs(full_db - ENVELOPE_ANCHOR_DB) <= NMSE_SLACK_DB,
                    f"{name} mmse_full NMSE {full_db:.4f} dB within {NMSE_SLACK_DB} dB of "
                    f"{ENVELOPE_ANCHOR_DB:.3f} dB")
        fail_unless(all(n > 0 for n in launches.values()),
                    f"{name}: every kernel launched on the envelope path: {launches}")
        k = cfg.ofdm.num_used_subcarriers
        print(f"{name} (4x{num_rx}, {num_symbols} x {k}, ETU {doppler:.0f} Hz 10 dB 10% pilots, "
              f"{b} frames): "
              f"NMSE dB " + ", ".join(f"{est} {db:.4f}" for est, (_, db) in out.items())
              + f"; launches " + ", ".join(f"{kn} {v}" for kn, v in launches.items())
              + f"; peak memory {peak_gib:.2f} GiB")
        print(f"  card vs CPU on the first {ENVELOPE_CPU_FRAMES} frames, max error of rms: "
              + ", ".join(envelope_against_cpu(dev, cfg, params, draws, pairs)))
        hold_against_plain(f"  {name}", cap.args)
        gram, rhs = cap.args["hpd_solve"]
        vals, mask, method = cap.args["interp_fused"]
        slot_args = cap.args["interp"]
        timed = {
            "hpd_solve": (lambda: hpd_mod.hpd_solve(gram, rhs), hpd_mod.work(*rhs.shape),
                          f"{tuple(gram.shape)} x {rhs.shape[-1]}, route "
                          f"{hpd_mod.plan(*rhs.shape[1:]).route}"),
            "interp_fused": (lambda: grid_mod.interpolate_grid_fused(vals, mask, method),
                             grid_mod.work(mask, vals.shape[1], method),
                             f"{tuple(vals.shape)} {method}, route "
                             f"{grid_mod.plan(*vals.shape[1:]).route}"),
            "interp": (lambda: slot_mod.interpolate_slots(*slot_args), slot_mod.work(*slot_args),
                       f"{tuple(slot_args[0].shape)} {slot_args[-1]}, route "
                       f"{slot_mod.plan(*slot_args[0].shape[1:], *slot_args[3]).route}"),
        }
        for kn, (fn, work, shape) in timed.items():
            ms, ms_min, ms_max = graph_ms(fn)
            bound_ms, bound_by = bound(*work)
            print(f"  {kn}: kernel {ms:.4f} ms ({ms_min:.4f}-{ms_max:.4f} over 5 replays of a graph "
                  f"of 20), bound {bound_ms:.4f} ms ({bound_by}) at {shape}")
        if gram.shape[-1] > hpd_mod.MAX_N:
            fail_unless(hpd_mod.plan(*rhs.shape[1:]).route == "cluster",
                        f"{name}: mmse_full's system {tuple(gram.shape)} takes the cluster kernel")
            hpd_cluster_times({f"{name}'s": (gram, rhs)})
        else:
            plain_ms = cuda_ms(lambda: hpd_mod.hpd_solve_plain(gram, rhs))[0]
            library_ms = cuda_ms(lambda: torch.linalg.solve(gram, rhs))[0]
            print(f"  hpd_solve at {tuple(gram.shape)}: plain {plain_ms:.4f} ms, library "
                  f"(torch.linalg.solve) {library_ms:.4f} ms, back to back")
        for kn, v in launches.items():
            total[kn] += v
    envelope_hard_cases(dev)
    hpd_random_times(dev)
    route_times(main_args, parity_args)
    print(f"  card: {card}")
    print(f"phase 19 wall time: {time.perf_counter() - t_phase:.1f} s")
    return total


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
    from ce5g_torch.ops import nmse as nmse_mod
    from ce5g_torch.ops import channel as channel_mod
    from ce5g_torch.ops import pilot_select as select_mod
    from ce5g_torch.ops import profile_gram as gram_mod

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
    h_main, e_main, axes_main = captured["nmse"]
    kernels.append(kernel_row("nmse", "ce5g_torch/csrc/nmse.cu", None, launches["nmse"],
                              main_errs["nmse"],
                              lambda: nmse_mod.nmse(h_main, e_main, axes_main),
                              lambda: nmse_mod.nmse_plain(h_main, e_main, axes_main),
                              nmse_mod.work(h_main, e_main)))
    select_args = captured["pilot_select"]
    u_main, _, _, _, p_main = select_args
    kernels.append(kernel_row("pilot_select", "ce5g_torch/csrc/pilot_select.cu", None,
                              launches["pilot_select"], main_errs["pilot_select"],
                              lambda: select_mod.pilot_select(*select_args),
                              lambda: select_mod.pilot_select_plain(*select_args),
                              select_mod.work(*u_main.shape, p_main)))
    channel_args = captured["channel"]
    kernels.append(kernel_row("channel", "ce5g_torch/csrc/channel.cu", None, launches["channel"],
                              main_errs["channel"], lambda: channel_mod.channel(*channel_args),
                              lambda: channel_mod.channel_plain(*channel_args),
                              channel_mod.work(channel_args[0], channel_args[3])))
    gram_args = captured["profile_gram"]
    _, gram_s, gram_r, gram_k = gram_args[0].shape
    gram_pilots = gram_args[2].sum((1, 2)).long().tolist()
    kernels.append(kernel_row("profile_gram", "ce5g_torch/csrc/profile_gram.cu", None,
                              launches["profile_gram"], main_errs["profile_gram"],
                              lambda: gram_mod.profile_gram(*gram_args),
                              lambda: gram_mod.profile_gram_plain(*gram_args),
                              gram_mod.work(gram_s, gram_r, gram_k,
                                            [gram_args[3].num_paths] * len(gram_pilots),
                                            gram_pilots)))
    shapes = {"hpd_solve": tuple(gram.shape), "interp_fused": tuple(vals.shape),
              "interp": tuple(slot_args[0].shape) + (slot_args[-1],),
              "nmse": tuple(h_main.shape), "pilot_select": tuple(u_main.shape),
              "channel": tuple(channel_args[0].shape),
              "profile_gram": tuple(gram_args[0].shape)}
    for kern in kernels:
        print(f"{kern['name']}: kernel {kern['ms']:.4f} ms ({kern['ms_min']:.4f}-"
              f"{kern['ms_max']:.4f} over 5 replays of a graph of 20), back-to-back calls "
              f"{kern['call_ms']:.4f} ms, plain {kern['plain_ms']:.4f} ms, "
              f"bound {kern['bound_ms']:.4f} ms ({kern['bound_by']}), library "
              f"{kern['library_ms'] if kern['library_ms'] is None else round(kern['library_ms'], 4)} ms "
              f"at {shapes[kern['name']]}")
    for kern in kernels[1:3]:
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
    nmse_times(dev)
    pilot_select_times(dev)
    channel_times(dev)
    profile_gram_times(dev)

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
    # sidecars) is removed however phases 9-16 end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as workdir:
        t0 = time.perf_counter()
        serving_launches, ev, ds, serving_results = serving_phase(dev, card, workdir)
        where_a_serving_batch_goes(ev, ds, MODEL_BATCH)
        print(f"phases 9-10 wall time: {time.perf_counter() - t0:.1f} s")
        blind_launches, blind_results = blind_phase(dev, card, workdir, ev.cfg, ds, ev,
                                                    serving_results)
        training_launches, tune_sets = training_phase(dev, card, ds)
        factory_launches = factory_phase(dev, card)
        evaluation_launches = evaluation_phase(dev, card, serving_results, tune_sets)
        time_domain_launches = time_domain_phase(dev, card, tune_sets)
        cli_launches = cli_phase(dev, card, workdir, ds, serving_results, blind_results)
    notebook_launches = notebook_phase(dev, card)
    bench_launches = measuring_phase(dev, card, rates)
    envelope_launches = envelope_phase(dev, card, captured, parity_args)
    for kern in kernels:
        kern["launches_by_path"] = {"main": launches[kern["name"]],
                                    "parity": parity_launches[kern["name"]],
                                    "serving": serving_launches[kern["name"]],
                                    "blind": blind_launches[kern["name"]],
                                    "training": training_launches[kern["name"]],
                                    "factory": factory_launches[kern["name"]],
                                    "evaluation": evaluation_launches[kern["name"]],
                                    "time_domain": time_domain_launches[kern["name"]],
                                    "cli": cli_launches[kern["name"]],
                                    "notebook": notebook_launches[kern["name"]],
                                    "bench": bench_launches[kern["name"]],
                                    "envelope": envelope_launches[kern["name"]]}
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
