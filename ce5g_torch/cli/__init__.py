"""The port's command line: one module per entry point of the JAX
package's ``scripts/`` and its ``bench.py``, each run as ``python -m
ce5g_torch.cli.<name>`` with that script's flags, defaults and output
files.

Every module has ``main(argv=None) -> int`` and ``build_parser()``. Each
takes ``--device`` (default ``cuda``; without a card it raises unless
given ``--device cpu``), and every directory it writes is a flag it must
be given, so a run never overwrites the JAX package's committed study
files. Computation a JAX script does inline is a plain function of its
module, so the tests can call it with arrays.

    quick_start          simulate one frame, LS / diagonal MMSE / Wiener
    generate_dataset     the dataset factory (torchrun for several writers)
    compute_wiener       Wiener feature sidecars ('wiener', 'bwiener')
    train_model          train one model family on a generated split
    evaluate_models      baselines, estimators and checkpoints on a split
    pilot_optimization   the pilot-density study
    tune_hyperparameters grid or random search over the cnn
    apply_tuning         retrain the search's winner and evaluate it
    final_report         FINAL_REPORT.md over a results directory
    train_online         generate → train with no files in the loop
    generate_at_scale    digest run, online training and codec rate
    parity_phase2        the Phase-2 classical-estimator parity study
    identifiable_study   the 1×2 SIMO estimator study
    diagnose_plateau     the superposition floor of the 2×2 split
    visualize_channels   channel heatmaps, Doppler sweep, autocorrelation
    bench                the headline: sustained frames/s and NMSE, one JSON line
    benchmark_suite      stage rates, rooflines, the HPD solve, codec, train steps
    bench_factory        the factory's device and end-to-end samples/s
    profile_bench        the bench pipeline's stages
    profile_fine         pilot, Jakes and MMSE sub-stages; larger batches
    profile_solve        small HPD-solve and frequency-response variants
"""

MODULES = (
    "quick_start",
    "generate_dataset",
    "compute_wiener",
    "train_model",
    "evaluate_models",
    "pilot_optimization",
    "tune_hyperparameters",
    "apply_tuning",
    "final_report",
    "train_online",
    "generate_at_scale",
    "parity_phase2",
    "identifiable_study",
    "diagnose_plateau",
    "visualize_channels",
    "bench",
    "benchmark_suite",
    "bench_factory",
    "profile_bench",
    "profile_fine",
    "profile_solve",
)
