"""Evaluation of the port: the Phase-2 classical-estimator parity study
(``parity``), the test-split evaluation of the classical and neural
estimators (``evaluate``), measured BER (``ber``), the pilot-density
study (``pilot_opt``), the hyperparameter search (``tuning``) and the
reports (``report``)."""
from .ber import (
    ber_batch,
    ber_frame,
    ber_sweep,
    draw_qam_frames,
    simulate_qam_batch,
    simulate_qam_frame,
)
from .evaluate import ModelEvaluator, evaluate_baselines, evaluate_estimators
from .pilot_opt import PilotOptimizer
from .report import (
    generate_evaluation_report,
    generate_final_report,
    plot_comparison,
    plot_snr_sweep,
    plot_training_curves,
)
from .tuning import DEFAULT_CNN_SPACE, HyperparameterTuner, QuickDataset

__all__ = [
    "ber_batch",
    "ber_frame",
    "ber_sweep",
    "draw_qam_frames",
    "simulate_qam_batch",
    "simulate_qam_frame",
    "ModelEvaluator",
    "evaluate_baselines",
    "evaluate_estimators",
    "PilotOptimizer",
    "generate_evaluation_report",
    "generate_final_report",
    "plot_comparison",
    "plot_snr_sweep",
    "plot_training_curves",
    "DEFAULT_CNN_SPACE",
    "HyperparameterTuner",
    "QuickDataset",
]
