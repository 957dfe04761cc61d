from .complexify import complex_to_real, packed_complex_matmul, real_to_complex
from .host import get_numpy, put_complex
from .metrics import (
    awgn_noise,
    ber_approximation,
    calculate_ber,
    db2linear,
    evaluate_estimator,
    linear2db,
    mse,
    nmse,
    nmse_db,
)
from .profiling import Stopwatch, annotate, trace
from .qam import bits_per_symbol, qam_demodulate, qam_modulate
from .sanitize import assert_finite, debug_nans, finite_report

__all__ = [
    "complex_to_real",
    "get_numpy",
    "put_complex",
    "packed_complex_matmul",
    "real_to_complex",
    "awgn_noise",
    "ber_approximation",
    "calculate_ber",
    "db2linear",
    "evaluate_estimator",
    "linear2db",
    "mse",
    "nmse",
    "nmse_db",
    "bits_per_symbol",
    "qam_demodulate",
    "qam_modulate",
    "Stopwatch",
    "annotate",
    "trace",
    "assert_finite",
    "debug_nans",
    "finite_report",
]
