from .equalize import equalize_channel
from .interpolate import interpolate_grid, normalized_conv_interpolate
from .ls import ls_at_pilots, ls_estimate
from .mmse import (
    WienerPrior,
    build_wiener_prior,
    estimate_covariance,
    mmse_diag_at_pilots,
    mmse_diag_estimate,
    mmse_full_estimate,
    wiener_reconstruct,
    wiener_solve,
)
from .time_prior import auto_time_rank, bessel_j0
from .api import estimate_batch, estimate_frame

__all__ = [
    "equalize_channel",
    "interpolate_grid",
    "normalized_conv_interpolate",
    "ls_at_pilots",
    "ls_estimate",
    "WienerPrior",
    "bessel_j0",
    "build_wiener_prior",
    "estimate_covariance",
    "wiener_reconstruct",
    "wiener_solve",
    "mmse_diag_at_pilots",
    "mmse_diag_estimate",
    "mmse_full_estimate",
    "auto_time_rank",
    "estimate_batch",
    "estimate_frame",
]
