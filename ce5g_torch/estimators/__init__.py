from .interpolate import interpolate_grid
from .ls import ls_at_pilots, ls_estimate
from .mmse import bessel_j0, mmse_diag_at_pilots, mmse_diag_estimate, mmse_full_estimate
from .api import auto_time_rank, estimate_batch, estimate_frame

__all__ = [
    "interpolate_grid",
    "ls_at_pilots",
    "ls_estimate",
    "bessel_j0",
    "mmse_diag_at_pilots",
    "mmse_diag_estimate",
    "mmse_full_estimate",
    "auto_time_rank",
    "estimate_batch",
    "estimate_frame",
]
