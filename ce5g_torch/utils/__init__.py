from .complexify import packed_complex_matmul
from .metrics import linear2db, mse, nmse, nmse_db

__all__ = ["packed_complex_matmul", "linear2db", "mse", "nmse", "nmse_db"]
