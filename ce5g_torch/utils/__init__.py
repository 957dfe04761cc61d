from .complexify import packed_complex_matmul
from .metrics import ber_approximation, db2linear, linear2db, mse, nmse, nmse_db

__all__ = ["packed_complex_matmul", "ber_approximation", "db2linear", "linear2db", "mse",
           "nmse", "nmse_db"]
