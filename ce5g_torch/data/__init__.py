"""Split generation and chunk files of the port (``ce5g_tpu.data``'s
part that feeds a split)."""
from .generator import CHUNK_KEYS, draw_params, generate_chunk, read_chunk, read_split

__all__ = ["CHUNK_KEYS", "draw_params", "generate_chunk", "read_chunk", "read_split"]
