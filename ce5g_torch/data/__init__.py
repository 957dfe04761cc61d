"""The port's dataset factory (``ce5g_tpu.data``): chunks of frames are
simulated and LS-estimated on the card, written as chunk files with a
JSON manifest (npz, h5 or the ``.ce5g`` container), resumable and split
across writers by chunk index; verification, Wiener sidecars, and the
at-scale digest and online-training paths."""
from .atscale import generate_digest_split, online_train, verify_digest_chunk
from .generator import (
    CHUNK_KEYS,
    DatasetGenerator,
    draw_params,
    generate_chunk,
    read_chunk,
    read_split,
)
from .verify import verify_dataset
from .wiener import compute_wiener_sidecar

__all__ = [
    "CHUNK_KEYS",
    "DatasetGenerator",
    "compute_wiener_sidecar",
    "draw_params",
    "generate_chunk",
    "generate_digest_split",
    "online_train",
    "read_chunk",
    "read_split",
    "verify_dataset",
    "verify_digest_chunk",
]
