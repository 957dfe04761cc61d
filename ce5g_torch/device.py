"""Device selection for the port's entry points.

Every public entry point takes ``device=`` (default ``"cuda"``) and calls
:func:`resolve_device`. Without a card it raises instead of quietly
running on the CPU; the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it is CUDA and no card
    is present. On CUDA it also pins float32 matmuls to full precision:
    the Woodbury system of ``estimators.mmse`` is conditioned by 1/σ², which
    TF32's 10-bit mantissa does not resolve at high SNR (the JAX package saw
    +5 dB NMSE without full precision). cuDNN's
    convolutions and LSTMs are kept in full float32 too: the models run at
    the JAX package's default float32 until TF32 or bf16 is measured."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev
