"""The precision a reference run computes in.

``REFERENCE`` is float64 throughout. ``CONTROL`` is the nearest step below
what the port's configuration states: float32 where the port computes in
float64 (the Wiener system), and TF32 where it computes float32 matmuls
with TF32 off. TF32 is applied to the operands of every matmul and einsum
(rounded to 10 explicit mantissa bits, to nearest, ties away from zero, as
the tensor cores take them) with the sums in float32, so the control reads
the same on any device.
"""
from __future__ import annotations

import dataclasses

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) with every real part rounded to TF32."""
    if x.is_complex():
        return torch.view_as_complex(tf32(torch.view_as_real(x.resolve_conj()).contiguous()))
    if x.dtype != torch.float32:
        raise TypeError(f"TF32 rounding takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF  # add half of the dropped 13 bits, drop them
    return rounded.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype
    complex: torch.dtype
    tf32_matmul: bool

    def einsum(self, equation: str, *operands: torch.Tensor) -> torch.Tensor:
        """``torch.einsum`` in this precision; with ``tf32_matmul`` on
        operands rounded to TF32. Real operands join complex ones as complex."""
        cplx = any(op.is_complex() for op in operands)
        dtype = self.complex if cplx else self.real
        ops = [op.to(dtype) for op in operands]
        if self.tf32_matmul:
            ops = [tf32(op) for op in ops]
        return torch.einsum(equation, *ops)


REFERENCE = Precision("reference", torch.float64, torch.complex128, False)
CONTROL = Precision("control", torch.float32, torch.complex64, True)
