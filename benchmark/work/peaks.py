"""Published peaks of each card, keyed by ``torch.cuda.get_device_name``.

A copy of the port's ``utils.profiling.CARD_PEAKS`` with the float64 rate
added. float32 is the rate outside the tensor cores (the port keeps TF32
off); float64 is the tensor cores' FP64 rate, which cuBLAS's DGEMM reaches,
so a float64 count over it is a least time. The rates assume the card's
full power limit. A card missing here gets no roofline: another card's
peaks are never borrowed.
"""
from __future__ import annotations

from typing import Dict, Optional

CARD_PEAKS: Dict[str, Dict] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "fp64_flops": 67e12, "bf16_flops": 989e12,
                              "hbm_Bps": 3.35e12, "source": "NVIDIA H100 data sheet, SXM5"},
    "NVIDIA H100 PCIe": {"fp32_flops": 51e12, "fp64_flops": 51e12, "bf16_flops": 756e12,
                         "hbm_Bps": 2.0e12, "source": "NVIDIA H100 data sheet, PCIe"},
    "NVIDIA H100 NVL": {"fp32_flops": 60e12, "fp64_flops": 60e12, "bf16_flops": 835e12,
                        "hbm_Bps": 3.9e12, "source": "NVIDIA H100 data sheet, NVL"},
    "NVIDIA H200": {"fp32_flops": 67e12, "fp64_flops": 67e12, "bf16_flops": 989e12,
                    "hbm_Bps": 4.8e12, "source": "NVIDIA H200 data sheet, SXM"},
}


def peaks_for(name: Optional[str]) -> Optional[Dict]:
    """The peaks of the card named ``name``, or None."""
    return CARD_PEAKS.get(name) if name else None


def least_seconds(nbytes: float, flops: Dict[str, float], peaks: Dict) -> float:
    """The least time to move ``nbytes`` and do ``flops`` (precision →
    count, each over its own peak, one after the other): the larger of
    the two."""
    t_ops = sum(n / peaks[f"{p}_flops"] for p, n in flops.items())
    return max(nbytes / peaks["hbm_Bps"], t_ops)
