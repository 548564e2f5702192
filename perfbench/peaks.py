"""Published dense peaks of the card (NVIDIA's H100 data sheets, without
sparsity), by variant: bf16 tensor-core operations/s, int8 tensor-core
operations/s, device-memory bytes/s.  The rates assume the card's full
power limit; a run records the card's name beside its numbers."""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    variant: str
    bf16: float
    int8: float
    bandwidth: float


_TABLE = {
    "H100 SXM": (989e12, 1979e12, 3.35e12),
    "H100 PCIe": (756e12, 1513e12, 2.0e12),
    "H100 NVL": (835e12, 1671e12, 3.9e12),
}


def peaks_for(device_name: str) -> Peaks:
    """The peaks of the variant ``device_name`` names (SXM unless it says
    PCIe or NVL)."""
    variant = ("H100 PCIe" if "PCIe" in device_name else
               "H100 NVL" if "NVL" in device_name else "H100 SXM")
    return Peaks(variant, *_TABLE[variant])
