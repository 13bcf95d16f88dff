"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, SXM parts, at the full power limit)."""

from __future__ import annotations

from typing import Optional

# device name (as torch.cuda.get_device_name gives it) prefix -> HBM bytes/s
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bytes_per_s(kind: str) -> Optional[float]:
    """The card's memory bandwidth, or None for a device not in the table."""
    for name, peak in HBM_BYTES_PER_S.items():
        if kind.startswith(name):
            return peak
    return None
