"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit). A share of a peak
is stated against these; every result line records the card's power limit
beside it (``device.power_limit_w``, ``harness.power_limit_w``)."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops_per_s": 495e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (``torch.cuda.
    get_device_name``), or None for a card the table lacks."""
    return PEAKS.get(kind)
