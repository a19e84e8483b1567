"""Published peaks of the device the cells run on (NVIDIA's H100 SXM data
sheet, at the full 700 W power limit)."""
from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
}
