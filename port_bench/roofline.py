"""The yardstick's peaks and the bytes each kernel with a roofline metric
has to move.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 80 GB of HBM3 at
3.35 TB/s.  A share of the roofline is stated against it, with the card's
power limit beside it.
"""

from __future__ import annotations

#: HBM bandwidth of one H100 SXM, bytes a second
H100_HBM_BYTES_S = 3.35e12


def k2_bytes(height: int, width: int) -> int:
    """K2's count-once bytes for a (height, width) history warp: the u32
    history read once (4 B a pixel), the two f32 source coordinates read
    once (8 B) and the (4, height, width) f32 planes written once (16 B)."""
    return (4 + 8 + 16) * height * width


def bound_s(nbytes: int) -> float:
    """The least time that moving ``nbytes`` takes at the HBM peak."""
    return nbytes / H100_HBM_BYTES_S
