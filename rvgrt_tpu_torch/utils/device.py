"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises.

    The port never falls back to the CPU on its own: a caller who wants the
    CPU (the parity tests) says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rvgrt_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
