"""Upscaler model family: named variants of the learned DLSS replacement.

The port of ``rvgrt_tpu/models/upscaler.py``.  The reference delegates
upscaling to the closed Streamline DLSS binary with a mode enum
(``main.cpp:529-543``); here the role is a family of conv-net variants
trading quality for frame cost, all with the DLSS input contract (low-res
color + motion + depth + jitter + warped high-res history -> 3x color +
blend weight).

========  ========  ======  =====================================
name      features  layers  intent
========  ========  ======  =====================================
up-s       16        2      cheapest; interactive preview
up-m       32        3      default (bench / stage-5 operating point)
up-l       64        4      quality; offline re-render
========  ========  ======  =====================================
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rvgrt_tpu_torch.upscale import model as _m
from rvgrt_tpu_torch.utils.device import resolve_device


class UpscalerSpec(NamedTuple):
    name: str
    features: int
    depth_layers: int


VARIANTS: dict[str, UpscalerSpec] = {
    "up-s": UpscalerSpec("up-s", 16, 2),
    "up-m": UpscalerSpec("up-m", 32, 3),
    "up-l": UpscalerSpec("up-l", 64, 4),
}


def build(name: str = "up-m") -> _m.UpscalerNet:
    spec = VARIANTS[name]
    return _m.UpscalerNet(features=spec.features,
                          depth_layers=spec.depth_layers)


def init(name: str, generator: torch.Generator | None, height: int,
         width: int, device=None) -> _m.UpscalerNet:
    """A named variant, initialised as ``model.init_params`` initialises
    it (``generator`` seeds the feature kernels)."""
    spec = VARIANTS[name]
    return _m.init_params(height, width, features=spec.features,
                          generator=generator, device=resolve_device(device),
                          depth_layers=spec.depth_layers)
