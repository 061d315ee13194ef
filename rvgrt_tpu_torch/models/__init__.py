"""Model registry: the port of ``rvgrt_tpu/models/__init__.py``.

The framework's learned components live here as named families, the way
the reference exposes DLSS modes (``main.cpp:529-543``):

* :mod:`rvgrt_tpu_torch.models.upscaler` - the 3x temporal upscaler family
  (the DLSS replacement, SURVEY.md §2.2).

``get(name)`` resolves any registered "family/variant" string, e.g.
``get("upscaler/up-m")``.
"""

from __future__ import annotations

from rvgrt_tpu_torch.models import upscaler


def get(name: str):
    """Resolve 'family/variant' to a constructed module (its parameters
    uninitialised: load a checkpoint or initialise it)."""
    family, _, variant = name.partition("/")
    if family == "upscaler":
        return upscaler.build(variant or "up-m")
    raise KeyError(f"unknown model family: {family!r} "
                   f"(available: ['upscaler'])")
