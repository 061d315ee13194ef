"""uint32 arithmetic on int32 tensors.

The JAX package computes hashes, flag fields and packed words in
``uint32``.  PyTorch on the CPU has no ``>>``, ``<<`` or ``>`` for
``torch.uint32``, and ``>>`` on int32 is an arithmetic shift.  So the port
carries every such word as int32 with the same 32 bits; multiplication,
addition, xor, and, or and ``<<`` wrap identically.  This module holds the
steps that differ: logical right shift, unsigned compare, conversion to
float, and the numpy round trip.  Every u32 step of the port goes through
these helpers (the CUDA kernels use ``uint32_t`` instead).
"""

from __future__ import annotations

import numpy as np
import torch

_I32 = torch.int32
_SIGN = -(1 << 31)  # 0x80000000 as an int32


def c(value: int) -> int:
    """A u32 constant as the int32 of the same bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


def lsr(x: torch.Tensor, k) -> torch.Tensor:
    """Logical shift right by ``k`` (a Python int, or a tensor in [0, 31])."""
    if isinstance(k, torch.Tensor):
        # keep the low 32-k bits; written so that k == 0 keeps all 32
        k = k.to(_I32)
        return (x >> k) & ~((-1 << (31 - k)) << 1)
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def shl(x: torch.Tensor, k) -> torch.Tensor:
    """Shift left, wrapping at 32 bits (``k`` an int or a tensor in [0, 31])."""
    if isinstance(k, torch.Tensor):
        k = k.to(_I32)
    return x << k


def lt(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned ``a < b``."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """The u32 value of each word, rounded to float32 once."""
    return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy array -> int32 tensor of the same bits."""
    a = np.ascontiguousarray(a)
    assert a.dtype == np.uint32, a.dtype
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array of the same bits."""
    assert t.dtype == _I32, t.dtype
    return t.detach().cpu().numpy().view(np.uint32)
