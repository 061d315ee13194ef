"""K2: the temporal-upscale history warp (``csrc/warp_kernels.cu``).

Replaces ``rvgrt_tpu/ops/warp_kernels.py::warp_packed_bilinear``: an exact
4-tap bilinear gather of the packed u32 RGBN history at per-pixel f32
source coordinates, the +1 taps clamped to the edge.  Returns
``(planes, overflow)``: (4, OH, W) f32 [r, g, b, n/255-of-max] and an int32
count of taps outside the TPU kernel's DMA window.  The CUDA kernel gathers
straight from device memory and has no window, so ``overflow`` is always 0.

``warp_packed_bilinear`` launches the kernel for CUDA tensors and runs the
plain version (``warp_packed_bilinear_plain``, the counterpart of
``warp_packed_bilinear_xla``) for CPU tensors.  The kernel blends in the TPU
kernel's order (weights first), the plain version in the XLA oracle's order,
so the two differ by float rounding (<= 1e-6).  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from rvgrt_tpu_torch.core import u32

_F32 = torch.float32
_I32 = torch.int32

launches = 0


def _unpack4(word):
    """u32 RGBN -> 4 f32 planes (r, g, b in [0,1], n in [0,1]-of-max)."""
    f = 1.0 / 255.0
    return ((word & 0xFF).to(_F32) * f,
            (u32.lsr(word, 8) & 0xFF).to(_F32) * f,
            (u32.lsr(word, 16) & 0xFF).to(_F32) * f,
            (u32.lsr(word, 24) & 0xFF).to(_F32) * f)


def warp_packed_bilinear_plain(packed: torch.Tensor, xs: torch.Tensor,
                               ys: torch.Tensor):
    """Exact 4-tap bilinear gather in plain PyTorch (the XLA oracle)."""
    hh, hw = packed.shape
    x0 = torch.floor(xs).to(_I32)
    y0 = torch.floor(ys).to(_I32)
    x1 = torch.clamp_max(x0 + 1, hw - 1)
    y1 = torch.clamp_max(y0 + 1, hh - 1)
    fx = (xs - x0.to(_F32))[None]
    fy = (ys - y0.to(_F32))[None]

    def tap(yi, xi):
        return torch.stack(_unpack4(packed[yi.long(), xi.long()]))

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x1) * fx * (1 - fy)
           + tap(y1, x0) * (1 - fx) * fy + tap(y1, x1) * fx * fy)
    return out, torch.zeros((), dtype=_I32, device=packed.device)


def warp_packed_bilinear(packed: torch.Tensor, xs: torch.Tensor,
                         ys: torch.Tensor):
    """``packed``: (H, W) u32 words as int32; ``xs``/``ys``: (OH, W) f32
    source coords, already clipped into [0, W-1] / [0, H-1].  Returns
    ``(planes, overflow)``."""
    if packed.device.type == "cpu":
        return warp_packed_bilinear_plain(packed, xs, ys)
    return warp_packed_bilinear_cuda(packed, xs, ys)


def warp_packed_bilinear_cuda(packed: torch.Tensor, xs: torch.Tensor,
                              ys: torch.Tensor):
    """The CUDA kernel; raises for anything it does not take."""
    from rvgrt_tpu_torch.ops import _lib

    global launches
    dev = packed.device
    if dev.type != "cuda" or packed.ndim != 2:
        raise ValueError(f"warp_packed_bilinear_cuda: packed "
                         f"{tuple(packed.shape)} on {dev}")
    hh, hw = packed.shape
    _lib.require(packed, "packed", _I32, dev)
    _lib.require(xs, "xs", _F32, dev)
    if xs.ndim != 2 or xs.shape[1] != hw:
        raise ValueError(f"warp_packed_bilinear_cuda: xs {tuple(xs.shape)} "
                         f"for a ({hh}, {hw}) history")
    _lib.require(ys, "ys", _F32, dev, xs.shape)
    out = torch.empty((4,) + tuple(xs.shape), dtype=_F32, device=dev)
    fn = _lib.library().rvgrt_warp_bilinear
    launches += 1
    _lib.check(fn(packed.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                  out.data_ptr(), hh, hw, xs.numel(), _lib.stream_ptr(dev)),
               "warp_packed_bilinear_cuda")
    return out, torch.zeros((), dtype=_I32, device=dev)
