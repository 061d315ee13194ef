"""P1 and P2: the gather probe's kernels (``csrc/gather_kernels.cu``).

P1 replaces ``scripts/probe_r7.py::pallas_take``, a flat gather with the
index clamped into the table (``jnp.take(tbl, idx, mode="clip")``):
``take_clip(tbl, idx)[i] = tbl[clamp(idx[i], 0, n - 1)]``.

P2 replaces ``scripts/probe_r7.py::pallas_tala``, a per-column gather
(``jnp.take_along_axis(t2, i2, axis=0)``):
``take_along_cols(t2, i2)[r, c] = t2[i2[r, c], c]``, with
``take_along_axis``'s own rule for an index outside [0, S): a negative one
counts from the end once, and one still outside gives its fill word,
0xFFFFFFFF.  The probe forms ``t2`` and ``i2 = idx % S`` outside its kernel
(``tala_inputs``), and so does the port.

u32 words travel as int32 tensors of the same bits (``core/u32.py``);
indices are int32.  Each wrapper launches its kernel for CUDA tensors and
runs its plain version (``take_clip_plain``, ``take_along_cols_plain``) for
CPU tensors.  ``take_clip_launches`` and ``take_along_cols_launches``
count the launches of each kernel.
"""

from __future__ import annotations

import torch

_I32 = torch.int32

take_clip_launches = 0
take_along_cols_launches = 0


def take_clip_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(tbl, idx, mode="clip")`` in plain PyTorch."""
    return torch.take(tbl, torch.clamp(idx, 0, tbl.numel() - 1).long())


def take_along_cols_plain(t2: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(t2, i2, axis=0)`` in plain PyTorch."""
    rows = t2.shape[0]
    i = torch.where(i2 < 0, i2 + rows, i2)
    inside = (i >= 0) & (i < rows)
    got = torch.gather(t2, 0, torch.clamp(i, 0, rows - 1).long())
    return torch.where(inside, got, torch.full_like(got, -1))


def tala_inputs(tbl: torch.Tensor, idx: torch.Tensor, cols: int = 128):
    """The probe's prologue to P2: the flat table cut to whole rows of
    ``cols`` words, ``t2`` (S, cols), and ``i2 = idx % S`` (floor
    modulo, as ``jnp``'s ``%``)."""
    rows = tbl.numel() // cols
    return (tbl[:rows * cols].reshape(rows, cols),
            torch.remainder(idx, rows).to(_I32))


def take_clip(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1: ``tbl`` (n,) u32 words as int32, ``idx`` int32 of any shape ->
    int32 words of ``idx``'s shape."""
    if tbl.device.type == "cpu":
        return take_clip_plain(tbl, idx)
    return take_clip_cuda(tbl, idx)


def take_along_cols(t2: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """P2: ``t2`` (S, C) u32 words as int32, ``i2`` (R, C) int32 ->
    (R, C) int32 words."""
    if t2.device.type == "cpu":
        return take_along_cols_plain(t2, i2)
    return take_along_cols_cuda(t2, i2)


def take_clip_cuda(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel of P1; raises for anything it does not take."""
    from rvgrt_tpu_torch.ops import _lib

    global take_clip_launches
    dev = tbl.device
    if dev.type != "cuda" or tbl.ndim != 1 or tbl.numel() == 0:
        raise ValueError(f"take_clip_cuda: table {tuple(tbl.shape)} on "
                         f"{dev}")
    _lib.require(tbl, "tbl", _I32, dev)
    _lib.require(idx, "idx", _I32, dev)
    out = torch.empty_like(idx)
    take_clip_launches += 1
    _lib.check(_lib.library().rvgrt_take_clip(
        tbl.data_ptr(), tbl.numel(), idx.data_ptr(), out.data_ptr(),
        idx.numel(), _lib.stream_ptr(dev)), "take_clip_cuda")
    return out


def take_clip_l2(tbl: torch.Tensor, idx: torch.Tensor, window_bytes: int,
                 hit_ratio: float) -> torch.Tensor:
    """P1's kernel launched with an L2 access-policy window over the first
    ``window_bytes`` of ``tbl``, a share ``hit_ratio`` of it persisting (a
    measurement of the probe's question; the path runs ``take_clip``).  The
    device's persisting share of L2 is set with ``set_persisting_l2``."""
    from rvgrt_tpu_torch.ops import _lib

    global take_clip_launches
    dev = tbl.device
    if dev.type != "cuda" or tbl.ndim != 1 or tbl.numel() == 0:
        raise ValueError(f"take_clip_l2: table {tuple(tbl.shape)} on {dev}")
    _lib.require(tbl, "tbl", _I32, dev)
    _lib.require(idx, "idx", _I32, dev)
    out = torch.empty_like(idx)
    take_clip_launches += 1
    _lib.check(_lib.library().rvgrt_take_clip_l2(
        tbl.data_ptr(), tbl.numel(), idx.data_ptr(), out.data_ptr(),
        idx.numel(), window_bytes, hit_ratio, _lib.stream_ptr(dev)),
        "take_clip_l2")
    return out


def set_persisting_l2(nbytes: int) -> None:
    """Set aside ``nbytes`` of the current device's L2 for persisting
    accesses; 0 gives it back and clears the persisting lines."""
    from rvgrt_tpu_torch.ops import _lib

    _lib.check(_lib.library().rvgrt_set_persisting_l2(nbytes),
               "set_persisting_l2")


def take_along_cols_cuda(t2: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel of P2; raises for anything it does not take."""
    from rvgrt_tpu_torch.ops import _lib

    global take_along_cols_launches
    dev = t2.device
    if dev.type != "cuda" or t2.ndim != 2 or t2.numel() == 0:
        raise ValueError(f"take_along_cols_cuda: table {tuple(t2.shape)} "
                         f"on {dev}")
    rows, cols = t2.shape
    _lib.require(t2, "t2", _I32, dev)
    _lib.require(i2, "i2", _I32, dev)
    if i2.ndim != 2 or i2.shape[1] != cols:
        raise ValueError(f"take_along_cols_cuda: i2 {tuple(i2.shape)} for "
                         f"a ({rows}, {cols}) table")
    out = torch.empty_like(i2)
    take_along_cols_launches += 1
    _lib.check(_lib.library().rvgrt_take_along_cols(
        t2.data_ptr(), rows, cols, i2.data_ptr(), out.data_ptr(),
        i2.numel(), _lib.stream_ptr(dev)), "take_along_cols_cuda")
    return out
