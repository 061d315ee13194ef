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

How a launch is laid out is decided here, by ``launch_plan``, a pure
function of the shapes, the pointers' alignment and the card's limits
(``gather_limits``, read once a device): how many lanes take the vector
path (``V`` lanes a thread, 16 B accesses) and how many the scalar loop,
whether the table goes to a cluster's shared memory (``on_chip``) or is
read through L2, and the grid.  Of the L2 path's cache-policy hints the
wrappers take ``HINT_STREAM``; the probe times the body under each
combination (``hints=``), and ``HINT_KEEP`` measured no gain at any table
and a loss at 64-100 MiB (PERF.md).  The on-chip variant (``on_chip=True``) is a measurement
of the probe's question, off the path: on the H100 it is slower than the L2
path at every table it takes (``tools/probe_r7.py``; PERF.md).
"""

from __future__ import annotations

import dataclasses

import torch

_I32 = torch.int32

#: as ``csrc/gather_kernels.cu``: lanes a thread owns, threads of a block on
#: the L2 path, CTAs of the on-chip cluster and threads of each, and the
#: bytes of shared memory before a CTA's slice of the table (its mbarrier)
V = 4
BLOCK = 256
CLUSTER = 16
CLUSTER_BLOCK = 1024
BARRIER_BYTES = 16
#: the L2 path's cache-policy hints: indices and words streamed
#: evict-first; table words read under an evict-last policy, no L1 line.
#: ``HINTS``, the wrappers' choice, is the set the probe's ablation timed
#: fastest on the H100
HINT_STREAM, HINT_KEEP = 1, 2
HINTS = HINT_STREAM
_P1, _P2 = 0, 1

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


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of a gather kernel."""

    groups: int       # V-lane groups on the vector path (16 B accesses)
    tail: int         # lanes after them, taken one a thread
    on_chip: bool     # the table in a cluster's shared memory
    grid: int         # blocks (on chip, a multiple of CLUSTER)
    slice_words: int  # on chip: table words each CTA holds, else 0


def on_chip_slice(table_words: int, smem_optin: int) -> int:
    """Table words each CTA of a ``CLUSTER``-CTA cluster holds, a whole
    number of 16 B units, or 0 when the table does not fit their shared
    memory (``smem_optin`` bytes a CTA, ``BARRIER_BYTES`` of it taken)."""
    words = -(-table_words // CLUSTER)
    words = -(-words // 4) * 4
    return words if BARRIER_BYTES + 4 * words <= smem_optin else 0


def on_chip_words_max(smem_optin: int) -> int:
    """The largest table, in words, that the on-chip variant takes."""
    return CLUSTER * ((smem_optin - BARRIER_BYTES) // 16 * 4)


def launch_plan(lanes: int, table_words: int, cols, ptrs, limits: dict,
                on_chip: bool = False) -> LaunchPlan:
    """The launch for ``lanes`` lanes over a ``table_words``-word table.

    ``cols``: P2's row width, None for P1.  ``ptrs``: the addresses of the
    indices, the output and the table.  ``limits``: ``sms``,
    ``blocks_per_sm`` (resident blocks of ``BLOCK`` threads), ``smem_optin``
    and ``clusters`` (resident ``CLUSTER``-CTA clusters), as
    ``gather_limits`` gives them.  ``on_chip``: the on-chip variant
    (ValueError where the table does not fit or the card holds no
    cluster); else the table is read through L2.

    A thread owns ``V`` consecutive lanes where the indices and the output
    are 16 B aligned and, for P2, ``cols % V == 0``; else every lane is
    scalar.  The grid is the blocks the card holds at once, capped at the
    blocks the lanes fill.
    """
    idx_ptr, out_ptr, tbl_ptr = ptrs
    vec = idx_ptr % 16 == 0 and out_ptr % 16 == 0 and (
        cols is None or cols % V == 0)
    groups = lanes // V if vec else 0
    tail = lanes - groups * V
    threads = max(groups, tail, 1)
    if on_chip:
        fits = (on_chip_slice(table_words, limits["smem_optin"])
                if tbl_ptr % 16 == 0 and limits["clusters"] > 0 else 0)
        if not fits:
            raise ValueError(
                f"on-chip gather: a {table_words}-word table at "
                f"{tbl_ptr:#x} does not fit {CLUSTER} CTAs of "
                f"{limits['smem_optin']} B ({limits['clusters']} clusters "
                "resident)")
        clusters = min(limits["clusters"],
                       -(-threads // (CLUSTER * CLUSTER_BLOCK)))
        return LaunchPlan(groups, tail, True, CLUSTER * max(clusters, 1),
                          fits)
    grid = min(limits["sms"] * limits["blocks_per_sm"], -(-threads // BLOCK))
    return LaunchPlan(groups, tail, False, max(grid, 1), 0)


_limits: dict = {}


def gather_limits(dev) -> tuple:
    """The card's limits for ``launch_plan``, P1's and P2's, read once a
    device (``rvgrt_gather_limits``)."""
    import ctypes

    from rvgrt_tpu_torch.ops import _lib

    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _limits:
        v = (ctypes.c_int * 6)()
        _lib.check(_lib.library().rvgrt_gather_limits(
            key, ctypes.addressof(v)), "gather_limits")
        _limits[key] = tuple(
            dict(sms=v[0], blocks_per_sm=v[1 + k], smem_optin=v[3],
                 clusters=v[4 + k]) for k in (_P1, _P2))
    return _limits[key]


def _gather(what: str, kind: int, tbl, cols, idx, hints: int, on_chip,
            window=(0, 0.0)) -> torch.Tensor:
    """Plan and launch one gather; counts it in its kernel's counter."""
    from rvgrt_tpu_torch.ops import _lib

    dev = tbl.device
    out = torch.empty_like(idx)
    lanes, n = idx.numel(), tbl.numel()
    if lanes == 0:
        return out
    plan = launch_plan(lanes, n, cols,
                       (idx.data_ptr(), out.data_ptr(), tbl.data_ptr()),
                       gather_limits(dev)[kind], on_chip)
    lib, stream = _lib.library(), _lib.stream_ptr(dev)
    counter = ("take_clip_launches", "take_along_cols_launches")[kind]
    globals()[counter] += 1
    if plan.on_chip:
        err = lib.rvgrt_gather_cluster(
            kind, tbl.data_ptr(), n, cols or 0, idx.data_ptr(),
            out.data_ptr(), lanes, plan.groups, plan.grid // CLUSTER,
            plan.slice_words, stream)
    else:
        err = lib.rvgrt_gather(
            kind, tbl.data_ptr(), n, cols or 0, idx.data_ptr(),
            out.data_ptr(), lanes, plan.groups, plan.grid, hints, *window,
            stream)
    _lib.check(err, what)
    return out


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


def _require_take(what: str, tbl, idx) -> None:
    from rvgrt_tpu_torch.ops import _lib

    dev = tbl.device
    if dev.type != "cuda" or tbl.ndim != 1 or tbl.numel() == 0:
        raise ValueError(f"{what}: table {tuple(tbl.shape)} on {dev}")
    _lib.require(tbl, "tbl", _I32, dev)
    _lib.require(idx, "idx", _I32, dev)


def take_clip_cuda(tbl: torch.Tensor, idx: torch.Tensor, hints: int = HINTS,
                   on_chip: bool = False) -> torch.Tensor:
    """The CUDA kernel of P1; raises for anything it does not take.
    ``hints``: the L2 path's cache-policy hints (the probe's ablation);
    ``on_chip``: the on-chip variant (``launch_plan``)."""
    _require_take("take_clip_cuda", tbl, idx)
    return _gather("take_clip_cuda", _P1, tbl, None, idx, hints, on_chip)


def take_clip_l2(tbl: torch.Tensor, idx: torch.Tensor, window_bytes: int,
                 hit_ratio: float) -> torch.Tensor:
    """P1's L2 path launched with an L2 access-policy window over the first
    ``window_bytes`` of ``tbl``, a share ``hit_ratio`` of it persisting (a
    measurement of the probe's question; the path runs ``take_clip``).  The
    device's persisting share of L2 is set with ``set_persisting_l2``."""
    _require_take("take_clip_l2", tbl, idx)
    return _gather("take_clip_l2", _P1, tbl, None, idx, HINTS, False,
                   (window_bytes, hit_ratio))


def set_persisting_l2(nbytes: int) -> None:
    """Set aside ``nbytes`` of the current device's L2 for persisting
    accesses; 0 gives it back and clears the persisting lines."""
    from rvgrt_tpu_torch.ops import _lib

    _lib.check(_lib.library().rvgrt_set_persisting_l2(nbytes),
               "set_persisting_l2")


def take_along_cols_cuda(t2: torch.Tensor, i2: torch.Tensor,
                         hints: int = HINTS,
                         on_chip: bool = False) -> torch.Tensor:
    """The CUDA kernel of P2; raises for anything it does not take.
    ``hints`` and ``on_chip`` as for ``take_clip_cuda``."""
    from rvgrt_tpu_torch.ops import _lib

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
    return _gather("take_along_cols_cuda", _P2, t2, cols, i2, hints,
                   on_chip)
