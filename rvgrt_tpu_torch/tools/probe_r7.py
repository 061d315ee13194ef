#!/usr/bin/env python3
"""The gather probe on one NVIDIA GPU: the counterpart of sections 1-2 of
``scripts/probe_r7.py``.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.probe_r7 [--reps 7] [--out FILE]

The TPU probe asked whether a per-lane gather from a table held in the
core's fast memory (VMEM) beats XLA's gather from HBM.  The card has no
such level of tens of MB; its nearest is the 50 MB L2, which a table of up
to about that size stays in across a launch.  So on the card the question
becomes: does a random gather from a 2-100 MB table run faster once the
table fits in L2?

1. The gather ladder.  For each table size in ``SIZES_MB`` the same table
   as the probe's (``arange(n) * 2654435761``, u32, n = MiB * 2^18 words)
   and the same 1M indices (``(8192, 128)`` int32, ``randint(0, n)`` from
   ``numpy.random.RandomState(0)``, drawn in the probe's order) go through
   P1 (``ops.gather_kernels.take_clip``, the probe's ``pallas_take``) and
   P2 (``take_along_cols`` on ``tala_inputs``, its ``pallas_tala``).  Each
   is held bit for bit against its plain version.  Beside them: the library
   gather (``torch.take``; ``torch.gather`` for P2), the probe's "XLA HBM
   gather".  Then the probe's small-table reference ladder, ``REF_MB``:
   ``torch.take`` and P1 from ``arange(n)``.
2. The capacity ladder becomes the card's own limits, read from the
   device: the shared memory a block may opt in to, the L2 size, and the
   most of L2 that may persist.  On the ladder, P1 is also timed with an
   L2 access-policy window over its table (``take_clip_l2``), the share
   that may persist marked persisting: the probe's question asked of L2.

Sections 3-5 of the TPU probe (slim carry, the checkerboard shape,
``shard_map`` at mesh 1) need ``RenderConfig.slim_carry`` and the
``parallel/`` package, which the port does not have yet; they are skipped,
and the tool says so.

Each row: the kernel's device time (``ms``: CUDA-graph replays of 10
calls), ``event_ms`` (the Python call, host included, CUDA events), the
plain version's and the library call's times, and ``bound_ms``: the bytes
the gather must move at 3.35 TB/s - the indices read once, the words
written once, and each distinct 32 B sector of the table that the indices
touch read once.  One line per row on stderr, one JSON line per row on
stdout, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

SIZES_MB = (2, 8, 32, 64, 100)
REF_MB = (2, 64, 256)
ROWS, COLS = 8192, 128  # 1M lanes
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SECTOR = 32  # bytes the card moves for one random word
SKIPPED = ("sections 3-5 of scripts/probe_r7.py (slim carry, the "
           "checkerboard shape, shard_map at mesh 1) are skipped: they need "
           "RenderConfig.slim_carry and parallel/, which are not ported")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def words(mb: int) -> int:
    return mb * (1 << 20) // 4


def inputs(dev) -> list:
    """The probe's tables and indices, in its order: for each size of
    ``SIZES_MB`` (``kind`` "ladder") the hashed table and its indices, then
    for each of ``REF_MB`` (``kind`` "reference") ``arange(n)`` and its
    indices; one ``RandomState(SEED)`` draws every index array in turn.
    Returns ``[(kind, mb, make)]``, ``make()`` -> (table, idx) on ``dev``,
    so one table at a time lives on the card."""
    import torch

    from rvgrt_tpu_torch.core import u32

    rng = np.random.RandomState(SEED)
    out = []
    for kind, sizes, mult in (("ladder", SIZES_MB, 2654435761),
                              ("reference", REF_MB, 1)):
        for mb in sizes:
            n = words(mb)
            idx = rng.randint(0, n, size=(ROWS, COLS)).astype(np.int32)

            def make(n=n, idx=idx, mult=mult):
                tbl = torch.arange(n, dtype=torch.int32, device=dev)
                if mult != 1:
                    tbl = tbl * u32.c(mult)  # wraps as u32
                return tbl, torch.from_numpy(idx).to(dev)
            out.append((kind, mb, make))
    return out


def gather(tbl, idx, p2: bool = True) -> dict:
    """The probe's gathers through the port's kernels: P1 on the flat
    table, and P2 on the probe's per-column form of it."""
    from rvgrt_tpu_torch.ops import gather_kernels as g

    out = {"P1": g.take_clip(tbl, idx)}
    if p2:
        out["P2"] = g.take_along_cols(*g.tala_inputs(tbl, idx, COLS))
    return out


def sectors(elem_idx, n: int) -> int:
    """Distinct 32 B sectors of an ``n``-word table that the flat word
    indices ``elem_idx`` touch."""
    import torch

    touched = torch.zeros(-(-n * 4 // SECTOR), dtype=torch.bool,
                          device=elem_idx.device)
    touched[(elem_idx.long() * 4) // SECTOR] = True
    return int(touched.sum())


def l2_window(tbl, idx, want, limits: dict, dev, reps: int) -> dict:
    """P1's kernel with an L2 access-policy window over the table
    (``take_clip_l2``): as much of the table as one window may cover, with
    the share of it that the card's persisting L2 can hold marked
    persisting; bit for bit against ``want`` and graph-timed.  The
    persisting share is set for the measurement and given back after."""
    import torch

    from rvgrt_tpu_torch.ops import gather_kernels as g
    from rvgrt_tpu_torch.utils.timer import graph_ms

    persist = limits["persisting_l2_max_bytes"]
    window = min(tbl.numel() * 4, limits["access_policy_window_max_bytes"])
    hit = min(1.0, persist / window)
    g.set_persisting_l2(persist)
    try:
        got = g.take_clip_l2(tbl, idx, window, hit)
        assert torch.equal(got, want), "take_clip_l2 differs"
        ms = graph_ms(lambda: g.take_clip_l2(tbl, idx, window, hit), dev,
                      calls=10, reps=reps)
    finally:
        g.set_persisting_l2(0)
    return dict(l2_window_ms=ms, l2_window_bytes=window,
                l2_hit_ratio=hit, l2_persisting_bytes=persist)


def measure(kind: str, mb: int, tbl, idx, got: dict, dev, limits: dict,
            reps: int = 7) -> list:
    """Rows for the gathers of ``got`` (from ``gather``): each kernel
    against its plain version (bit for bit; raises if not), its graph and
    event times, the plain version's and the library call's times and its
    byte bound; for P1 on the ladder also its time under an L2 window
    (``l2_window``)."""
    import torch

    from rvgrt_tpu_torch.ops import gather_kernels as g
    from rvgrt_tpu_torch.utils.timer import graph_ms, timed_ms

    n = tbl.numel()
    lanes = idx.numel()
    t2, i2 = g.tala_inputs(tbl, idx, COLS)
    cases = {
        "P1": dict(kernel=lambda: g.take_clip(tbl, idx),
                   plain=lambda: g.take_clip_plain(tbl, idx),
                   lib_args=(tbl, torch.clamp(idx, 0, n - 1).long()),
                   library=torch.take, elem=torch.clamp(idx, 0, n - 1),
                   words=n, table=f"u32 ({n},)"),
        "P2": dict(kernel=lambda: g.take_along_cols(t2, i2),
                   plain=lambda: g.take_along_cols_plain(t2, i2),
                   lib_args=(t2, 0, i2.long()), library=torch.gather,
                   elem=i2 * COLS + torch.arange(COLS, dtype=torch.int32,
                                                 device=dev),
                   words=t2.numel(), table=f"u32 {tuple(t2.shape)}"),
    }
    rows = []
    for name, c in cases.items():
        if name not in got:
            continue
        want = c["plain"]()
        same = torch.equal(got[name], want)
        assert same, f"{name} differs from its plain version at {mb} MiB"
        lib_same = torch.equal(c["library"](*c["lib_args"]), want)
        touched = sectors(c["elem"], c["words"])
        moved = 4 * lanes + 4 * lanes + SECTOR * touched
        row = dict(
            kind=kind, kernel=name, table_mib=mb, table=c["table"],
            idx=f"i32 {tuple(idx.shape)}", lanes=lanes,
            ms=graph_ms(c["kernel"], dev, calls=10, reps=reps),
            event_ms=timed_ms(lambda _: c["kernel"](), dev, reps=reps),
            plain_ms=timed_ms(lambda _: c["plain"](), dev, reps=reps),
            library_ms=graph_ms(lambda: c["library"](*c["lib_args"]), dev,
                                calls=10, reps=reps),
            library=f"torch.{c['library'].__name__} (int64 indices)",
            bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bound_bytes=moved, sectors_touched=touched, max_abs_err=0.0,
            bit_exact=True, library_equal=lib_same)
        if name == "P1" and kind == "ladder":
            row.update(l2_window(tbl, idx, want, limits, dev, reps))
        rows.append(row)
        log(f"{kind:9s} {name} {mb:4d} MiB: kernel {row['ms']:.4f} ms, "
            f"event {row['event_ms']:.4f}, plain {row['plain_ms']:.4f}, "
            f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"ms ({touched} sectors)"
            + (f", under an L2 window {row['l2_window_ms']:.4f} ms"
               if "l2_window_ms" in row else ""))
    return rows


def device_limits(dev) -> dict:
    """The card's limits that replace the probe's VMEM capacity ladder."""
    from rvgrt_tpu_torch.ops import _lib

    vals = (ctypes.c_int * 4)()
    _lib.check(_lib.library().rvgrt_device_limits(
        dev.index or 0, ctypes.addressof(vals)), "device_limits")
    return dict(shared_memory_per_block_optin_bytes=vals[0],
                l2_bytes=vals[1], persisting_l2_max_bytes=vals[2],
                access_policy_window_max_bytes=vals[3])


def run(dev, reps: int = 7, counts=None) -> dict:
    """The whole probe on ``dev``.  ``counts``: optional ``(reset, read)``
    pair of callables around the gathers themselves (the path), so that a
    caller can count their launches apart from those of the checks and
    timings."""
    rows, launches = [], {}
    limits = device_limits(dev)
    for kind, mb, make in inputs(dev):
        tbl, idx = make()
        if counts is not None:
            counts[0]()
        got = gather(tbl, idx, p2=kind == "ladder")
        if counts is not None:
            for k, v in counts[1]().items():
                launches[k] = launches.get(k, 0) + v
        rows += measure(kind, mb, tbl, idx, got, dev, limits, reps=reps)
        del tbl, idx, got
    return dict(rows=rows, limits=limits, skipped=SKIPPED,
                launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="", help="also write the rows here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("probe_r7: no CUDA device; the probe times the card")
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(SKIPPED)
    res = run(torch.device("cuda"), reps=args.reps)
    for row in res["rows"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({"limits": res["limits"], "card": card}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(res, card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
