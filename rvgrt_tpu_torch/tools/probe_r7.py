#!/usr/bin/env python3
"""The gather probe on one NVIDIA GPU: the counterpart of sections 1-2 of
``scripts/probe_r7.py``.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.probe_r7 [--reps 7] [--out FILE]
    python3 -m rvgrt_tpu_torch.tools.probe_r7 --parent DIR [--out FILE]

The TPU probe asked whether a per-lane gather from a table held in the
core's fast memory (VMEM) beats XLA's gather from HBM.  On the H100 each
rung of its ladder is bound by something else:

- 2 and 8 MiB tables stay in the 50 MB L2 from call to call.  There the
  time is the latency of a table load that waits on its index load, and
  the L2-to-SM traffic: each random 4 B word moves a 32 B sector, 33.5 MB
  a call for 4 MB of words.  P1 and P2 (``csrc/gather_kernels.cu``) give a
  thread 8 lanes with all 8 table loads in flight and the next indices
  loaded before the words are stored, in a grid the card holds at once.
- 32-100 MiB tables outgrow L2, and the index and output streams compete
  with them for it: the misses are random 32 B reads from HBM, and the
  byte bound counts the distinct sectors.  The kernels stream indices and
  words evict-first; the ablation times the body under each combination
  of that hint and an evict-last policy on the table words
  (``hints_ms``, two rounds, the second in reverse order).
- The probe's own question, asked of Hopper's on-chip memory: a 16-CTA
  cluster holds 16 x 227 KB = 3.55 MiB of shared memory, so the 2 MiB rung
  fits.  The on-chip variant copies the table into the cluster's shared
  memory with bulk asynchronous copies once a cluster and reads each word
  from the owning CTA (4 B over the SM-to-SM network instead of a 32 B
  sector from L2).  Where the table fits, it is timed against the L2
  path in alternating rounds; ``on_chip_wins`` holds when its slowest
  round beats the L2 path's fastest.  It does not on the H100, so the
  wrappers read through L2 and the variant stays this measurement
  (``on_chip=True``).  ``parts`` splits the 2 MiB rung's times into their
  parts with inputs chosen for it (``parts``).

1. The gather ladder.  For each table size in ``SIZES_MB`` the same table
   as the probe's (``arange(n) * 2654435761``, u32, n = MiB * 2^18 words)
   and the same 1M indices (``(8192, 128)`` int32, ``randint(0, n)`` from
   ``numpy.random.RandomState(0)``, drawn in the probe's order) go through
   P1 (``ops.gather_kernels.take_clip``, the probe's ``pallas_take``) and
   P2 (``take_along_cols`` on ``tala_inputs``, its ``pallas_tala``).  Each
   is held bit for bit against its plain version, as is every variant.
   Beside them: the library gather (``torch.take``; ``torch.gather`` for
   P2), the probe's "XLA HBM gather".  Then the probe's small-table
   reference ladder, ``REF_MB``: ``torch.take`` and P1 from ``arange(n)``.
2. The capacity ladder becomes the card's own limits, read from the
   device: the shared memory a block may opt in to, the L2 size, and the
   most of L2 that may persist.  On the ladder, P1 is also timed with an
   L2 access-policy window over its table (``take_clip_l2``), the share
   that may persist marked persisting: the probe's question asked of L2.
3. The edge cases (``edge_checks``, also run by ``chip_smoke.py``): lane
   counts of 1-7 past a multiple of 8, an index view 4 B past an aligned
   address, indices below 0 and at n and beyond, P2 with 7 columns, and
   tables one word under, at and over the on-chip variant's threshold,
   each bit for bit against the plain version.

Sections 3-5 of the TPU probe (slim carry, the checkerboard shape,
``shard_map`` at mesh 1) are skipped, and the tool says so: they time the
tracer inside ``parallel/``'s mesh, which the port does not have yet
(slim carry itself is K1's slim variant, timed by ``chip_smoke.py``).

Each row: the kernel's device time (``ms``: CUDA-graph replays of 10
calls), ``event_ms`` (the Python call, host included, CUDA events), the
plain version's and the library call's times, and ``bound_ms``: the bytes
the gather must move at 3.35 TB/s - the indices read once, the words
written once, and each distinct 32 B sector of the table that the indices
touch read once.  One line per row on stderr, one JSON line per row on
stdout, the card's name and power limit first.

``--parent DIR`` runs the probe of another checkout (DIR, e.g. the parent
commit unpacked with ``git archive``) and of this one in one process tree,
in the order parent, this, this, parent, and prints for each row the two
trees' kernel times side by side (``parent_ms``, ``ms``).
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
           "checkerboard shape, shard_map at mesh 1) are skipped: they time "
           "the tracer inside parallel/'s mesh, which is not ported")


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


#: the L2 path's hint variants the ablation times: name -> ``hints``
HINT_VARIANTS = {"stream+keep": 3, "keep": 2, "stream": 1, "none": 0}
#: alternating rounds of the L2 path and the on-chip variant
ON_CHIP_ROUNDS = 3


def hint_rounds(kernel, want, dev, reps: int) -> dict:
    """The L2 path under each of ``HINT_VARIANTS``, bit for bit against
    ``want``, graph-timed in two rounds, the second in reverse order (a
    timing depends on what ran before it): name -> [first, second]."""
    import torch

    from rvgrt_tpu_torch.utils.timer import graph_ms

    out = {name: [] for name in HINT_VARIANTS}
    for order in (list(HINT_VARIANTS), list(HINT_VARIANTS)[::-1]):
        for name in order:
            h = HINT_VARIANTS[name]
            assert torch.equal(kernel(hints=h), want), f"hints {name} differ"
            out[name].append(graph_ms(lambda: kernel(hints=h), dev,
                                      calls=10, reps=reps))
    return out


def on_chip_rounds(kernel, want, dev, reps: int) -> dict:
    """The on-chip variant against the L2 path where the table fits a
    cluster's shared memory: bit for bit against ``want``, then
    ``ON_CHIP_ROUNDS`` alternating graph timings of each (L2 first).
    ``on_chip_wins``: its slowest round beats the L2 path's fastest."""
    import torch

    from rvgrt_tpu_torch.utils.timer import graph_ms

    assert torch.equal(kernel(on_chip=True), want), "on-chip variant differs"
    l2, chip = [], []
    for _ in range(ON_CHIP_ROUNDS):
        l2.append(graph_ms(lambda: kernel(on_chip=False), dev, calls=10,
                           reps=reps))
        chip.append(graph_ms(lambda: kernel(on_chip=True), dev, calls=10,
                             reps=reps))
    return dict(l2_rounds_ms=l2, on_chip_rounds_ms=chip,
                on_chip_ms=sorted(chip)[len(chip) // 2],
                on_chip_wins=max(chip) < min(l2))


def parts(tbl, idx, dev, reps: int) -> dict:
    """What P1's times at a table that fits a cluster are made of, from
    inputs chosen for it (each bit for bit, graph-timed):

    - ``warp_word_ms``: the L2 path with each warp's lanes on one word, a
      sector of its own (4096 sectors in all): the launch and the index
      and word streams, which no gather design saves;
    - ``on_chip_same_word_ms``: the on-chip variant with each lane on the
      first word of its own CTA's slice: the launch, the copies into
      shared memory, the cluster syncs and the streams;
    - ``on_chip_local_ms``: each lane on a random word of its own CTA's
      slice: random reads of local shared memory.

    The row's ``on_chip_ms`` reads 15 of 16 words from other CTAs."""
    import torch

    from rvgrt_tpu_torch.ops import gather_kernels as g
    from rvgrt_tpu_torch.utils.timer import graph_ms

    n, lanes = tbl.numel(), idx.numel()
    plan = g.launch_plan(lanes, n, None, (idx.data_ptr(), 0, tbl.data_ptr()),
                         g.gather_limits(dev)[0], on_chip=True)
    assert plan.tail == 0
    lane = torch.arange(lanes, device=dev)
    warp_word = lane // (32 * g.V) * 8 % n  # a warp takes 32 * V lanes
    # group k of V lanes goes to thread k % (grid threads), in block
    # thread // CLUSTER_BLOCK, which is rank block % CLUSTER of its cluster
    thread = lane // g.V % (plan.grid * g.CLUSTER_BLOCK)
    base = thread // g.CLUSTER_BLOCK % g.CLUSTER * plan.slice_words
    held = torch.clamp(n - base, max=plan.slice_words)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    local = base + (torch.rand(lanes, device=dev, generator=gen)
                    * held).long()
    out = {}
    for name, ix, chip in (("warp_word_ms", warp_word, False),
                           ("on_chip_same_word_ms", base, True),
                           ("on_chip_local_ms", local, True)):
        ix = ix.to(torch.int32).view(idx.shape)
        want = g.take_clip_plain(tbl, ix)
        assert torch.equal(g.take_clip_cuda(tbl, ix, on_chip=chip), want), \
            name
        out[name] = graph_ms(
            lambda: g.take_clip_cuda(tbl, ix, on_chip=chip), dev, calls=10,
            reps=reps)
    return out


def measure(kind: str, mb: int, tbl, idx, got: dict, dev, limits: dict,
            reps: int = 7) -> list:
    """Rows for the gathers of ``got`` (from ``gather``): each kernel
    against its plain version (bit for bit; raises if not), its graph and
    event times, the plain version's and the library call's times and its
    byte bound; on the ladder also the body under each hint variant
    (``hints_ms``), for P1 its time under an L2 window (``l2_window``), and
    where the table fits a cluster, the on-chip variant
    (``on_chip_rounds``; for P1 on the ladder also ``parts``)."""
    import torch

    from rvgrt_tpu_torch.ops import gather_kernels as g
    from rvgrt_tpu_torch.utils.timer import graph_ms, timed_ms

    n = tbl.numel()
    lanes = idx.numel()
    t2, i2 = g.tala_inputs(tbl, idx, COLS)
    cases = {
        "P1": dict(kernel=lambda **kw: g.take_clip_cuda(tbl, idx, **kw),
                   plain=lambda: g.take_clip_plain(tbl, idx),
                   lib_args=(tbl, torch.clamp(idx, 0, n - 1).long()),
                   library=torch.take, elem=torch.clamp(idx, 0, n - 1),
                   words=n, table=f"u32 ({n},)"),
        "P2": dict(kernel=lambda **kw: g.take_along_cols_cuda(t2, i2, **kw),
                   plain=lambda: g.take_along_cols_plain(t2, i2),
                   lib_args=(t2, 0, i2.long()), library=torch.gather,
                   elem=i2 * COLS + torch.arange(COLS, dtype=torch.int32,
                                                 device=dev),
                   words=t2.numel(), table=f"u32 {tuple(t2.shape)}"),
    }
    smem = limits["shared_memory_per_block_optin_bytes"]
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
        kernel = c["kernel"]
        row = dict(
            kind=kind, kernel=name, table_mib=mb, table=c["table"],
            idx=f"i32 {tuple(idx.shape)}", lanes=lanes,
            ms=graph_ms(kernel, dev, calls=10, reps=reps),
            event_ms=timed_ms(lambda _: kernel(), dev, reps=reps),
            plain_ms=timed_ms(lambda _: c["plain"](), dev, reps=reps),
            library_ms=graph_ms(lambda: c["library"](*c["lib_args"]), dev,
                                calls=10, reps=reps),
            library=f"torch.{c['library'].__name__} (int64 indices)",
            bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bound_bytes=moved, sectors_touched=touched, max_abs_err=0.0,
            bit_exact=True, library_equal=lib_same)
        if kind == "ladder":
            row["hints_ms"] = hint_rounds(kernel, want, dev, reps)
        if g.on_chip_slice(c["words"], smem):
            row.update(on_chip_rounds(kernel, want, dev, reps))
            if name == "P1" and kind == "ladder":
                row["parts"] = parts(tbl, idx, dev, reps)
        if name == "P1" and kind == "ladder":
            row.update(l2_window(tbl, idx, want, limits, dev, reps))
        rows.append(row)
        log(f"{kind:9s} {name} {mb:4d} MiB: kernel {row['ms']:.4f} ms, "
            f"event {row['event_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} ms ({touched} sectors)"
            + (f", hints {row['hints_ms']}" if "hints_ms" in row else "")
            + (f", on chip {row['on_chip_rounds_ms']} against L2 "
               f"{row['l2_rounds_ms']}" if "on_chip_ms" in row else "")
            + (f", parts {row['parts']}" if "parts" in row else "")
            + (f", under an L2 window {row['l2_window_ms']:.4f} ms"
               if "l2_window_ms" in row else ""))
    return rows


def edge_cases(dev, smem_optin: int) -> list:
    """The gathers' edge cases at about the probe's size: ``[(name,
    kernel, make)]``, ``make()`` -> (table, indices, on_chip) on ``dev``
    (P1: a flat table; P2: an (S, cols) one).  Indices are drawn beyond
    the table on both sides, and the first lanes are set to the edges
    (-1, n, n + 1 and the int32 extremes)."""
    import torch

    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.ops import gather_kernels as g

    lanes = ROWS * COLS
    top = g.on_chip_words_max(smem_optin)

    def table(n, seed):
        rng = np.random.default_rng(seed)
        return u32.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                              .astype(np.uint32), dev)

    def indices(n, shape, seed, offset=False):
        rng = np.random.default_rng(seed + 1)
        i = rng.integers(-2 * n - 1, 2 * n + 2, shape).astype(np.int32)
        i.flat[:5] = (-1, n, n + 1, np.iinfo(np.int32).min,
                      np.iinfo(np.int32).max)
        t = torch.from_numpy(i).to(dev)
        if offset:  # a contiguous view 4 B past an aligned address
            buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(t.shape)
            assert t.data_ptr() % 16 == 4
        return t

    cases = []
    for k in range(1, 8):
        cases.append((f"lanes_mod8_{k}", "P1", lambda k=k: (
            table(1 << 21, k), indices(1 << 21, (lanes + k,), k), None)))
    cases += [
        ("index_offset_4B", "P1", lambda: (
            table(1 << 21, 8), indices(1 << 21, (ROWS, COLS), 8, True),
            None)),
        ("out_of_range", "P1", lambda: (
            table(3 + (1 << 21), 9), indices(3 + (1 << 21), (ROWS, COLS), 9),
            None)),
        ("out_of_range", "P2", lambda: (
            table(16384 * COLS, 10).view(16384, COLS),
            indices(16384, (ROWS, COLS), 10), None)),
        ("index_offset_4B", "P2", lambda: (
            table(16384 * COLS, 11).view(16384, COLS),
            indices(16384, (ROWS, COLS), 11, True), None)),
        ("cols_7", "P2", lambda: (
            table(16384 * 7, 12).view(16384, 7),
            indices(16384, (lanes // 7 + 3, 7), 12), None)),
    ]
    for d, path in ((-1, True), (0, True), (1, False)):
        cases.append((f"threshold_{d:+d}_word", "P1", lambda d=d, p=path: (
            table(top + d, 13 + d), indices(top + d, (ROWS, COLS), 13 + d),
            p)))
    for cols in (COLS, 7):
        s = top // cols
        for d, path in ((0, True), (1, False)):
            cases.append((f"threshold_{d:+d}_row_cols_{cols}", "P2",
                          lambda s=s + d, cols=cols, p=path: (
                              table(s * cols, 16 + cols).view(s, cols),
                              indices(s, (ROWS, cols), 16 + cols), p)))
    return cases


def edge_checks(dev, limits: dict | None = None) -> list:
    """Each edge case (``edge_cases``) through the wrapper (whatever path
    it plans) and, at the threshold cases, through the on-chip variant
    where the table fits it (and a ValueError where it does not), each bit
    for bit against the plain version.  Raises on a difference."""
    import torch

    from rvgrt_tpu_torch.ops import gather_kernels as g

    limits = limits or device_limits(dev)
    out = []
    for name, kern, make in edge_cases(
            dev, limits["shared_memory_per_block_optin_bytes"]):
        tbl, idx, fits = make()
        if kern == "P1":
            fn = lambda **kw: g.take_clip_cuda(tbl, idx, **kw)  # noqa: E731
            want = g.take_clip_plain(tbl, idx)
        else:
            fn = lambda **kw: g.take_along_cols_cuda(tbl, idx, **kw)  # noqa
            want = g.take_along_cols_plain(tbl, idx)
        paths = {"planned": fn()}
        if fits is True:
            paths["on_chip"] = fn(on_chip=True)
        elif fits is False:
            try:
                fn(on_chip=True)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{kern} {name}: on-chip variant took "
                                     "a table over its threshold")
        for path, got in paths.items():
            assert torch.equal(got, want), f"{kern} {name} ({path}) differs"
        out.append(dict(case=name, kernel=kern, table=list(tbl.shape),
                        idx=list(idx.shape), idx_offset=idx.data_ptr() % 16,
                        paths=sorted(paths), bit_exact=True))
        del tbl, idx, want, paths
    return out


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
    from rvgrt_tpu_torch.ops import gather_kernels as g

    rows, launches = [], {}
    limits = device_limits(dev)
    limits["gather"] = dict(zip(("P1", "P2"), g.gather_limits(dev)))
    log(f"limits: {limits}")
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
    edges = edge_checks(dev, limits)
    log(f"edge cases, bit for bit: {[(e['kernel'], e['case']) for e in edges]}")
    return dict(rows=rows, limits=limits, skipped=SKIPPED,
                launches=launches, edges=edges)


def compare(parent: Path, reps: int, keep: str = "") -> list:
    """The probe of the checkout ``parent`` and of this one, each in its
    own process, in the order parent, this, this, parent: one row per
    (kind, kernel, table) with both trees' kernel times (``parent_ms``,
    ``ms``: two runs each), the bound and this tree's library time.  Each
    run's own output is kept beside ``keep`` (``<keep>.run<i>.json``)
    where it is given."""
    import tempfile

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate((parent, ROOT, ROOT, parent)):
            out = (Path(f"{keep}.run{i}.json").resolve() if keep
                   else Path(tmp) / f"run{i}.json")
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                [sys.executable, "-m", "rvgrt_tpu_torch.tools.probe_r7",
                 "--reps", str(reps), "--out", str(out)], cwd=tree,
                check=True, stdout=subprocess.DEVNULL)
            runs.append((tree == parent, json.loads(out.read_text())))
    table = {}
    for is_parent, res in runs:
        for r in res["rows"]:
            key = (r["kind"], r["kernel"], r["table_mib"])
            row = table.setdefault(key, dict(
                kind=r["kind"], kernel=r["kernel"], table_mib=r["table_mib"],
                parent_ms=[], ms=[], bound_ms=r["bound_ms"]))
            row["parent_ms" if is_parent else "ms"].append(r["ms"])
            if not is_parent:
                row["library_ms"] = r["library_ms"]
    return list(table.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="", help="also write the rows here")
    ap.add_argument("--parent", default="",
                    help="a checkout to compare with: its probe and this "
                         "one's, alternating (parent, this, this, parent)")
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
    if args.parent:
        res = dict(compare=compare(Path(args.parent).resolve(), args.reps,
                                   keep=args.out))
        for row in res["compare"]:
            print(json.dumps(row), flush=True)
    else:
        log(SKIPPED)
        res = run(torch.device("cuda"), reps=args.reps)
        for row in res["rows"]:
            print(json.dumps(row), flush=True)
        print(json.dumps({"limits": res["limits"], "card": card}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(res, card=card), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
