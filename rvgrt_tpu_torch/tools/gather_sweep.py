#!/usr/bin/env python3
"""Time variants of P1 and P2 (``rvgrt_tpu_torch/csrc/gather_kernels.cu``)
on one NVIDIA GPU: how many lanes, and so independent table loads, a thread
needs in flight, and how large a block.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.gather_sweep [--variants A,B]
        [--mib 2,8,32,64,100] [--out FILE]

Each variant is a copy of the source with other values of its constants
(``kV`` lanes a thread, ``kBlock`` threads a block: ``VARIANTS``), built
into a library of its own under ``rvgrt_tpu_torch/_build/gather_sweep/``
with ``k3_sweep.build`` (one ``nvcc`` each, all at once, with ptxas's
register report).  At each table size the probe's table and indices
(``probe_r7.inputs``) go through each variant's P1 and, on the probe's
(S, 128) form, P2 along the L2 path under the wrappers' hints
(``gather_kernels.HINTS``), each held bit for
bit against the plain version and graph-timed (10 calls), in two rounds,
the second in reverse order.  A variant's grid is planned as the wrapper
plans it, with its own constants and its own occupancy (its
``rvgrt_gather_limits``); ``v1_b256`` sends every lane through the
kernel's scalar loop, one lane a thread at a time (the shape of the first
port of these kernels, on the persistent grid).  One JSON line per
variant, size and round; the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _const(name: str, value: int) -> tuple:
    return rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};"


#: name -> edits of the source; "v4_b256" is the source as committed.
#: Names in ``SCALAR`` run every lane through the kernel's scalar loop (one
#: lane a thread at a time, on the same persistent grid)
SCALAR = {"v1_b256"}
VARIANTS = {
    "v4_b256": [],
    "v1_b256": [],
    "v8_b256": [_const("kV", 8)],
    "v16_b256": [_const("kV", 16)],
    "v4_b128": [_const("kBlock", 128)],
    "v4_b512": [_const("kBlock", 512)],
}


def variant_plan(v: int, block: int, lanes: int, limits: dict,
                 scalar: bool = False):
    """``launch_plan``'s L2 path with a variant's ``V`` and ``BLOCK``;
    ``scalar``: as for indices off 16 B, every lane scalar."""
    from rvgrt_tpu_torch.ops import gather_kernels as g

    saved = g.V, g.BLOCK
    g.V, g.BLOCK = v, block
    try:
        return g.launch_plan(lanes, 1, None, (4 if scalar else 0, 0, 0),
                             limits)
    finally:
        g.V, g.BLOCK = saved


def launcher(so: Path, v: int, block: int, dev, scalar: bool = False):
    """``gather(kind, table, idx, cols)`` through a variant's
    ``rvgrt_gather``, planned with its constants and occupancy."""
    import torch

    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.ops import gather_kernels as g

    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rvgrt_gather.argtypes = [ci, vp, cll, ci, vp, vp, cll, cll, ci, ci,
                                 cll, ctypes.c_float, vp]
    lib.rvgrt_gather.restype = ci
    lib.rvgrt_gather_limits.argtypes = [ci, vp]
    lib.rvgrt_gather_limits.restype = ci
    lim = (ctypes.c_int * 6)()
    if lib.rvgrt_gather_limits(dev.index or 0, ctypes.addressof(lim)):
        raise RuntimeError(f"{so.name}: rvgrt_gather_limits failed")
    limits = [dict(sms=lim[0], blocks_per_sm=lim[1 + k], smem_optin=lim[3],
                   clusters=lim[4 + k]) for k in (0, 1)]

    def gather(kind, tbl, idx, cols):
        out = torch.empty_like(idx)
        plan = variant_plan(v, block, idx.numel(), limits[kind], scalar)
        err = lib.rvgrt_gather(kind, tbl.data_ptr(), tbl.numel(), cols,
                               idx.data_ptr(), out.data_ptr(), idx.numel(),
                               plan.groups, plan.grid, g.HINTS, 0, 0.0,
                               _lib.stream_ptr(dev))
        if err:
            raise RuntimeError(f"{so.name}: CUDA error {err}")
        return out

    return gather, limits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--mib", default="2,8,32,64,100")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device; the sweep times the card",
              file=sys.stderr)
        return 1
    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.ops import gather_kernels as g
    from rvgrt_tpu_torch.tools import k3_sweep, probe_r7
    from rvgrt_tpu_torch.utils.timer import graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = [n for n in args.variants.split(",") if n]
    src = _lib.CSRC / "gather_kernels.cu"
    built = k3_sweep.build({n: (src, VARIANTS[n]) for n in names},
                           _lib.BUILD_DIR / "gather_sweep", prefix="gather")
    dev = torch.device("cuda")
    launch = {}
    for n in names:
        consts = dict(kV=g.V, kBlock=g.BLOCK)
        for pattern, repl in VARIANTS[n]:
            key, value = repl.split()[2], int(repl.split()[-1].rstrip(";"))
            consts[key] = value
        launch[n] = launcher(built[n][0], consts["kV"], consts["kBlock"],
                             dev, n in SCALAR)
        print(json.dumps(dict(variant=n, ptxas=built[n][1],
                              limits=launch[n][1], **consts)), flush=True)
    sizes = [int(m) for m in args.mib.split(",")]
    rows = []
    for kind, mb, make in probe_r7.inputs(dev):
        if kind != "ladder" or mb not in sizes:
            continue
        tbl, idx = make()
        t2, i2 = g.tala_inputs(tbl, idx, probe_r7.COLS)
        cases = {"P1": (0, tbl, idx, 0, g.take_clip_plain(tbl, idx)),
                 "P2": (1, t2, i2, probe_r7.COLS,
                        g.take_along_cols_plain(t2, i2))}
        for rnd, order in enumerate((names, names[::-1])):
            for n in order:
                row = dict(variant=n, table_mib=mb, round=rnd)
                for k, (kid, t, ix, cols, want) in cases.items():
                    fn = launch[n][0]
                    got = fn(kid, t, ix, cols)
                    assert torch.equal(got, want), f"{n} {k} at {mb} MiB"
                    row[f"{k}_ms"] = graph_ms(
                        lambda: fn(kid, t, ix, cols), dev, calls=10,
                        reps=args.reps)
                rows.append(row)
                print(json.dumps(row), flush=True)
        del tbl, idx, t2, i2, cases
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
