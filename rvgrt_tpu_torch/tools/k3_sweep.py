#!/usr/bin/env python3
"""Time variants of the port's K3 kernel (``rvgrt_tpu_torch/csrc/
sdf_kernels.cu``) on one NVIDIA GPU.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.k3_sweep [--cube 10] [--variants A,B]
        [--sass DIR] [--rates] [--source NAME=PATH ...]
        [--cold N --parent DIR] [--out FILE]

Each variant is a copy of the kernel source with a few edits (another
value of one of its constants, or a design step taken out: ``VARIANTS``),
built into a library of its own under ``rvgrt_tpu_torch/_build/k3_sweep/``;
``--source`` adds a build of another source with the same C entry point (an
older design, for a comparison in the same process).  All are built at
once, one ``nvcc`` each, with ptxas's register report.  The input is the
world's own first-pass distance field at ``--cube`` (the main path's K3
input); each variant runs the axis-1 pass and then the axis-0 pass on its
output, each held bit for bit against the plain version and graph-timed
with ``chip_smoke.k3_pass``, which also gives the bound; then the world
build's whole SDF phase (``engine._sdf_phase_fn``, all four passes through
the variant) is timed warm, host included.  The variants run in two
rounds, the second in reverse order.  ``--sass DIR`` writes the default
build's SASS there with a count of its opcodes.  ``--rates`` first times
``k3_rates.cu``: the issue rate of each instruction the offset loop could
be built from.

``--cold N`` times the SDF phase as the world build meets it, first in a
fresh process, in this tree and in the tree ``--parent`` (another checkout
of the repository, built in its own tree), N times each, alternating
between them.  A process either times the SDF phase cold and then twice
warm, or (``k3``) first times one cold ``minconv_pass`` alone on the
first-pass field and then the phase.  One JSON line per variant and round,
and per cold process; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _const(name: str, value: int) -> tuple:
    return rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};"


#: the far-row skip taken out: no row is ever far
_NO_SKIP = (re.escape("auto far = [near](int a, int b) "
                      "{ return near[b + 1] == near[a]; };"),
            "auto far = [](int, int) { return false; };")
#: the early exit taken out
_NO_EXIT = (re.escape("if ((uint32_t)(off * off) >= acc.largest()) break;"),
            "")
#: the 32-bit loop at every cap
_WIDE = (re.escape("return 2 * cap * cap <= 65535\n"), "return false\n")

#: name -> edits of the source, each (pattern, replacement) matching once;
#: "default" is the source as committed
VARIANTS = {
    "default": [],
    "no_skip": [_NO_SKIP],
    "no_skip_no_exit": [_NO_SKIP, _NO_EXIT],
    "tile128": [_const("kTile", 128)],
    "tile128_warps4": [_const("kTile", 128), _const("kWarps", 4)],
    "warps4": [_const("kWarps", 4)],
    "warps16": [_const("kWarps", 16)],
    "rows4": [_const("kRows", 4)],
    "rows16": [_const("kRows", 16)],
    "wide": [_WIDE],
    "batch1": [_const("kBatch", 1)],
    "batch4": [_const("kBatch", 4)],
}

#: the operations of k3_rates.cu, by its kind number
RATE_KINDS = ("viaddmin_u16x2", "vminu2", "add_min_u32", "min_u32",
              "add_min_f32")

#: one cold process of ``--cold``: argv is (mode, cube); prints one JSON line
COLD_CHILD = r"""
import json, sys, time
import torch
from rvgrt_tpu_torch.config import WorldConfig
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.ops import _lib, sdf_kernels
from rvgrt_tpu_torch.world import sdf, voxel_grid


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


_lib.library()
dev = torch.device("cuda")
cfg = WorldConfig().with_cube(int(sys.argv[2]))
cap = cfg.sdf_max_dist
bits = voxel_grid.generate(cfg, device=dev)
row = {"mode": sys.argv[1]}
if sys.argv[1] == "k3":
    field = sdf._axis_distance_1d(voxel_grid.coarse_occupancy(bits, cfg),
                                  axis=2, cap=cap)
    row["k3_s"] = [timed(lambda: sdf_kernels.minconv_pass(field, 1, cap))
                   for _ in range(2)]
row["sdf_phase_s"] = [timed(lambda: engine._sdf_phase_fn(bits, cfg))
                      for _ in range(3)]
print(json.dumps(row))
"""


def variant_source(src: Path, edits: list, out: Path) -> Path:
    """``src`` with ``edits`` applied, written to ``out``."""
    text = src.read_text()
    for pattern, repl in edits:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise RuntimeError(f"{pattern!r} matches {n} times in {src}")
    out.write_text(text)
    return out


def build(builds: dict, out_dir: Path, prefix: str = "k3") -> dict:
    """Compile every (source, edits) at once into ``out_dir``, each file
    named ``{prefix}_{name}``; returns name -> (library path, ptxas
    report)."""
    from rvgrt_tpu_torch.ops import _lib

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _lib._nvcc()
    procs = {}
    for name, (src, edits) in builds.items():
        if edits:
            src = variant_source(src, edits, out_dir / f"{prefix}_{name}.cu")
        so = out_dir / f"{prefix}_{name}.so"
        cmd = [nvcc, *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(src),
               "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    done = {}
    for name, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        done[name] = (so, ptxas)
    return done


def launcher(so: Path):
    """``launch(d, axis, cap)`` through a variant's ``rvgrt_minconv_mid``,
    as ``ops/sdf_kernels.py::minconv_pass_cuda`` calls it."""
    import torch

    from rvgrt_tpu_torch.ops import _lib

    fn = ctypes.CDLL(str(so)).rvgrt_minconv_mid
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, ctypes.c_longlong, ci, vp]
    fn.restype = ci

    def launch(d, axis, cap):
        z, y, x = d.shape
        outer, n, inner = (z, y, x) if axis == 1 else (1, z, y * x)
        out = torch.empty_like(d)
        err = fn(d.data_ptr(), out.data_ptr(), outer, n, inner, cap,
                 _lib.stream_ptr(d.device))
        if err:
            raise RuntimeError(f"{so.name}: CUDA error {err}")
        return out

    return launch


def sass_counts(so: Path, out_dir: Path) -> dict:
    """The SASS of ``so`` written to ``out_dir``; opcode counts of each
    kernel in it."""
    from rvgrt_tpu_torch.ops import _lib

    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{so.stem}.sass").write_text(text)
    counts, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     ln)
        if m and name:
            counts[name][m.group(1).split(".")[0]] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def rates(so: Path, dev) -> dict:
    """Operations per second of each kind of ``k3_rates.cu``
    (graph-timed), and per SM and clock at 1.98 GHz."""
    import torch

    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.utils.timer import graph_ms

    fn = ctypes.CDLL(str(so)).rvgrt_rate
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, ci, ci, ci, vp]
    fn.restype = ci
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = sms * 16, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    res = {}
    for kind, name in enumerate(RATE_KINDS):
        def go():
            err = fn(kind, out.data_ptr(), blocks, threads, iters,
                     _lib.stream_ptr(dev))
            if err:
                raise RuntimeError(f"rate probe {name}: CUDA error {err}")
        ms = graph_ms(go, dev, calls=3)
        ops = blocks * threads * iters * 8
        res[name] = {"ms": ms, "ops_per_s": ops / ms * 1e3,
                     "per_sm_clock_at_1.98GHz": ops / ms * 1e3 / sms
                     / 1.98e9}
    return res


def cold(trees: dict, count: int, cube: int):
    """``count`` cold processes of each mode in each tree, alternating
    trees; yields one dict per process."""
    names = list(trees)
    for i in range(count):
        for name in names if i % 2 == 0 else names[::-1]:
            for mode in ("phase", "k3"):
                res = subprocess.run(
                    [sys.executable, "-c", COLD_CHILD, mode, str(cube)],
                    cwd=trees[name], capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"cold {mode} in {name} failed:\n"
                                       f"{res.stdout}{res.stderr}")
                row = json.loads(res.stdout.strip().splitlines()[-1])
                yield {"cold": i, "tree": name, **row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=10,
                    help="log2 of the world edge (default 10: 1024^3, whose "
                         "coarse grid is 512^3)")
    ap.add_argument("--variants", default="",
                    help="comma-separated names of VARIANTS to run (default: "
                         "all; 'none' for none)")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="also build and time this source as variant NAME")
    ap.add_argument("--sass", default="", metavar="DIR",
                    help="write the default build's SASS and opcode counts "
                         "here")
    ap.add_argument("--rates", action="store_true",
                    help="also measure the issue rates of k3_rates.cu")
    ap.add_argument("--cold", type=int, default=0, metavar="N",
                    help="time the SDF phase in N fresh processes of each "
                         "kind, in this tree and in --parent")
    ap.add_argument("--parent", default="", metavar="DIR",
                    help="another checkout of the repository, for --cold")
    ap.add_argument("--out", default="", help="also write all lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k3_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from rvgrt_tpu_torch.config import WorldConfig
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.ops import _lib, sdf_kernels
    from rvgrt_tpu_torch.utils.timer import timed_ms
    from rvgrt_tpu_torch.world import sdf, voxel_grid

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = [{"card": card}]

    def emit(row):
        lines.append(row)
        print(json.dumps(row), flush=True)

    print(json.dumps(lines[0]), flush=True)
    if args.cold:
        trees = {"this": ROOT}
        if args.parent:
            trees["parent"] = Path(args.parent).resolve()
        for row in cold(trees, args.cold, args.cube):
            emit(row)

    src = _lib.CSRC / "sdf_kernels.cu"
    names = ([] if args.variants == "none" else
             args.variants.split(",") if args.variants else list(VARIANTS))
    builds = {k: (src, VARIANTS[k]) for k in names}
    for spec in args.source:
        name, path = spec.split("=", 1)
        builds[name] = (Path(path), [])
    if args.rates:
        builds["rates"] = (Path(__file__).with_name("k3_rates.cu"), [])
    libs = build(builds, _lib.BUILD_DIR / "k3_sweep") if builds else {}
    dev = torch.device("cuda")
    if args.sass:
        emit({"sass": {k: sass_counts(libs[k][0], Path(args.sass))
                       for k in ("default", "rates") if k in libs}})
    if args.rates:
        emit({"rates": rates(libs.pop("rates")[0], dev)})
        del builds["rates"]

    names = list(builds)
    if names:
        cfg = WorldConfig().with_cube(args.cube)
        cap = cfg.sdf_max_dist
        bits = voxel_grid.generate(cfg, device=dev)
        coarse = voxel_grid.coarse_occupancy(bits, cfg)
        field = sdf._axis_distance_1d(coarse, axis=2, cap=cap)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            so, ptxas = libs[name]
            launch = launcher(so)
            d, row = field, {"variant": name, "round": rnd,
                             "edits": builds[name][1], "ptxas": ptxas}
            for axis in (1, 0):
                stats, d = chip_smoke.k3_pass(d, axis, cap, dev, launch)
                row[f"axis{axis}"] = stats
            # the world build's SDF phase, its four passes through launch
            real, sdf_kernels.minconv_pass = sdf_kernels.minconv_pass, launch
            try:
                row["sdf_phase_ms"] = timed_ms(
                    lambda _: engine._sdf_phase_fn(bits, cfg), dev, reps=5,
                    warmup=1)
            finally:
                sdf_kernels.minconv_pass = real
            emit(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
