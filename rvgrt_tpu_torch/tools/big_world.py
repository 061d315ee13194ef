#!/usr/bin/env python3
"""A big world on one NVIDIA GPU: the 4096x512x4096 reference world or the
2048^3 world, built and rendered at bench.py's operating point.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.big_world --world reference|2048 \\
        [--frames 6] [--cli-frames N] [--out FILE]

It runs ``chip_smoke.phase_big_world``, the phase ``chip_smoke.py`` runs
for each big world: the build (``BENCH_REF_WORLD=1`` or ``BENCH_CUBE=11``:
2^33 voxels, 2^28 occupancy words, 2^30 coarse SDF cells, a 2^29-word trace
table, 2^27 GI cells) with its phase times and peak device memory, K3 bit
for bit at the build's four passes, for the reference world the traced GI
init in eight 2^24-lane K1 traces, bench.py's frames through
``driver/frame_loop.py``, and K1 bit for bit on their traces.
``--cli-frames N`` then runs the headless driver as a user would,
``driver/cli.py --config reference`` (or ``stage5`` for 2048^3) ``--frames
N --fly --upscale temporal``, through ``chip_smoke.phase_cli``.  It prints
the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: the CLI config that builds each big world
CLI_CONFIG = {"reference": "reference", "2048": "stage5"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", choices=list(CLI_CONFIG), required=True)
    ap.add_argument("--frames", type=int, default=6,
                    help="timed frames, after 2 warm-ups")
    ap.add_argument("--cli-frames", type=int, default=0,
                    help="then run the CLI on this world for N frames")
    ap.add_argument("--out", default="", help="also write the report here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("big_world: no CUDA device; the big worlds run on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from rvgrt_tpu_torch.ops import _lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    _lib.library()
    counts = {}
    report = chip_smoke.phase_big_world(dev, args.world, args.frames, counts)
    if args.cli_frames:
        torch.cuda.empty_cache()
        report["cli"], _ = chip_smoke.phase_cli(
            dev, CLI_CONFIG[args.world], args.cli_frames, counts)
    report.update(card=card, launches=counts)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
