#!/usr/bin/env python3
"""bench.py's post stages on one NVIDIA GPU, in alternating rounds.

Run from the repository root on the GPU machine:

    python3 -m rvgrt_tpu_torch.tools.post_modes [--rounds 2] [--frames 6] \\
        [--profile 2] [--out FILE]

It builds the headline 1024^3 world at bench.py's operating point and runs
``chip_smoke.phase_post_modes`` over the headline's own post stage (the
temporal accumulator, ``"headline"``) and ``chip_smoke.POST_MODES``
(``"net"``, ``"residual"``, the accumulator with composite cadence 2 and
``"none"``), ``--rounds`` times, the order reversed every other round, so
that a difference between two modes can be told from the drift of a host
that sets the pace.  ``--profile N`` runs N more frames of each mode in
the first round, each under ``torch.profiler``: the device's busy time,
its idle share and the launches of each frame.  It prints the card's name
and power limit, then one JSON line: per mode each round's frame median
and p90, peak memory (and what was resident before the mode), and the
first round's whole report.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--frames", type=int, default=6,
                    help="timed frames a mode, after 2 warm-ups")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="profile N more frames of each mode (first round)")
    ap.add_argument("--cube", type=int, default=10,
                    help="log2 of the world edge (default 10: 1024^3)")
    ap.add_argument("--out", default="", help="also write the report here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("post_modes: no CUDA device; the modes are timed on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.ops import _lib

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    _lib.library()
    ecfg = cs.headline_config(args.cube, cs.WIDTH, cs.HEIGHT)
    world = engine.build_world(ecfg, verbose=False, device=dev)
    pose = cs.headline_pose(world.bits, ecfg.world)
    modes = (("headline", "temporal", 1, None),) + cs.POST_MODES
    rounds, first = [], None
    for r in range(args.rounds):
        order = modes if r % 2 == 0 else modes[::-1]
        rep = cs.phase_post_modes(world, ecfg, pose, dev, args.frames, {},
                                  modes=order,
                                  profile=args.profile if r == 0 else 0)
        rounds.append({name: dict(ms_median=rep[name]["ms_median"],
                                  ms_p90=rep[name]["ms_p90"],
                                  peak_mem_gb=rep[name]["peak_mem_gb"],
                                  resident_before_gb=rep[name][
                                      "resident_before_gb"])
                       for name, *_ in order})
        first = first or rep
    report = dict(card=card, order=[m[0] for m in modes], rounds=rounds,
                  first_round=first)
    text = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
