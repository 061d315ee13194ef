"""The readings that the limits of ``limits/<workload>.json`` are set from,
read on the card at the cell's own size, many seeds in one process:

    python -m port_bench.control --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 6 [--out FILE]

For each seed of ``--seeds`` a run of the cell as ``port_bench.run`` makes
it (set-up on a world built once for all seeds, a window of ``--seconds``
at the cell's own load, the check), and its numbers: the lower readings.
For each seed of ``--control-seeds`` the control too, the reference in
bfloat16 in the port's place (the learned upscaler's convs in float8, where
the post stage is ``"net"``; a composite cadence carried as the port
carries it) on the same poses and kept frames: the upper readings.  One
JSON line a seed on stdout (and in ``--out``), then the largest reading of
the port and the smallest of the control for each number, beside the limit
the cell has now.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import run


def readings(cell, seeds, control_seeds, seconds: float, device="cuda",
             log=run.log, max_frames=None) -> list[dict]:
    """One dict a seed: its numbers (``port``) and, for a control seed,
    the control's (``control``)."""
    import torch

    from port_bench import check, drive, spec
    from port_bench.reference import config as rcfg
    from port_bench.reference import frame as rframe

    dev = torch.device(device)
    ecfg = spec.engine_config(cell.config, rcfg)
    world = ref = low = None
    out = []
    for seed in seeds:
        r = drive.PortRun(cell, seed, dev, log=log)
        r.setup(time.perf_counter(), world=world)
        world = r.world
        r.window(seconds, max_frames=max_frames)
        r.loop = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if ref is None:
            ref = rframe.build_world(ecfg, dev)
        row = {"seed": seed, "frames": len(r.rec.frames),
               "window_frame": r.kept["window"].index,
               "port": check.compare(cell, world, r.kept, r.poses,
                                     r.rates[:r.n_warm], dev, log=log,
                                     ref=ref)}
        if seed in control_seeds:
            if low is None:
                low = rframe.build_world(ecfg, dev, lowp=True)
            row["control"] = check.compare(cell, low, r.kept, r.poses,
                                           r.rates[:r.n_warm], dev,
                                           lowp=True, log=log, ref=ref)
        log(json.dumps(row))
        out.append(row)
        del r
    return out


def summary(rows: list[dict], limits: dict) -> dict:
    """For each number: the port's largest reading, the control's
    smallest, and the cell's limit."""
    from port_bench import check

    out = {}
    for k in check.NUMBERS:
        port = [r["port"][k] for r in rows]
        ctl = [r["control"][k] for r in rows if "control" in r]
        out[k] = {"port_max": max(port) if port else None,
                  "control_min": min(ctl) if ctl else None,
                  "limit": limits[k]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from port_bench import spec

    if not torch.cuda.is_available():
        run.log("the readings are read on a CUDA card; none is available")
        return 2
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(cell, seeds + sorted(ctl - set(seeds)), ctl,
                    args.seconds)
    res = {"workload": args.workload, "card": run.card_info(),
           "rows": rows, "summary": summary(rows, cell.limits)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
