"""Where a frame's time goes, stage by stage, on the card: the program's
spans (``rvgrt_tpu_torch/utils/profiling.py``) over one run of a cell, and
the device operations and idle gaps of the profiled sub-window put down to
the spans open when they were launched.

    python -m port_bench.stages --workload <name> --seed <n> --seconds <s>

One run as ``run.py`` makes it, with spans on from the start: set-up (its
warm-up frames), a window of ``--seconds``, then the benchmark's profiled
sub-window (``drive.PortRun.traced``).  It prints the per-stage table (host
and self ms a window frame, launches, device and idle ms a sub-window
frame) to stderr and one JSON line, with the figures of ``span_metrics``,
to stdout.  The benchmark's own ``--trace 1`` runs keep ``attribute``'s
figures of their sub-window, where spans are on, in ``rec.trace["stages"]``;
their measured window runs with spans off, so the host figures a window
frame are this tool's alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import run

#: the stages directly under a frame's root span, in the order they run
TOP = ("gi_update", "base", "composite", "expand", "post")
#: the host calls that launch device work (the runtime's, or the driver's)
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")
PREFIX = "rvgrt."


def _open_stacks(times, ranges) -> list[tuple]:
    """For each host time of ``times`` (sorted), the names of the ranges
    of ``ranges`` ((start, end, name), nested) open at it, outermost
    first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(ranges) and ranges[k][0] <= t:
            while stack and stack[-1][1] <= ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(tuple(r[2] for r in stack))
    return out


def _launch_call(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCH_CALLS
    return e.name().startswith(("cuda", "cu"))


def attribute(events, frames: int) -> dict:
    """The profiled sub-window's device side by stage: each device
    operation (kernel, copy, set; those ``drive.summarise`` counts) put
    down to the ``rvgrt.*`` ranges open at the host call that launched it,
    found by the profiler's correlation id, and each idle gap to those open
    at the gap's middle.  Returns ``{"frames", "stages": {name: {"launches",
    "device_ms", "idle_ms", "self_launches", "self_device_ms",
    "self_idle_ms"}}, "outside": {"launches", "device_ms", "idle_ms"},
    "unmatched"}``: a stage counts what was launched inside it, its
    ``self_`` figures what its inner stages did not take; ``outside`` is
    what no range was open at; ``unmatched`` counts operations whose launch
    call the profiler did not record.  Times are summed over the
    sub-window (not a frame).  Raises ``ValueError`` where the events hold
    no ``pb.subwindow`` range."""
    from torch.autograd import DeviceType

    from port_bench import drive

    ranges, calls, dev_ops, t0 = [], {}, [], None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # a span's range also lies on the device's timeline
            # (``drive.ANNOTATIONS`` tells it apart where the events carry no
            # activity type)
            if drive._device_op(e):
                dev_ops.append(e)
        elif name == "pb.subwindow":
            t0 = e.start_ns()
        elif name.startswith(PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name[len(PREFIX):]))
        elif _launch_call(e) and e.correlation_id():
            calls[e.correlation_id()] = e.start_ns()
    if t0 is None:
        raise ValueError("no pb.subwindow range among the profiler's events")
    out = {"frames": frames, "stages": {},
           "outside": {"launches": 0, "device_ms": 0.0, "idle_ms": 0.0},
           "unmatched": 0}
    ops = []
    for e in dev_ops:
        s = e.start_ns()
        if s < t0:
            continue
        at = calls.get(e.correlation_id())
        if at is None:
            at = calls.get(e.linked_correlation_id())
        if at is None:
            out["unmatched"] += 1
            continue
        ops.append((at, s, s + e.duration_ns()))
    ops.sort()

    def row(name):
        return out["stages"].setdefault(name, {
            "launches": 0, "device_ms": 0.0, "idle_ms": 0.0,
            "self_launches": 0, "self_device_ms": 0.0, "self_idle_ms": 0.0})

    def add(stack, key, value):
        if not stack:
            out["outside"][key] += value
            return
        for name in set(stack):
            row(name)[key] += value
        row(stack[-1])["self_" + key] += value

    for stack, (_, s, e) in zip(_open_stacks([o[0] for o in ops], ranges),
                                ops):
        add(stack, "launches", 1)
        add(stack, "device_ms", (e - s) / 1e6)
    # the idle gaps as drive.summarise finds them, from the sub-window's
    # start, each put down to the ranges open at its middle
    gaps, cur = [], t0
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append(((cur + s) // 2, s - cur))
        cur = max(cur, e)
    gaps.sort()
    for stack, (_, dur) in zip(_open_stacks([g[0] for g in gaps], ranges),
                               gaps):
        add(stack, "idle_ms", dur / 1e6)
    return out


def span_metrics(window: dict, gi_frames: int, frames: int, warm: dict,
                 stages: dict | None, overflow: int | None,
                 gi_windows: int) -> dict:
    """The per-layer figures the spans make: host figures a window frame
    (``window``: the tracer's summary over the window's frames, of which
    ``gi_frames`` ran a GI window), device figures a sub-window frame
    (``stages``: ``attribute``'s), ``warm``: the summary over the warm-up
    frames; ``overflow`` / ``gi_windows``: the respite's overflowing rays
    and the GI windows over the window.  A figure whose spans or records
    are missing is None."""
    def host(name, per=frames):
        r = window.get(name)
        return r["host_ms"] / per if r and per else None

    out = {"frame_sync_wait_ms": sum(
               r["host_ms"] for k, r in window.items()
               if k.startswith("sync.")) / frames if frames else None,
           "gi_update_host_ms": host("gi_update", gi_frames),
           "base_host_ms": host("base"),
           "composite_host_ms": host("composite"),
           "expand_host_ms": host("expand"),
           "post_host_ms": host("post"),
           "warm_frames_s": warm["frame"]["host_ms"] / 1e3
           if warm.get("frame") else None,
           "gi_overflow_per_window": overflow / gi_windows
           if overflow is not None and gi_windows else None}
    st = (stages or {}).get("stages", {})
    n = (stages or {}).get("frames") or 0
    gi_n = (stages or {}).get("gi_frames") or 0

    def dev(name, key, per):
        r = st.get(name)
        return r[key] / per if r and per else None

    out.update(gi_update_device_ms=dev("gi_update", "device_ms", gi_n),
               base_launches_per_frame=dev("base", "launches", n),
               composite_launches_per_frame=dev("composite", "launches", n),
               composite_device_ms=dev("composite", "device_ms", n))
    return out


def table(window: dict, frames: int, stages: dict | None) -> str:
    """The per-stage table: host and self ms a window frame, launches,
    device and idle ms a sub-window frame (each stage with what it
    launched inside its inner stages; the inner stages indented)."""
    st = (stages or {}).get("stages", {})
    n = (stages or {}).get("frames") or 1
    names = ["frame", *TOP, "prepass", "primary", "shadow", "water",
             "sync.water", "shade"]
    names += sorted((set(window) | set(st)) - set(names))
    lines = [f"{'stage':<14}{'host ms':>10}{'self ms':>10}{'launches':>10}"
             f"{'device ms':>11}{'idle ms':>10}"]
    for name in names:
        h, d = window.get(name), st.get(name)
        if not h and not d:
            continue
        pad = "" if name == "frame" or name in TOP else "  "
        lines.append(
            f"{pad + name:<14}"
            f"{h['host_ms'] / frames if h else 0.0:>10.2f}"
            f"{h['self_ms'] / frames if h else 0.0:>10.2f}"
            f"{d['launches'] / n if d else 0.0:>10.1f}"
            f"{d['device_ms'] / n if d else 0.0:>11.3f}"
            f"{d['idle_ms'] / n if d else 0.0:>10.3f}")
    o = (stages or {}).get("outside")
    if o:
        lines.append(f"{'(outside)':<14}{'':>20}{o['launches'] / n:>10.1f}"
                     f"{o['device_ms'] / n:>11.3f}{o['idle_ms'] / n:>10.3f}")
    return "\n".join(lines)


def subwindow(prun) -> dict:
    """``prun``'s profiled sub-window (``drive.PortRun.traced``, spans on);
    returns its trace summary, with ``attribute``'s figures under
    ``"stages"``.  Raises ``RuntimeError`` where the sub-window brought no
    events to attribute."""
    prun.traced()
    t = prun.rec.trace
    if not t or not t.get("stages"):
        raise RuntimeError("the profiled sub-window brought no events: "
                           "drive.PortRun.traced found no device operation "
                           "in its pb.subwindow range")
    return t


def measure(cell, seed: int, seconds: float, device="cuda",
            max_frames=None) -> dict:
    """The run of the module docstring (on the CPU no profiled
    sub-window, and ``max_frames`` window frames)."""
    from port_bench import drive
    from rvgrt_tpu_torch.utils import profiling

    prun = drive.PortRun(cell, seed, device, log=run.log)
    tracer = profiling.enable()
    try:
        prun.setup(time.perf_counter())
        loop = prun.loop
        over0, win0 = int(loop.overflow), loop.gi_windows
        prun.window(seconds, max_frames=max_frames)
        over, gi_windows = int(loop.overflow) - over0, loop.gi_windows - win0
        n_warm, frames = prun.n_warm, len(prun.rec.host_ms)
        res = {"workload": cell.name, "seed": seed, "frames": frames,
               "spans_warm": tracer.summary(frames=range(n_warm)),
               "spans_window": tracer.summary(
                   frames=range(n_warm, n_warm + frames)),
               "gi_frames": sum(g for _, g in prun.rec.frames),
               "overflow": over, "gi_windows": gi_windows}
        stages = None
        if prun.dev.type == "cuda":
            t = subwindow(prun)
            stages = t["stages"]
            res.update(stages=stages, variants=t["variants"])
    finally:
        profiling.disable()
    res["metrics"] = span_metrics(res["spans_window"], res["gi_frames"],
                                  frames, res["spans_warm"], stages,
                                  over, gi_windows)
    res["table"] = table(res["spans_window"], frames, stages)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from port_bench import spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        run.log(f"{args.workload}: needs a CUDA card. No result.")
        return 2
    res = measure(cell, args.seed, args.seconds)
    res["card"] = run.card_info()
    run.log(f"{cell.name} seed {args.seed}, card {res['card']}:\n"
            + res["table"])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
