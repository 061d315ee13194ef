"""Tracing / profiling / structured metrics.

The port of ``rvgrt_tpu/utils/profiling.py``.  The reference's
observability is a RAII stopwatch, a title-bar frame-time average and
printf (SURVEY.md §5.1/§5.5).  Here: a device-time profiler on
``torch.profiler`` (a host clock around an eager call measures the time
to enqueue it, not the card's), a wall-clock phase timer and a JSONL
metrics sink whose lines are the JAX package's.
"""

from __future__ import annotations

import collections
import json
import os
import time
from contextlib import contextmanager


def device_time_ms(fn, *args, warmup: int = 1) -> tuple[float, dict]:
    """Run ``fn(*args)`` under ``torch.profiler`` and return its device
    time: (the summed device time of the CUDA kernels it launched, ms;
    {kernel name: ms} for the 12 that took the most).  ``warmup`` calls run
    first, unprofiled.  Where the profiler saw no device kernel (no GPU)
    the time is NaN and the dict empty, as the JAX function returns when it
    finds no device trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn(*args)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn(*args)
        sync()
    dur = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dur[e.key] += e.self_device_time_total
    if not dur:
        return float("nan"), {}
    ops = {n: d / 1000.0 for n, d in dur.most_common(12)}
    return sum(dur.values()) / 1000.0, ops


@contextmanager
def phase(name: str, sink: "MetricsLog | None" = None, verbose: bool = True):
    """Wall-clock phase timer (build phases; NOT for device kernels)."""
    t0 = time.perf_counter()
    yield
    ms = (time.perf_counter() - t0) * 1e3
    if verbose:
        print(f"{name} took {ms:.1f} ms")
    if sink is not None:
        sink.log(event="phase", name=name, ms=round(ms, 2))


class MetricsLog:
    """Append-only JSONL metrics (frame times, build phases, bench runs)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)

    def log(self, **fields):
        fields.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
