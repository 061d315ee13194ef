"""Phase timer and frame-time averager (the ``Timer.hpp`` equivalents),
and the two ways the port times a call on the card.

``Timer`` times on the host clock by default; given a CUDA device it brackets
the block with CUDA events and synchronises at exit, so the time is the
device work of the block, not the time to enqueue it.  ``timed_ms`` is the
median ``Timer`` of a call, host included; ``graph_ms`` the device's time
for it alone, from replays of a CUDA graph.
"""

from __future__ import annotations

import statistics
import sys
import time
from collections import deque

import torch


class Timer:
    """Context-manager stopwatch printing '<name> took X ms' like the
    reference's RAII Timer (Timer.hpp:7-27)."""

    def __init__(self, name: str, verbose: bool = True,
                 device: str | torch.device | None = None):
        self.name = name
        self.verbose = verbose
        self.elapsed_ms = 0.0
        dev = torch.device(device) if device is not None else None
        self.cuda = dev is not None and dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev1.record()
            self.ev1.synchronize()
            self.elapsed_ms = self.ev0.elapsed_time(self.ev1)
        else:
            self.elapsed_ms = (time.perf_counter() - self.t0) * 1e3
        if self.verbose:
            # stderr: diagnostics must not pollute stdout protocols
            print(f"{self.name} took {self.elapsed_ms:.1f} ms",
                  file=sys.stderr, flush=True)
        return False


class FrameTimeAverager:
    """Sliding-window frame-time average (Timer.hpp:33-58, 30-frame
    window): ``tick()`` once a frame, on the host clock."""

    def __init__(self, window: int = 30):
        self.times = deque(maxlen=window)
        self.last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self.last is not None:
            self.times.append(now - self.last)
        self.last = now
        return self.average_ms

    @property
    def average_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1e3 * sum(self.times) / len(self.times)

    @property
    def fps(self) -> float:
        ms = self.average_ms
        return 1e3 / ms if ms > 0 else 0.0


def timed_ms(fn, dev, reps: int = 7, warmup: int = 2, setup=None) -> float:
    """Median time of ``fn(setup())`` over ``reps`` runs after ``warmup``
    (CUDA events on a GPU, host included); only ``fn`` is inside the
    timer."""
    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        with Timer("", verbose=False, device=dev) as t:
            fn(arg)
        if i >= warmup:
            times.append(t.elapsed_ms)
    return statistics.median(times)


def graph_ms(fn, dev, calls: int = 1, reps: int = 7, warmup: int = 2,
             setup=None) -> float:
    """The device's time for one ``fn()``: ``calls`` calls of ``fn`` are
    captured once into a CUDA graph, and the median CUDA-event time of a
    replay over ``reps`` replays after ``warmup`` is divided by ``calls``.
    A replay launches every kernel from the device's own queue, so the
    host's cost of making each launch (Python, ctypes, the wrapper's
    checks) is left out.  ``setup`` runs before the capture and before each
    replay, outside the timer: it refreshes what ``fn`` updates in place."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        if setup is not None:
            setup()
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    if setup is not None:
        setup()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
        with Timer("", verbose=False, device=dev) as t:
            graph.replay()
        if i >= warmup:
            times.append(t.elapsed_ms / calls)
    del graph
    return statistics.median(times)
