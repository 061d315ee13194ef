"""Spans over the frame path, and a device-time profiler.

* ``span(name, frame=None)``: a named host range around one stage of the
  frame path (``FrameLoop.frame`` and ``pipeline.render_slab``).  Spans are
  off unless a caller installs a tracer with ``enable()``: off, ``span``
  checks one module global and returns one shared no-op context, records
  nothing and allocates nothing.  On, each span records ``Span(name,
  parent, frame, start_ns, end_ns)`` on ``time.perf_counter_ns()`` in the
  tracer's list and, while a ``torch.profiler`` session runs, opens
  ``record_function("rvgrt.<name>")`` for its extent, so that every span is
  also a host range on the profiler's own timeline, the clock of the
  device's records.  ``FrameLoop.frame(i, ...)`` opens the root span
  ``frame`` with ``frame=i``; a span opened inside another carries its
  frame id.  Each place on the frame path where the host waits for the
  card opens ``sync.<what>``: the water test's read (``sync.water``) and
  the GI upsample's two blocking uploads (``sync.gi_upsample``).  Spans
  assume one thread renders at a time, and change no tensor.
* ``enable()`` installs a new ``Tracer`` and returns it; ``disable()``
  removes it.  The tracer keeps its spans in memory and writes nothing.
* ``device_time_ms(fn, *args)``: the device time of one call under
  ``torch.profiler`` (``chip_smoke.py --profile``).

The JAX package's ``rvgrt_tpu/utils/profiling.py`` wraps ``jax.profiler``
around a call and has no spans.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass

from torch.autograd import _profiler_enabled
from torch.profiler import record_function


@dataclass(slots=True)
class Span:
    """One span: ``parent`` is the index in ``Tracer.spans`` of the span it
    opened inside (-1 for none), ``frame`` the frame id it carries, and
    ``end_ns`` is -1 while it is open."""
    name: str
    parent: int
    frame: int | None
    start_ns: int
    end_ns: int = -1


class Tracer:
    """The spans recorded since it was installed (or last cleared), in the
    order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self._open: list[int] = []

    def clear(self) -> None:
        """Forget every span; call it between frames, with none open."""
        self.spans.clear()
        self._open.clear()

    def summary(self, frames=None) -> dict:
        """``{name: {"count", "host_ms", "self_ms"}}`` over the closed spans
        whose frame id is in ``frames`` (every span where None): how many,
        their summed duration and their summed self time, a span's duration
        less that of the spans opened directly inside it."""
        spans = self.spans
        inner = [0] * len(spans)
        for s in spans:
            if s.parent >= 0 and s.end_ns >= 0:
                inner[s.parent] += s.end_ns - s.start_ns
        keep = None if frames is None else set(frames)
        out: dict = {}
        for k, s in enumerate(spans):
            if s.end_ns < 0 or (keep is not None and s.frame not in keep):
                continue
            row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                            "self_ms": 0.0})
            dur = s.end_ns - s.start_ns
            row["count"] += 1
            row["host_ms"] += dur / 1e6
            row["self_ms"] += (dur - inner[k]) / 1e6
        return out


class _Off:
    """The context ``span`` returns while no tracer is installed."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
#: the installed tracer, or None: spans are off
_tracer: Tracer | None = None


class _On:
    __slots__ = ("tracer", "name", "frame", "index", "rf")

    def __init__(self, tracer: Tracer, name: str, frame: int | None):
        self.tracer, self.name, self.frame = tracer, name, frame

    def __enter__(self):
        t = self.tracer
        parent = t._open[-1] if t._open else -1
        frame = self.frame
        if frame is None and parent >= 0:
            frame = t.spans[parent].frame
        # a range on the profiler's timeline while one runs (opening one
        # costs about 12 us of host even with no profiler to see it)
        self.rf = (record_function(f"rvgrt.{self.name}")
                   if _profiler_enabled() else None)
        if self.rf is not None:
            self.rf.__enter__()
        self.index = len(t.spans)
        t.spans.append(Span(self.name, parent, frame, time.perf_counter_ns()))
        t._open.append(self.index)
        return None

    def __exit__(self, *exc):
        t = self.tracer
        t.spans[self.index].end_ns = time.perf_counter_ns()
        t._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, frame: int | None = None):
    """A context over one stage of the frame path (module docstring);
    ``frame``: the frame id, given by the root span of a frame."""
    if _tracer is None:
        return _OFF
    return _On(_tracer, name, frame)


def enable() -> Tracer:
    """Install a new tracer, in place of any installed one, and return
    it."""
    global _tracer
    _tracer = Tracer()
    return _tracer


def disable() -> None:
    """Remove the installed tracer: spans are off again."""
    global _tracer
    _tracer = None


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
