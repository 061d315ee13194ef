"""Phase timer (the ``Timer.hpp`` equivalent).

``Timer`` times on the host clock by default; given a CUDA device it brackets
the block with CUDA events and synchronises at exit, so the time is the
device work of the block, not the time to enqueue it.
"""

from __future__ import annotations

import sys
import time

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
