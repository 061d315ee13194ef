"""ctypes binding of the native frame sink (``native/framesink.cpp``).

The presentation layer of the port's CLI: the frame loop pushes (H, W, 3)
uint8 frames into the sink's ring buffer, and a C++ writer thread encodes
PNGs off the critical path - the headless replacement for the reference's
swap-chain present (``main.cpp:194-217``).  The library is built on first
use into ``rvgrt_tpu_torch/_build/native/`` (``driver/native.py``); where
it cannot be built the sink raises.
"""

from __future__ import annotations

import ctypes
import os

from rvgrt_tpu_torch.driver import native

_VP, _CI, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
SIGS = {
    "framesink_create": ([ctypes.c_char_p, ctypes.c_char_p, _CI], _VP),
    "framesink_push": ([_VP, native.U8P, _CI, _CI, _U64], _CI),
    "framesink_flush": ([_VP], None),
    "framesink_written": ([_VP], _U64),
    "framesink_dropped": ([_VP], _U64),
    "framesink_destroy": ([_VP], None),
    "framesink_write_png": ([ctypes.c_char_p, native.U8P, _CI, _CI], _CI),
}


def get_lib() -> ctypes.CDLL:
    return native.load("framesink", SIGS)


class FrameSink:
    """Async PNG frame writer backed by the C++ ring buffer."""

    def __init__(self, directory: str, prefix: str = "frame_",
                 capacity: int = 16):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix
        self._lib = get_lib()
        self._h = self._lib.framesink_create(
            directory.encode(), prefix.encode(), capacity)

    def push(self, rgb_u8, index: int) -> bool:
        """Queue an (H, W, 3) uint8 frame (tensor or array); returns False
        if dropped."""
        a = native.rgb_frame(rgb_u8)
        h, w, _ = a.shape
        return self._lib.framesink_push(
            self._h, a.ctypes.data_as(native.U8P), w, h, index) == 0

    def flush(self):
        self._lib.framesink_flush(self._h)

    @property
    def written(self) -> int:
        return int(self._lib.framesink_written(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.framesink_dropped(self._h))

    def close(self):
        if self._h is not None:
            self.flush()
            self._lib.framesink_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
