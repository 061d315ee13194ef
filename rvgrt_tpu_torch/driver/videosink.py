"""ctypes binding of the native video sink (``native/videosink.cpp``).

The render loop pushes (H, W, 3) uint8 frames; a C++ writer thread encodes
baseline JPEG (a self-contained encoder) and muxes Motion-JPEG into an AVI
('MJPG') or an MP4 ('mp4v'), chosen by the file's extension.  A full queue
drops frames rather than stall the frame loop, as a swap chain's present
does (``main.cpp:194-217``).  The library is built on first use into
``rvgrt_tpu_torch/_build/native/`` (``driver/native.py``).
"""

from __future__ import annotations

import ctypes

from rvgrt_tpu_torch.driver import native

_VP, _CI, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
SIGS = {
    "videosink_create": ([ctypes.c_char_p, _CI, _CI, ctypes.c_double, _CI,
                          _CI], _VP),
    "videosink_push": ([_VP, native.U8P, _CI, _CI], _CI),
    "videosink_close": ([_VP], None),
    "videosink_frames": ([_VP], _U64),
    "videosink_dropped": ([_VP], _U64),
    "videosink_write_jpeg": ([ctypes.c_char_p, native.U8P, _CI, _CI, _CI],
                             _CI),
}


def get_lib() -> ctypes.CDLL:
    return native.load("videosink", SIGS)


class VideoSink:
    """Async MJPEG video writer (container from the file extension)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0, quality: int = 90):
        self.path = path
        self._lib = get_lib()
        container = 1 if path.lower().endswith(".mp4") else 0
        self._h = self._lib.videosink_create(
            path.encode(), width, height, float(fps), int(quality),
            container)
        if not self._h:
            raise RuntimeError(f"cannot open {path}")

    def push(self, rgb_u8) -> bool:
        """Queue an (H, W, 3) uint8 frame (tensor or array); returns False
        if dropped."""
        a = native.rgb_frame(rgb_u8)
        h, w, _ = a.shape
        return self._lib.videosink_push(
            self._h, a.ctypes.data_as(native.U8P), w, h) == 0

    @property
    def frames(self) -> int:
        return int(self._lib.videosink_frames(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.videosink_dropped(self._h))

    def close(self):
        """Drain the queue, finalize the container, release the handle."""
        if self._h:
            self._lib.videosink_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
