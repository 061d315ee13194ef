"""The host's time in ``FrameLoop.frame`` (the enqueue, no sync) a window
frame, by the benchmark's clock around each call."""


def read(rec):
    if not rec.host_ms:
        return None
    return sum(rec.host_ms) / len(rec.host_ms)
