"""Frames completed in the window over the window's time: from the start
event, recorded before the first timed frame, to the last frame's
completion event."""


def read(rec):
    if not rec.intervals_ms:
        return None
    return len(rec.intervals_ms) / (rec.window_ms / 1e3)
