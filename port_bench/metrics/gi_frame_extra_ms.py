"""The median interval of the window's frames that ran a GI window, less
the median of the others (completion events)."""

import statistics


def read(rec):
    gi = [t for t, (_, g) in zip(rec.intervals_ms, rec.frames) if g]
    rest = [t for t, (_, g) in zip(rec.intervals_ms, rec.frames) if not g]
    if not gi or not rest:
        return None
    return statistics.median(gi) - statistics.median(rest)
