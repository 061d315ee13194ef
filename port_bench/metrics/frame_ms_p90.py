"""The 90th percentile of every frame interval of the window (the gap
between the completion events of consecutive frames)."""

import statistics


def read(rec):
    if len(rec.intervals_ms) < 2:
        return None
    return statistics.quantiles(rec.intervals_ms, n=10,
                                method="inclusive")[8]
