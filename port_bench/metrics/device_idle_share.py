"""1 - the device's busy time over the traced sub-window, from the
profiler, over the time those frames take unprofiled, percent.  The time
unprofiled is, for each frame of the sub-window, the mean interval of the
window's frames of its (rate tier, GI) variant (completion events), so the
profiler's own host overhead, which lengthens the profiled frames, is not
counted as idle.  Nothing where a variant of the sub-window has no frame
in the window."""

import statistics


def read(rec):
    t = rec.trace
    if not t or not t.get("span_s") or not t.get("variants"):
        return None
    by_variant: dict = {}
    for ms, (rate, gi) in zip(rec.intervals_ms, rec.frames):
        by_variant.setdefault((rate, bool(gi)), []).append(ms)
    span_ms = 0.0
    for rate, gi in t["variants"]:
        got = by_variant.get((rate, bool(gi)))
        if not got:
            return None
        span_ms += statistics.fmean(got)
    return 100.0 * (1.0 - t["busy_s"] * 1e3 / span_ms)
