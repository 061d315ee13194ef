"""K1's device time (the profiler's ``trace_kernel`` records) over the
traced sub-window, a frame; nothing where the profiler lost a K1 record."""


def read(rec):
    t = rec.trace
    if not t or not t.get("k1_records") or \
            t["k1_records"] != t["k1_launched"]:
        return None
    return t["k1_s"] * 1e3 / t["frames"]
