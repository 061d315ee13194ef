"""The device operations (kernels, copies, sets) the profiler saw in the
traced sub-window, a frame."""


def read(rec):
    t = rec.trace
    if not t or not t.get("ops"):
        return None
    return t["ops"] / t["frames"]
