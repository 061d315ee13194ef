"""K2's share of its roofline over the traced sub-window, percent: its
count-once bytes at the HBM peak (``roofline.k2_bytes`` of the display
size) over its device time (the profiler's ``warp_kernel`` records)."""

from port_bench import roofline


def read(rec):
    t = rec.trace
    if not t or not t.get("k2_records") or not t["k2_s"]:
        return None
    r = rec.config["render"]
    s = rec.config["loop"]["scale"]
    least = roofline.bound_s(roofline.k2_bytes(s * r["height"],
                                               s * r["width"]))
    return 100.0 * t["k2_records"] * least / t["k2_s"]
