"""The stage tool (``port_bench/stages.py``): device operations and idle
gaps put down to the program's spans on synthetic profiler events, its
figures from empty records, and one run on the CPU at 128^3."""

import pytest
import torch

from port_bench import stages
from port_bench.tests.small import small_cell

SEED = 2147483647 + 17


class Ev:
    def __init__(self, name, start, dur, kind, corr=0, linked=0):
        self._n, self._s, self._d, self._k = name, start, dur, kind
        self._c, self._l = corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def device_type(self):
        from torch.autograd import DeviceType
        return (DeviceType.CUDA if self._k.startswith(("gpu_", "kernel"))
                else DeviceType.CPU)


def frame_events():
    """One frame: ``frame`` [1000, 9000) over ``base`` [1100, 5000) over
    ``primary`` [1200, 2000), each range also on the device's timeline;
    kernels launched in ``primary`` (correlation 7), in ``base`` (8, found
    by the linked id), after the frame (9), and one whose launch the
    profiler lost (10)."""
    return [Ev("pb.subwindow", 1000, 9000, "user_annotation"),
            Ev("rvgrt.frame", 1000, 8000, "user_annotation"),
            Ev("rvgrt.frame", 2000, 7000, "gpu_user_annotation"),
            Ev("rvgrt.base", 1100, 3900, "user_annotation"),
            Ev("rvgrt.primary", 1200, 800, "user_annotation"),
            Ev("aten::add", 1250, 200, "cpu_op", corr=99),
            Ev("cudaLaunchKernel", 1300, 50, "cuda_runtime", corr=7),
            Ev("cudaLaunchKernel", 2100, 50, "cuda_runtime", corr=55),
            Ev("cudaMemcpyAsync", 9500, 50, "cuda_runtime", corr=9),
            Ev("trace_kernel", 2500, 500, "kernel", corr=7),
            Ev("add_kernel", 5000, 1000, "kernel", corr=1, linked=55),
            Ev("Memcpy HtoD", 9600, 100, "gpu_memcpy", corr=9),
            Ev("lost", 9800, 100, "kernel", corr=10),
            Ev("early", 500, 100, "kernel", corr=7)]


def test_pb_a_launch_counts_in_every_range_open_at_it():
    t = stages.attribute(frame_events(), 1)
    st = t["stages"]
    assert st["primary"]["launches"] == st["primary"]["self_launches"] == 1
    assert st["primary"]["device_ms"] == pytest.approx(500 / 1e6)
    assert st["base"]["launches"] == 2 and st["base"]["self_launches"] == 1
    assert st["base"]["self_device_ms"] == pytest.approx(1000 / 1e6)
    assert st["frame"]["launches"] == 2 and st["frame"]["self_launches"] == 0
    assert st["frame"]["device_ms"] == pytest.approx(1500 / 1e6)
    # the device-side copies of the ranges are no operations
    assert sum(r["self_launches"] for r in st.values()) == 2


def test_pb_a_launch_outside_every_range_and_a_lost_one():
    t = stages.attribute(frame_events(), 1)
    assert t["outside"]["launches"] == 1
    assert t["outside"]["device_ms"] == pytest.approx(100 / 1e6)
    assert t["unmatched"] == 1


def test_pb_a_gap_goes_to_the_ranges_open_at_its_middle():
    t = stages.attribute(frame_events(), 1)
    st = t["stages"]
    # gaps: 1000-2500 (middle 1750: primary), 3000-5000 (4000: base),
    # 6000-9600 (7800: frame), 9700-9800 (the lost kernel's launch is not
    # known, so it leaves no gap of its own; 9700-... after the copy ends
    # is not a gap, no operation follows it)
    assert st["primary"]["self_idle_ms"] == pytest.approx(1500 / 1e6)
    assert st["base"]["self_idle_ms"] == pytest.approx(2000 / 1e6)
    assert st["base"]["idle_ms"] == pytest.approx(3500 / 1e6)
    assert st["frame"]["self_idle_ms"] == pytest.approx(3600 / 1e6)
    assert t["outside"]["idle_ms"] == 0.0


class OldEv(Ev):
    """An event of a PyTorch whose events have no activity type (the
    card's 2.11): a launch call, and a span's range on the device, are
    known by name only."""
    activity_type = None


def test_pb_without_activity_types_ranges_are_no_operations():
    evs = [OldEv(e.name(), e.start_ns(), e.duration_ns(), e._k, e._c, e._l)
           for e in frame_events()]
    assert stages.attribute(evs, 1) == stages.attribute(frame_events(), 1)


def test_pb_without_a_subwindow_attribution_refuses():
    with pytest.raises(ValueError, match="pb.subwindow"):
        stages.attribute([e for e in frame_events()
                          if e.name() != "pb.subwindow"], 1)


def test_pb_a_subwindow_that_brings_no_events_refuses(monkeypatch):
    from port_bench import drive

    class Run:
        rec = drive.Record()

        def traced(self):
            self.rec.trace = drive.summarise([], 1)

    monkeypatch.setattr(drive, "summarise", lambda events, n: {"frames": n})
    with pytest.raises(RuntimeError, match="no events"):
        stages.subwindow(Run())
    assert drive.summarise([], 1) == {"frames": 1}


def test_pb_figures_are_none_where_records_are_missing():
    got = stages.span_metrics({}, 0, 0, {}, None, None, 0)
    assert set(got) == {
        "frame_sync_wait_ms", "gi_update_host_ms", "gi_update_device_ms",
        "gi_overflow_per_window", "base_host_ms", "base_launches_per_frame",
        "composite_host_ms", "composite_launches_per_frame",
        "composite_device_ms", "expand_host_ms", "post_host_ms",
        "warm_frames_s"}
    assert all(v is None for v in got.values())


def test_pb_figures_from_spans_and_stages():
    window = {"frame": {"count": 4, "host_ms": 400.0, "self_ms": 4.0},
              "gi_update": {"count": 2, "host_ms": 60.0, "self_ms": 60.0},
              "sync.water": {"count": 4, "host_ms": 20.0, "self_ms": 20.0},
              "composite": {"count": 4, "host_ms": 120.0, "self_ms": 120.0},
              "expand": {"count": 4, "host_ms": 2.0, "self_ms": 2.0}}
    warm = {"frame": {"count": 4, "host_ms": 5000.0, "self_ms": 1.0}}
    st = {"frames": 2, "gi_frames": 1, "stages": {
        "gi_update": {"launches": 1000, "device_ms": 9.0},
        "composite": {"launches": 20000, "device_ms": 30.0}}}
    got = stages.span_metrics(window, 2, 4, warm, st, 300, 2)
    assert got["frame_sync_wait_ms"] == 5.0
    assert got["gi_update_host_ms"] == 30.0
    assert got["composite_host_ms"] == 30.0
    assert got["warm_frames_s"] == 5.0
    assert got["gi_overflow_per_window"] == 150.0
    assert got["gi_update_device_ms"] == 9.0
    assert got["composite_launches_per_frame"] == 10000.0
    assert got["composite_device_ms"] == 15.0
    assert got["base_host_ms"] is None and got["post_host_ms"] is None
    assert got["expand_host_ms"] == 0.5


def test_pb_a_cpu_run_records_every_stage():
    torch.set_num_threads(4)
    res = stages.measure(small_cell("headline_1024.fly"), SEED, 1e9,
                         device="cpu", max_frames=2)
    assert set(stages.TOP) | {"frame", "sync.water"} <= set(
        res["spans_window"])
    assert res["spans_window"]["frame"]["count"] == 2
    assert res["spans_warm"]["frame"]["count"] == 4
    assert res["gi_windows"] == res["gi_frames"] == 1
    m = res["metrics"]
    assert isinstance(m["gi_overflow_per_window"], float)
    assert m["warm_frames_s"] > 0 and m["frame_sync_wait_ms"] >= 0
    assert m["composite_device_ms"] is None  # no profiled sub-window here
