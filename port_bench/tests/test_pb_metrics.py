"""The metric readers and the trace summary on synthetic records."""

import statistics

import pytest

from port_bench import drive, roofline, spec
from port_bench.drive import Record


def cell():
    return spec.Cell(spec.load_benchmark(), "headline_1024.fly")


def read(name, rec):
    return cell().reader(name)(rec)


def window(intervals, frames):
    return Record(intervals_ms=list(intervals), frames=list(frames),
                  window_ms=float(sum(intervals)),
                  config=cell().config)


def test_pb_fps_counts_every_frame_over_the_whole_window():
    iv = [100.0] * 9 + [1000.0]
    rec = window(iv, [("checker", i % 2 == 0) for i in range(10)])
    assert read("fps", rec) == pytest.approx(10 / 1.9)


def test_pb_p90_over_every_interval():
    iv = list(range(1, 101))
    rec = window(iv, [("quarter", False)] * 100)
    assert read("frame_ms_p90", rec) == pytest.approx(
        statistics.quantiles(iv, n=10, method="inclusive")[8])
    assert 90 <= read("frame_ms_p90", rec) <= 91


def test_pb_gi_frame_extra_is_a_difference_of_medians():
    iv = [130.0, 100.0, 150.0, 90.0, 140.0, 110.0]
    fr = [("checker", i % 2 == 0) for i in range(6)]
    assert read("gi_frame_extra_ms", window(iv, fr)) == pytest.approx(40.0)
    assert read("gi_frame_extra_ms",
                window(iv, [("full", False)] * 6)) is None


def test_pb_quarter_share_and_host_time():
    rec = window([1.0] * 4, [("quarter", True), ("checker", False),
                             ("quarter", True), ("quarter", False)])
    rec.host_ms = [2.0, 4.0, 6.0, 8.0]
    assert read("quarter_share", rec) == pytest.approx(75.0)
    assert read("host_ms_per_frame", rec) == pytest.approx(5.0)


def test_pb_build_phases():
    rec = Record(phase_times={"building fine voxel grid": 11.0,
                              "building coarse SDF": 0.5})
    assert read("world_build_s", rec) == pytest.approx(11.5)
    assert read("voxel_fill_s", rec) == pytest.approx(11.0)


def test_pb_k2_bytes_from_its_shapes():
    b = roofline.k2_bytes(2400, 3840)
    assert b == 4 * 2400 * 3840 + 2 * 4 * 2400 * 3840 + 4 * 4 * 2400 * 3840
    assert roofline.bound_s(b) * 1e3 == pytest.approx(0.077, abs=5e-4)


VARIANTS = [("checker", True), ("checker", False), ("quarter", True),
            ("quarter", False)]
#: window frames of each variant; their means sum to 1000 ms
WINDOW = [(290.0, VARIANTS[0]), (310.0, VARIANTS[0]), (200.0, VARIANTS[1]),
          (250.0, VARIANTS[2]), (240.0, VARIANTS[3]), (260.0, VARIANTS[3])]


def trace(**kw):
    t = dict(frames=4, ops=40000, span_s=1.3, busy_s=0.15, k1_s=0.004,
             k2_s=4 * 0.0001, k1_records=12, k1_launched=12, k2_records=4,
             device_ops=[], idle_gaps=[], variants=list(VARIANTS))
    t.update(kw)
    return Record(trace=t, config=cell().config,
                  intervals_ms=[ms for ms, _ in WINDOW],
                  frames=[v for _, v in WINDOW])


def test_pb_traced_readers():
    rec = trace()
    assert read("k1_ms_per_frame", rec) == pytest.approx(1.0)
    assert read("launches_per_frame", rec) == pytest.approx(10000)
    assert read("device_idle_share", rec) == pytest.approx(85.0)
    least = roofline.bound_s(roofline.k2_bytes(2400, 3840))
    assert read("k2_roofline", rec) == pytest.approx(100 * least / 1e-4)


def test_pb_idle_share_leaves_the_profilers_time_out():
    """The idle share's time is the window's unprofiled frames of the
    sub-window's variants, not the profiled span, which the profiler's
    host overhead lengthens; nothing where a variant has no window
    frame."""
    assert read("device_idle_share", trace(span_s=9.0)) == \
        pytest.approx(85.0)
    twice = trace(variants=VARIANTS + [VARIANTS[1]], busy_s=0.24)
    assert read("device_idle_share", twice) == pytest.approx(80.0)
    lost = trace(variants=VARIANTS + [("full", True)])
    assert read("device_idle_share", lost) is None


def test_pb_lost_k1_record_reads_nothing():
    assert read("k1_ms_per_frame", trace(k1_records=11)) is None
    assert read("k2_roofline", trace(k2_records=0, k2_s=0.0)) is None
    assert read("k1_ms_per_frame", Record()) is None


class Ev:
    def __init__(self, name, start, dur, kind):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        from torch.autograd import DeviceType
        return (DeviceType.CPU if self._k in ("cpu_op", "user_annotation")
                else DeviceType.CUDA)


def test_pb_summarise_unions_the_device_ops():
    evs = [Ev("ProfilerStep#1", 0, 10_000, "user_annotation"),
           Ev("ProfilerStep#1", 0, 10_000, "gpu_user_annotation"),
           Ev("pb.subwindow", 1000, 5000, "user_annotation"),
           Ev("aten::add", 1000, 1900, "cpu_op"),
           Ev("aten::mul", 1500, 500, "cpu_op"),
           Ev("trace_kernel<false, false>", 1200, 400, "kernel"),
           Ev("warp_kernel", 1500, 200, "kernel"),  # overlaps the first
           Ev("add_kernel", 2000, 1000, "kernel"),
           Ev("Memset", 4000, 1000, "gpu_memset"),
           Ev("early", 500, 100, "kernel")]          # before the span
    t = drive.summarise(evs, 2)
    assert t["ops"] == 4
    assert t["span_s"] == pytest.approx((5000 - 1000) / 1e9)
    assert t["busy_s"] == pytest.approx((500 + 1000 + 1000) / 1e9)
    assert t["k1_records"] == 1 and t["k2_records"] == 1
    assert t["k1_s"] == pytest.approx(400 / 1e9)
    gaps = dict(t["idle_gaps"])
    # 1000-1200 in aten::add, 1700-2000 in aten::add (mul ended at 2000:
    # the middle 1850 is inside it), 3000-4000 outside any op
    assert gaps["aten::mul"] == pytest.approx(300 / 1e9)
    assert gaps["aten::add"] == pytest.approx(200 / 1e9)
    assert gaps["python"] == pytest.approx(1000 / 1e9)


class OldEv(Ev):
    """An event of a PyTorch whose events have no activity type."""
    activity_type = None


def test_pb_summarise_without_activity_types():
    evs = [OldEv("ProfilerStep#1", 0, 10_000, "user_annotation"),
           OldEv("ProfilerStep#1", 0, 10_000, "gpu_user_annotation"),
           OldEv("pb.subwindow", 1000, 5000, "user_annotation"),
           OldEv("pb.subwindow", 1000, 5000, "gpu_user_annotation"),
           OldEv("trace_kernel<false, false>", 1200, 400, "kernel")]
    t = drive.summarise(evs, 1)
    assert t["ops"] == 1 and t["k1_records"] == 1
    assert t["busy_s"] == pytest.approx(400 / 1e9)
