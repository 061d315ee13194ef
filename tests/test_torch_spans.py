"""The port's spans over the frame path (``utils/profiling.py``), on the CPU.

Off, ``span`` hands out one shared no-op context and records nothing.  On,
``FrameLoop.frame`` records the tree of its stages: the root ``frame``
with the frame's index, ``gi_update`` on a GI frame, ``base`` (with
``prepass``, ``primary``, ``shadow``, ``water`` and its host read
``sync.water``, ``shade`` inside it), ``composite`` (with the GI
upsample's two blocking uploads, ``sync.gi_upsample``), ``expand`` and
``post``.  A frame renders bit for bit the same with spans on as off.  The
tracer's summary is checked on spans of known times.  One test needs a
CUDA card: the host reads ``set_sync_debug_mode("warn")`` reports in a
frame number the ``sync.*`` spans.  A 64^3 world at 64x40, built once;
the file imports neither jax nor the JAX package.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch.bench import headline_config
from rvgrt_tpu_torch.driver import engine, frame_loop
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import (Character, InputState,
                                          phase_jitter_sequence)
from rvgrt_tpu_torch.utils import profiling

#: a camera 12 voxels over the 64^3 world's flat floor (its top at y 30,
#: under the water level) looking down at it, and the same looking up
WATER, SKY = -3.67, -1.7
#: (frame, rate, pitch) of the frames the tests render: a GI window on
#: every even frame
FRAMES = [(0, "checker", WATER), (1, "quarter", WATER), (2, "full", SKY)]
#: the spans under the root, and under ``base``, in the order they open
TOP = ["gi_update", "base", "composite", "expand", "post"]
BASE = ["prepass", "primary", "shadow", "water", "shade"]


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(2)
    ecfg = headline_config(6, 64, 40)
    return ecfg, engine.build_world(ecfg, verbose=False, device="cpu")


@pytest.fixture(autouse=True)
def spans_off():
    profiling.disable()
    yield
    profiling.disable()


def camera(i: int, pitch: float, device="cpu") -> pipeline.CameraArrays:
    ch = Character(display_width=192, display_height=120, render_width=64,
                   render_height=40, yaw=0.3, pitch=pitch,
                   position=np.array([32.0, 42.0, 56.0], np.float32),
                   jitter_sequence=phase_jitter_sequence(3))
    cam = ch.update(InputState(), 1.0 / 60.0, i)
    return engine.camera_arrays(
        cam, vp=ch.unjittered_view_projection,
        prev_vp=ch.prev_unjittered_view_projection,
        jitter=ch.ray_jitter_ndc(), time_s=i / 60.0, device=device)


def loop_of(world) -> frame_loop.FrameLoop:
    ecfg, w = world
    return frame_loop.FrameLoop(w, ecfg, scale=3, gi_frame=None)


def render(loop, i: int, rate: str, pitch: float):
    return loop.frame(i, camera(i, pitch, loop.world.bits.device), rate)


def test_spans_off_hand_out_one_context_and_record_nothing(world):
    a, b = profiling.span("frame", frame=3), profiling.span("sync.water")
    assert a is b
    with a:
        with b:
            pass
    render(loop_of(world), *FRAMES[1])
    assert profiling._tracer is None
    tracer = profiling.enable()
    with profiling.span("x"):
        assert profiling.span("y") is not a
    profiling.disable()
    with profiling.span("z"):
        pass
    assert [s.name for s in tracer.spans] == ["x"]


@pytest.mark.parametrize("k", [0, 1], ids=["gi_frame", "no_gi_frame"])
def test_frame_records_its_stage_tree(world, k):
    loop = loop_of(world)
    if k:
        render(loop, *FRAMES[0])
    tracer = profiling.enable()
    i, rate, pitch = FRAMES[k]
    render(loop, i, rate, pitch)
    spans = tracer.spans
    names = [s.name for s in spans]
    assert len(spans) <= 20
    assert names[0] == "frame" and spans[0].parent == -1
    assert all(s.frame == i for s in spans)
    under = [s.name for s in spans if s.parent == 0]
    assert under == [t for t in TOP if k == 0 or t != "gi_update"]
    base = names.index("base")
    assert [s.name for s in spans if s.parent == base] == BASE
    water = names.index("water")
    assert [s.name for s in spans if s.parent == water] == ["sync.water"]
    comp = names.index("composite")
    assert [s.name for s in spans if s.parent == comp] == [
        "sync.gi_upsample"] * 2
    assert len(names) == len(set(names)) + 1
    inner = [0] * len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            inner[s.parent] += s.end_ns - s.start_ns
    summary = tracer.summary()
    for name, row in summary.items():
        mine = [n for n, s in enumerate(spans) if s.name == name]
        assert row["count"] == len(mine)
        assert row["host_ms"] == pytest.approx(sum(
            spans[n].end_ns - spans[n].start_ns for n in mine) / 1e6,
            abs=1e-9)
        assert row["self_ms"] == pytest.approx(sum(
            spans[n].end_ns - spans[n].start_ns - inner[n]
            for n in mine) / 1e6, abs=1e-9)


def test_traced_frames_are_bit_identical(world):
    off, on = loop_of(world), loop_of(world)
    for i, rate, pitch in FRAMES:
        profiling.disable()
        a = render(off, i, rate, pitch)
        tracer = profiling.enable()
        b = render(on, i, rate, pitch)
        assert [s.frame for s in tracer.spans] == [i] * len(tracer.spans)
        for x, y in [(a.image, b.image), (a.out.color, b.out.color),
                     (a.out.motion, b.out.motion),
                     (a.out.depth, b.out.depth), (a.hit, b.hit),
                     (off.gi, on.gi), (off.overflow, on.overflow),
                     *zip(off.state, on.state)]:
            assert torch.equal(x, y)
        assert (off.offset, off.gi_windows) == (on.offset, on.gi_windows)


@pytest.mark.parametrize("pitch", [WATER, SKY], ids=["water", "sky"])
def test_the_water_read_is_one_span_a_frame(world, monkeypatch, pitch):
    """The host read before the water pass runs in every frame, water in
    view or not, and is recorded once a frame; the pass runs only with
    water in view."""
    from rvgrt_tpu_torch.render import shading

    calls = []
    normal = shading.water_normal
    monkeypatch.setattr(shading, "water_normal",
                        lambda *a: calls.append(1) or normal(*a))
    loop = loop_of(world)
    render(loop, 0, "checker", WATER)
    tracer = profiling.enable()
    calls.clear()
    render(loop, 1, "checker", pitch)
    names = [s.name for s in tracer.spans]
    assert names.count("sync.water") == 1
    assert sorted(n for n in names if n.startswith("sync.")) == [
        "sync.gi_upsample", "sync.gi_upsample", "sync.water"]
    assert len(calls) == (1 if pitch == WATER else 0)


def test_enable_disable_clear():
    assert profiling.span("a") is profiling._OFF
    t1 = profiling.enable()
    assert isinstance(t1, profiling.Tracer) and profiling._tracer is t1
    with profiling.span("a", frame=5):
        with profiling.span("b"):
            pass
    assert [(s.name, s.parent, s.frame) for s in t1.spans] == [
        ("a", -1, 5), ("b", 0, 5)]
    t2 = profiling.enable()
    assert t2 is not t1 and profiling._tracer is t2
    with profiling.span("c"):
        pass
    assert len(t1.spans) == 2 and [s.name for s in t2.spans] == ["c"]
    assert t2.spans[0].frame is None
    t2.clear()
    assert t2.spans == [] and t2.summary() == {}
    profiling.disable()
    assert profiling._tracer is None
    with profiling.span("d"):
        pass
    assert t2.spans == []


def test_spans_are_profiler_ranges_while_a_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    tracer = profiling.enable()
    with profiling.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("frame", frame=0):
            with profiling.span("base"):
                torch.ones(3).add_(1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "rvgrt.frame" in names and "rvgrt.base" in names
    assert "rvgrt.outside" not in names
    assert [s.name for s in tracer.spans] == ["outside", "frame", "base"]


def test_summary_arithmetic():
    t = profiling.Tracer()
    S = profiling.Span
    ms = 1_000_000
    t.spans = [S("frame", -1, 0, 0, 100 * ms),
               S("base", 0, 0, 10 * ms, 60 * ms),
               S("primary", 1, 0, 20 * ms, 30 * ms),
               S("sync.water", 1, 0, 40 * ms, 45 * ms),
               S("post", 0, 0, 70 * ms, 90 * ms),
               S("frame", -1, 1, 200 * ms, 250 * ms),
               S("base", 5, 1, 205 * ms, 245 * ms),
               S("frame", -1, 2, 300 * ms)]   # still open
    got = t.summary()
    assert got["frame"] == {"count": 2, "host_ms": 150.0,
                            "self_ms": 100.0 - 70.0 + 50.0 - 40.0}
    assert got["base"] == {"count": 2, "host_ms": 90.0,
                           "self_ms": 50.0 - 15.0 + 40.0}
    assert got["primary"]["self_ms"] == 10.0
    assert got["post"] == {"count": 1, "host_ms": 20.0, "self_ms": 20.0}
    assert t.summary(frames=[1]) == {
        "frame": {"count": 1, "host_ms": 50.0, "self_ms": 10.0},
        "base": {"count": 1, "host_ms": 40.0, "self_ms": 40.0}}
    assert t.summary(frames=[0])["frame"]["self_ms"] == 30.0
    assert t.summary(frames=[2]) == {}


@pytest.mark.cuda
def test_sync_spans_match_the_host_reads():
    """On a card: every host read ``set_sync_debug_mode("warn")`` reports
    in a frame of each kind lies in a ``sync.*`` span, one span a read
    (after ``test_trace_makes_no_host_read`` in ``test_torch_kernels.py``).
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++")
    ecfg = headline_config(6, 64, 40)
    w = engine.build_world(ecfg, verbose=False, device="cuda")
    loop = frame_loop.FrameLoop(w, ecfg, scale=3, gi_frame=None)
    loop.frame(0, camera(0, WATER, "cuda"), "checker")  # builds the kernels
    # a process's first switch to "warn" reports a read of its own
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    for i, rate, pitch in [(j + 1, r, p) for j, r, p in FRAMES]:
        cam = camera(i, pitch, "cuda")
        torch.cuda.synchronize()
        tracer = profiling.enable()
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loop.frame(i, cam, rate)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        profiling.disable()
        torch.cuda.synchronize()
        reads = [x for x in got if "synchroniz" in str(x.message)]
        spans = [s for s in tracer.spans if s.name.startswith("sync.")]
        assert len(reads) == len(spans) >= 1, (
            [(x.filename, x.lineno) for x in reads], [s.name for s in spans])
