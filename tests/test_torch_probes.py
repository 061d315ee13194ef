"""Parity of the port's probe tools (``rvgrt_tpu_torch/tools/``) and of
``pipeline.min_dist_upsample``, on the CPU.

* ``pipeline.min_dist_upsample`` against JAX's in this process (eager
  elementwise work, which XLA:CPU contracts nowhere): bit for bit.
* The quality probe (``probe_checker_motion``): its frame loop over 3
  frames of the ``mixed`` script on a 32^3 world at 32x20, every variant:
  the adaptive tiers are JAX's scheduler's on the same poses; each
  variant's 3x image equals, bit for bit, the loop written out here from
  the port's primitives (GI window, rate-cut base frame, composite on the
  cadence with the addend reused between, expand, valid mask, upscale), and
  so does the last frame's SSAA target; the SSAA jitters are
  ``default_rng(1000 + i)``'s draws as the script takes them; ``psnr``
  gives 99 dB below an MSE of 1e-12.  Against JAX: the script's loop,
  written out from its ``main`` with the JAX package's functions in the
  child (``ref_quality_loop``), over the first 2 of those poses: the
  full-rate and every variant's image >= 50 dB against JAX's, the
  variant-vs-full PSNRs within 0.1 dB, the tiers equal (the SSAA target
  is held against the primitives and the rng's draws only).  The whole script against the tool, a JAX run of minutes,
  is one ``slow`` test.
* The latency probe (``probe_r31_latency``): its trials against a live
  ``ViewerServer`` over a stub engine with a fixed step time, and a
  failing step that makes the probe raise.
* The cost probe (``perf_probe``): its camera is the script's, and its
  stages on a 64^3 world at 128x80 (the probe's ``RenderConfig``
  defaults) against JAX's through ``_flat_trace_fn``: the parked trace's
  ``its``, the cascade start, the prepass, the minDist start and the
  primary from it, bit for bit; its floor fit and straggler tiles on
  known data, its timer on the CPU (the host clock, no device times),
  its profiler's kernel sums and re-run of a session that lost a K1
  record, and K1's kernel name, which its profiler times match, against
  the CUDA source.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.driver.viewer import ViewerServer
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.render.scheduler import RATE_QUARTER
from rvgrt_tpu_torch.scene.camera import Camera, InputState
from rvgrt_tpu_torch.tools import perf_probe
from rvgrt_tpu_torch.tools import probe_checker_motion as pcm
from rvgrt_tpu_torch.tools import probe_r31_latency as lat
from rvgrt_tpu_torch.upscale import temporal
from tests import torch_jaxref as ref

#: the quality loop's size: the 32^3 world at 32x20 -> 96x60
QUALITY_ARGS = ["--cube", "5", "--low-w", "32", "--low-h", "20",
                "--frames", "3", "--warm", "1", "--ssaa", "2", "--mode",
                "all", "--script", "mixed", "--device", "cpu"]
#: the slow test's size (the JAX script takes minutes on a CPU, its XLA
#: compiles)
SLOW_ARGS = ["--cube", "5", "--low-w", "32", "--low-h", "20", "--frames",
             "4", "--warm", "2", "--ssaa", "2", "--mode", "all",
             "--script", "mixed"]
SLOW_TIMEOUT = 900.0
#: the cost probe's config at 64^3 and 128x80 (RenderConfig's defaults:
#: prepass divisor 2, so min_dist_upsample's 2x matches the frame)
PROBE_SPEC = {"cube": 6, "render": dict(width=128, height=80),
              "engine": dict(gi_init_mode="heightfield")}
CAM = ref.camera(pos=(30.0, 44.0, 60.0), forward=(0.25, -0.18, -1.0),
                 jitter=(0.0, 0.0), time_s=0.0)
#: the stub engine's step time in the latency test (s)
STEP_S = 0.1


#: the frames of the quality loop held against JAX's (the first of
#: QUALITY_ARGS' 3: a composite frame and a reusing one)
JAX_FRAMES = 2


def _quality_ecfg(args):
    return tcfg.EngineConfig(
        world=tcfg.WorldConfig().with_cube(args.cube),
        render=dataclasses.replace(tcfg.RenderConfig(), width=args.low_w,
                                   height=args.low_h))


def _cam_dict(ch, jitter, i) -> dict:
    """The camera dict (``torch_jaxref.camera``'s keys) of a character's
    pose at frame ``i``."""
    c = ch.camera
    return dict(pos=c.pos.copy(), forward=c.forward.copy(),
                right=c.right.copy(), up=c.up.copy(),
                vp=np.asarray(ch.unjittered_view_projection, np.float32),
                prev_vp=np.asarray(ch.prev_unjittered_view_projection,
                                   np.float32),
                jitter=np.asarray(jitter, np.float32), time=i / 60.0)


def _replay_cameras(world, ecfg, frames):
    """The quality loop's poses replayed on fresh engines over ``world``
    (the tool's character updates, no rendering): per frame the low
    camera's dict and the 3x one's (its jitter 0)."""
    lo, hi = pcm.make_engines(ecfg, True, "cpu", world=world)
    ch, hc = lo.character, hi.character
    cams, hi_cams = [], []
    for i in range(frames):
        ch.update(pcm.inputs_mixed(i, frames), 1.0 / 60.0, i)
        hc.position, hc.yaw, hc.pitch = ch.position.copy(), ch.yaw, ch.pitch
        hc.velocity = ch.velocity.copy()
        hc.update(InputState(), 0.0, i)
        cams.append(_cam_dict(ch, ch.ray_jitter_ndc(), i))
        hi_cams.append(_cam_dict(hc, (0.0, 0.0), i))
    return cams, hi_cams


@pytest.fixture(scope="module")
def quality():
    """The quality loop's world (the tool's build at QUALITY_ARGS), its
    poses replayed, and the script's loop over the first JAX_FRAMES of
    them in a JAX child of its own (``ref_quality_loop``; its result on
    first use, beside the other child's jobs)."""
    args = pcm.parse_args(QUALITY_ARGS)
    ecfg = _quality_ecfg(args)
    world = engine.build_world(ecfg, verbose=False, device="cpu")
    cams, hi_cams = _replay_cameras(world, ecfg, args.frames)
    child = ref.start([("ref_quality_loop", dict(
        spec={"cube": args.cube,
              "render": dict(width=args.low_w, height=args.low_h)},
        world=engine.world_to_numpy(world), cams=cams[:JAX_FRAMES],
        comp_cadence=args.comp_cadence))])
    q = dict(args=args, ecfg=ecfg, world=world, cams=cams, hi_cams=hi_cams)

    def jax_loop():
        if "jax" not in q:
            q["jax"] = child.result()[0]
        return q["jax"]

    q["jax_loop"] = jax_loop
    yield q
    jax_loop()


@pytest.fixture(scope="module")
def jax_child(quality):
    """The cost probe's JAX job, started once beside the quality loop's
    child; its result on first use, so the port's work of the tests
    before overlaps them."""
    child = ref.start([
        ("ref_perf_stages", dict(spec=PROBE_SPEC, cam=CAM,
                                 cap=perf_probe.FLOOR_CAPS[0]))])
    got = {}

    def result():
        if not got:
            got["r"] = child.result()
        return got["r"]

    yield result
    result()


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(
        -50.0, 300.0, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(10, 16), (7, 5), (1, 3)])
def test_min_dist_upsample(jax_child, shape):
    # the first test asks for ``jax_child`` so that the JAX jobs start here
    from rvgrt_tpu.render import pipeline as jpipeline

    a = _rand(shape, 1)
    got = pipeline.min_dist_upsample(torch.from_numpy(a)).numpy()
    want = np.asarray(jpipeline.min_dist_upsample(a))
    assert got.shape == (2 * shape[0], 2 * shape[1])
    np.testing.assert_array_equal(got, want)


def test_psnr_and_ssaa_jitters():
    a = torch.rand(6, 8, 3, generator=torch.Generator().manual_seed(4))
    assert pcm.psnr(a, a) == pcm.PSNR_CAP
    assert pcm.psnr(a, a + 1e-7) == pcm.PSNR_CAP  # MSE 1e-14
    assert abs(pcm.psnr(a, a + 0.01) - 40.0) < 1e-3
    for i in (0, 5):
        rng = np.random.default_rng(1000 + i)
        want = []
        for _ in range(4):
            jx, jy = rng.random(2) - 0.5
            want.append((2.0 * jx / 96, 2.0 * jy / 60))
        assert pcm.ssaa_jitters(i, 4, 96, 60) == want
    assert pcm.ssaa_jitters(3, 1, 96, 60) == [(0.0, 0.0)]


def _recompute(world, ecfg, cams, hi_cams, comp_cadence):
    """The probe's variants written out from the port's primitives at the
    replayed poses: {variant: [3x image a frame]}, the adaptive tiers, and
    the last frame's SSAA target."""
    from rvgrt_tpu_torch.render.scheduler import AdaptiveRateScheduler

    w = world
    h_lo, w_lo = ecfg.render.height, ecfg.render.width
    hi_ecfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, width=w_lo * 3, height=h_lo * 3))
    states = {n: temporal.init_state(h_lo, w_lo, device="cpu")
              for n in pcm.VARIANTS}
    addend = {n: None for n in pcm.VARIANTS}
    sched = AdaptiveRateScheduler(w_lo, h_lo)
    images = {n: [] for n in pcm.VARIANTS}
    tiers = []
    gi = w.gi
    prev = None
    for i, c in enumerate(cams):
        cam_obj = Camera(pos=c["pos"], forward=c["forward"],
                         right=c["right"], up=c["up"])
        cam = engine.camera_arrays(cam_obj, c["vp"], c["prev_vp"],
                                   tuple(c["jitter"]), c["time"],
                                   device="cpu")
        gi = gi_update.update_gi(gi, w.bits, w.sdf, w.atlas, ecfg, i, 0,
                                 sky_y=w.sky_y, table=w.trace_table)
        rate_a = "checker" if prev is None else sched.step(prev, cam_obj)
        tiers.append(rate_a)
        prev = cam_obj
        for n in pcm.VARIANTS:
            rate = rate_a if n == "adaptive" else n
            q = rate == RATE_QUARTER
            par = pipeline.QUARTER_PHASE_ORDER[i & 3] if q else i & 1
            half, gb = pipeline.render_frame(
                w.bits, w.sdf, gi, w.atlas, cam, ecfg, include_gi=False,
                sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
                quarter_phase=par if q else None,
                checker_parity=None if q else par)
            if n == "adaptive" or i % comp_cadence == 0:
                col, addend[n] = pipeline.gi_composite(
                    half.color, gb, gi, w.sdf, ecfg, return_addend=True)
            else:
                col = torch.clamp(half.color + addend[n], 0.0, 1.0)
            if q:
                ex = pipeline.quarter_expand
                valid = pipeline.quarter_valid_mask(h_lo, w_lo, par)
            else:
                def ex(a, par=par):
                    return pipeline.checker_expand(a, par)
                valid = pipeline.checker_valid_mask(h_lo, w_lo, par)
            img, states[n] = temporal.temporal_upscale(
                ex(col), ex(half.motion), ex(half.depth), cam.jitter,
                states[n], valid=valid)
            images[n].append(img)
    last = len(cams) - 1
    c = hi_cams[last]
    target = None
    for jx, jy in pcm.ssaa_jitters(last, 2, w_lo * 3, h_lo * 3):
        jcam = engine.camera_arrays(
            Camera(pos=c["pos"], forward=c["forward"], right=c["right"],
                   up=c["up"]),
            c["vp"], c["prev_vp"], (jx, jy), c["time"], device="cpu")
        img = pipeline.render_frame(
            w.bits, w.sdf, gi, w.atlas, jcam, hi_ecfg, include_gi=True,
            sky_y=w.sky_y, table=w.trace_table).color
        target = img if target is None else target + img
    return images, tiers, target / 2


def _tool_frames(quality):
    """The tool's frame loop at QUALITY_ARGS on the fixture's world, once
    per module (its images kept)."""
    if "recs" not in quality:
        q, args = quality, quality["args"]
        lo, hi = pcm.make_engines(q["ecfg"], True, "cpu", world=q["world"])
        q["recs"] = pcm.run_frames(lo, hi, args.frames, args.script,
                                   pcm.VARIANTS, args.ssaa,
                                   args.comp_cadence, keep_images=True)
    return quality["recs"]


def test_quality_frame_loop(quality):
    args = quality["args"]
    recs = _tool_frames(quality)
    assert [r.frame for r in recs] == list(range(args.frames))
    for r, c in zip(recs, quality["cams"]):
        np.testing.assert_array_equal(r.pose[0], c["pos"])
        np.testing.assert_array_equal(r.pose[1], c["forward"])

    # the adaptive tiers: "checker" first, then JAX's scheduler's picks
    poses = [tuple(np.asarray(p, np.float32) for p in r.pose) for r in recs]
    tiers = [r.tiers["adaptive"] for r in recs]
    assert tiers[0] == "checker"
    assert tiers[1:] == ref.ref_rate_schedule(args.low_w, args.low_h, 60.0,
                                              poses)
    for r in recs:
        assert r.tiers["checker"] == "checker"
        assert r.tiers["quarter"] == "quarter"

    # the loop written out from the primitives at the replayed poses
    images, tiers2, target = _recompute(
        quality["world"], quality["ecfg"], quality["cams"],
        quality["hi_cams"], args.comp_cadence)
    assert tiers2 == tiers
    for r in recs:
        for n in pcm.VARIANTS:
            assert torch.equal(r.images[n], images[n][r.frame]), \
                (n, r.frame)
            assert r.vs_full[n] == pcm.psnr(r.images["full"], r.images[n])
            assert r.vs_truth[n] == pcm.psnr(r.images[n],
                                             r.images["target"])
        assert r.full_vs_truth == pcm.psnr(r.images["full"],
                                           r.images["target"])
        assert all(map(math.isfinite, r.vs_truth.values()))
    assert torch.equal(recs[-1].images["target"], target)
    summ = pcm.tail_summary(recs, pcm.VARIANTS, args.warm)
    assert summ["variants"]["adaptive"]["tiers"] == dict(
        sorted({t: tiers[1:].count(t) for t in set(tiers[1:])}.items()))


@pytest.mark.parametrize("image", ("full",) + pcm.VARIANTS)
def test_quality_frame_loop_against_jax(quality, image):
    """The tool's images against the script's loop in JAX
    (``ref_quality_loop``) on the same world and poses: >= 50 dB a frame,
    the variant-vs-full PSNR within 0.1 dB of the script's, the tiers
    equal."""
    recs = _tool_frames(quality)
    want = quality["jax_loop"]()
    assert len(want) == JAX_FRAMES
    for r, wf in zip(recs, want):
        got = r.images[image].numpy()
        assert got.shape == wf["images"][image].shape
        assert ref.psnr(got, wf["images"][image]) >= 50.0, (image, r.frame)
        if image != "full":
            assert r.tiers[image] == wf["tiers"][image], r.frame
            assert abs(r.vs_full[image] - wf["vs_full"][image]) <= 0.1, \
                (image, r.frame, r.vs_full[image], wf["vs_full"][image])


class _StubOut:
    color = torch.full((24, 32, 3), 0.5)


class _StubEngine:
    """A fixed step time; raises at step ``fail_at`` (1-based) if given."""

    ecfg = tcfg.EngineConfig(render=dataclasses.replace(
        tcfg.RenderConfig(), width=32, height=24))

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.steps = 0
        self.mouse = 0.0
        self.lock = threading.Lock()

    def step(self, inputs, dt):
        time.sleep(STEP_S)
        with self.lock:
            self.steps += 1
            self.mouse += inputs.mouse_dx
        if self.fail_at is not None and self.steps >= self.fail_at:
            raise ValueError("step failed")
        return _StubOut()


def test_latency_trials_over_a_stub_engine():
    eng = _StubEngine()
    srv = ViewerServer(eng, port=0, max_fps=1000).start()
    trials = 4
    try:
        lat.warm_up(srv, timeout_s=60)
        assert srv.frame_count >= lat.WARM_FRAMES
        res = lat.run_trials(srv, trials)
        deadline = time.time() + 10
        while eng.mouse < 3.0 * trials and time.time() < deadline:
            time.sleep(0.01)
    finally:
        srv.stop()
    fa, ga = res["first_after_ms"], res["guaranteed_ms"]
    assert len(fa) == len(ga) == len(res["post_ms"]) == trials
    assert all(0.0 < f <= g for f, g in zip(fa, ga))
    # the frame s0 + 2 starts after the frame in flight at the POST, so it
    # ends at least a step after it (the window between the read of s0
    # and the clock's start aside, hence the median)
    assert sorted(ga)[trials // 2] >= 1e3 * STEP_S
    assert eng.mouse == 3.0 * trials  # every POST reached a frame


def test_latency_probe_raises_on_a_failed_step():
    eng = _StubEngine(fail_at=lat.WARM_FRAMES + 3)
    srv = ViewerServer(eng, port=0, max_fps=1000).start()
    with pytest.raises(RuntimeError, match="render loop failed") as e:
        try:
            lat.warm_up(srv, timeout_s=60)
            lat.run_trials(srv, 10)
        finally:
            srv.stop()
    assert isinstance(e.value.__cause__, ValueError)


def test_perf_probe_floor_and_straggler():
    fit = perf_probe.floor_fit((2, 8, 32), [1.0 + 0.5 * c for c in
                                            (2, 8, 32)], lanes=1000)
    assert abs(fit["intercept_ms"] - 1.0) < 1e-9
    assert abs(fit["ns_per_lane_superstep"] - 500.0) < 1e-6
    its = torch.ones(40, 256, dtype=torch.int32)
    its[3, 5] = 9      # tile (0, 0) and warp 0 of row 3 (lanes 768..799)
    its[25, 200] = 5   # tile (1, 1)
    s = perf_probe.straggler(its, 20, 128)
    assert s["tile_max_max"] == 9 and s["max"] == 9
    assert s["tile_max_mean"] == (9 + 1 + 1 + 5) / 4
    w = perf_probe.straggler(its.reshape(-1), 1, 32)
    assert w["tile"] == [1, 32]
    assert w["tile_max_mean"] == (9 + 5 + (320 - 2)) / 320


def test_perf_probe_timer_on_the_cpu():
    """On the CPU the timer reads the host clock only, and a floor whose
    times were not measured is not fitted."""
    calls = []
    out = perf_probe.timeit("stage", lambda: calls.append(1), 3,
                            torch.device("cpu"), log=lambda s: None)
    assert len(calls) == 1 + 3  # one warm call, then the reps
    assert out["host_min_ms"] <= out["host_ms"]
    assert all(out[k] is None for k in ("event_ms", "event_min_ms",
                                        "device_ms", "k1_ms", "busy"))
    assert perf_probe.floor_fit((2, 8, 32), [1.0, None, 2.0], 10) is None
    assert perf_probe.floor_fit((2, 8, 32), [1.0, math.nan, 2.0],
                                10) is None


def test_perf_probe_profiler_reruns_a_session_that_lost_k1(monkeypatch):
    """The kernel sums leave out the step's own range; a session that
    recorded fewer K1 kernels than K1's wrapper launched is run again, and
    K1's time is NaN where no session of ``tries`` was whole."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(key, us, count=1, dt=DeviceType.CUDA):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=dt)

    assert perf_probe.kernel_times([
        ev("trace_kernel", 30.0, 2), ev("elementwise", 400.0, 9),
        ev("ProfilerStep#1", 5000.0), ev("trace_kernel", 99.0,
                                         dt=DeviceType.CPU)]) == \
        (0.43, 0.03, 2)
    sessions = [(0.5, 0.0, 0, 1), (0.6, 0.0, 0, 1), (0.7, 0.03, 1, 1),
                (0.8, 0.03, 1, 1)]
    monkeypatch.setattr(perf_probe, "_profile_once",
                        lambda fn: sessions.pop(0))
    assert perf_probe.device_ms(lambda: None) == (0.7, 0.03)
    assert len(sessions) == 1
    sessions[:] = [(0.5, 0.0, 0, 1)] * 3
    total, k1 = perf_probe.device_ms(lambda: None, tries=3)
    assert total == 0.5 and math.isnan(k1) and not sessions
    # a call that launches no K1 is whole with no K1 record
    sessions[:] = [(0.2, 0.0, 0, 0)]
    assert perf_probe.device_ms(lambda: None) == (0.2, 0.0)


def test_perf_probe_times_k1_by_its_kernel_name():
    """The profiler's K1 time matches the kernel K1 launches."""
    src = (ref.REPO / "rvgrt_tpu_torch" / "csrc" /
           "superstep_kernel.cu").read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)"
                         r"\s+)?(\w+)\(", src)
    assert kernels == [perf_probe.K1_KERNEL]


def test_perf_probe_stages(jax_child):
    from rvgrt_tpu.world import voxel_grid as jvg

    ecfg = ref.make_ecfg(tcfg, PROBE_SPEC)
    world = engine.build_world(ecfg, verbose=False, device="cpu")
    cam = engine.camera_arrays(
        Camera(pos=CAM["pos"], forward=CAM["forward"], right=CAM["right"],
               up=CAM["up"]),
        CAM["vp"], CAM["prev_vp"], CAM["jitter"], CAM["time"],
        device="cpu")
    st = perf_probe.Stages(world, ecfg, cam)
    cap = perf_probe.FLOOR_CAPS[0]
    parked = st.parked(cap)
    cascade = st.cascade()
    hd, hs = st.prepass()
    start = pipeline.min_dist_upsample(hd)
    prim = st.primary_res(start)
    got_cam = perf_probe.probe_camera(world.bits, ecfg.world)

    want = jax_child()[0]
    jw = want["world"]
    for k in ("bits", "sdf", "gi", "atlas", "trace_table"):
        np.testing.assert_array_equal(
            engine.world_to_numpy(world)[k], jw[k], err_msg=k)
    np.testing.assert_array_equal(parked.numpy(), want["parked_its"])
    np.testing.assert_array_equal(cascade.numpy(), want["cascade"])
    np.testing.assert_array_equal(hd.numpy(), want["half_dist"])
    np.testing.assert_array_equal(hs.numpy(), want["half_shadow"])
    np.testing.assert_array_equal(start.numpy(), want["start"])
    assert bool(want["primary"]["hit"].any())
    for f, v in want["primary"].items():
        np.testing.assert_array_equal(getattr(prim, f).numpy(), v,
                                      err_msg=f)

    # the script's camera, computed as perf_probe.py:70-89 computes it
    cfg = ecfg.world
    bits_np = jw["bits"].reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
    col = np.asarray(jvg.unpack_bits_x(bits_np[cfg.size_z // 2]))[
        :, cfg.size_x // 2]
    ys = np.where(col)[0]
    cam_y = min((float(ys.max()) if len(ys) else 30.0) + 12.0,
                cfg.size_y - 2.0)
    fwd = np.array([math.cos(0.5) * 0.87, -0.5, math.sin(0.5) * 0.87],
                   np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0, 1, 0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    up /= np.linalg.norm(up)
    np.testing.assert_array_equal(
        got_cam.pos, np.array([cfg.size_x / 2, cam_y, cfg.size_z / 2],
                              np.float32))
    for a, b in ((got_cam.forward, fwd), (got_cam.right, right),
                 (got_cam.up, up)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


_FRAME_LINE = re.compile(r"^frame (\d+): full-vs-truth ([\d.]+)(.*)$")
_VARIANT = re.compile(
    r"\| (\w+)\[(\w)\] vs-full ([\d.]+) vs-truth ([\d.]+)")


def _parse_frames(text: str) -> dict:
    """{frame: (full-vs-truth, {variant: (tier letter, vs-full,
    vs-truth)})} of the probe's printed frame lines."""
    out = {}
    for line in text.splitlines():
        m = _FRAME_LINE.match(line.strip())
        if m:
            out[int(m[1])] = (float(m[2]), {
                v[0]: (v[1], float(v[2]), float(v[3]))
                for v in _VARIANT.findall(m[3])})
    return out


@pytest.mark.slow
def test_probe_checker_motion_script(tmp_path, capsys):
    """The repository's ``scripts/probe_checker_motion.py`` (from a copy,
    so its compile cache starts empty; no FMA contraction) against the
    port's tool at the same flags: every printed PSNR within 0.1 dB, the
    tiers equal."""
    (tmp_path / "scripts").mkdir()
    shutil.copy(ref.REPO / "scripts" / "probe_checker_motion.py",
                tmp_path / "scripts" / "probe_checker_motion.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ref.REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "scripts" /
                             "probe_checker_motion.py")] + SLOW_ARGS,
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    pcm.main(SLOW_ARGS + ["--device", "cpu"])
    port = capsys.readouterr().out
    try:
        out, err = proc.communicate(timeout=SLOW_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    want, got = _parse_frames(out), _parse_frames(port)
    assert sorted(want) == sorted(got) == list(range(4))
    for i, (wf, wv) in want.items():
        gf, gv = got[i]
        assert abs(gf - wf) <= 0.1, (i, gf, wf)
        assert sorted(gv) == sorted(wv)
        for n, (tier, vf, vt) in wv.items():
            assert gv[n][0] == tier, (i, n)
            assert abs(gv[n][1] - vf) <= 0.1 and abs(gv[n][2] - vt) <= 0.1, \
                (i, n, gv[n], wv[n])
    mix = re.search(r"tiers=(\S+)", out)
    assert mix and f"tiers={mix[1]}" in port
