"""The port's side of a run: set-up, the measured window and the traced
sub-window of one cell.

Set-up loads the kernels, builds the world (``build_world(phase_times=)``),
loads the learned upscaler where the configuration's post stage is
``"net"`` (``upscale/model.py::load_checkpoint`` of ``loop.net``), makes
the ``FrameLoop`` of the cell's configuration (its ``comp_cadence`` too)
and warms each (rate tier, GI) variant that the cell's frames use, once,
at the first pose.  The window then calls ``FrameLoop.frame(i, cam,
rate)`` until the host clock has run ``seconds``, each frame's rate the
program's pick (its ``AdaptiveRateScheduler`` over consecutive poses, or
the configuration's fixed tier), each frame issued when the host returns
from the last: one user who waits for each frame.  After each frame's last
launch one CUDA event is recorded; none is read until the window has
ended, so frame ``i``'s time is the interval between the completion events
of frames ``i - 1`` and ``i``, when its image is ready to present.

A traced run goes on after the window: it looks ahead along the flight for
the first ``sub_frames`` frames that hold each variant twice, runs the
frames before them without the profiler, and runs them under
``torch.profiler``, the frame before them in the profiler's warm-up step.
The program's spans (``rvgrt_tpu_torch/utils/profiling.py``) are on for
the profiled frames alone, never in the measured window, so that
``rec.trace["stages"]`` holds the sub-window's launches, device and idle
time put down to each span (``stages.attribute``).

For the check the run keeps, as references and without a copy (the frame
loop makes new tensors each frame), the outputs of the chain, the run's
first ``CHAIN_FRAMES`` frames (warm-up frames, then window frames where
there are fewer), which the reference follows from the world with its own
GI words and accumulator, and, for one window frame drawn from the seed by
reservoir sampling, the GI words, post-stage state and carried composite
addend it started from and its outputs.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from port_bench import flight as flight_mod
from port_bench import spec

#: frames of look-ahead for a traced sub-window that holds every variant
LOOKAHEAD = 150
#: seconds kept clear of the profiler's step edges (a kernel whose device
#: time falls near an edge can lose its record)
PROFILE_MARGIN_S = 0.005
#: profiled sub-windows tried before a run gives up on a whole one
PROFILE_TRIES = 3
#: the run's first frames, the chain that the check follows with the
#: reference's own state (each a plain frame of 7-12 s on the card, which
#: every run's check pays)
CHAIN_FRAMES = 3


def upload(pose: flight_mod.Pose, dev: torch.device, cam_type):
    """The pose as the port's ``CameraArrays``, copied to ``dev`` in one
    transfer from pinned memory that does not wait for the device."""
    parts = pose.arrays()
    host = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.float32).reshape(-1) for a in parts]))
    if dev.type == "cuda":
        flat = host.pin_memory().to(dev, non_blocking=True)
    else:
        flat = host
    out, k = [], 0
    for a in parts:
        n = int(np.asarray(a).size)
        out.append(flat[k:k + n].reshape(np.asarray(a).shape))
        k += n
    return cam_type(*out)


def terrain_top(bits: torch.Tensor, wcfg, x: int, z: int) -> float:
    """The highest solid voxel of column (x, z) of the port's world (30 if
    it has none; ``bench.py``'s rule), one scalar read."""
    vol = bits.reshape(wcfg.size_z, wcfg.size_y, wcfg.size_x // 32)
    col = vol[z, :, x // 32]
    solid = ((col >> (x % 32)) & 1).bool()
    ys = torch.arange(wcfg.size_y, device=bits.device)
    top = torch.where(solid, ys, -1).max()
    return float(top) if bool(solid.any()) else 30.0


#: the prefix of the keys of the chain's kept frames
CHAIN = "chain"


def chain_key(i: int) -> str:
    return f"{CHAIN}{i}"


@dataclass
class Kept:
    """What the check compares of one frame: its index, rate and pose, the
    state it started from (GI words, post-stage state and, with a
    composite cadence, the carried addend; None for a frame of the chain,
    which the reference follows with its own), and what it produced."""
    index: int
    rate: str
    pose: flight_mod.Pose
    gi_in: torch.Tensor | None
    state_in: object
    addend_in: torch.Tensor | None
    gi_out: torch.Tensor
    color: torch.Tensor
    motion: torch.Tensor
    depth: torch.Tensor
    image: torch.Tensor


@dataclass
class Record:
    """What a run measured, for the metric readers."""
    setup_s: float = math.nan
    build_s: float = math.nan
    phase_times: dict = field(default_factory=dict)
    kernel_build_s: float | None = None
    frames: list = field(default_factory=list)   # window: (rate, gi_ran)
    host_ms: list = field(default_factory=list)  # window: the enqueue
    intervals_ms: list = field(default_factory=list)
    window_ms: float = math.nan
    trace: dict | None = None
    config: dict = field(default_factory=dict)


class PortRun:
    """One run of a cell on the port, on ``device`` (``cuda`` in a
    measured run; the CPU tests use ``cpu``, where nothing is timed)."""

    def __init__(self, cell: spec.Cell, seed: int, device, log=print):
        from rvgrt_tpu_torch import config as pcfg

        self.cell, self.seed, self.log = cell, seed, log
        self.dev = torch.device(device)
        self.ecfg = spec.engine_config(cell.config, pcfg)
        self.loopcfg = cell.config["loop"]
        self.rec = Record(config=cell.config)
        self.poses: list[flight_mod.Pose] = []
        self.rates: list[str] = []
        self.kept: dict[str, Kept] = {}
        self._res_rng = flight_mod.rng_for(seed, 2)

    # ---- set-up ----------------------------------------------------------

    def variants(self) -> list[tuple[str, bool]]:
        """The (rate tier, GI window) pairs the cell's frames use."""
        lc = self.loopcfg
        tiers = ["checker", "quarter"] if lc["rates"] == "adaptive" \
            else [lc["rates"]]
        gis = [True, False] if lc["include_gi"] and lc["gi_cadence"] > 1 \
            else [lc["include_gi"]]
        return [(t, g) for t in tiers for g in gis]

    def setup(self, t_start: float, world=None) -> None:
        """Set-up (module docstring); ``world``: a world of this
        configuration already built, in place of building one (the
        control tool's seeds share one)."""
        from rvgrt_tpu_torch.driver import engine, frame_loop
        from rvgrt_tpu_torch.render import pipeline
        from rvgrt_tpu_torch.render.scheduler import AdaptiveRateScheduler
        from rvgrt_tpu_torch.upscale import model as up_model

        ecfg, lc, dev = self.ecfg, self.loopcfg, self.dev
        if dev.type == "cuda":
            from rvgrt_tpu_torch.ops import _lib

            _lib.library()
            self.rec.kernel_build_s = _lib.build_seconds
        t0 = time.perf_counter()
        self.world = world if world is not None else engine.build_world(
            ecfg, verbose=False, phase_times=self.rec.phase_times,
            device=dev)
        self.sync()
        self.rec.build_s = time.perf_counter() - t0
        wc, r = ecfg.world, ecfg.render
        col = flight_mod.start_column(self.cell.traffic, wc.size_x,
                                      wc.size_z)
        top = terrain_top(self.world.bits, wc, *col)
        self.flight = flight_mod.Flight(
            self.cell.traffic, self.seed, col, top, wc.size_y,
            (r.width, r.height, r.display_width, r.display_height,
             r.fov_degrees), lc["post"])
        net_path = self.cell.net_path()
        net = None if net_path is None else up_model.load_checkpoint(
            str(net_path), dev)
        self.loop = frame_loop.FrameLoop(
            self.world, ecfg, scale=lc["scale"], upscaler=lc["post"],
            net=net, comp_cadence=lc.get("comp_cadence", 1),
            gi_cadence=lc["gi_cadence"], include_gi=lc["include_gi"],
            gi_frame=None, warp_taps=lc["warp_taps"])
        self.cam_type = pipeline.CameraArrays
        self.sched = (AdaptiveRateScheduler(r.width, r.height, r.fov_degrees)
                      if lc["rates"] == "adaptive" else None)
        # each variant once, at the start pose: frame i runs a GI window
        # where i % gi_cadence == 0, so frame i takes the first variant not
        # yet run whose GI flag is its own (or any, where none is)
        todo = self.variants()
        while todo:
            i = len(self.poses)
            gi = self.gi_ran(i)
            v = next((v for v in todo if v[1] == gi), todo[0])
            if v[1] == gi:
                todo.remove(v)
            self.poses.append(self.flight.next(hold=True))
            self.rates.append(v[0])
            self.frame(i)
        self.n_warm = len(self.poses)
        self.sync()
        self.rec.setup_s = time.perf_counter() - t_start

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ---- frames ----------------------------------------------------------

    def next_rate(self, pose) -> str:
        if self.sched is None:
            return self.loopcfg["rates"]
        return self.sched.step(self.poses[-1], pose)

    def gi_ran(self, i: int) -> bool:
        """Whether frame ``i`` runs a GI window."""
        lc = self.loopcfg
        return lc["include_gi"] and i % lc["gi_cadence"] == 0

    def frame(self, i: int, keep: tuple = ()):
        """Frame ``i`` at ``self.rates[i]``; returns its ``FrameResult`` and
        the host seconds of the call.  ``keep``: also keep it for the check
        under these keys; a frame of the chain is kept under its key of the
        chain too, without its state."""
        cam = upload(self.poses[i], self.dev, self.cam_type)
        loop = self.loop
        gi_in, state_in, addend_in = loop.gi, loop.state, loop.addend
        t0 = time.perf_counter()
        res = self.loop.frame(i, cam, self.rates[i])
        host = time.perf_counter() - t0
        if i < CHAIN_FRAMES:
            keep += (chain_key(i),)
        for key in keep:
            chain = key.startswith(CHAIN)
            self.kept[key] = Kept(
                index=i, rate=self.rates[i], pose=self.poses[i],
                gi_in=None if chain else gi_in,
                state_in=None if chain else state_in,
                addend_in=None if chain else addend_in, gi_out=loop.gi,
                color=res.out.color, motion=res.out.motion,
                depth=res.out.depth, image=res.image)
        return res, host

    def advance(self) -> int:
        """Append the next pose and its rate; returns its frame index."""
        pose = self.flight.next()
        self.rates.append(self.next_rate(pose))
        self.poses.append(pose)
        return len(self.poses) - 1

    def window(self, seconds: float, max_frames: int | None = None) -> None:
        """The measured window: frames until ``seconds`` of host clock (or
        ``max_frames``, on the CPU), one completion event a frame."""
        cuda = self.dev.type == "cuda"
        events = []
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        n = 0
        while True:
            i = self.advance()
            # reservoir sampling: window frame n is the kept one with
            # probability 1 / (n + 1)
            keep = ("window",) if self._res_rng.random() * (n + 1) < 1.0 \
                else ()
            _, host = self.frame(i, keep=keep)
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            self.rec.host_ms.append(host * 1e3)
            self.rec.frames.append((self.rates[i], self.gi_ran(i)))
            n += 1
            if max_frames is not None and n >= max_frames:
                break
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        if cuda:
            marks = [start] + events
            self.rec.intervals_ms = [a.elapsed_time(b)
                                     for a, b in zip(marks, marks[1:])]
            self.rec.window_ms = start.elapsed_time(events[-1])

    # ---- traced sub-window ------------------------------------------------

    def _locate(self, first: int) -> int:
        """The first frame index ``s >= first`` whose ``sub_frames`` frames
        hold every variant twice, looking ``LOOKAHEAD`` frames ahead (or
        ``first`` if none does)."""
        n = self.loopcfg["sub_frames"]
        want = self.variants()
        fl, sched = copy.deepcopy(self.flight), copy.deepcopy(self.sched)
        rates, prev = [], self.poses[-1]
        gi = [self.gi_ran(len(self.poses) + k) for k in range(LOOKAHEAD + n)]
        for _ in range(LOOKAHEAD + n):
            pose = fl.next()
            rates.append(self.loopcfg["rates"] if sched is None
                         else sched.step(prev, pose))
            prev = pose
        base = len(self.poses)
        for s in range(first, base + LOOKAHEAD):
            got = [(rates[k - base], gi[k - base]) for k in range(s, s + n)]
            if all(got.count(v) >= 2 for v in want):
                return s
        return first

    def traced(self) -> None:
        """The profiled sub-window (module docstring), with the program's
        spans on; fills ``rec.trace``."""
        from torch.profiler import ProfilerActivity, profile, schedule
        from torch.profiler import record_function

        from port_bench import stages
        from rvgrt_tpu_torch.ops import superstep_kernel
        from rvgrt_tpu_torch.utils import profiling

        n = self.loopcfg["sub_frames"]
        for attempt in range(PROFILE_TRIES):
            s = self._locate(len(self.poses) + 1)
            while len(self.poses) < s - 1:
                self.frame(self.advance())
            self.sync()
            got = {}

            def ready(p):
                got["events"] = p.profiler.kineto_results.events()

            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            profiling.enable()
            try:
                with profile(activities=acts, on_trace_ready=ready,
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1)) as prof:
                    self.frame(self.advance())
                    self.sync()
                    time.sleep(PROFILE_MARGIN_S)
                    prof.step()
                    time.sleep(PROFILE_MARGIN_S)
                    k1_before = superstep_kernel.launches
                    tiers = []
                    with record_function("pb.subwindow"):
                        for _ in range(n):
                            i = self.advance()
                            tiers.append((self.rates[i], self.gi_ran(i)))
                            self.frame(i)
                    self.sync()
                    k1_launched = superstep_kernel.launches - k1_before
                    time.sleep(PROFILE_MARGIN_S)
                    prof.step()
            finally:
                profiling.disable()
            events = got.get("events", [])
            trace = summarise(events, n)
            trace.update(variants=tiers, k1_launched=k1_launched,
                         attempt=attempt)
            if trace.get("span_s"):
                trace["stages"] = stages.attribute(events, n)
                trace["stages"]["gi_frames"] = sum(g for _, g in tiers)
            self.rec.trace = trace
            if trace["k1_records"] == k1_launched:
                return
            self.log(f"profiled sub-window {attempt}: {trace['k1_records']} "
                     f"K1 records of {k1_launched} launches; again")


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


#: the profiler's activities that are device work (it also puts the host's
#: annotated ranges, such as its steps, on the device's timeline)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: the names of those annotated ranges (the profiler's steps, the harness's
#: ``pb.*`` and the program's spans ``rvgrt.*``), where an event has no
#: activity type
ANNOTATIONS = ("ProfilerStep", "pb.", "rvgrt.")


def _device_op(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_WORK
    return not e.name().startswith(ANNOTATIONS)


def summarise(events, frames: int) -> dict:
    """The profiled sub-window's device side from the profiler's events:
    the span from the ``pb.subwindow`` range's start to the last device
    operation's end, the device operations (kernels, copies, sets) inside
    it, their union, K1's and K2's time, the operations that took most
    time and the idle gaps by the host operation open across them."""
    from torch.autograd import DeviceType

    dev_ops, cpu_ops, t0 = [], [], None
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if _device_op(e):
                dev_ops.append((start, start + dur, name))
        elif name == "pb.subwindow":
            t0 = start
        elif not name.startswith(ANNOTATIONS):
            cpu_ops.append((start, start + dur, name))
    if t0 is None or not dev_ops:
        return dict(k1_records=0, frames=frames, ops=0)
    dev_ops = sorted(o for o in dev_ops if o[0] >= t0)
    t1 = max(o[1] for o in dev_ops)
    busy, gaps, cur_s, cur_e = 0, [], None, t0
    for s, e, _ in dev_ops:
        if cur_s is None or s > cur_e:
            if s > cur_e:
                gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for s, e, name in dev_ops:
        by_name[name] = by_name.get(name, 0) + (e - s)
    k1 = sum(v for k, v in by_name.items() if "trace_kernel" in k)
    k2 = sum(v for k, v in by_name.items() if "warp_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        frames=frames, ops=len(dev_ops), span_s=(t1 - t0) / 1e9,
        busy_s=busy / 1e9, k1_s=k1 / 1e9, k2_s=k2 / 1e9,
        k1_records=sum(1 for o in dev_ops if "trace_kernel" in o[2]),
        k2_records=sum(1 for o in dev_ops if "warp_kernel" in o[2]),
        device_ops=[[_short(k), v / 1e9] for k, v in top],
        idle_gaps=_label_gaps(gaps, cpu_ops))


def _label_gaps(gaps, cpu_ops) -> list:
    """The idle gaps' seconds summed by the innermost host operation open
    at each gap's middle (``python`` where none is), the 10 largest."""
    ops = sorted(cpu_ops)
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    out: dict = {}
    stack, k = [], 0
    for m, dur in mids:
        while k < len(ops) and ops[k][0] <= m:
            while stack and stack[-1][1] <= ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        label = _short(stack[-1][2], 80) if stack else "python"
        out[label] = out.get(label, 0) + dur
    top = sorted(out.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v / 1e9] for k, v in top]
