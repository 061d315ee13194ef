"""``bench.py``'s frame loop: the frames its benchmark times.

The JAX package keeps this loop inside ``bench.py``'s ``main()``; the port
keeps it here so that ``chip_smoke.py`` and a later benchmark drive the
same frames.  Per frame ``i``:

1. the rate: the first frame at checkerboard rate, then the motion-adaptive
   scheduler's pick from the previous and the current pose
   (``rate_schedule``; ``bench.py:491-501``), checkerboard under fast
   motion, quarter rate when slow or still;
2. the parity (``i & 1``) or quarter phase (``QUARTER_PHASE_ORDER[i &
   3]``), host ints (``frame_phase``; ``bench.py:530-531``);
3. every ``GI_CADENCE``-th frame, one GI window (``update_gi``, with the
   straggler respite at ``ecfg.gi_straggler_budget``); the window's offset
   advances only right before a frame that runs one, so the sweep has no
   gaps (``bench.py:536-539``, ``:560-598``);
4. the base frame on the rate-cut grid with its G-buffer, the GI
   composite, the expand of colour, motion and depth to the full grid, the
   valid mask, and ``temporal_upscale(valid=..., warp_taps="pallas")``
   (``bench.py:355-435`` with a composite every frame).

The poses come from the caller: ``path_yaws`` is ``bench.py``'s camera path
(``:263-290``) and ``path_cameras`` turns it into per-frame cameras through
a ``Character``, which supplies the view-projection matrices and the
jitter, as ``Engine.step`` does.  Two things of ``bench.py`` are not
copied: its cameras carry identity matrices (every motion vector 0), and
it passes frame 0 to every GI window; here the matrices are the
Character's and the GI frame number is the frame index.  Its extra warm-up
frames, which exist to compile graphs, have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.driver.engine import World, camera_arrays
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.render.scheduler import (RATE_CHECKER, RATE_QUARTER,
                                              AdaptiveRateScheduler)
from rvgrt_tpu_torch.scene.camera import Camera, Character, InputState
from rvgrt_tpu_torch.upscale import temporal
from rvgrt_tpu_torch.utils.device import resolve_device

#: bench.py's interactive path, rad of yaw a frame: fast pan, slow look,
#: near-static dwell, each a third of the timed frames
FAST_PAN, SLOW_LOOK, DWELL = 0.05, 0.004, 0.0005
#: bench.py's constant pan, rad a frame
PAN = 0.35
#: bench.py's warm-up frames before the timed ones; they pan fast
WARMUP = 2
#: a GI window every 2nd frame (bench.py's ``BENCH_GI_CADENCE`` default)
GI_CADENCE = 2


def path_yaws(frames: int, path: str = "interactive") -> list[float]:
    """The yaw, in rad from the first pose, of each of ``frames`` timed
    frames and the ``WARMUP`` frames before them (``bench.py``'s
    ``path_cams``): the warm-ups pan fast, so the timed window starts in
    the tier of its first third."""
    yaws, yaw = [], 0.0
    third = max(frames // 3, 1)
    for i in range(frames + WARMUP):
        if path == "pan":
            yaw = PAN * i
        elif path != "interactive":
            raise ValueError(f"unknown camera path {path!r}")
        elif i > 0:
            j = i - WARMUP  # index in the timed window
            yaw += FAST_PAN if j < third else (
                SLOW_LOOK if j < 2 * third else DWELL)
        yaws.append(yaw)
    return yaws


def path_cameras(character: Character, yaws, time_s: float = 0.0,
                 device=None) -> list[tuple[Camera, pipeline.CameraArrays]]:
    """Frame ``i`` of the path: ``character`` turned to its first yaw plus
    ``yaws[i]`` and updated with frame count ``i`` (the matrices, the
    previous frame's matrices and the jitter of that frame), as the pose
    and the render-side camera.  The water clock advances 1/60 s a
    frame."""
    dev = resolve_device(device)
    yaw0 = character.yaw
    out = []
    for i, yaw in enumerate(yaws):
        character.yaw = yaw0 + yaw
        cam = character.update(InputState(), 1.0 / 60.0, i)
        out.append((cam, camera_arrays(
            cam, vp=character.unjittered_view_projection,
            prev_vp=character.prev_unjittered_view_projection,
            jitter=character.ray_jitter_ndc(), time_s=time_s + i / 60.0,
            device=dev)))
    return out


def rate_schedule(poses, ecfg: EngineConfig) -> list[str]:
    """The rate of each frame from consecutive poses: the first frame at
    checkerboard rate (no history yet), then the scheduler's pick, which
    looks one pose back as an interactive session would."""
    r = ecfg.render
    sched = AdaptiveRateScheduler(r.width, r.height, r.fov_degrees)
    return [RATE_CHECKER] + [sched.step(a, b)
                             for a, b in zip(poses, poses[1:])]


def frame_phase(i: int, rate: str) -> int:
    """The checkerboard parity or quarter phase of frame ``i``."""
    if rate == RATE_QUARTER:
        return pipeline.QUARTER_PHASE_ORDER[i & 3]
    return i & 1


class FrameResult(NamedTuple):
    rate: str
    phase: int
    gi_ran: bool
    out: pipeline.FrameOutputs  # composited, expanded to (H, W)
    hit: torch.Tensor           # primary hits on the rate-cut grid
    image: torch.Tensor         # (scale*H, scale*W, 3) reconstruction


class FrameLoop:
    """``bench.py``'s frame at one operating point: the world, the GI grid
    it updates, the window offset and the temporal state it carries.
    ``scale`` 3 is the display upscale of the headline, 1 native-res
    reconstruction (config-4).  ``overflow`` sums the respite's
    ``straggler_overflow`` over the GI windows, on the device."""

    def __init__(self, world: World, ecfg: EngineConfig, scale: int = 3):
        self.world = world
        self.ecfg = ecfg
        dev = world.bits.device
        r = ecfg.render
        self.state = temporal.init_state(r.height, r.width, scale=scale,
                                         device=dev)
        self.gi = world.gi
        self.offset = 0
        self.gi_windows = 0
        self.overflow = torch.zeros((), dtype=torch.int32, device=dev)

    def frame(self, i: int, cam: pipeline.CameraArrays,
              rate: str) -> FrameResult:
        w, ec = self.world, self.ecfg
        r = ec.render
        phase = frame_phase(i, rate)
        gi_ran = i % GI_CADENCE == 0
        if gi_ran:
            if self.gi_windows:
                self.offset = gi_update.advance_offset(self.offset, ec)
            self.gi, st = gi_update.update_gi(
                self.gi, w.bits, w.sdf, w.atlas, ec, i, self.offset,
                sky_y=w.sky_y, table=w.trace_table, return_stats=True)
            self.overflow = self.overflow + st["straggler_overflow"]
            self.gi_windows += 1
        out, gb = pipeline.render_frame(
            w.bits, w.sdf, self.gi, w.atlas, cam, ec, include_gi=False,
            sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
            checker_parity=phase if rate == RATE_CHECKER else None,
            quarter_phase=phase if rate == RATE_QUARTER else None)
        out = out._replace(color=pipeline.gi_composite(out.color, gb,
                                                       self.gi, w.sdf, ec))
        dev = out.color.device
        valid = None
        if rate == RATE_CHECKER:
            def expand(a):
                return pipeline.checker_expand(a, phase)
            valid = pipeline.checker_valid_mask(r.height, r.width, phase,
                                                device=dev)
        elif rate == RATE_QUARTER:
            expand = pipeline.quarter_expand
            valid = pipeline.quarter_valid_mask(r.height, r.width, phase,
                                                device=dev)
        if valid is not None:
            out = out._replace(color=expand(out.color),
                               motion=expand(out.motion),
                               depth=expand(out.depth))
        image, self.state = temporal.temporal_upscale(
            out.color, out.motion, out.depth, cam.jitter, self.state,
            valid=valid, warp_taps="pallas")
        return FrameResult(rate=rate, phase=phase, gi_ran=gi_ran, out=out,
                           hit=gb.hit, image=image)
