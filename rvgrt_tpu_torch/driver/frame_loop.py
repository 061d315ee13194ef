"""``bench.py``'s frame loop: the frames its benchmark times.

The JAX package keeps this loop inside ``bench.py``'s ``main()``; the port
keeps it here so that ``chip_smoke.py`` and the port's entry point
``rvgrt_tpu_torch/bench.py`` drive the same frames.  Per frame ``i``:

1. the rate (``rate_schedule``; ``bench.py:337-348``, ``:491-501``): by
   default the first frame at checkerboard rate, then the motion-adaptive
   scheduler's pick from the previous and the current pose, checkerboard
   under fast motion, quarter rate when slow or still; or one fixed tier,
   ``"checker"``, ``"quarter"`` or ``"full"`` (``BENCH_CHECKER=1|2``, ``4``,
   ``0``);
2. the parity (``i & 1``) or quarter phase (``QUARTER_PHASE_ORDER[i &
   3]``), host ints (``frame_phase``; ``bench.py:530-531``);
3. every ``gi_cadence``-th frame (``BENCH_GI_CADENCE``, default 2), one GI
   window (``update_gi``, with the straggler respite at
   ``ecfg.gi_straggler_budget``); the window's offset advances only right
   before a frame that runs one, so the sweep has no gaps
   (``bench.py:536-539``, ``:560-598``).  ``include_gi=False``
   (``BENCH_GI=0``) runs no window and no composite;
4. the base frame on the rate-cut grid with its G-buffer, the GI
   composite, the expand of colour, motion and depth to the full grid, the
   valid mask, and the post stage (``bench.py:355-435``).

The post stage is one of ``bench.py``'s ``BENCH_UPSCALE`` modes
(``FrameLoop(upscaler=...)``, ``bench.py:72-133``, ``:294-323``,
``:421-435``):

* ``"temporal"`` (the default): ``temporal_upscale(valid=...,
  warp_taps=...)``, the history warp through K2 under the default taps
  ``"pallas"`` (``BENCH_WARP``);
* ``"net"``: the learned upscaler (``upscale/model.py``, a checkpoint such
  as ``checkpoints/upscaler.pkl``), its history the previous 3x output
  warped by a plain gather, no valid mask;
* ``"residual"``: the accumulator as in ``"temporal"``, then the learned
  residual head (``upscale/residual.py``) as a post-pass on its output and
  confidence; the accumulator's state carries on unchanged;
* ``"none"``: native output, no upscale (``BENCH_UPSCALE=0``).

At scale 1 (config-4) every mode but ``"temporal"`` is native output, as
``bench.py`` runs them there.  ``comp_cadence`` > 1 is
``BENCH_COMP_CADENCE``: frame ``i`` re-adds the carried full-resolution
addend of the last composite, re-selected at its own rate and phase,
instead of compositing when ``i % comp_cadence != 0`` (``bench.py:382-399``,
``:516-523``, ``:543``).

Only ``"temporal"`` runs the motion-adaptive rate tier.  ``bench.py``
decides that (``bench.py:90-99``) before it turns ``BENCH_UPSCALE=residual``
into the accumulator (``:305``), so ``"residual"``, like ``"net"`` and
``"none"``, renders every frame at full rate along the constant ``"pan"``
path (``adaptive``, ``camera_path``); ``"net"`` and ``"none"`` take the
reference's 8-phase jitter table, the accumulator's modes the 9-phase one
(``jitter_sequence``, ``bench.py:475-476``).

The poses come from the caller.  ``path_yaws`` is ``bench.py``'s camera
path (``:263-290``); ``path_cameras`` turns it into per-frame cameras
through a ``Character``, which supplies the view-projection matrices and
the jitter, as ``Engine.step`` does, and advances the water clock 1/60 s a
frame; the GI frame number is the frame index.  ``bench.py`` itself gives
its cameras identity matrices (every motion vector 0), passes frame 0 to
every GI window and keeps the water clock at ``time_s=0``: the port's entry
point (``rvgrt_tpu_torch/bench.py``) reproduces that with raw cameras and
``gi_frame=0``.  Its extra warm-up frames, which re-render a pose at a tier
the first two frames did not cover, are ``frame(..., advance=False)``.
Beside those, per mode:

* ``"net"``: ``bench.py`` falls back to fresh weights (``init_params``)
  when ``checkpoints/upscaler.pkl`` is missing; the loop takes the net it
  is given and refuses none;
* ``"residual"``: ``bench.py`` falls back to the plain accumulator when
  ``checkpoints/residual_head.pkl`` is missing; the loop refuses to run
  without a head;
* ``"temporal"`` with ``comp_cadence`` 1: ``bench.py`` carries a (1, 1, 3)
  placeholder addend to keep its compiled graphs' shapes fixed; the loop
  carries none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.driver.engine import World, camera_arrays
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.render.scheduler import (RATE_CHECKER, RATE_FULL,
                                              RATE_QUARTER,
                                              AdaptiveRateScheduler)
from rvgrt_tpu_torch.scene.camera import (JITTER_SEQUENCE, Camera, Character,
                                          InputState, phase_jitter_sequence)
from rvgrt_tpu_torch.upscale import model as up_model
from rvgrt_tpu_torch.upscale import residual, temporal
from rvgrt_tpu_torch.utils import profiling
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
#: bench.py's ``BENCH_UPSCALE`` modes (module docstring)
UPSCALERS = ("temporal", "net", "residual", "none")
#: ``rate_schedule``'s choices: the scheduler, or one fixed tier
RATES = ("adaptive", RATE_CHECKER, RATE_QUARTER, RATE_FULL)


def adaptive(upscaler: str) -> bool:
    """Whether ``bench.py`` runs the motion-adaptive rate tier under
    ``upscaler``: under the plain accumulator only (module docstring)."""
    if upscaler not in UPSCALERS:
        raise ValueError(f"unknown upscaler {upscaler!r}")
    return upscaler == "temporal"


def camera_path(upscaler: str) -> str:
    """``bench.py``'s camera path under ``upscaler``: the interactive
    thirds with the adaptive tier, the constant pan without it."""
    return "interactive" if adaptive(upscaler) else "pan"


def jitter_sequence(upscaler: str):
    """The jitter table ``bench.py`` renders with under ``upscaler``: the
    9-phase sequence that covers every display phase of the 3x
    accumulator, else the reference's 8-phase table."""
    return (phase_jitter_sequence(3) if upscaler in ("temporal", "residual")
            else JITTER_SEQUENCE)


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


def rate_schedule(poses, ecfg: EngineConfig,
                  rates: str = "adaptive") -> list[str]:
    """The rate of each frame from consecutive poses.  ``rates``, one of
    ``RATES``: ``"adaptive"`` puts the first frame at checkerboard rate (no
    history yet), then the scheduler's pick, which looks one pose back, as
    a live flythrough would; a tier puts every frame at that rate."""
    if rates not in RATES:
        raise ValueError(f"unknown rates {rates!r}; one of {RATES}")
    if rates != "adaptive":
        return [rates] * len(poses)
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
    hit: torch.Tensor | None    # primary hits on the rate-cut grid (None
    #                             without GI: no G-buffer is returned)
    image: torch.Tensor         # (scale*H, scale*W, 3) reconstruction


class FrameLoop:
    """``bench.py``'s frame at one operating point: the world, the GI grid
    it updates, the window offset and the post stage's state it carries
    (the accumulator's ``TemporalState``, the net's 3x history, or None).
    ``scale`` 3 is the display upscale of the headline, 1 native-res
    reconstruction (config-4).  ``upscaler`` is the post stage's mode and
    ``net`` its learned module: an ``UpscalerNet`` for ``"net"``, a
    ``ResidualHead`` for ``"residual"``.  ``comp_cadence`` > 1 reuses the
    GI composite's addend between composites.  ``gi_cadence``: a GI window
    every that many frames; ``include_gi=False``: none, and no composite.
    ``gi_frame``: the frame number every GI window seeds its bounce rays
    with (``bench.py`` passes 0), or None for the frame index.
    ``warp_taps``: the accumulator's history warp.  ``overflow`` sums the
    respite's ``straggler_overflow`` over the GI windows, on the device."""

    def __init__(self, world: World, ecfg: EngineConfig, scale: int = 3,
                 upscaler: str = "temporal", net=None,
                 comp_cadence: int = 1, gi_cadence: int = GI_CADENCE,
                 include_gi: bool = True, gi_frame: int | None = None,
                 warp_taps: str = "pallas"):
        adaptive(upscaler)  # validates the name
        if upscaler != "temporal" and scale != 3:
            upscaler = "none"  # bench.py upscales only at the headline
        if upscaler in ("net", "residual") and net is None:
            raise ValueError(f"upscaler {upscaler!r} needs its net")
        if comp_cadence < 1 or gi_cadence < 1:
            raise ValueError(f"cadences {comp_cadence}, {gi_cadence} < 1")
        self.world = world
        self.ecfg = ecfg
        self.upscaler = upscaler
        self.net = net
        self.comp_cadence = comp_cadence
        self.gi_cadence = gi_cadence
        self.include_gi = include_gi
        self.gi_frame = gi_frame
        self.warp_taps = warp_taps
        dev = world.bits.device
        r = ecfg.render
        if upscaler in ("temporal", "residual"):
            self.state = temporal.init_state(r.height, r.width, scale=scale,
                                             device=dev)
        elif upscaler == "net":
            self.state = torch.zeros(r.height * scale, r.width * scale, 3,
                                     dtype=torch.float32, device=dev)
        else:
            self.state = None
        # the last composite's added light at full resolution, re-selected
        # at each reusing frame's rate and phase
        self.addend = (torch.zeros(r.height, r.width, 3,
                                   dtype=torch.float32, device=dev)
                       if comp_cadence > 1 else None)
        self.gi = world.gi
        self.offset = 0
        self.gi_windows = 0
        self.overflow = torch.zeros((), dtype=torch.int32, device=dev)

    def _composite(self, i: int, color, gb, rate: str, phase: int):
        """The GI composite of frame ``i``, or the carried addend re-added
        on a reusing frame (``bench.py:382-399``)."""
        w, ec = self.world, self.ecfg
        if self.comp_cadence == 1:
            return pipeline.gi_composite(color, gb, self.gi, w.sdf, ec,
                                         gi_occ=w.gi_occ)
        if i % self.comp_cadence != 0:
            add = self.addend
            if rate == RATE_CHECKER:
                add = pipeline.checker_select(add, phase)
            elif rate == RATE_QUARTER:
                add = pipeline.quarter_select(add, phase)
            return torch.clamp(color + add, 0.0, 1.0)
        color, add = pipeline.gi_composite(color, gb, self.gi, w.sdf, ec,
                                           gi_occ=w.gi_occ,
                                           return_addend=True)
        if rate == RATE_CHECKER:
            add = pipeline.checker_expand(add, phase)
        elif rate == RATE_QUARTER:
            add = pipeline.quarter_expand(add)
        self.addend = add
        return color

    def _post(self, out: pipeline.FrameOutputs, cam: pipeline.CameraArrays,
              valid) -> torch.Tensor:
        """The post stage of the loop's mode; returns the frame's image."""
        if self.upscaler == "none":
            return out.color
        if self.upscaler == "net":
            image, _ = up_model.upscale(self.net, out.color, out.motion,
                                        out.depth, cam.jitter, self.state)
            self.state = image
            return image
        image, self.state = temporal.temporal_upscale(
            out.color, out.motion, out.depth, cam.jitter, self.state,
            valid=valid, warp_taps=self.warp_taps)
        if self.upscaler == "residual":
            image = residual.apply(self.net, out.color, out.motion,
                                   out.depth, cam.jitter, image,
                                   self.state.conf)
        return image

    def frame(self, i: int, cam: pipeline.CameraArrays, rate: str,
              advance: bool = True) -> FrameResult:
        """Frame ``i`` at ``rate``.  ``advance=False``: a GI window of this
        frame keeps the last window's offset (``bench.py``'s extra warm-up
        frames, ``:573-591``).  With spans on (``utils/profiling.py``) the
        frame is the root span ``frame``, its id ``i``, over the stages
        ``gi_update`` (GI frames), ``base``, ``composite`` (with GI),
        ``expand`` and ``post``."""
        with profiling.span("frame", frame=i):
            return self._frame(i, cam, rate, advance)

    def _frame(self, i: int, cam: pipeline.CameraArrays, rate: str,
               advance: bool) -> FrameResult:
        w, ec = self.world, self.ecfg
        r = ec.render
        phase = frame_phase(i, rate)
        gi_ran = self.include_gi and i % self.gi_cadence == 0
        if gi_ran:
            with profiling.span("gi_update"):
                if self.gi_windows and advance:
                    self.offset = gi_update.advance_offset(self.offset, ec)
                self.gi, st = gi_update.update_gi(
                    self.gi, w.bits, w.sdf, w.atlas, ec,
                    i if self.gi_frame is None else self.gi_frame,
                    self.offset, sky_y=w.sky_y, table=w.trace_table,
                    return_stats=True)
                self.overflow = self.overflow + st["straggler_overflow"]
                self.gi_windows += 1
        with profiling.span("base"):
            res = pipeline.render_frame(
                w.bits, w.sdf, self.gi, w.atlas, cam, ec, include_gi=False,
                sky_y=w.sky_y, table=w.trace_table,
                return_gbuffer=self.include_gi,
                checker_parity=phase if rate == RATE_CHECKER else None,
                quarter_phase=phase if rate == RATE_QUARTER else None)
        out, gb = res if self.include_gi else (res, None)
        if self.include_gi:
            with profiling.span("composite"):
                out = out._replace(color=self._composite(
                    i, out.color, gb, rate, phase))
        valid = None
        with profiling.span("expand"):
            dev = out.color.device
            if rate == RATE_CHECKER:
                def expand(a):
                    return pipeline.checker_expand(a, phase)
                valid = pipeline.checker_valid_mask(r.height, r.width,
                                                    phase, device=dev)
            elif rate == RATE_QUARTER:
                expand = pipeline.quarter_expand
                valid = pipeline.quarter_valid_mask(r.height, r.width,
                                                    phase, device=dev)
            if valid is not None:
                out = out._replace(color=expand(out.color),
                                   motion=expand(out.motion),
                                   depth=expand(out.depth))
        with profiling.span("post"):
            image = self._post(out, cam, valid)
        return FrameResult(rate=rate, phase=phase, gi_ran=gi_ran, out=out,
                           hit=None if gb is None else gb.hit, image=image)
