"""Motion-adaptive primary-ray rate scheduler (host-side).

A numpy copy of ``rvgrt_tpu/render/scheduler.py``: the port keeps its own
so it never imports the JAX package, and the two pick the same tier for
the same poses (``tests/test_torch_rates.py``).

This fills the DLSS mode-selection role (``main.cpp:529-543``): the
reference picks ONE static upscaler quality mode at startup
(UltraPerformance); here the rate tiers are buffers of different shapes
(full / 2-phase checkerboard / 4-phase quarter interleave,
``pipeline.checker_*`` / ``pipeline.quarter_*``), so the scheduler can
follow the camera frame by frame instead.

Policy, from the quality ladder the JAX package measured on a TPU
(``PERF_TPU_HISTORY.md``, ``scripts/probe_checker_motion.py``):

* quarter-rate costs several dB vs full-rate under a fast pan (the
  temporal accumulator refreshes each pixel only every 4 frames, so
  shading/alias content is up to 3 frames stale where the image moves),
  but tracks the checker tier when the camera is slow or static;
* checkerboard costs well under 1 dB on the same fast-pan path;

so: fast motion -> checkerboard, slow/static -> quarter.  Full rate is
available as an optional top tier for extreme motion (off by default:
checkerboard's fast-pan cost is already below the visibility knee, and
the top tier would fire exactly when frame time matters most).

The motion metric is ESTIMATED SCREEN MOTION from consecutive camera
poses - pure host-side numpy on the same information
``Character.update`` has before the frame is dispatched (no device
readback, so choosing a tier never waits for the device).  Rotation contributes ``d_angle / fov_per_pixel`` pixels;
translation contributes parallax flow against a conservative scene
depth.  Units are render-resolution pixels per frame; thresholds are
configured as a fraction of render width so the policy is
resolution-independent.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

RATE_FULL = "full"
RATE_CHECKER = "checker"
RATE_QUARTER = "quarter"

#: tier order from cheapest (index 0) to most expensive
RATES = (RATE_QUARTER, RATE_CHECKER, RATE_FULL)


@dataclasses.dataclass(frozen=True)
class AdaptiveRateConfig:
    """Thresholds for the motion-adaptive rate policy.

    ``checker_above_frac``: screen motion (fraction of render WIDTH per
    frame) at or above which the frame is dispatched at checkerboard
    rate; below it, quarter rate.  The default 0.01 (1% of screen width
    per frame; a ~35 deg/s pan at 60 FPS with a 60 deg fov) is
    calibrated by ``scripts/probe_checker_motion.py --script mixed``:
    below it the quarter tier's delivered PSNR tracks the checker tier,
    above it the gap opens toward the measured fast-pan costs
    (quarter -3.54 dB vs full, checker -0.76 dB).

    ``full_above_frac``: motion at or above which the frame runs FULL
    rate.  Negative disables the tier (default): checkerboard's
    measured fast-pan cost is already small, and the top tier would
    fire exactly when frame time matters most.

    ``hysteresis``: fractional dead zone around each threshold - a tier
    switch requires crossing the threshold by this margin in the new
    direction, preventing flapping (each flap disturbs the
    accumulator's per-rate refresh cadence for no quality gain).

    ``parallax_depth``: conservative scene depth (voxels) used to turn
    camera translation into screen flow; small values over-estimate
    motion (the safe direction: over-estimating promotes to a HIGHER
    rate).
    """

    checker_above_frac: float = 0.01
    full_above_frac: float = -1.0
    hysteresis: float = 0.25
    parallax_depth: float = 12.0

    def thresholds(self) -> list[float]:
        """Active tier boundaries, cheapest first: [quarter->checker, ...]."""
        t = [self.checker_above_frac]
        if self.full_above_frac >= 0.0:
            t.append(self.full_above_frac)
        return t


class AdaptiveRateScheduler:
    """Per-frame rate picker; host-side, stateful only for hysteresis."""

    def __init__(self, width: int, height: int, fov_degrees: float = 60.0,
                 cfg: AdaptiveRateConfig | None = None):
        self.cfg = cfg or AdaptiveRateConfig()
        self.width = int(width)
        self.height = int(height)
        # horizontal fov from the vertical fov + aspect (perspective() in
        # scene/camera.py takes fovy)
        fovy = math.radians(fov_degrees)
        aspect = width / height
        self._fov_x = 2.0 * math.atan(math.tan(0.5 * fovy) * aspect)
        # focal length in render pixels (for translation parallax)
        self._focal_px = (0.5 * width) / math.tan(0.5 * self._fov_x)
        # conservative start: the accumulator history is empty, so the
        # first frames behave like a moving camera regardless of poses
        self._tier = RATES.index(RATE_CHECKER)

    # ---- motion metric -------------------------------------------------

    def motion_pixels(self, prev_pos, prev_forward, pos, forward) -> float:
        """Estimated screen motion (render px/frame) between two poses."""
        f0 = np.asarray(prev_forward, np.float64)
        f1 = np.asarray(forward, np.float64)
        f0 = f0 / max(np.linalg.norm(f0), 1e-12)
        f1 = f1 / max(np.linalg.norm(f1), 1e-12)
        ang = math.acos(float(np.clip(np.dot(f0, f1), -1.0, 1.0)))
        rot_px = ang * self.width / self._fov_x
        dp = np.asarray(pos, np.float64) - np.asarray(prev_pos, np.float64)
        # translation -> screen flow against a conservative near depth;
        # both the lateral component (direct image shift) and the forward
        # component (radial flow at the image periphery) move content by
        # ~|dp| * focal / depth at the worst-case pixel
        trans_px = (float(np.linalg.norm(dp)) / max(
            self.cfg.parallax_depth, 1e-6)) * self._focal_px
        return rot_px + trans_px

    # ---- policy --------------------------------------------------------

    def pick(self, motion_px: float) -> str:
        """Choose the rate tier for the next frame (with hysteresis).

        The raw policy is a tier index from the threshold ladder; the
        hysteresis rule only lets the tier move when the boundary being
        crossed is cleared by ``hysteresis`` margin in the direction of
        travel, and moves it one boundary at a time per call (tier
        flapping costs accumulator quality; one-step moves are free).
        """
        frac = motion_px / self.width
        thr = self.cfg.thresholds()
        h = self.cfg.hysteresis
        cur = min(self._tier, len(thr))  # clamp if full tier was disabled
        raw = sum(1 for t in thr if frac >= t)
        if raw > cur and frac >= thr[cur] * (1.0 + h):
            cur += 1
        elif raw < cur and frac < thr[cur - 1] * (1.0 - h):
            cur -= 1
        self._tier = cur
        return RATES[cur]

    def step(self, prev_cam, cam) -> str:
        """Convenience: motion from two ``Camera``s -> rate for this frame."""
        m = self.motion_pixels(prev_cam.pos, prev_cam.forward,
                               cam.pos, cam.forward)
        return self.pick(m)
