"""The benchmark's one traffic generator: a seeded flythrough of one user.

A traffic mix is a JSON file of parameters (``port_bench/traffic/<name>.json``)
that ``Flight`` reads; no mix has code of its own.  The parameters:

* ``start_column``: the start column's x and z, as shares of the world's
  edge (the same for every seed: the column sets what the view holds, and
  with it the work of a frame);
* ``height_above_terrain``: the camera's height above the terrain top of
  that column (``bench.py``'s rule, clamped 2 voxels under the world's top);
* ``pitch``: the camera's pitch (``Character``'s convention);
* ``segments_rad_per_frame``: the turn rate of each kind of segment; every
  kind comes once in each cycle, in an order drawn from the seed, each
  segment with a sign drawn from the seed;
* ``segment_frames``: a segment's length in frames, drawn from the seed in
  this closed range;
* ``frame_dt_s``: the water clock's step a frame, and the time step of the
  ``Character``'s motion;
* ``segment_moves`` (optional; none where it is left out): for a kind of
  segment, the keys held down through it, as ``InputState``'s move axes
  ``[strafe, vertical, forward]`` in {-1, 0, 1}, times the segment's sign;
  the ``Character`` then moves by the upstream's dynamics (``speed`` 30
  voxels/s, ``speed_dropoff`` 0.95 a frame; ``Character.cpp:56-126``).
  A kind without moves, and a mix without the key, never translates.

The start yaw is drawn from the seed too.  Frame 0 is the start pose; the
path is made lazily, frame by frame, so it never runs out.  Each frame's
camera comes from a ``Character`` (``reference/camera.py``, a frozen copy of
the port's): its view-projection matrices, the previous frame's, and the
jitter of the frame's index in the post stage's jitter table, as the port's
``frame_loop.path_cameras`` makes them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from port_bench.reference import camera as cam_mod

#: the 3x accumulator's jitter (it needs every display phase), else the
#: reference's 8-phase table (``frame_loop.jitter_sequence``)
JITTER = {"temporal": lambda: cam_mod.phase_jitter_sequence(3),
          "net": lambda: cam_mod.JITTER_SEQUENCE,
          "none": lambda: cam_mod.JITTER_SEQUENCE}


@dataclass(frozen=True)
class Pose:
    """One frame's camera as numpy arrays: the basis, the current and
    previous unjittered view-projection, the NDC jitter and the clock."""
    pos: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    vp: np.ndarray
    prev_vp: np.ndarray
    jitter: np.ndarray
    time: np.ndarray

    def arrays(self) -> tuple:
        """The fields in ``CameraArrays``' order."""
        return (self.pos, self.forward, self.right, self.up, self.vp,
                self.prev_vp, self.jitter, self.time)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent random stream ``stream`` of ``seed`` (any int)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def start_column(traffic: dict, size_x: int,
                 size_z: int) -> tuple[int, int]:
    """The start column's (x, z) voxel."""
    fx, fz = traffic["start_column"]
    return int(size_x * fx), int(size_z * fz)


class Flight:
    """The poses of one seeded flythrough.  ``terrain_top``: the highest
    solid voxel of the start column; ``render``: (width, height,
    display_width, display_height, fov_degrees); ``post``: the post stage,
    which picks the jitter table."""

    def __init__(self, traffic: dict, seed: int, column: tuple[int, int],
                 terrain_top: float, size_y: int, render: tuple,
                 post: str):
        self.traffic = traffic
        width, height, dwidth, dheight, fov = render
        self._g = rng_for(seed, 1)
        self.yaw0 = float(self._g.uniform(0.0, 2.0 * math.pi))
        x, z = column
        y = min(terrain_top + traffic["height_above_terrain"], size_y - 2.0)
        self.character = cam_mod.Character(
            display_width=dwidth, display_height=dheight,
            render_width=width, render_height=height, fov_degrees=fov,
            position=np.array([x, y, z], np.float32),
            pitch=float(traffic["pitch"]), yaw=self.yaw0,
            jitter_sequence=JITTER[post]())
        self._rates = traffic["segments_rad_per_frame"]
        self._moves = traffic.get("segment_moves", {})
        self._segment: list = []         # the rest of the current segment
        self._cycle: list[str] = []      # the kinds left in this cycle
        self.yaw = 0.0                   # rad from the start yaw
        self.frame = -1

    def _turn(self) -> tuple[float, tuple]:
        """The next frame's turn (rad) and the move axes held."""
        if not self._segment:
            if not self._cycle:
                self._cycle = list(self._g.permutation(sorted(self._rates)))
            kind = self._cycle.pop(0)
            lo, hi = self.traffic["segment_frames"]
            n = int(self._g.integers(lo, hi + 1))
            sign = 1.0 if self._g.random() < 0.5 else -1.0
            move = tuple(sign * float(a)
                         for a in self._moves.get(kind, (0, 0, 0)))
            self._segment = [(sign * self._rates[kind], move)] * n
        return self._segment.pop()

    def next(self, hold: bool = False) -> Pose:
        """The next frame's pose; ``hold``: at the last pose's yaw (the
        warm-up frames at the start pose)."""
        self.frame += 1
        move = (0.0, 0.0, 0.0)
        if self.frame > 0 and not hold:
            turn, move = self._turn()
            self.yaw += turn
        ch = self.character
        ch.yaw = self.yaw0 + self.yaw
        keys = cam_mod.InputState(move_x=move[0], move_y=move[1],
                                  move_z=move[2])
        cam = ch.update(keys, self.traffic["frame_dt_s"], self.frame)
        f32 = np.float32
        return Pose(pos=cam.pos.astype(f32), forward=cam.forward.astype(f32),
                    right=cam.right.astype(f32), up=cam.up.astype(f32),
                    vp=ch.unjittered_view_projection.astype(f32),
                    prev_vp=ch.prev_unjittered_view_projection.astype(f32),
                    jitter=np.array(ch.ray_jitter_ndc(), f32),
                    time=np.array(self.frame * self.traffic["frame_dt_s"],
                                  f32))
