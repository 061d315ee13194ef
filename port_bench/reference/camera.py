"""Camera / Character: fly-camera dynamics, matrices, TAA jitter.

Host-side (numpy) replacement for the reference's ``Character``/``Camera``
(``src/Character.cpp``, ``include/Camera.hpp``): raw mouse deltas ->
yaw/pitch (pitch clamped), WASD-style axes -> velocity with 0.95 drag,
glm-convention lookAt/perspective (FOV 60deg, near 0.1, far 50000), the
8-frame jitter sequence applied to the projection's third column, and the
previous unjittered view-projection kept for motion vectors.

Matrices are stored glm column-major - ``m[col][row]`` - to match
``mat_mul_vec`` (``cumath.cuh:47-54``); the camera basis handed to the
renderer is (pos, forward, right, up) exactly as ``Character::Update`` builds
it (``Character.cpp:112-115``).

Deterministic camera paths built from this class are the engine's replay
format (the reference has no checkpointing; worlds and paths regenerate
bit-for-bit from config - SURVEY.md §5.4).

A numpy copy of ``rvgrt_tpu/scene/camera.py``: the port keeps its own so it
never imports the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

F32 = np.float32

# Standard 8-phase Halton-style TAA jitter sequence in units of pixels/8
# (Character.cpp:9-15); applied at half strength (Character.cpp:101-102).
JITTER_SEQUENCE = np.array([
    [-1.0 / 8.0, -1.0 / 8.0], [1.0 / 8.0, 3.0 / 8.0],
    [5.0 / 8.0, -3.0 / 8.0], [-3.0 / 8.0, 5.0 / 8.0],
    [-7.0 / 8.0, -5.0 / 8.0], [3.0 / 8.0, 7.0 / 8.0],
    [7.0 / 8.0, -7.0 / 8.0], [-5.0 / 8.0, 1.0 / 8.0],
], np.float32)


def phase_jitter_sequence(scale: int) -> np.ndarray:
    """Full-coverage jitter for SCALE-x temporal super-resolution.

    The reference's 8-phase table covers only 7 of the 9 display-pixel
    phases of a 3x upscale (two display phases never receive a direct
    sample and stay interpolated forever).  This sequence lands exactly
    one sample per display phase every scale^2 frames: phase p's offset
    from the render-pixel center is (p + 0.5)/scale - 0.5, stored at 2x
    because Character consumes sequences at half strength
    (Character.cpp:101-102 semantics).  Frames are ordered by an R2
    low-discrepancy rank so consecutive frames stay well spread.
    """
    n = scale * scale
    order = sorted(range(n),
                   key=lambda k: ((k % scale) * 0.7548776662466927
                                  + (k // scale) * 0.5698402909980532) % 1.0)
    seq = [[2.0 * (((k % scale) + 0.5) / scale - 0.5),
            2.0 * (((k // scale) + 0.5) / scale - 0.5)] for k in order]
    return np.array(seq, np.float32)


def _norm(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v)).astype(F32)


def dir_from_sphere(pitch: float, yaw: float) -> np.ndarray:
    """Spherical angles -> unit direction (calcDirfromSphere,
    Character.cpp:18-25)."""
    pih = math.pi * 0.5
    s_yaw, s_yaw_p, s_pitch, s_pitch_p = (
        math.sin(yaw), math.sin(yaw + pih), math.sin(pitch),
        math.sin(pitch + pih))
    return _norm(np.array([
        -s_yaw * -s_pitch_p,
        -s_pitch,
        -s_yaw_p * s_pitch_p,
    ], F32))


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAtRH in column-major m[col][row] layout."""
    f = _norm(center - eye)
    s = _norm(np.cross(f, up))
    u = np.cross(s, f).astype(F32)
    m = np.eye(4, dtype=F32)  # m[col][row]
    m[0, 0], m[1, 0], m[2, 0] = s
    m[0, 1], m[1, 1], m[2, 1] = u
    m[0, 2], m[1, 2], m[2, 2] = -f
    m[3, 0] = -float(s @ eye)
    m[3, 1] = -float(u @ eye)
    m[3, 2] = float(f @ eye)
    return m


def perspective(fovy_rad: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """glm::perspectiveRH_NO (depth in [-1, 1]) in column-major layout."""
    th = math.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), F32)
    m[0, 0] = 1.0 / (aspect * th)
    m[1, 1] = 1.0 / th
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -1.0
    m[3, 2] = -(2.0 * far * near) / (far - near)
    return m


def glm_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """glm matrix product a*b for column-major m[col][row] storage."""
    return (b @ a).astype(F32)


@dataclass
class Camera:
    """The renderer-facing basis (Camera.hpp): pos + forward/right/up."""
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    forward: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1], F32))
    right: np.ndarray = field(default_factory=lambda: np.array([1, 0, 0], F32))
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], F32))


@dataclass
class InputState:
    """Per-frame input snapshot - replaces Win32 key polling + raw mouse.

    ``move`` axes: x = D/A strafe, y = space/Z vertical, z = W/S forward,
    each in {-1, 0, 1} (Character.cpp:69-71); mouse deltas in counts.
    """
    move_x: float = 0.0
    move_y: float = 0.0
    move_z: float = 0.0
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0


@dataclass
class Character:
    """Fly camera with the reference's dynamics (Character.cpp:27-126)."""

    display_width: int = 3840
    display_height: int = 2400
    render_width: int = 1280
    render_height: int = 800

    position: np.ndarray = field(
        default_factory=lambda: np.array([128.0, 350.0, 128.0], F32))
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3, F32))
    yaw: float = -0.7
    pitch: float = -math.pi - 0.3
    fov_degrees: float = 60.0
    near_plane: float = 0.1
    far_plane: float = 50000.0
    speed: float = 30.0
    speed_dropoff: float = 0.95
    jump_speed: float = -30.0
    sensitivity: float = 0.015
    gravity: float = 0.0
    use_jitter: bool = True
    # the TAA jitter table; swap for phase_jitter_sequence(3) when the
    # temporal super-resolution upscaler is in the loop (full 3x3 display-
    # phase coverage).  The default is the reference's 8-phase table.
    jitter_sequence: np.ndarray = field(
        default_factory=lambda: JITTER_SEQUENCE)

    def __post_init__(self):
        self.direction = dir_from_sphere(self.pitch, self.yaw)
        self.view_projection = np.eye(4, dtype=F32)
        self.unjittered_view_projection = np.eye(4, dtype=F32)
        self.prev_view_projection = np.eye(4, dtype=F32)
        self.prev_unjittered_view_projection = np.eye(4, dtype=F32)
        self.jitter_px = (0.0, 0.0)
        self.camera = Camera()

    # pitch clamp range (Character.cpp:66)
    PITCH_MIN = -4.5
    PITCH_MAX = -1.65

    def update(self, inputs: InputState, delta_time: float,
               frame_count: int) -> Camera:
        self.prev_view_projection = self.view_projection
        self.prev_unjittered_view_projection = self.unjittered_view_projection

        self.yaw = math.fmod(
            self.yaw + inputs.mouse_dx * self.sensitivity * delta_time
            * self.fov_degrees, math.pi * 2.0)
        self.pitch = min(max(
            self.pitch + inputs.mouse_dy * self.sensitivity * delta_time
            * self.fov_degrees, self.PITCH_MIN), self.PITCH_MAX)
        self.direction = dir_from_sphere(self.pitch, self.yaw)

        world_up = np.array([0.0, 1.0, 0.0], F32)
        strafe = np.cross(self.direction, world_up).astype(F32)
        self.velocity = (self.velocity
                         + F32(inputs.move_x * self.speed) * strafe
                         + F32(inputs.move_z * self.speed) * self.direction)
        self.velocity = self.velocity * F32(self.speed_dropoff)

        # jump = up * -(move_y * speed) * jumpSpeed (Character.cpp:76)
        jump = world_up * F32(-(inputs.move_y * self.speed) * self.jump_speed)
        grav = world_up * F32(self.gravity)
        add = (self.velocity + jump + grav) * F32(delta_time)
        # position = mix(position, position + add, 0.5)
        self.position = (self.position + add * F32(0.5)).astype(F32)

        dir_right = _norm(np.cross(self.direction, world_up))
        dir_up = _norm(np.cross(self.direction, dir_right))

        view = look_at(self.position, self.position + self.direction, world_up)
        proj = perspective(math.radians(self.fov_degrees),
                           self.display_width / self.display_height,
                           self.near_plane, self.far_plane)
        self.unjittered_view_projection = glm_mul(proj, view)

        jx = jy = 0.0
        if self.use_jitter:
            seq = self.jitter_sequence
            jx = float(seq[frame_count % len(seq)][0]) * 0.5
            jy = float(seq[frame_count % len(seq)][1]) * 0.5
            proj = proj.copy()
            proj[2, 0] += jx / (0.5 * self.display_width)
            proj[2, 1] += jy / (0.5 * self.display_height)
        self.jitter_px = (jx, jy)
        self.view_projection = glm_mul(proj, view)

        self.camera = Camera(pos=self.position.copy(),
                             forward=self.direction.copy(),
                             right=dir_right, up=dir_up)
        return self.camera

    def ray_jitter_ndc(self) -> tuple[float, float]:
        """Sub-pixel jitter in render-resolution NDC units for ray gen.

        The reference intended this but its constant-buffer indexing bug
        zeroes it (SURVEY.md appendix B); we apply it for real so the
        learned upscaler sees genuinely jittered samples.
        """
        jx, jy = self.jitter_px
        return (jx * 2.0 / self.render_width, jy * 2.0 / self.render_height)
