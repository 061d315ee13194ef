"""Engine: world lifecycle + per-frame stepping (the ``State`` equivalent).

The port of ``rvgrt_tpu/driver/engine.py``: the reference's world build
(``State.cpp:24-56``: allocate -> fill -> SDF -> GI init) and render-loop
orchestration (``main.cpp:104-234``).  The world is a dataclass of tensors
on one device; ``Engine.step`` runs the split-dispatch GI frame: GI update,
the GI-less base frame with its G-buffer, then the GI composite.  JAX's
``jit`` and ahead-of-time compile machinery has no counterpart: PyTorch runs
eagerly and the kernels are built once per process on first use.

``world_from_numpy`` / ``world_to_numpy`` carry a world between processes
or packages (u32 arrays travel as their int32 bits).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera, Character, InputState
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.utils.device import resolve_device
from rvgrt_tpu_torch.utils.timer import Timer
from rvgrt_tpu_torch.world import atlas as atlas_mod
from rvgrt_tpu_torch.world import gi_grid, sdf as sdf_mod, voxel_grid


@dataclass
class World:
    """Device-resident world state (the CArray/CoarseArray/Texturepack set).
    u32 words are carried as int32 tensors of the same bits."""
    bits: torch.Tensor   # (num_words,) u32 occupancy
    sdf: torch.Tensor    # (sdf_cells,) uint8 coarse SDF
    gi: torch.Tensor     # (gi_cells,) u32 packed RGBA8 radiance
    atlas: torch.Tensor  # (256*256,) u32 packed RGBA8 texture atlas
    # derived: cone-occlusion mip at GI res (alpha-byte-shifted u32), built
    # only for RenderConfig.gi_fused_cone; rebuilt on load, never persisted
    gi_occ: torch.Tensor | None = None
    # derived: 1 + highest solid voxel y (f32 0-d) for sky early-exit
    sky_y: torch.Tensor | None = None
    # derived: combined tracer gather table [4x2x4 bricks | packed SDF]
    trace_table: torch.Tensor | None = None


_U32_KEYS = ("bits", "gi", "atlas", "trace_table")


def world_to_numpy(world: World) -> dict:
    """{bits, sdf, gi, atlas, sky_y, trace_table} as numpy arrays (uint32,
    uint8, uint32, uint32, float32 0-d, uint32)."""
    out = {}
    for k in ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table"):
        v = getattr(world, k)
        if v is None:
            continue
        out[k] = u32.to_numpy(v) if k in _U32_KEYS \
            else v.detach().cpu().numpy()
    return out


def world_from_numpy(d: dict, device=None) -> World:
    """A World from the arrays of ``world_to_numpy`` (or of the JAX
    package's World, converted with ``np.asarray``)."""
    dev = resolve_device(device)
    kw = {}
    for k in ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table"):
        if d.get(k) is None:
            continue
        a = np.asarray(d[k])
        if k in _U32_KEYS:
            kw[k] = u32.from_numpy(a.astype(np.uint32), dev)
        elif k == "sdf":
            kw[k] = torch.from_numpy(a.astype(np.uint8).copy()).to(dev)
        else:
            kw[k] = torch.tensor(float(a), dtype=torch.float32, device=dev)
    return World(**kw)


def _sdf_phase_fn(b, cfg):
    """The whole SDF phase: coarse occupancy reduce -> separable distance
    transform -> far-field mip extension."""
    coarse = voxel_grid.coarse_occupancy(b, cfg)
    s = sdf_mod.build_sdf(coarse, cfg)
    return sdf_mod.extend_sdf_far(s, coarse, cfg)


def build_world(ecfg: EngineConfig, verbose: bool = True,
                init_gi: bool = True, phase_times: dict | None = None,
                device=None, phase_peak_gb: dict | None = None) -> World:
    """Deterministic world build (State.cpp:24-56 lifecycle) with phase
    timers.  ``phase_times``: optional dict filled with {phase: seconds},
    timed with CUDA events on a GPU.  ``phase_peak_gb``: optional dict
    filled, on a GPU, with {phase: the device memory's peak in the phase,
    GB}; it resets the device's peak statistic at each phase.  Nothing but
    the World outlives a phase: the coarse occupancy and each SDF pass are
    freed as the next step returns."""
    dev = resolve_device(device)
    cfg = ecfg.world
    peaks = phase_peak_gb is not None and dev.type == "cuda"

    @contextlib.contextmanager
    def phase(name):
        if peaks:
            torch.cuda.reset_peak_memory_stats(dev)
        with Timer(name, verbose, device=dev) as t:
            yield
        if phase_times is not None:
            phase_times[name] = t.elapsed_ms / 1e3
        if peaks:
            phase_peak_gb[name] = torch.cuda.max_memory_allocated(dev) / 1e9

    with phase("building fine voxel grid"):
        bits = voxel_grid.generate(cfg, ecfg.terrain, device=dev)
    with phase("building coarse SDF"):
        sdf = _sdf_phase_fn(bits, cfg)
    with phase("building texture atlas"):
        atlas = atlas_mod.default_atlas(dev)
    with phase("building tracer gather table"):
        table = wavefront.make_trace_table(bits, sdf, cfg)
    with phase("computing sky limit"):
        sky_y = voxel_grid.sky_limit(bits, cfg)
    if init_gi:
        with phase("initializing GI"):
            if ecfg.gi_init_mode == "heightfield":
                gi = gi_update.init_gi_heightfield(bits, ecfg)
            else:
                gi = gi_update.init_gi_strided(bits, sdf, ecfg, sky_y=sky_y,
                                               table=table,
                                               stride=ecfg.gi_init_stride)
    else:
        gi = gi_grid.zeros(cfg, dev)
    # the occlusion mip feeds only the fused cone table (off by default)
    gi_occ = None
    if ecfg.render.gi_fused_cone:
        with phase("building cone occlusion"):
            gi_occ = gi_grid.build_occlusion(sdf, cfg)
    return World(bits=bits, sdf=sdf, gi=gi, atlas=atlas, gi_occ=gi_occ,
                 sky_y=sky_y, trace_table=table)


def camera_arrays(cam: Camera, vp: np.ndarray | None = None,
                  prev_vp: np.ndarray | None = None,
                  jitter=(0.0, 0.0), time_s: float = 0.0,
                  device=None) -> pipeline.CameraArrays:
    dev = resolve_device(device)
    eye = np.eye(4, dtype=np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    return pipeline.CameraArrays(
        pos=t(cam.pos), forward=t(cam.forward), right=t(cam.right),
        up=t(cam.up), vp=t(vp if vp is not None else eye),
        prev_vp=t(prev_vp if prev_vp is not None else eye),
        jitter=t(jitter), time=t(time_s))


def gi_update_step(gi, bits, sdf, atlas, frame: int, gi_offset: int,
                   ecfg: EngineConfig, sky_y=None, table=None):
    return gi_update.update_gi(gi, bits, sdf, atlas, ecfg, frame,
                               gi_offset, sky_y=sky_y, table=table)


def base_frame_step(bits, sdf, gi, atlas, cam: pipeline.CameraArrays,
                    ecfg: EngineConfig, sky_y=None, table=None):
    return pipeline.render_frame(bits, sdf, gi, atlas, cam, ecfg,
                                 include_gi=False, sky_y=sky_y, table=table,
                                 return_gbuffer=True)


def gi_composite_step(color, gb, gi, sdf, ecfg: EngineConfig, gi_occ=None):
    return pipeline.gi_composite(color, gb, gi, sdf, ecfg, gi_occ=gi_occ)


class Engine:
    """Stateful convenience wrapper: world + character + frame loop.
    ``world``: an existing world to share (the object itself, so that each
    engine's GI update writes the one grid) in place of building one."""

    def __init__(self, ecfg: EngineConfig, include_gi: bool = True,
                 verbose: bool = True, device=None,
                 phase_times: dict | None = None,
                 world: World | None = None):
        self.device = resolve_device(device)
        self.ecfg = ecfg
        self.include_gi = include_gi
        self.world = world if world is not None else build_world(
            ecfg, verbose=verbose, init_gi=include_gi,
            phase_times=phase_times, device=self.device)
        self.character = Character(
            display_width=ecfg.render.display_width,
            display_height=ecfg.render.display_height,
            render_width=ecfg.render.width,
            render_height=ecfg.render.height)
        self.frame_count = 0
        self.gi_offset = 0
        self.start_time = time.time()

    def _cam(self, jitter, time_s) -> pipeline.CameraArrays:
        ch = self.character
        return camera_arrays(
            ch.camera, vp=ch.unjittered_view_projection,
            prev_vp=ch.prev_unjittered_view_projection,
            jitter=jitter, time_s=time_s, device=self.device)

    def step(self, inputs: InputState | None = None,
             delta_time: float = 1.0 / 60.0,
             time_s: float | None = None) -> pipeline.FrameOutputs:
        """One frame.  ``time_s``: the clock that animates the water
        (seconds since the engine started, by default)."""
        ch = self.character
        ch.update(inputs or InputState(), delta_time, self.frame_count)
        if time_s is None:
            time_s = (time.time() - self.start_time) % 1e6
        cam = self._cam(ch.ray_jitter_ndc(), time_s)
        w = self.world
        if self.include_gi and self.ecfg.render.gi_split_dispatch:
            gi = gi_update_step(w.gi, w.bits, w.sdf, w.atlas,
                                self.frame_count, self.gi_offset, self.ecfg,
                                sky_y=w.sky_y, table=w.trace_table)
            out, gb = base_frame_step(w.bits, w.sdf, gi, w.atlas, cam,
                                      self.ecfg, sky_y=w.sky_y,
                                      table=w.trace_table)
            color = gi_composite_step(out.color, gb, gi, w.sdf, self.ecfg,
                                      gi_occ=w.gi_occ)
            out = out._replace(color=color)
        else:
            gi = w.gi
            if self.include_gi:
                gi = gi_update_step(w.gi, w.bits, w.sdf, w.atlas,
                                    self.frame_count, self.gi_offset,
                                    self.ecfg, sky_y=w.sky_y,
                                    table=w.trace_table)
            out = pipeline.render_frame(
                w.bits, w.sdf, gi, w.atlas, cam, self.ecfg,
                include_gi=self.include_gi, gi_occ=w.gi_occ, sky_y=w.sky_y,
                table=w.trace_table)
        self.world.gi = gi
        self.frame_count += 1
        self.gi_offset = gi_update.advance_offset(self.gi_offset, self.ecfg)
        return out

    def render_at(self, jitter_ndc=(0.0, 0.0),
                  time_s: float = 0.0) -> pipeline.FrameOutputs:
        """Re-render the CURRENT pose with a jitter override, advancing
        nothing (no GI update, no frame count)."""
        cam = self._cam(jitter_ndc, time_s)
        w = self.world
        out, gb = base_frame_step(w.bits, w.sdf, w.gi, w.atlas, cam,
                                  self.ecfg, sky_y=w.sky_y,
                                  table=w.trace_table)
        if self.include_gi:
            color = gi_composite_step(out.color, gb, w.gi, w.sdf, self.ecfg,
                                      gi_occ=w.gi_occ)
            out = out._replace(color=color)
        return out
