"""The plain reference of the port's world build and of one frame of its
frame loop (``rvgrt_tpu_torch/driver/engine.py::build_world``,
``driver/frame_loop.py::FrameLoop.frame``), worked out again from a
configuration, a camera and the state the frame starts from.

Plain PyTorch on the modules beside this one, which are frozen copies of the
port's plain paths, and on ``upscaler.py``, the learned upscaler written
from the JAX package; it imports nothing of the port.  It runs the modes
the benchmark's configurations use: the post stage ``"temporal"`` (the 3x
or 1x accumulator), ``"net"`` (the learned upscaler at 3x, its history the
last image) or ``"none"``, and a GI composite every frame or, with
``comp_cadence`` > 1, every that many frames, the frames between re-adding
the last composite's carried addend, selected at their own rate and phase
(``FrameLoop._composite``).

``lowp=True`` is the control of the benchmark's comparison: every float
image a frame hands from one stage to the next (the shaded colour, the
composite and its carried addend, the expanded colour, motion and depth,
the post stage's output and history) is rounded to bfloat16, the precision
a later change might store them in, and so are the GI update's blended
radiance and, in the world build, the terrain's density; the tracer's
positions stay float32.  The learned upscaler's convs take their inputs
and kernels in float8 (e4m3), the step below the bfloat16 they are
configured in.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import atlas as atlas_mod
from . import gi_update, pipeline, sdf as sdf_mod, temporal, voxel_grid
from . import upscaler as up_ref
from . import wavefront
from .config import EngineConfig
from .scheduler import RATE_CHECKER, RATE_QUARTER

POST_STAGES = ("temporal", "net", "none")


@dataclass
class World:
    bits: torch.Tensor
    sdf: torch.Tensor
    gi: torch.Tensor
    atlas: torch.Tensor
    sky_y: torch.Tensor
    trace_table: torch.Tensor


def build_world(ecfg: EngineConfig, device, lowp: bool = False) -> World:
    """The world of ``ecfg``: fine bits, coarse SDF with its far mips, the
    atlas, the tracer's gather table, the sky limit and the GI grid after
    its init (heightfield or traced).  ``lowp``: the terrain's density
    rounded to bfloat16 (the control)."""
    cfg = ecfg.world
    if ecfg.render.gi_fused_cone:
        raise ValueError("the reference does not run the fused cone table")
    bits = voxel_grid.generate(cfg, ecfg.terrain, device=device, lowp=lowp)
    coarse = voxel_grid.coarse_occupancy(bits, cfg)
    sdf = sdf_mod.extend_sdf_far(sdf_mod.build_sdf(coarse, cfg), coarse, cfg)
    del coarse
    atlas = atlas_mod.default_atlas(device)
    table = wavefront.make_trace_table(bits, sdf, cfg)
    sky_y = voxel_grid.sky_limit(bits, cfg)
    if ecfg.gi_init_mode == "heightfield":
        gi = gi_update.init_gi_heightfield(bits, ecfg)
    else:
        gi = gi_update.init_gi_strided(bits, sdf, ecfg, sky_y=sky_y,
                                       table=table,
                                       stride=ecfg.gi_init_stride)
    return World(bits=bits, sdf=sdf, gi=gi, atlas=atlas, sky_y=sky_y,
                 trace_table=table)


def gi_offsets(n_frames: int, ecfg: EngineConfig, gi_cadence: int,
               include_gi: bool = True) -> list[int]:
    """The GI window's offset at each of frames ``0 .. n_frames - 1``: it
    advances right before a frame that runs a window, from the second
    window on."""
    out, offset, windows = [], 0, 0
    for i in range(n_frames):
        if include_gi and i % gi_cadence == 0:
            if windows:
                offset = gi_update.advance_offset(offset, ecfg)
            windows += 1
        out.append(offset)
    return out


def frame_phase(i: int, rate: str) -> int:
    """The checkerboard parity or quarter phase of frame ``i``."""
    if rate == RATE_QUARTER:
        return pipeline.QUARTER_PHASE_ORDER[i & 3]
    return i & 1


def init_state(ecfg: EngineConfig, scale: int, upscaler: str, device):
    """The post stage's state before the first frame: the accumulator's,
    the net's black (3H, 3W, 3) history, or None."""
    if upscaler == "none":
        return None
    r = ecfg.render
    if upscaler == "net":
        return torch.zeros(r.height * up_ref.SCALE, r.width * up_ref.SCALE,
                           3, dtype=torch.float32, device=device)
    return temporal.init_state(r.height, r.width, scale=scale, device=device)


def _q(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if lowp else x


def _composite(color, gb, gi, world: World, ecfg: EngineConfig, i: int,
               rate: str, phase: int, comp_cadence: int, addend, lowp: bool):
    """The composited colour of frame ``i`` and the addend carried on
    (module docstring)."""
    if comp_cadence == 1:
        return _q(pipeline.gi_composite(color, gb, gi, world.sdf, ecfg),
                  lowp), addend
    if i % comp_cadence:
        add = addend
        if rate == RATE_CHECKER:
            add = pipeline.checker_select(add, phase)
        elif rate == RATE_QUARTER:
            add = pipeline.quarter_select(add, phase)
        return _q(torch.clamp(color + add, 0.0, 1.0), lowp), addend
    color, add = pipeline.gi_composite(color, gb, gi, world.sdf, ecfg,
                                       return_addend=True)
    if rate == RATE_CHECKER:
        add = pipeline.checker_expand(add, phase)
    elif rate == RATE_QUARTER:
        add = pipeline.quarter_expand(add)
    return _q(color, lowp), _q(add, lowp)


def frame(world: World, ecfg: EngineConfig, i: int,
          cam: pipeline.CameraArrays, rate: str, gi: torch.Tensor, state,
          offset: int, *, upscaler: str, gi_cadence: int,
          include_gi: bool = True, warp_taps: str = "pallas",
          net: up_ref.Net | None = None, comp_cadence: int = 1,
          addend: torch.Tensor | None = None, lowp: bool = False) -> dict:
    """Frame ``i`` at ``rate`` from the GI words ``gi``, the post stage's
    ``state`` and, with ``comp_cadence`` > 1, the carried composite
    ``addend`` ((H, W, 3); unread where frame ``i`` composites), with the
    GI window at ``offset``; ``net``: the learned upscaler (``upscaler.load``)
    of the post stage ``"net"``.  Returns ``{"gi": the words after the
    frame, "color", "motion", "depth": (H, W, ...) at render size after the
    composite and the expand, "image": the displayed image, "state": the
    post stage's next state, "addend": the addend carried on}``."""
    if upscaler not in POST_STAGES:
        raise ValueError(f"post stage {upscaler!r}: not one of "
                         f"{POST_STAGES}")
    w, r = world, ecfg.render
    phase = frame_phase(i, rate)
    if include_gi and i % gi_cadence == 0:
        gi = gi_update.update_gi(gi, w.bits, w.sdf, w.atlas, ecfg, i, offset,
                                 sky_y=w.sky_y, table=w.trace_table,
                                 lowp=lowp)
    res = pipeline.render_frame(
        w.bits, w.sdf, gi, w.atlas, cam, ecfg, include_gi=False,
        sky_y=w.sky_y, table=w.trace_table, return_gbuffer=include_gi,
        checker_parity=phase if rate == RATE_CHECKER else None,
        quarter_phase=phase if rate == RATE_QUARTER else None)
    out, gb = res if include_gi else (res, None)
    color = _q(out.color, lowp)
    if include_gi:
        color, addend = _composite(color, gb, gi, w, ecfg, i, rate, phase,
                                   comp_cadence, addend, lowp)
    motion, depth = out.motion, out.depth
    dev = color.device
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
        color, motion, depth = expand(color), expand(motion), expand(depth)
    color, motion, depth = (_q(a, lowp) for a in (color, motion, depth))
    if upscaler == "none":
        image = color
    elif upscaler == "net":
        image = _q(up_ref.upscale(net, color, motion, depth, cam.jitter,
                                  state, lowp_dtype=up_ref.FP8 if lowp
                                  else None), lowp)
        state = image
    else:
        image, state = temporal.temporal_upscale(
            color, motion, depth, cam.jitter, state, valid=valid,
            warp_taps=warp_taps)
        image = _q(image, lowp)
        state = state._replace(history=image)
    return {"gi": gi, "color": color, "motion": motion, "depth": depth,
            "image": image, "state": state, "addend": addend}
