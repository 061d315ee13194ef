"""Headless driver: camera-path flythrough -> PNG frames + stats.

The port of ``rvgrt_tpu/driver/cli.py``, which replaces the reference's
Win32 window, render thread and swap chain (``main.cpp:104-234``) with a
replayable runner: build the world, fly a deterministic camera path, push
each frame to the native sink, print frame-time stats (the title bar's
FrameTimeAverager).  Frames are quantised and reduced on the device; only
the uint8 frame comes to the host.

    python -m rvgrt_tpu_torch.driver.cli --config stage4 --frames 6 --fly \\
        --upscale temporal --out /tmp/fly

It runs on the GPU unless ``--device cpu`` is given.  ``--upscale
temporal`` runs the analytic temporal super-resolution accumulator at 3x
with the 9-phase jitter and the accumulator's default history warp
(``bilinear_shift``, one gather), as the JAX CLI does; the exact 4-tap
warp of kernel K2 (``warp_taps="pallas"``) is ``bench.py``'s, which
``driver/frame_loop.py`` runs.  ``--upscale fresh`` runs the learned
upscaler (``upscale/model.py``) with fresh weights from a seeded generator
(a zero shuffle conv: its first output is the bilinear anchor blended with
the empty history), ``--upscale PATH`` with a checkpoint's
(``model.load_checkpoint``, e.g. ``checkpoints/upscaler_r2.pkl``); its
history is the previous 3x output and the 3x image goes to the sink.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import numpy as np
import torch

from rvgrt_tpu_torch import config as cfg_mod
from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver.engine import Engine
from rvgrt_tpu_torch.scene.camera import InputState
from rvgrt_tpu_torch.utils.timer import FrameTimeAverager

#: the upscalers' display scale
SCALE = 3

CONFIGS = {
    "stage1": cfg_mod.config_stage1,
    "stage2": cfg_mod.config_stage2,
    "stage3": cfg_mod.config_stage3,
    "stage4": cfg_mod.config_stage4,
    "stage5": cfg_mod.config_stage5,
    "reference": cfg_mod.config_reference,
}


def tiny_config() -> EngineConfig:
    return EngineConfig(world=WorldConfig().with_cube(6),
                        render=dataclasses.replace(
                            RenderConfig(), width=160, height=96))


def _unpack_x(words: np.ndarray) -> np.ndarray:
    """(..., W) uint32 -> (..., W*32) bool, x fastest (``pack_bits_x``)."""
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], -1).astype(bool)


def _planes(eng: Engine) -> np.ndarray:
    cfg = eng.ecfg.world
    return u32.to_numpy(eng.world.bits).reshape(cfg.size_z, cfg.size_y,
                                                cfg.size_x // 32)


def find_interesting_column(eng: Engine):
    """(x, z, top_y) of a tall-terrain column - a view with actual content.

    Columns must leave sky headroom (top <= size_y - 10, so the spawn is
    not clamped inside rock) and are scored with an interior-margin bonus:
    a spawn on the world's rim can look straight out of the grid."""
    cfg = eng.ecfg.world
    bits_np = _planes(eng)
    # subsample columns for speed
    zs = np.arange(0, cfg.size_z, max(1, cfg.size_z // 64))
    best = (cfg.size_x // 2, cfg.size_z // 2, 30.0)
    best_score = -1e9
    max_top = cfg.size_y - 10
    xs = np.arange(cfg.size_x)
    for z in zs:
        plane = _unpack_x(bits_np[z])  # (Y, X)
        heights = (cfg.size_y - 1
                   - np.argmax(plane[::-1], axis=0)) * plane.any(axis=0)
        edge = np.minimum.reduce([
            xs, cfg.size_x - 1 - xs,
            np.full_like(xs, min(z, cfg.size_z - 1 - int(z)))])
        margin = np.minimum(edge / max(cfg.size_x, 1), 0.15)
        score = np.where(heights <= max_top, heights + 100.0 * margin, -1e9)
        x = int(score.argmax())
        if score[x] > best_score and heights[x] > 30:
            best_score = float(score[x])
            best = (x, int(z), float(heights[x]))
    return best


def spawn_above_terrain(eng: Engine, x: int | None = None,
                        z: int | None = None, clearance: float = 8.0):
    """Place the character in air above the terrain column at (x, z);
    defaults to a tall-terrain column, looking toward the world's
    centre."""
    cfg = eng.ecfg.world
    if x is None or z is None:
        x, z, top = find_interesting_column(eng)
    else:
        col = _unpack_x(_planes(eng)[z])[:, x]  # (Y,) bools
        solid_ys = np.where(col)[0]
        top = float(solid_ys.max()) if len(solid_ys) else 30.0
    y = min(top + clearance, cfg.size_y - 2.0)
    eng.character.position = np.array([x, y, z], np.float32)
    eng.character.pitch = -math.pi - 0.5
    # dir_from_sphere gives the horizontal direction cos(pitch) * (-sin
    # yaw, cos yaw) with cos(pitch) < 0 over the legal pitch band, so
    # yaw = atan2(-dx, dz) aims at the centre
    dx_c = cfg.size_x / 2.0 - x
    dz_c = cfg.size_z / 2.0 - z
    if abs(dx_c) + abs(dz_c) > 1e-3:
        eng.character.yaw = math.atan2(-dx_c, dz_c)
    return eng.character.position


def to_u8(color: torch.Tensor) -> torch.Tensor:
    """[0, 1] float colour -> uint8, truncating, on the colour's device."""
    return (torch.clamp(color, 0, 1) * 255).to(torch.uint8)


def main(argv=None) -> dict:
    """Run the flythrough; returns its stats (build and frame times, frames
    written)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="tiny",
                   choices=list(CONFIGS) + ["tiny"])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="frame output directory, or a .mp4/.avi path for "
                        "the native MJPEG video sink")
    p.add_argument("--fps", type=float, default=30.0,
                   help="video timestamp rate for --out video files")
    p.add_argument("--no-gi", action="store_true")
    p.add_argument("--fly", action="store_true",
                   help="move forward + turn during the path")
    p.add_argument("--upscale", default=None, metavar="MODE",
                   help="'temporal': the analytic temporal super-resolution "
                        "accumulator at 3x (upscale/temporal.py); 'fresh' or "
                        "a params path: the learned 3x upscaler "
                        "(upscale/model.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs every "
                        "kernel's plain PyTorch version)")
    args = p.parse_args(argv)

    ecfg = tiny_config() if args.config == "tiny" else CONFIGS[args.config]()
    dev = torch.device(args.device)
    phase_s = {}
    t0 = time.perf_counter()
    eng = Engine(ecfg, include_gi=not args.no_gi, device=dev,
                 phase_times=phase_s)
    build_s = time.perf_counter() - t0
    print(f"world ready in {build_s:.1f}s", file=sys.stderr)
    spawn = spawn_above_terrain(eng)
    print(f"spawn at {spawn}", file=sys.stderr)

    video = args.out and args.out.lower().endswith((".mp4", ".avi"))
    sink = vsink = None  # the video sink's size depends on --upscale
    if args.out and not video:
        from rvgrt_tpu_torch.driver.framesink import FrameSink

        sink = FrameSink(args.out)
    avg = FrameTimeAverager()
    t_state = net = history = None
    if args.upscale == "temporal":
        from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
        from rvgrt_tpu_torch.upscale import temporal

        # full display-phase coverage for the accumulator (the reference's
        # 8-phase table misses 2 of the 9 phases of a 3x upscale)
        eng.character.jitter_sequence = phase_jitter_sequence(SCALE)
        t_state = temporal.init_state(ecfg.render.height, ecfg.render.width,
                                      scale=SCALE, device=dev)
    elif args.upscale:
        from rvgrt_tpu_torch.upscale import model as up_model

        if args.upscale == "fresh":
            net = up_model.init_params(
                ecfg.render.height, ecfg.render.width,
                generator=torch.Generator().manual_seed(0), device=dev)
        else:
            net = up_model.load_checkpoint(args.upscale, device=dev)
        history = torch.zeros(ecfg.render.height * SCALE,
                              ecfg.render.width * SCALE, 3,
                              dtype=torch.float32, device=dev)

    frame_ms = []
    for i in range(args.frames):
        t_frame = time.perf_counter()
        inputs = InputState(move_z=1.0 if args.fly else 0.0,
                            mouse_dx=2.0 if args.fly else 0.0)
        out = eng.step(inputs)
        if t_state is not None:
            jitter = torch.tensor(eng.character.ray_jitter_ndc(),
                                  dtype=torch.float32, device=dev)
            hi, t_state = temporal.temporal_upscale(
                out.color, out.motion, out.depth, jitter, t_state)
            img = to_u8(hi).cpu().numpy()
        elif net is not None:
            jitter = torch.tensor(eng.character.ray_jitter_ndc(),
                                  dtype=torch.float32, device=dev)
            history, _ = up_model.upscale(net, out.color, out.motion,
                                          out.depth, jitter, history)
            img = to_u8(history).cpu().numpy()
        else:
            img = to_u8(out.color).cpu().numpy()
        hit = float((out.depth < 1).float().mean())
        frame_ms.append((time.perf_counter() - t_frame) * 1e3)
        ms = avg.tick()
        if sink is not None:
            sink.push(img, i)
        elif video:
            if vsink is None:
                from rvgrt_tpu_torch.driver.videosink import VideoSink

                vsink = VideoSink(args.out, img.shape[1], img.shape[0],
                                  fps=args.fps)
            vsink.push(img)
        print(f"frame {i}: {ms:.1f} ms avg, hit {hit:.2f}", file=sys.stderr)
    written = dropped = 0
    if sink is not None:
        sink.flush()
        written, dropped = sink.written, sink.dropped
        sink.close()
        print(f"wrote {written} frames to {args.out} (dropped {dropped})",
              file=sys.stderr)
    if vsink is not None:
        written, dropped = vsink.frames, vsink.dropped
        vsink.close()
        print(f"wrote {written} video frames to {args.out} (dropped "
              f"{dropped})", file=sys.stderr)
    print(f"avg frame time {avg.average_ms:.1f} ms ({avg.fps:.1f} FPS)",
          file=sys.stderr)
    return dict(build_s=build_s, phase_s=phase_s, frame_ms=frame_ms,
                avg_ms=avg.average_ms, written=written, dropped=dropped,
                spawn=[float(v) for v in spawn])


if __name__ == "__main__":
    main()
