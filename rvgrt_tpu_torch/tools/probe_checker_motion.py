"""Rate-tier-under-motion quality probe: what the checkerboard, quarter and
motion-adaptive tiers cost in delivered quality against SSAA truth.

The port of ``scripts/probe_checker_motion.py`` (VERDICT r3 #7, r4 #1), with
the same flags and defaults and one more, ``--warp``.  It replays a
deterministic moving camera and accumulates, closed loop:

* the full-rate pipeline (every pixel traced every frame, GI in the frame),
* one or more rate-cut variants: the 2-phase checkerboard, the 4-phase
  quarter interleave and the motion-ADAPTIVE scheduler
  (``render/scheduler.py``), which picks checker under fast motion and
  quarter when slow or still (``"checker"`` on frame 0), each through its
  own accumulator state: the base frame on the rate-cut grid, the GI
  composite (its addend reused on the frames between composites under
  ``--comp-cadence``; the adaptive variant composites every frame), the
  expand, the valid mask and ``temporal_upscale``,

and, per pose, an SSAA target: ``--ssaa`` renders of the unjittered 3x
pose, jittered from ``np.random.default_rng(1000 + i)``.  A GI window runs
every frame at offset 0 and every variant reads it.  Two engines share one
world: the low one renders with the 9-phase jitter, the high one (3x,
``use_jitter = False``) follows its pose.

It reports per frame and over the moving tail (frames ``--warm`` on):
variant-vs-full PSNR (agreement), full-vs-truth and variant-vs-truth PSNR
(what the rate cut costs in delivered quality), and the adaptive tier mix.

Motion scripts: ``pan`` (fly forward + fast pan, then a strafe leg: every
frame is fast) and ``mixed`` (thirds of fast pan, slow look, near-static
dwell: the adaptive scheduler's home turf).  ``--warp`` picks the
accumulator's history taps: ``bilinear_shift`` (the script's, the
accumulator's default) or ``pallas``, kernel K2, as ``bench.py`` runs the
headline.

Usage (the default device is the GPU; ``--device cpu`` runs the plain
PyTorch path):

    python -m rvgrt_tpu_torch.tools.probe_checker_motion [--cube 7] \\
        [--frames 24] [--mode checker|quarter|adaptive|all] \\
        [--script pan|mixed] [--warp bilinear_shift|pallas]

``main`` prints the script's lines, then one JSON line (the tail means, the
tier mix, the peak device memory and the seconds of the SSAA renders) and
returns that report with the per-frame records.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from rvgrt_tpu_torch.render.scheduler import (RATE_FULL, RATE_QUARTER,
                                              AdaptiveRateScheduler)
from rvgrt_tpu_torch.scene.camera import InputState

#: the rate-cut variants of ``--mode all``, in the script's order
VARIANTS = ("checker", "quarter", "adaptive")
#: the SSAA jitters of frame i come from default_rng(SSAA_SEED + i)
SSAA_SEED = 1000
#: the PSNR reported for an MSE under 1e-12 (identical images)
PSNR_CAP = 99.0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cube", type=int, default=7)
    p.add_argument("--low-w", type=int, default=128)
    p.add_argument("--low-h", type=int, default=80)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--warm", type=int, default=6,
                   help="frames excluded from the reported means")
    p.add_argument("--ssaa", type=int, default=4)
    p.add_argument("--gi", action="store_true", default=True)
    p.add_argument("--mode", choices=["checker", "quarter", "adaptive",
                                      "all"], default="checker",
                   help="rate-cut variant(s) to measure against full rate")
    p.add_argument("--script", choices=["pan", "mixed"], default="pan",
                   help="camera motion profile (see module docstring)")
    p.add_argument("--comp-cadence", type=int, default=2,
                   help="GI-composite reuse cadence for the fixed-rate "
                        "variants (1 = composite every frame; adaptive "
                        "always composites every frame)")
    p.add_argument("--warp", choices=["bilinear_shift", "pallas"],
                   default="bilinear_shift",
                   help="the accumulator's history taps (pallas: kernel "
                        "K2, as bench.py's headline)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def inputs_pan(i: int, frames: int) -> InputState:
    """Fly forward + fast pan, then a strafe leg (every frame fast)."""
    if i < frames // 2:
        return InputState(move_z=1.0, mouse_dx=6.0)
    return InputState(move_z=0.6, move_x=1.0, mouse_dx=-4.0)


def inputs_mixed(i: int, frames: int) -> InputState:
    """Thirds: fast pan (checker territory), slow look-around, dwell (the
    velocity decays)."""
    third = max(frames // 3, 1)
    if i < third:
        return InputState(mouse_dx=6.0)
    if i < 2 * third:
        return InputState(mouse_dx=0.5)
    return InputState()


SCRIPTS = {"pan": inputs_pan, "mixed": inputs_mixed}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR of two [0, 1] images from their float32 mean squared error;
    ``PSNR_CAP`` below an MSE of 1e-12."""
    mse = float(torch.mean((a - b) ** 2))
    return PSNR_CAP if mse < 1e-12 else 10.0 * math.log10(1.0 / mse)


def ssaa_jitters(i: int, ssaa: int, width: int, height: int) -> list:
    """Frame ``i``'s SSAA jitters in NDC of a ``width x height`` (3x)
    render: ``max(ssaa, 1)`` draws of ``default_rng(1000 + i).random(2) -
    0.5`` pixels, or one unjittered render when ``ssaa`` <= 1."""
    if ssaa <= 1:
        return [(0.0, 0.0)]
    rng = np.random.default_rng(SSAA_SEED + i)
    out = []
    for _ in range(ssaa):
        jx, jy = rng.random(2) - 0.5
        out.append((2.0 * jx / width, 2.0 * jy / height))
    return out


class Variant:
    """A rate-cut variant's accumulator state, carried GI addend and
    scheduler (the adaptive one only)."""

    def __init__(self, name: str, width: int, height: int, device):
        from rvgrt_tpu_torch.upscale import temporal

        self.name = name
        self.state = temporal.init_state(height, width, device=device)
        self.addend = None
        self.sched = (AdaptiveRateScheduler(width, height)
                      if name == "adaptive" else None)

    def rate_for(self, prev_cam, cam) -> str:
        """The fixed variants' own tier; the adaptive one's pick from the
        previous and this camera, ``"checker"`` on the first frame."""
        if self.sched is None:
            return self.name
        if prev_cam is None:
            return "checker"
        return self.sched.step(prev_cam, cam)


class FrameRecord(NamedTuple):
    frame: int
    pose: tuple            # (pos, forward) of the low camera, numpy
    full_vs_truth: float
    tiers: dict            # {variant: rate}
    vs_full: dict          # {variant: dB}
    vs_truth: dict         # {variant: dB}
    frame_s: float         # host seconds of the GI window, the full-rate
    ssaa_s: float          # frame and the variants; of the SSAA target
    images: dict | None    # {"full", "target", variant: image} if kept


def make_engines(ecfg, include_gi: bool, device, world=None):
    """The low engine (``ecfg``, 9-phase jitter, spawned above the terrain)
    and the 3x engine on the same world (no jitter, at the same pose).
    ``world``: an existing world for the low engine in place of a build."""
    from rvgrt_tpu_torch.driver.cli import spawn_above_terrain
    from rvgrt_tpu_torch.driver.engine import Engine
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
    from rvgrt_tpu_torch.upscale import model as up_model

    s = up_model.SCALE
    r = ecfg.render
    hi_cfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        r, width=r.width * s, height=r.height * s))
    lo = Engine(ecfg, include_gi=include_gi, verbose=False, device=device,
                world=world)
    hi = Engine(hi_cfg, include_gi=include_gi, verbose=False, device=device,
                world=lo.world)
    hi.character.use_jitter = False
    lo.character.jitter_sequence = phase_jitter_sequence(3)
    spawn = spawn_above_terrain(lo)
    hi.character.position = spawn.copy()
    return lo, hi


def _variant_frame(v: Variant, i: int, cam, gi, rate: str, par: int,
                   lo, include_gi: bool, comp_cadence: int,
                   warp_taps: str) -> torch.Tensor:
    """One frame of a variant at ``rate``: updates ``v.state`` (and the
    carried addend), returns its 3x image."""
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.upscale import temporal

    w, ecfg = lo.world, lo.ecfg
    h_lo, w_lo = ecfg.render.height, ecfg.render.width
    if rate == RATE_FULL:
        out = pipeline.render_frame(
            w.bits, w.sdf, gi, w.atlas, cam, ecfg, include_gi=include_gi,
            gi_occ=w.gi_occ, sky_y=w.sky_y, table=w.trace_table)
        img, v.state = temporal.temporal_upscale(
            out.color, out.motion, out.depth, cam.jitter, v.state,
            warp_taps=warp_taps)
        return img
    quarter = rate == RATE_QUARTER
    r = pipeline.render_frame(
        w.bits, w.sdf, gi, w.atlas, cam, ecfg, include_gi=False,
        sky_y=w.sky_y, table=w.trace_table, return_gbuffer=include_gi,
        quarter_phase=par if quarter else None,
        checker_parity=None if quarter else par)
    half, gb = r if include_gi else (r, None)
    if include_gi:
        if (v.sched is not None or i % comp_cadence == 0
                or v.addend is None):
            col, v.addend = pipeline.gi_composite(
                half.color, gb, gi, w.sdf, ecfg, gi_occ=w.gi_occ,
                return_addend=True)
        else:
            col = torch.clamp(half.color + v.addend, 0.0, 1.0)
        half = half._replace(color=col)
    dev = half.color.device
    if quarter:
        ex = pipeline.quarter_expand
        valid = pipeline.quarter_valid_mask(h_lo, w_lo, par, device=dev)
    else:
        def ex(a):
            return pipeline.checker_expand(a, par)
        valid = pipeline.checker_valid_mask(h_lo, w_lo, par, device=dev)
    img, v.state = temporal.temporal_upscale(
        ex(half.color), ex(half.motion), ex(half.depth), cam.jitter,
        v.state, valid=valid, warp_taps=warp_taps)
    return img


def run_frames(lo, hi, frames: int, script: str, variants, ssaa: int,
               comp_cadence: int, include_gi: bool = True,
               warp_taps: str = "bilinear_shift", keep_images: bool = False,
               log=None) -> list:
    """The probe's frame loop (the script's ``main`` loop) over ``frames``
    poses of the motion ``script``: per frame the GI window at offset 0,
    the full-rate frame and its accumulator, each variant of ``variants``
    at its tier, and the SSAA target.  Returns a ``FrameRecord`` a frame
    (with its images when ``keep_images``); ``log`` gets the script's
    line for each frame."""
    from rvgrt_tpu_torch.driver.engine import camera_arrays
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.upscale import temporal

    world, ecfg = lo.world, lo.ecfg
    dev = world.bits.device
    h_lo, w_lo = ecfg.render.height, ecfg.render.width
    inputs = SCRIPTS[script]
    vs = [Variant(n, w_lo, h_lo, dev) for n in variants]
    st_full = temporal.init_state(h_lo, w_lo, device=dev)
    gi = world.gi
    prev_cam = None
    records = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for i in range(frames):
        t0 = time.perf_counter()
        lo.character.update(inputs(i, frames), 1.0 / 60.0, i)
        ch, hc = lo.character, hi.character
        hc.position = ch.position.copy()
        hc.yaw, hc.pitch = ch.yaw, ch.pitch
        hc.velocity = ch.velocity.copy()
        hc.update(InputState(), 0.0, i)
        cam_obj = ch.camera
        cam = camera_arrays(cam_obj, ch.unjittered_view_projection,
                            ch.prev_unjittered_view_projection,
                            ch.ray_jitter_ndc(), i / 60.0, device=dev)
        if include_gi:
            gi = gi_update.update_gi(gi, world.bits, world.sdf, world.atlas,
                                     ecfg, i, 0, sky_y=world.sky_y,
                                     table=world.trace_table)
        full = pipeline.render_frame(
            world.bits, world.sdf, gi, world.atlas, cam, ecfg,
            include_gi=include_gi, gi_occ=world.gi_occ, sky_y=world.sky_y,
            table=world.trace_table)
        out_full, st_full = temporal.temporal_upscale(
            full.color, full.motion, full.depth, cam.jitter, st_full,
            warp_taps=warp_taps)
        outs, tiers = {}, {}
        for v in vs:
            rate = tiers[v.name] = v.rate_for(prev_cam, cam_obj)
            par = (pipeline.QUARTER_PHASE_ORDER[i & 3]
                   if rate == RATE_QUARTER else i & 1)
            outs[v.name] = _variant_frame(v, i, cam, gi, rate, par, lo,
                                          include_gi, comp_cadence,
                                          warp_taps)
        prev_cam = dataclasses.replace(cam_obj, pos=cam_obj.pos.copy(),
                                       forward=cam_obj.forward.copy())
        sync()
        t1 = time.perf_counter()

        # the SSAA target at the unjittered 3x pose
        acc = None
        for jitter in ssaa_jitters(i, ssaa, hi.ecfg.render.width,
                                   hi.ecfg.render.height):
            jcam = camera_arrays(hc.camera, hc.unjittered_view_projection,
                                 hc.prev_unjittered_view_projection,
                                 jitter, i / 60.0, device=dev)
            img = pipeline.render_frame(
                world.bits, world.sdf, gi, world.atlas, jcam, hi.ecfg,
                include_gi=include_gi, gi_occ=world.gi_occ,
                sky_y=world.sky_y, table=world.trace_table).color
            acc = img if acc is None else acc + img
        target = acc / max(ssaa, 1)
        sync()
        t2 = time.perf_counter()

        pf = psnr(out_full, target)
        vs_full = {n: psnr(out_full, img) for n, img in outs.items()}
        vs_truth = {n: psnr(img, target) for n, img in outs.items()}
        images = None
        if keep_images:
            images = dict(outs, full=out_full, target=target)
        records.append(FrameRecord(
            frame=i, pose=(cam_obj.pos.copy(), cam_obj.forward.copy()),
            full_vs_truth=pf, tiers=tiers, vs_full=vs_full,
            vs_truth=vs_truth, frame_s=t1 - t0, ssaa_s=t2 - t1,
            images=images))
        if log is not None:
            line = f"frame {i}: full-vs-truth {pf:.2f}"
            for n in outs:
                line += (f" | {n}[{tiers[n][0]}] vs-full {vs_full[n]:.2f}"
                         f" vs-truth {vs_truth[n]:.2f}")
            log(line)
    return records


def tail_summary(records: list, variants, warm: int) -> dict:
    """The moving tail's means (frames ``warm`` on): full-vs-truth, and per
    variant vs-full, vs-truth, the cost (full-vs-truth minus vs-truth) and,
    for the adaptive one, the tier mix over every frame after the first."""
    tail = [r for r in records if r.frame >= warm]
    full = statistics.fmean(r.full_vs_truth for r in tail)
    out = {"full_vs_truth_db": full, "variants": {}}
    for n in variants:
        truth = statistics.fmean(r.vs_truth[n] for r in tail)
        rep = dict(vs_full_db=statistics.fmean(r.vs_full[n] for r in tail),
                   vs_truth_db=truth, cost_db=full - truth)
        if n == "adaptive":
            rep["tiers"] = dict(sorted(Counter(
                r.tiers[n] for r in records[1:]).items()))
        out["variants"][n] = rep
    return out


def main(argv=None, ecfg=None, world=None, keep_images: bool = False
         ) -> dict:
    """Run the probe.  ``ecfg``: render at this EngineConfig in place of
    the script's (``--cube``, ``--low-w`` / ``--low-h`` and
    ``RenderConfig()``'s defaults), e.g. ``bench.headline_config``'s;
    ``world``: an existing world of that config in place of a build.
    Returns the JSON line's report plus ``records`` (``FrameRecord``s)."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
    from rvgrt_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    if args.frames <= args.warm:
        raise ValueError(f"--frames {args.frames} leaves no frame after "
                         f"--warm {args.warm}")
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"device={dev} ({name})", flush=True)
    if ecfg is None:
        ecfg = EngineConfig(
            world=WorldConfig().with_cube(args.cube),
            render=dataclasses.replace(RenderConfig(), width=args.low_w,
                                       height=args.low_h))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lo, hi = make_engines(ecfg, args.gi, dev, world=world)
    build_s = time.perf_counter() - t0
    variants = VARIANTS if args.mode == "all" else (args.mode,)
    t0 = time.perf_counter()
    records = run_frames(lo, hi, args.frames, args.script, variants,
                         args.ssaa, args.comp_cadence, include_gi=args.gi,
                         warp_taps=args.warp, keep_images=keep_images,
                         log=lambda s: print(s, flush=True))
    loop_s = time.perf_counter() - t0
    summ = tail_summary(records, variants, args.warm)
    print(f"\n== moving tail (frames {args.warm}..{args.frames - 1}, "
          f"script={args.script}, {loop_s:.0f}s) ==")
    print(f"full-vs-truth:    {summ['full_vs_truth_db']:.2f} dB")
    for n, v in summ["variants"].items():
        mix = ""
        if "tiers" in v and v["tiers"]:
            mix = "  tiers=" + ",".join(f"{k}:{c}"
                                        for k, c in v["tiers"].items())
        print(f"{n}: vs-full {v['vs_full_db']:.2f} dB, vs-truth "
              f"{v['vs_truth_db']:.2f} dB (cost {v['cost_db']:+.2f} dB)"
              + mix)
    r = ecfg.render
    report = dict(
        tool="probe_checker_motion", device=name,
        world=f"{ecfg.world.size_x}x{ecfg.world.size_y}x"
              f"{ecfg.world.size_z}",
        render=f"{r.width}x{r.height} -> {hi.ecfg.render.width}x"
               f"{hi.ecfg.render.height}",
        script=args.script, mode=args.mode, frames=args.frames,
        warm=args.warm, ssaa=args.ssaa, comp_cadence=args.comp_cadence,
        warp=args.warp, **summ,
        per_frame=[dict(frame=rec.frame, tiers=rec.tiers,
                        full_vs_truth=rec.full_vs_truth,
                        vs_full=rec.vs_full, vs_truth=rec.vs_truth)
                   for rec in records],
        build_s=build_s, loop_s=loop_s,
        frame_s=statistics.median(rec.frame_s for rec in records),
        ssaa_s=statistics.median(rec.ssaa_s for rec in records),
        peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
        else None)
    print(json.dumps(report), flush=True)
    report["records"] = records
    return report


if __name__ == "__main__":
    main()
