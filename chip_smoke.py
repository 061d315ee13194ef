#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rvgrt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rvgrt_tpu_torch/csrc/`` into
``rvgrt_tpu_torch/_build/`` and runs these phases in order.  Any failure
ends the run with a traceback and a non-zero exit code, and no result line
is printed.

1. card: the GPU's name and power limit, as nvidia-smi gives them;
2. world build (main path): ``Engine(ecfg)`` at the headline world, 1024^3;
   the SDF's min-plus passes run kernel K3;
3. headline (main path): ``bench.py``'s frames, through
   ``driver/frame_loop.py``: 2 warm-up and 12 timed frames along its
   interactive path (thirds of fast pan, slow look and dwell), each at the
   rate the motion-adaptive scheduler picks (checkerboard or quarter; the
   mix {checker 4, quarter 8} is asserted), a GI window every 2nd frame with
   the two-phase straggler respite (budget 12), the base frame with its
   G-buffer at 1280x800 on the rate-cut grid, the GI composite, the expand
   and ``temporal_upscale(valid=..., warp_taps="pallas")`` to 3840x2400.
   Every trace is one launch of K1 (a two-phase trace two, one a phase)
   with no host read inside it; the history warp is K2;
4. config-4 (main path): the same loop at 1920x1080 native on the same
   world, temporal reconstruction at scale 1, 2 warm-up and 6 timed frames;
4b. the entry point (main path; ``phase_bench``): ``python3 -m
   rvgrt_tpu_torch.bench``, the port of ``bench.py``, as a user runs it with
   every ``BENCH_*`` knob at its default, in a process of its own: its own
   1024^3 world, 2 + 32 headline frames along the interactive path and 16
   config-4 frames, its one JSON line held to bench.py's keys, the tier mix
   {checker 10, quarter 22}, the 406 768 rays a frame of its accounting, no
   straggler overflow, a hit share in (0, 1] and fps > 0; then its
   ``run_point`` in this process on this world at ``BENCH_CHECKER=4
   BENCH_GI_CADENCE=1 BENCH_CONFIG4_RATE=0`` (2 + 8 headline frames, all at
   quarter rate with a GI window each, K1 and K2 once a frame; 2 + 4
   config-4 frames at full rate, native, no K2);
5. full rate (main path): the viewer's path, ``Engine.step`` +
   ``temporal_upscale``, 2 warm-up and 4 timed frames;
5b. post modes (main paths): ``bench.py``'s other post stages on the same
   world and pose (``POST_MODES``), 2 warm-up and 6 timed frames each at
   1280x800: ``"net"``, the learned upscaler from ``checkpoints/
   upscaler.pkl`` (up-l) to 3840x2400, and ``"residual"``, the accumulator
   with the learned residual head from ``checkpoints/residual_head.pkl``,
   both at full rate along the pan path as bench.py runs them; the
   accumulator with ``BENCH_COMP_CADENCE=2`` on the interactive path; and
   ``"none"``, native output.  Each checkpoint is asserted present and
   loaded; per mode the frame median and p90, peak memory and launches (K2
   only under the accumulator), and for the nets their device time by part
   (history warp, conv stack, display-resolution tail) beside their convs'
   FLOP bound at the dense bf16 peak.  Then the world checkpoint's round
   trip (``save_world`` + ``load_world``, bit for bit, timed) of the 1024^3
   world; and the CLI with
   ``--config tiny --frames 4 --upscale checkpoints/upscaler_r2.pkl``
   (3x PNGs, K1 launches == traces, no K2);
5c. training (main paths): the residual head's trainer,
   ``python -m rvgrt_tpu_torch.tools.train_residual`` at its documented
   usage (``--cube 8 --low-w 128 --low-h 96 --ssaa 4 --gi``) with frames and
   steps cut (``--frames 24 --eval-frames 12 --steps 50``, documented 72 and
   800): the pair renders (low-res, 3x and 4 SSAA renders a frame through
   K1 on a 256^3 world built with K3 and the traced GI init, the two
   engines sharing it), the accumulation, the steps, the held-out
   evaluation (head against accumulator) and the checkpoint read back bit
   for bit; then ``python -m rvgrt_tpu_torch.upscale.train --variant up-l
   --cube 8 --frames 36 --steps 20`` (the closed loop; 36 frames, as the
   trainer holds out the last two 12-frame segments).  K1 launches ==
   traces, no K2, losses finite and falling.  Not counted: one up-l
   ``train_step`` and one residual-head step at 1280x800 -> 3840x2400
   (median of 5 after 2 warm-ups, peak memory, the conv kernels' device
   time beside the step's conv FLOP bound at the dense bf16 peak), and a
   float32 step of up-s and of the head at the CPU tests' size on the card
   against the CPU (TF32 off: losses rtol 1e-4, gradients within 1e-5 x
   their max; bf16 losses rtol 1e-2);
5d. render switches (main paths; ``phase_switches``, on the 1024^3 world
   at 1280x800 -> 3840x2400): slim carry (``BENCH_SLIM=1``): bench.py's
   loop, 2 + 6 frames, K1 launches == traces; K1's slim variant bit for bit
   against the slim plain loop on the checkerboard primary trace (512 000
   lanes, with its times and bound) and on a GI window's two respite
   phases, and graph-timed against the carried variant in alternating
   rounds.  The fused cone table (``gi_fused_cone``): the loop, 2 + 6
   frames; a GI frame and one without under ``torch.profiler`` with the
   flag on and off (device launches and busy time a frame); one 64^3 frame on the card
   against the CPU's plain path (>= 50 dB, the occlusion mip bit for bit).
   The temporal start hints: a frame, then the next one hinted from its
   prepass (``temporal_hints_from_prepass``) against the same frame
   unhinted (hits within n/1000, >= 50 dB; the hits that ``sky_start``
   flips are counted, not held).  The PNG atlas: a 64^3 world
   built with ``REFERENCE_PNG`` pointing at a PNG the script writes (every
   row filter), its atlas ``load_png``'s, and a headline base frame with
   it.  The viewer (``driver/viewer.py``) over an ``Engine`` on the 1024^3
   world: three MJPEG parts and one input POST through urllib, the server
   stopped.  ``utils/profiling.device_time_ms`` on one frame beside its
   CUDA-event time;
5e. parallel (main paths; ``phase_parallel``, the port of
   ``rvgrt_tpu/parallel/`` on ``torch.distributed``).  K1's ZEDGES
   instantiations (carried and slim) on the headline's primary rays at
   the 1024^3 world cut into 4 z-slabs: slab 2, where the camera sits,
   with z_edges (False, False), and slab 0 with (True, False), each bit
   for bit against the plain loop on the 11 state arrays, ``steps`` and
   ``exit_dir``, lanes leaving through both interior faces, with graph
   times and bounds.  Phase A, over a 1-rank NCCL group at the headline:
   6 frames of ``render_frame_sharded`` (bit for bit against
   ``render_slab`` at full height), ``update_gi_sharded`` every 2nd frame
   (the words against ``update_gi``) and ``temporal_upscale_sharded(
   warp_taps="pallas")`` (against ``temporal_upscale``), each timed beside
   the unsharded call; ``trace_volume_sharded`` of the 1 024 000 primary
   rays, carried and slim (each bit for bit against ``trace``), and
   ``render_frame_volume``
   (PSNR > 30 dB, under 3 % of pixels off by more than 0.02).  Phase B:
   four processes on the one card in a gloo group (NCCL takes one rank a
   GPU; packets go through host memory, ``"transport": "gloo-host"``):
   the ring trace of the primary rays over 4 z-slabs of the 1024^3 world
   against the single-device trace (``tests/test_volume.py``'s
   thresholds), a bounded ring (65 536 rays a packet) bit-equal to the
   unbounded one, and ``render_frame_volume`` on a 256^3 world at 320x200
   (the frame gate above); the rounds, handoffs and packet bytes of each
   round and rank;
6. traced GI init (main path): ``config_stage4``'s GI init on the same
   world (stage 4's): one sun-shadow ray per GI cell through K1, at stride
   (1, 1) all 2^24 cells in one trace and at (2, 2) 2^22, each timed; K1 on
   the 2^24-lane trace against its plain loop (bit for bit, with its graph
   time and count-once bound), and the init's words against those of the
   plain path;
7. CLI (main path): ``python -m rvgrt_tpu_torch.driver.cli --config stage4
   --frames 6 --fly --upscale temporal --out <tmp>`` through ``cli.main``:
   a second 1024^3 world with the traced init, ``Engine.step`` frames at
   1920x1080, the 3x upscale to 5760x3240 with the accumulator's default
   taps (as the JAX CLI; no K2), and the native PNG sink (built
   with g++); 6 PNGs written, K1 launches == traces;
8. respite cost: one GI window with straggler budget 12 and with 0, timed
   as the main path pays for it (CUDA events around ``update_gi``);
9. reference: on a 64^3 world at 128x80, on the GPU and on the CPU (where
   every kernel is its plain PyTorch version, which the CPU test suite holds
   against the JAX package): the full-rate path for 3 frames and the frame
   loop for 6 (checkerboard and quarter frames, 16 384-cell GI windows that
   engage the respite); the frame loop for 4 on the non-cube 256x128x256
   world (``NONCUBE_SHIFTS``); and each post mode of phase 5b for 4;
   worlds and GI words bit-exact, >= 50 dB and exact hit classification on
   every base and output frame;
10. gather probe (main path): ``tools/probe_r7.py``, P1 and P2 from tables
   of 2-100 MiB and the library gather beside them, each kernel bit for bit
   against its plain version, also with each L2 cache-policy hint taken
   out and, at the 2 MiB rung, as the on-chip variant (the table in a
   16-CTA cluster's shared memory); the card's shared-memory and L2
   limits; then the edge cases (``probe_r7.edge_checks``, not counted):
   lanes 1-7 past a multiple of 8, an index view 4 B off, indices below 0
   and at n and beyond, P2 with 7 columns, and tables one word under, at
   and over the on-chip variant's threshold, each bit for bit;
11. kernels: K1, K2 and K3 against their plain versions on the inputs the
   main path gives them, with their times, the least time the card could
   take (``bound_ms``, from this run's data) and the main path's launch
   counts.  K1 on the checkerboard primary trace (superstep by superstep,
   and whole in one launch; its row's times and bound), the quarter primary
   trace, a GI window's respite phase 1 (budget 12) and phase 2, config-4's
   checkerboard and quarter primary traces and the full-rate path's primary
   trace, each bit-exact and graph-timed (and the GI init's, phase 6; the
   slim variant's, phase 5d; the ZEDGES variants', phase 5e); K2 at the
   headline's (2400, 3840),
   config-4's (1080, 1920) and the CLI's (3240, 5760) histories (the last
   by a direct call on the CLI's state); K3 at the world build's four passes.  P1's and
   P2's rows are phase 10's, at the 100 MiB table;
12. the big worlds (main path; ``phase_big_world``, also run alone by
   ``python3 -m rvgrt_tpu_torch.tools.big_world``), each alone on the card
   once the 1024^3 engines are freed: the reference's own 4096x512x4096
   world (bench.py's ``BENCH_REF_WORLD=1``) and the 2048^3 world
   (``BENCH_CUBE=11``), each 2^33 voxels.  The build (wall time, phase
   times, each phase's peak memory, under 80 GB); K3 bit for bit at its
   four passes (2^30 coarse cells, and the far mip); for the reference
   world the reference's traced GI init, eight 2^24-lane K1 traces, timed
   whole and per trace, one slice held against the plain loop; bench.py's
   frames (2 warm-up and 6 timed; the tier mix, K1 launches == traces, the
   262 144-cell GI window with its respite); K1 bit for bit on the
   checkerboard primary trace (with its bound) and on a GI window's respite
   phases; the image and a non-zero hit share.  Their K1 traces and K3
   passes join the kernel line's rows.

Launch accounting: ``wavefront.stats["traces"]`` counts each phase of a
two-phase trace as a trace, so on every path K1 launches == traces.
Every launch counter is set to 0 just before each main-path phase and read
just after it, so the launches of the checks are not counted; the kernel
line sums each kernel's launches over the build, the three frame paths, the
entry point's in-process points (the command's own process is not counted),
the GI init, the post modes, the CLIs, the two trainers' pair renders and world
builds, the render switches' loops, hinted frame and viewer, the probe's
gathers and the big worlds' builds, init and frames.
Times are CUDA-event medians on the card: a kernel's ``ms`` (and the
library call's) is the device time of a CUDA-graph replay of its launches,
``event_ms`` and ``plain_ms`` time the Python call itself, host included,
as the main path pays it.  The last lines are the JSON kernel table,
``{"kernels": [...]}``, and ``{"ok": true, "device": {...}}``.

The options shrink the run for debugging (``--cube 8 --frames 3
--worlds ''``; the CLI phase stays at stage 4); the defaults are the
headline configuration and both big worlds.
``--profile N`` adds, at the end, N headline frames and 2 full-rate
frames, each under its own
``torch.profiler``: per frame its tier, the device's busy time, idle share
and launches, and the kernels that took the most device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# bench.py's operating point, built by the port's entry point; GI_BUDGET is
# its gi_straggler_budget
from rvgrt_tpu_torch.bench import (  # noqa: E402
    GI_BUDGET, headline_config, native_config)

# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# int32: 132 SMs x 64 INT32 lanes x 1.98 GHz (half the FP32 lanes behind
# the 67 TFLOP/s float32 figure, one operation per lane per clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# the 64^3 reference pose
REF_POSE = dict(position=(30.0, 44.0, 60.0), yaw=math.pi + 0.25,
                pitch=-math.pi - 0.18)
WIDTH, HEIGHT = 1280, 800  # headline render resolution; displayed at 3x
C4_WIDTH, C4_HEIGHT = 1920, 1080  # config-4, native


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


#: the non-cube world of the reference phase: x = z = 2 y, as the
#: reference's 4096x512x4096 has x = z > y, with sky above the terrain
NONCUBE_SHIFTS = (8, 7, 8)


def reference_loop_config(shifts=(6, 6, 6)):
    """The frame-loop reference: the headline settings at 128x80 on a world
    of these (x, y, z) shifts (64^3 by default), with ``gi_coarseness=2``
    so that the GI grid (32^3 cells at 64^3) holds 16 384-cell windows,
    enough rays for the respite to engage (4 x 4096)."""
    from rvgrt_tpu_torch.config import WorldConfig

    sx, sy, sz = shifts
    ecfg = headline_config(WorldConfig(shift_x=sx, shift_y=sy, shift_z=sz),
                           128, 80)
    return dataclasses.replace(
        ecfg, world=dataclasses.replace(ecfg.world, gi_coarseness=2),
        gi_rays_per_frame=16384)


#: each kernel's launch counter: (module under rvgrt_tpu_torch.ops, name);
#: K1's also by instantiation (the carried one without z_edges has K1's
#: launches less the other three)
COUNTERS = {"K1": ("superstep_kernel", "launches"),
            "K1_slim": ("superstep_kernel", "slim_launches"),
            "K1_zedges": ("superstep_kernel", "zedges_launches"),
            "K1_zedges_slim": ("superstep_kernel", "zedges_slim_launches"),
            "K2": ("warp_kernels", "launches"),
            "K3": ("sdf_kernels", "launches"),
            "P1": ("gather_kernels", "take_clip_launches"),
            "P2": ("gather_kernels", "take_along_cols_launches")}


def _counter(k: str):
    import importlib

    mod, name = COUNTERS[k]
    return importlib.import_module(f"rvgrt_tpu_torch.ops.{mod}"), name


def reset_counts() -> None:
    from rvgrt_tpu_torch.trace import wavefront

    for k in COUNTERS:
        setattr(*_counter(k), 0)
    wavefront.reset_stats()


def read_counts() -> dict:
    return {k: getattr(*_counter(k)) for k in COUNTERS}


def p90(values) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(math.ceil(0.9 * len(v))) - 1)]


def headline_pose(bits, w) -> dict:
    """bench.py's placement on the world of occupancy words ``bits`` and
    WorldConfig ``w``: 12 voxels above the terrain top of the column at
    x = z = size_x // 2 (bench.py takes both from size_x, which is the
    centre while size_z == size_x), below the world's top, looking down 0.5
    along +x, as a Character pose."""
    import numpy as np

    from rvgrt_tpu_torch.bench import terrain_top

    cx = cz = w.size_x // 2
    cam_y = min(terrain_top(bits, w) + 12.0, w.size_y - 2.0)
    fwd = np.array([0.87, -0.5, 0.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    # Character.direction = (sin(yaw) cos(pitch), -sin(pitch),
    # -cos(yaw) cos(pitch)); pitch in (-pi - pi/2, -pi) looks down
    return dict(position=(float(cx), cam_y, float(cz)), yaw=-math.pi / 2.0,
                pitch=-math.pi - math.asin(float(-fwd[1])))


def make_character(ecfg, pose: dict, upscaler: str = "temporal"):
    """A Character at ``pose`` for ``ecfg``'s render and display sizes,
    with the jitter table bench.py renders with under ``upscaler`` (the
    9-phase one of the temporal accumulator by default)."""
    import numpy as np

    from rvgrt_tpu_torch.driver import frame_loop
    from rvgrt_tpu_torch.scene.camera import Character

    r = ecfg.render
    return Character(display_width=r.display_width,
                     display_height=r.display_height, render_width=r.width,
                     render_height=r.height,
                     position=np.asarray(pose["position"], np.float32),
                     yaw=pose["yaw"], pitch=pose["pitch"],
                     jitter_sequence=frame_loop.jitter_sequence(upscaler))


def expected_mix(frames: int) -> dict:
    """The tiers of ``frames`` timed frames along the interactive path: its
    fast third at checkerboard rate, the slow and dwell thirds at quarter
    rate (bench.py's thresholds: above 1.25 % of the width a frame, with
    hysteresis, and below 0.75 %)."""
    third = max(frames // 3, 1)
    return {"checker": third, "quarter": frames - third}


def run_loop(world, ecfg, pose: dict, frames: int, dev, scale: int,
             time_s: float = 1.0, upscaler: str = "temporal", net=None,
             comp_cadence: int = 1) -> dict:
    """``frame_loop.WARMUP`` + ``frames`` frames of
    ``driver/frame_loop.py`` in the post mode ``upscaler`` (with its
    ``net``) and composite cadence, along bench.py's path for that mode
    from ``pose`` (the interactive path under the temporal accumulator),
    each timed with CUDA events (host included) on a GPU.  Returns the
    loop, the rates, each frame's result and ms."""
    from rvgrt_tpu_torch.driver import frame_loop
    from rvgrt_tpu_torch.utils.timer import Timer

    cams = frame_loop.path_cameras(
        make_character(ecfg, pose, upscaler),
        frame_loop.path_yaws(frames, frame_loop.camera_path(upscaler)),
        time_s=time_s, device=dev)
    rates = frame_loop.rate_schedule([c for c, _ in cams], ecfg,
                                     rates="adaptive"
                                     if frame_loop.adaptive(upscaler)
                                     else "full")
    loop = frame_loop.FrameLoop(world, ecfg, scale=scale, upscaler=upscaler,
                                net=net, comp_cadence=comp_cadence)
    results, ms = [], []
    for i, (_, cam) in enumerate(cams):
        with Timer("frame", verbose=False, device=dev) as t:
            results.append(loop.frame(i, cam, rates[i]))
        ms.append(t.elapsed_ms)
    return dict(loop=loop, cams=cams, rates=rates, results=results, ms=ms)


def loop_report(run: dict, counts: dict, stats: dict) -> dict:
    """Frame times overall, per tier and per GI/no-GI frame over the timed
    frames, the tier mix, and the launches and traces per frame."""
    from rvgrt_tpu_torch.driver.frame_loop import WARMUP

    rates, ms = run["rates"][WARMUP:], run["ms"][WARMUP:]
    gi = [r.gi_ran for r in run["results"]][WARMUP:]
    n = len(run["ms"])

    def summary(vals):
        return {"n": len(vals), "ms_median": statistics.median(vals),
                "ms_p90": p90(vals)}

    tiers = {t: summary([m for m, r in zip(ms, rates) if r == t])
             for t in sorted(set(rates))}
    by_gi = {k: summary([m for m, g in zip(ms, gi) if g == (k == "gi")])
             for k in ("gi", "no_gi") if (k == "gi") in gi}
    loop = run["loop"]
    return {"warmup": WARMUP, "timed": len(ms), "ms_median":
            statistics.median(ms), "ms_p90": p90(ms), "ms_all": run["ms"],
            "rates_all": run["rates"], "tier_mix": {t: v["n"] for t, v in
                                                    tiers.items()},
            "per_tier": tiers, "per_gi": by_gi, "launches": counts,
            "traces": stats["traces"], "respites": stats["respites"],
            "gi_windows": loop.gi_windows,
            "straggler_overflow": int(loop.overflow),
            "k1_launches_per_frame": counts["K1"] / n,
            "k2_launches_per_frame": counts["K2"] / n,
            "traces_per_frame": stats["traces"] / n,
            "supersteps": stats["supersteps"],
            "supersteps_per_trace": stats["supersteps"]
            / max(stats["traces"], 1)}


def check_launches(counts: dict, stats: dict, frames: int,
                   gi_windows: int) -> None:
    """Every K1 launch is a trace (a two-phase trace is two), the GI
    windows' traces ran two-phase (sun and bounce, budget > 0 and enough
    rays at this world), and every frame warped its history once."""
    assert counts["K1"] > 0 and counts["K1"] == stats["traces"], \
        (counts, stats)
    assert counts["K2"] == frames, (counts, frames)
    assert stats["respites"] == 2 * gi_windows, (stats, gi_windows)


def run_full_rate(eng, n: int, dev, state=None, time_s=None):
    """``n`` frames of the viewer's path: Engine.step (every frame at full
    rate, GI every frame), then the 3x temporal upscale through K2.
    Returns (outputs, state, per-frame ms, last frame outputs)."""
    import torch

    from rvgrt_tpu_torch.scene.camera import InputState
    from rvgrt_tpu_torch.upscale import temporal
    from rvgrt_tpu_torch.utils.timer import Timer

    r = eng.ecfg.render
    if state is None:
        state = temporal.init_state(r.height, r.width, device=dev)
    # bench.py's fast pan, 0.05 rad a frame
    pan = InputState(mouse_dx=0.05 / eng.character.sensitivity)
    outs, ms = [], []
    for i in range(n):
        with Timer("frame", verbose=False, device=dev) as t:
            out = eng.step(pan, time_s=None if time_s is None
                           else time_s + i / 60.0)
            jit = torch.tensor(eng.character.ray_jitter_ndc(),
                               dtype=torch.float32, device=dev)
            hi, state = temporal.temporal_upscale(
                out.color, out.motion, out.depth, jit, state,
                warp_taps="pallas")
        ms.append(t.elapsed_ms)
        outs.append(hi)
    return outs, state, ms, out


def profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: (host wall ms, the device's busy
    ms - the sum of its kernels' times: one stream, so they never overlap -,
    device launches, the profiler's device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    assert busy_ms > 0, "the profiler saw no device time"
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels


def profile_frames(eng, pose, dev, n: int, top: int = 15) -> dict:
    """``n`` headline frames (the frame loop from ``pose``) and 2 frames of
    the full-rate path, each under its own ``torch.profiler``: per frame
    the host wall time, the device's busy time, the idle share and the
    device launches; over the loop's frames, the kernels that took the
    most device time."""
    import collections

    from rvgrt_tpu_torch.driver import frame_loop

    ecfg = eng.ecfg
    yaws = frame_loop.path_yaws(max(n - frame_loop.WARMUP, 1))
    cams = frame_loop.path_cameras(make_character(ecfg, pose), yaws,
                                   time_s=1.0, device=dev)
    rates = frame_loop.rate_schedule([c for c, _ in cams], ecfg)
    loop = frame_loop.FrameLoop(eng.world, ecfg, scale=3)
    eng.character = make_character(ecfg, pose)
    busy = collections.Counter()
    calls = collections.Counter()

    def one(fn, what: dict) -> dict:
        wall_ms, busy_ms, launches, kernels = profiled(fn)
        if what["path"] == "loop":
            for e in kernels:
                busy[e.key[:90]] += e.self_device_time_total / 1e3
                calls[e.key[:90]] += e.count
        return dict(what, wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_idle_share=1.0 - busy_ms / wall_ms,
                    device_launches=launches)

    frames = [one(lambda i=i, cam=cam: loop.frame(i, cam, rates[i]),
                  dict(path="loop", rate=rates[i],
                       gi=i % frame_loop.GI_CADENCE == 0))
              for i, (_, cam) in enumerate(cams)]
    frames += [one(lambda: run_full_rate(eng, 1, dev),
                   dict(path="full_rate", rate="full", gi=True))
               for _ in range(2)]
    m = len(cams)
    return {"frames": frames,
            "top": [{"kernel": k, "calls_per_frame": calls[k] / m,
                     "device_ms_per_frame": v / m}
                    for k, v in busy.most_common(top)]}


def check_image(img, shape) -> None:
    import torch

    assert tuple(img.shape) == shape, (tuple(img.shape), shape)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    assert float(img.std()) > 1e-3, "constant image"


def psnr(a, b) -> float:
    mse = float(((a.double().cpu() - b.double().cpu()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def respite_cost(eng, dev, offsets) -> dict:
    """One GI window at each of ``offsets`` with straggler budget 12 and
    with 0, each the median CUDA-event time of ``update_gi`` (host
    included, as the main path pays for it) over 7 calls after 2; and, at
    the first offset, the device's busy time and launches of one call
    under ``torch.profiler``, which split the cost into device and host."""
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.utils.timer import timed_ms

    w = eng.world
    out = {}
    for budget in (GI_BUDGET, 0):
        ec = dataclasses.replace(eng.ecfg, gi_straggler_budget=budget)

        def window(off, ec=ec):
            return gi_update.update_gi(w.gi, w.bits, w.sdf, w.atlas, ec, 0,
                                       off, sky_y=w.sky_y,
                                       table=w.trace_table)

        for off in offsets:
            out[f"budget{budget}_offset{off}_ms"] = timed_ms(
                lambda _: window(off), dev)
        wall, busy, launches, _ = profiled(lambda: window(offsets[0]))
        out[f"budget{budget}_offset{offsets[0]}_profiled"] = dict(
            wall_ms=wall, device_busy_ms=busy, device_launches=launches)
    out["window_cells"] = eng.ecfg.gi_window
    return out


def phase_reference(dev) -> dict:
    """The full-rate path and the frame loop on a 64^3 world at 128x80, and
    the frame loop on the non-cube world, on the GPU and on the CPU."""
    import numpy as np

    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence

    # the full-rate path, 3 frames
    ecfg = headline_config(6, 128, 80)
    runs = {}
    for d in (dev, "cpu"):
        eng = engine.Engine(ecfg, verbose=False, device=d)
        eng.character.jitter_sequence = phase_jitter_sequence(3)
        eng.character.position = np.asarray(REF_POSE["position"], np.float32)
        eng.character.yaw = REF_POSE["yaw"]
        eng.character.pitch = REF_POSE["pitch"]
        outs, _, _, last = run_full_rate(eng, 3, d, time_s=1.0)
        runs[str(d)] = (engine.world_to_numpy(eng.world), outs, last)
    (wg, og, lg), (wc, oc, lc) = runs[str(dev)], runs["cpu"]
    for k in wc:
        np.testing.assert_array_equal(wg[k], wc[k], err_msg=k)
    db = [psnr(a, b) for a, b in zip(og, oc)]
    base_db = psnr(lg.color, lc.color)
    hit_equal = bool(((lg.depth == 1.0).cpu() == (lc.depth == 1.0)).all())
    assert min(db) >= 50.0 and base_db >= 50.0, (db, base_db)
    assert hit_equal, "hit classification differs between GPU and CPU"
    full = {"world_bit_exact": True, "upscaled_psnr_db": db,
            "base_color_psnr_db": base_db, "hit_classification_equal": True}

    # the frame loop, 6 frames, respite engaged; and on the non-cube world
    return {"full_rate": full,
            "frame_loop": reference_loop(dev, reference_loop_config(), 4,
                                         REF_POSE),
            "frame_loop_" + "x".join(map(str, NONCUBE_SHIFTS)):
                reference_loop(dev, reference_loop_config(NONCUBE_SHIFTS),
                               2),
            "post_modes": reference_post_modes(dev, 2)}


def reference_post_modes(dev, frames: int) -> dict:
    """Each of ``POST_MODES`` for ``WARMUP`` + ``frames`` frames of the
    frame loop on the 64^3 world at 128x80 from ``REF_POSE``, on the GPU
    and on the CPU: the same rates, GI words equal, the hit classification
    equal and >= 50 dB on every base and output frame."""
    import numpy as np

    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.driver import engine

    ecfg = reference_loop_config()
    worlds = {str(d): engine.build_world(ecfg, verbose=False, device=d)
              for d in (dev, "cpu")}
    wg, wc = (engine.world_to_numpy(worlds[k]) for k in (str(dev), "cpu"))
    for k in wc:
        np.testing.assert_array_equal(wg[k], wc[k], err_msg=k)
    nets = {str(d): load_nets(d) for d in (dev, "cpu")}
    out = {}
    for name, mode, cadence, _ in POST_MODES:
        rg, rc = (run_loop(worlds[str(d)], ecfg, REF_POSE, frames, d,
                           scale=3, upscaler=mode, net=nets[str(d)].get(mode),
                           comp_cadence=cadence) for d in (dev, "cpu"))
        assert rg["rates"] == rc["rates"], (rg["rates"], rc["rates"])
        np.testing.assert_array_equal(u32.to_numpy(rg["loop"].gi),
                                      u32.to_numpy(rc["loop"].gi),
                                      err_msg=f"{name}: GI words")
        base_db, up_db, hits = [], [], []
        for a, b in zip(rg["results"], rc["results"]):
            assert bool((a.hit.cpu() == b.hit).all()), \
                f"{name}: hit classification differs between GPU and CPU"
            hits.append(float(b.hit.float().mean()))
            base_db.append(psnr(a.out.color, b.out.color))
            up_db.append(psnr(a.image, b.image))
        assert min(base_db) >= 50.0 and min(up_db) >= 50.0, \
            (name, base_db, up_db)
        assert max(hits) > 0.0, f"{name}: every primary ray missed"
        out[name] = {"rates": rg["rates"], "hit_share": hits,
                     "base_color_psnr_db": base_db,
                     "output_psnr_db": up_db,
                     "hit_classification_equal": True,
                     "gi_words_bit_exact": True}
    return out


def reference_loop(dev, ecfg, frames: int, pose=None) -> dict:
    """``frame_loop.WARMUP`` + ``frames`` frames of the frame loop of
    ``ecfg`` from ``pose`` (bench.py's placement, ``headline_pose``, when
    None) on the GPU and on the CPU: worlds, rates and GI words equal, the
    respite engaged at every GI window, the hit classification equal and
    >= 50 dB on every base and reconstructed frame."""
    import numpy as np

    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.trace import wavefront

    loops = {}
    for d in (dev, "cpu"):
        world = engine.build_world(ecfg, verbose=False, device=d)
        wavefront.reset_stats()
        run = run_loop(world, ecfg, pose or headline_pose(world.bits,
                                                          ecfg.world),
                       frames, d, scale=3)
        loops[str(d)] = (engine.world_to_numpy(world), run,
                         wavefront.read_stats())
    (wg, rg, sg), (wc, rc, sc) = loops[str(dev)], loops["cpu"]
    for k in wc:
        np.testing.assert_array_equal(wg[k], wc[k], err_msg=k)
    assert rg["rates"] == rc["rates"]
    assert {"checker", "quarter"} <= set(rg["rates"]), rg["rates"]
    assert sg["respites"] == sc["respites"] == 2 * rg["loop"].gi_windows > 0
    gi_g, gi_c = u32.to_numpy(rg["loop"].gi), u32.to_numpy(rc["loop"].gi)
    np.testing.assert_array_equal(gi_g, gi_c, err_msg="GI words")
    assert (gi_g != wc["gi"]).any(), "the GI windows changed nothing"
    base_db, up_db, hits = [], [], []
    for a, b in zip(rg["results"], rc["results"]):
        assert bool((a.hit.cpu() == b.hit).all()), \
            "hit classification differs between GPU and CPU"
        hits.append(float(b.hit.float().mean()))
        base_db.append(psnr(a.out.color, b.out.color))
        up_db.append(psnr(a.image, b.image))
    assert min(base_db) >= 50.0 and min(up_db) >= 50.0, (base_db, up_db)
    assert max(hits) > 0.0, "every primary ray missed"
    w = ecfg.world
    return {"world": f"{w.size_x}x{w.size_y}x{w.size_z}",
            "world_bit_exact": True, "gi_words_bit_exact": True,
            "rates": rg["rates"], "respites": sg["respites"],
            "straggler_overflow": [int(rg["loop"].overflow),
                                   int(rc["loop"].overflow)],
            "hit_share": hits, "base_color_psnr_db": base_db,
            "upscaled_psnr_db": up_db, "hit_classification_equal": True}


def capture_k1(fn) -> list:
    """Every K1 call ``fn`` makes, as (rcfg, start state, directions),
    cloned before the launch."""
    from rvgrt_tpu_torch.ops import superstep_kernel

    real = superstep_kernel.trace_supersteps
    got = []

    def hook(cfg, rcfg, table, dirs, s, sky_y=None, **kw):
        got.append((rcfg, {k: v.clone() for k, v in s.items()},
                    tuple(a.clone() for a in dirs)))
        return real(cfg, rcfg, table, dirs, s, sky_y=sky_y, **kw)

    superstep_kernel.trace_supersteps = hook
    try:
        fn()
    finally:
        superstep_kernel.trace_supersteps = real
    return got


def k1_primary(fn, lanes: int) -> tuple:
    """The primary trace among the K1 calls of ``fn``, a frame: the first
    call at ``lanes`` lanes (the water pair after it has the same count)."""
    return next(c for c in capture_k1(fn) if c[1]["flags"].numel() == lanes)


def k1_inputs(eng, cam, ecfg4, cam4) -> dict:
    """The main paths' K1 inputs: the primary trace of a checkerboard and
    of a quarter-rate frame of the headline at ``cam`` and of config-4
    (``ecfg4``) at ``cam4``, the full-rate path's primary trace at the
    engine's pose (``Engine.render_at``), and the bounce rays' respite
    phases 1 and 2 of the headline's GI window at offset 0 (the calls are
    sun phase 1, sun phase 2, bounce phase 1, bounce phase 2)."""
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.render import pipeline

    ec, w = eng.ecfg, eng.world
    out = {}
    for pre, e, c in (("", ec, cam), ("c4_", ecfg4, cam4)):
        r = e.render
        for rate, n, kw in (("checker", r.height * (r.width // 2),
                             dict(checker_parity=1)),
                            ("quarter", (r.height // 2) * (r.width // 2),
                             dict(quarter_phase=3))):
            out[pre + rate] = k1_primary(lambda: pipeline.render_frame(
                w.bits, w.sdf, w.gi, w.atlas, c, e, include_gi=False,
                sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
                **kw), n)
    out["full"] = k1_primary(eng.render_at,
                             ec.render.height * ec.render.width)
    calls = capture_k1(lambda: gi_update.update_gi(
        w.gi, w.bits, w.sdf, w.atlas, ec, 0, 0, sky_y=w.sky_y,
        table=w.trace_table))
    assert len(calls) == 4, len(calls)
    assert calls[2][0].max_supersteps == GI_BUDGET, calls[2][0]
    out["gi_phase1"], out["gi_phase2"] = calls[2], calls[3]
    return out


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


#: K1's per-lane words other than flags: state, then direction
K1_POS, K1_CELL, K1_TM = ("px", "py", "pz"), ("ix", "iy", "iz"), \
    ("tmx", "tmy", "tmz")
K1_DIR = ("dx", "dy", "dz")
K1_DD_ST = ("ddx", "ddy", "ddz", "stx", "sty", "stz")
K1_READ_WORDS = K1_POS + K1_CELL + ("its",) + K1_TM + K1_DIR + K1_DD_ST


def k1_step_ops(cfg, rcfg, dirs, s, nxt, sky_y, gathered, read,
                turned, z_edges=None) -> int:
    """The operations one superstep needs, taking state ``s`` to ``nxt``,
    estimated per branch each lane takes (csrc/superstep_kernel.cu; DDA:
    per substep taken, from its), all charged at the int32 rate.  Marks in
    the bool mask ``gathered`` the table words the lanes gather, and in
    ``read`` (a bool mask per word of ``K1_READ_WORDS``) the lanes whose
    start value of that word this superstep reads.  ``turned`` marks the
    lanes whose cell and tMax words a turn to DDA has set; this superstep's
    turns are added to it."""
    from rvgrt_tpu_torch.trace import wavefront as wf

    pre = wf._superstep_pregather(cfg, rcfg, dirs, s, sky_y=sky_y,
                                  z_edges=z_edges)
    phase = wf._get(s["flags"], wf._PH_SH, wf._PH_W)
    after = wf._get(nxt["flags"], wf._PH_SH, wf._PH_W)
    sphere, probe, act = pre["in_sphere"], pre["probe_turn"], \
        pre["action_turn"]
    live = phase < wf.PHASE_MISS
    sky = (phase == wf.PHASE_SPHERE) & ~sphere
    to_dda = sphere & (after == wf.PHASE_DDA)
    march = sphere & (wf._get(nxt["flags"], wf._SP_SH, wf._SP_W)
                      != wf._get(s["flags"], wf._SP_SH, wf._SP_W))
    jump = probe & (nxt["its"] != s["its"])
    gathered[pre["widx"][sphere | probe | act].long()] = True

    def mark(keys, m):
        for key in keys:
            read[key] |= m

    slim = rcfg.slim_carry
    if sky_y is not None:
        mark(("py", "dy"), sky | sphere)  # the sky test
    mark(K1_POS, sphere | jump | (act if slim else False))
    mark(K1_DIR, march | jump)
    mark(("its",), jump | act)
    # tMax set-up at the turn (carried), the DDA steps; slim carry sets up
    # no tMax at the turn and reads no tMax word
    mark(K1_DD_ST, act if slim else to_dda | act)
    mark(K1_CELL, (probe | act) & ~turned)
    if not slim:
        mark(K1_TM, act & ~turned)
    turned |= to_dda

    def count(m):
        return int(m.sum())

    substeps = int((nxt["its"] - s["its"])[act].sum())
    # slim: 9 operations fewer at the turn, 18 more (three recomputed
    # tMax words) at each DDA action superstep
    return (5 * count(live) + 4 * count(sky) + 30 * count(sphere)
            + (6 if slim else 15) * count(to_dda) + 30 * count(probe)
            + (28 if slim else 10) * count(act) + 15 * substeps)


def k1_trace_bytes(s0, s1, read, gathered) -> dict:
    """The bytes a whole trace from ``s0`` to ``s1`` must move, each once:
    every lane's flags word; each other state or direction word whose start
    value the trace reads (``read``, from ``k1_step_ops``); sky_y; each
    state word whose value changed, written; each distinct table word
    gathered, at 4 B (``total``) and at 32 B per distinct 32 B sector of
    the table, what the card moves for a random word (``total_32b``)."""
    import torch

    from rvgrt_tpu_torch.trace import wavefront as wf

    n = s0["flags"].numel()
    reads = 4 * n + 4 * sum(int(m.sum()) for m in read.values()) + 4
    writes = 4 * sum(int((_bits(s1[k]) != _bits(s0[k])).sum())
                     for k in wf.STATE_KEYS)
    words = int(gathered.sum())
    pad = gathered.new_zeros((-gathered.numel()) % 8)
    sectors = int(torch.cat([gathered, pad]).view(-1, 8).any(dim=1).sum())
    return dict(reads=reads, writes=writes, total=reads + writes + 4 * words,
                total_32b=reads + writes + 32 * sectors)


def _k1_mismatches(a, b):
    import torch

    from rvgrt_tpu_torch.trace import wavefront as wf

    return [k for k in wf.STATE_KEYS
            if not torch.equal(_bits(a[k]), _bits(b[k]))]


def _k1_max_abs(a, b) -> float:
    from rvgrt_tpu_torch.trace import wavefront as wf

    return max([float((a[k].double() - b[k].double()).abs().max())
                for k in wf.STATE_KEYS] + [0.0])


def k1_exit_dirs(s, dirs, rcfg, z_edges):
    """The payload's ``exit_dir`` of a final state (z_edges traces)."""
    import torch

    from rvgrt_tpu_torch.trace import wavefront as wf

    z = torch.zeros_like(s["px"])
    return wf._payload(s, dirs, z, z, z, torch.zeros((), dtype=torch.int32,
                                                     device=z.device),
                       slim=rcfg.slim_carry, z_edges=z_edges).exit_dir


def check_k1_trace(cfg, table, sky_y, rcfg, s0, dirs, dev,
                   z_edges=None) -> dict:
    """K1 (one launch) against the plain loop on one captured trace, bit
    for bit on all 11 state arrays and on ``steps`` (with ``z_edges``, on
    the payload's ``exit_dir`` too, and the lanes that exit low and high
    are counted); with the launch's graph-timed device ms."""
    import torch

    from rvgrt_tpu_torch.ops import superstep_kernel as k1
    from rvgrt_tpu_torch.utils.timer import graph_ms

    sp = {k: v.clone() for k, v in s0.items()}
    want = int(k1.trace_plain(cfg, rcfg, table, dirs, sp, sky_y=sky_y,
                              z_edges=z_edges))
    sk = {k: v.clone() for k, v in s0.items()}
    got = int(k1.trace_supersteps(cfg, rcfg, table, dirs, sk, sky_y=sky_y,
                                  z_edges=z_edges))
    bad = _k1_mismatches(sp, sk)
    err = _k1_max_abs(sp, sk)
    assert not bad and got == want, \
        f"K1 differs from its plain version: arrays {bad} (max abs " \
        f"{err}), steps {got} vs {want}"
    out = dict(lanes=s0["flags"].numel(), budget=rcfg.max_supersteps,
               steps=got, max_abs_err=err, bit_exact=True)
    if z_edges is not None:
        ed = k1_exit_dirs(sp, dirs, rcfg, z_edges)
        assert torch.equal(ed, k1_exit_dirs(sk, dirs, rcfg, z_edges))
        out.update(z_edges=list(z_edges), slim=rcfg.slim_carry,
                   exits_low=int((ed < 0).sum()),
                   exits_high=int((ed > 0).sum()))

    def reset():
        for key, v in s0.items():
            sk[key].copy_(v)

    out["ms"] = graph_ms(lambda: k1.trace_supersteps(
        cfg, rcfg, table, dirs, sk, sky_y=sky_y, z_edges=z_edges), dev,
        setup=reset)
    return out


def check_k1(cfg, table, sky_y, rcfg, s0, dirs, dev, plain_reps: int = 3,
             what: str = "the checkerboard primary trace",
             z_edges=None) -> dict:
    """K1 against the plain loop on one captured trace (``what``; the row's
    is the headline's checkerboard primary trace): superstep by superstep
    (``fused_superstep``, a budget of one superstep a launch) and the whole
    trace in one launch (``trace_supersteps``), bit for bit on all 11 state
    arrays and on ``steps``; with its graph time, event time, plain time
    (``plain_reps`` runs) and bound."""
    import torch

    from rvgrt_tpu_torch.ops import superstep_kernel as k1
    from rvgrt_tpu_torch.trace import wavefront as wf
    from rvgrt_tpu_torch.utils.timer import graph_ms, timed_ms

    n = s0["flags"].numel()

    def fresh():
        return {k: v.clone() for k, v in s0.items()}

    # superstep by superstep, in trace_plain's batches
    sp, sk = fresh(), fresh()
    k = max(rcfg.steps_per_check, 1)
    gathered = torch.zeros(table.numel(), dtype=torch.bool, device=dev)
    read = {key: torch.zeros(n, dtype=torch.bool, device=dev)
            for key in K1_READ_WORDS}
    turned = torch.zeros(n, dtype=torch.bool, device=dev)
    steps, ops_total, bad_steps, max_err = 0, 0, 0, 0.0
    zk = dict(z_edges=z_edges)
    while steps < rcfg.max_supersteps and wf.any_live(sp["flags"]):
        for _ in range(k):
            nxt = k1.superstep_plain(cfg, rcfg, table, dirs, sp, sky_y=sky_y,
                                     **zk)
            ops_total += k1_step_ops(cfg, rcfg, dirs, sp, nxt, sky_y,
                                     gathered, read, turned, **zk)
            sp = nxt
            k1.fused_superstep(cfg, rcfg, table, dirs, sk, sky_y=sky_y, **zk)
            if _k1_mismatches(sp, sk):
                bad_steps += 1
                max_err = max(max_err, _k1_max_abs(sp, sk))
        steps += k
    assert steps > 0
    assert bad_steps == 0, f"K1 (one superstep a launch) differs from its " \
        f"plain version at {bad_steps} supersteps, max abs {max_err}"

    # the whole trace in one launch
    s = fresh()
    got = int(k1.trace_supersteps(cfg, rcfg, table, dirs, s, sky_y=sky_y,
                                  **zk))
    bad = _k1_mismatches(sp, s)
    max_err = max(max_err, _k1_max_abs(sp, s))
    assert not bad and got == steps, \
        f"K1 (one launch) differs from its plain version: arrays {bad} " \
        f"(max abs {max_err}), steps {got} vs {steps}"

    graph_state = fresh()

    def reset():
        for key, v in s0.items():
            graph_state[key].copy_(v)

    ms = graph_ms(lambda: k1.trace_supersteps(
        cfg, rcfg, table, dirs, graph_state, sky_y=sky_y, **zk), dev,
        setup=reset)
    event_ms = timed_ms(lambda s: k1.trace_supersteps(
        cfg, rcfg, table, dirs, s, sky_y=sky_y, **zk), dev, setup=fresh)
    plain_ms = timed_ms(lambda s: k1.trace_plain(
        cfg, rcfg, table, dirs, s, sky_y=sky_y, **zk), dev, reps=plain_reps,
        warmup=1 if plain_reps > 1 else 0, setup=fresh)
    moved = k1_trace_bytes(s0, sp, read, gathered)
    t_bytes = moved["total"] / HBM_BYTES_PER_S
    t_ops = ops_total / INT32_OPS_PER_S
    return dict(ms=ms, event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=moved["total"], bound_read_bytes=moved["reads"],
                bound_write_bytes=moved["writes"], bound_ops=ops_total,
                bound_ms_32b_sectors=max(
                    moved["total_32b"] / HBM_BYTES_PER_S, t_ops) * 1e3,
                bound_bytes_32b_sectors=moved["total_32b"],
                table_words_gathered=int(gathered.sum()),
                library_ms=None, max_abs_err=max_err, steps=steps,
                lanes=n, budget=rcfg.max_supersteps, bit_exact=True,
                shape=f"{n} lanes, {steps} supersteps ({what}, one "
                      f"launch)")


def check_k2(state, motion, dev) -> dict:
    """K2 on a loop's last real history and motion."""
    import torch
    import torch.nn.functional as F

    from rvgrt_tpu_torch.ops import warp_kernels as k2
    from rvgrt_tpu_torch.upscale import temporal
    from rvgrt_tpu_torch.utils.timer import graph_ms, timed_ms

    packed, x, y, _ = temporal.warp_inputs(state, motion)
    got, ovf = k2.warp_packed_bilinear(packed, x, y)
    want, _ = k2.warp_packed_bilinear_plain(packed, x, y)
    err = float((got - want).abs().max())
    assert int(ovf) == 0
    assert err <= 1e-6, f"K2 differs from its plain version by {err}"
    hh, hw = packed.shape
    ms = graph_ms(lambda: k2.warp_packed_bilinear(packed, x, y), dev,
                  calls=10)
    event_ms = timed_ms(lambda _: k2.warp_packed_bilinear(packed, x, y), dev)
    plain_ms = timed_ms(
        lambda _: k2.warp_packed_bilinear_plain(packed, x, y), dev)
    # yardstick: one library call computing the same bilinear gather
    planes = torch.stack(k2._unpack4(packed))[None]
    grid = torch.stack([x * (2.0 / (hw - 1)) - 1.0,
                        y * (2.0 / (hh - 1)) - 1.0], dim=-1)[None]

    def library(_):
        return F.grid_sample(planes, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_err = float((library(None)[0] - want).abs().max())
    library_ms = graph_ms(lambda: library(None), dev, calls=10)
    px = packed.numel()
    # read the packed history, xs and ys once; write four f32 planes
    bytes_ = px * (4 + 4 + 4) + px * 16
    return dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=library_ms, library_max_abs_err=lib_err,
                max_abs_err=err, shape=f"({hh}, {hw}) u32 history")


#: int32 lane operations per tap pair (one output, one offset) of K3's
#: packed loop: a thread does two DPX instructions per offset (packed min of
#: the pair, packed add-and-min into acc) for its two columns
#: (csrc/sdf_kernels.cu, ``Acc<R, false>::tap``)
K3_OPS_PER_TAP = 1


def k3_tap_floor(d, best, axis: int, cap: int):
    """The tap pairs K3's loop must run for each output of the pass over
    ``d`` along ``axis``, from the min-plus squares ``best``: (Σ_exit) every
    offset off in [1, cap] with off^2 < a = min(best, cap^2), since a 0 at
    any such offset would change the output; (Σ) of those, the offsets
    where a neighbour d[i -+ off] is below cap: where both are at cap or
    outside the volume the candidate is >= cap^2 >= a, which the loop knows
    from its near-row counts without the tap.  Returns (Σ, Σ_exit) per
    output, as uint8."""
    import torch

    a = torch.clamp(best, max=cap * cap)
    n = d.shape[axis]
    shape = list(d.shape)
    shape[axis] = n + 2 * cap
    padded = torch.full(shape, 255, dtype=torch.uint8, device=d.device)
    padded.narrow(axis, cap, n).copy_(d)
    near = torch.zeros(d.shape, dtype=torch.uint8, device=d.device)
    exit_ = torch.zeros_like(near)
    for off in range(1, cap + 1):
        need = a > off * off
        exit_ += need
        m = torch.minimum(padded.narrow(axis, cap - off, n),
                          padded.narrow(axis, cap + off, n))
        near += need & (m < cap)
    return near, exit_


def k3_plain(d, axis: int, cap: int, slab_cells: int = 1 << 26) -> tuple:
    """K3's plain version of the pass over ``d`` along ``axis`` (its output)
    and the tap floors (Σ, Σ_exit) summed over outputs, from the plain
    min-plus squares.  It runs in slabs across an axis the pass does not run
    along (z for axis 1, y for axis 0) of about ``slab_cells`` cells each,
    so that its int32 temporaries stay near 2 GB at 2^30 cells."""
    import torch

    from rvgrt_tpu_torch.ops import sdf_kernels as k3

    dim = 0 if axis == 1 else 1
    n = d.shape[dim]
    step = max(1, n * slab_cells // d.numel())
    want = torch.empty_like(d)
    taps = taps_exit = 0
    for s0 in range(0, n, step):
        part = d.narrow(dim, s0, min(step, n - s0))
        best = k3.min_squares_plain(part, axis, cap)
        want.narrow(dim, s0, part.shape[dim]).copy_(
            torch.clamp_max(k3.isqrt(best), cap))
        t, te = k3_tap_floor(part, best, axis, cap)
        taps += int(t.sum(dtype=torch.int64))
        taps_exit += int(te.sum(dtype=torch.int64))
    return want, taps, taps_exit


def k3_pass(d, axis: int, cap: int, dev, launch, calls: int = 5) -> dict:
    """One K3 pass through ``launch(d, axis, cap)`` against the plain
    version, bit for bit, with its graph-timed ms and its bound from this
    input: bytes (one u8 read and one u8 write a cell) or the int32
    operations of the taps the loop must run (Σ, ``k3_tap_floor``),
    whichever is larger.  The operations figure (``algorithm_floor_ms``) is
    this loop's floor, not the function's: a linear-time lower-envelope
    transform runs no such taps, so where it sets ``bound_ms`` the bound is
    this algorithm's.  Returns the stats and the kernel's output."""
    import torch

    from rvgrt_tpu_torch.utils.timer import graph_ms

    got = launch(d, axis, cap)
    want, taps, taps_exit = k3_plain(d, axis, cap)
    same = torch.equal(got, want)
    diff = 0 if same else int((got.int() - want.int()).abs().max())
    assert same, f"K3 differs from its plain version on axis {axis}, " \
        f"cap {cap}, shape {tuple(d.shape)}: max abs {diff}"
    del want
    cells = d.numel()
    t_ops = taps * K3_OPS_PER_TAP / INT32_OPS_PER_S
    t_bytes = 2 * cells / HBM_BYTES_PER_S
    ms = graph_ms(lambda: launch(d, axis, cap), dev, calls=calls)
    return dict(shape=f"u8 {tuple(d.shape)}", axis=axis, cap=cap, ms=ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                algorithm_floor_ms=t_ops * 1e3, bound_bytes_ms=t_bytes * 1e3,
                taps=taps, taps_per_cell=taps / cells, taps_exit=taps_exit,
                taps_exit_per_cell=taps_exit / cells,
                mean_distance=int(got.sum(dtype=torch.int64)) / cells), got


def capture_k3_inputs(bits, cfg) -> list:
    """The inputs of every K3 launch of the world build, as (input, axis,
    cap): ``build_sdf``'s two passes and ``extend_sdf_far``'s two, taken at
    ``minconv_pass`` while the SDF phase runs again on the world's
    occupancy words ``bits``."""
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.ops import sdf_kernels as k3

    real = k3.minconv_pass
    got = []

    def hook(d, axis, cap):
        got.append((d, axis, cap))
        return real(d, axis, cap)

    k3.minconv_pass = hook
    try:
        engine._sdf_phase_fn(bits, cfg)
    finally:
        k3.minconv_pass = real
    return got


def k3_build_passes(bits, cfg, dev, plain_reps: int = 5) -> list:
    """K3 at each of the world build's four passes (``build_sdf``'s and
    ``extend_sdf_far``'s, on their own inputs), bit for bit against its
    plain version (``k3_pass``), with its event time and the plain
    version's time (``plain_reps`` runs)."""
    from rvgrt_tpu_torch.ops import sdf_kernels as k3
    from rvgrt_tpu_torch.utils.timer import timed_ms

    inputs = capture_k3_inputs(bits, cfg)
    assert len(inputs) == 4, [(tuple(d.shape), a, c) for d, a, c in inputs]
    names = ("build_sdf", "build_sdf", "extend_sdf_far", "extend_sdf_far")
    passes = []
    for name, (d, axis, cap) in zip(names, inputs):
        stats, _ = k3_pass(d, axis, cap, dev, k3.minconv_pass,
                           calls=5 if d.numel() > 2 ** 24 else 20)
        stats["event_ms"] = timed_ms(lambda _: k3.minconv_pass(d, axis, cap),
                                     dev, reps=5 if d.numel() > 2 ** 28
                                     else 7)
        stats["plain_ms"] = timed_ms(
            lambda _: k3.minconv_pass_plain(d, axis, cap), dev,
            reps=plain_reps, warmup=1 if plain_reps > 1 else 0)
        passes.append(dict(path=name, **stats))
        log(f"K3 {name}: {passes[-1]}")
    return passes


def check_k3(bits, cfg, dev) -> dict:
    """K3's row: ``k3_build_passes`` on the headline world's build (u8
    512^3, cap 64, and the far mip's 128^3, cap 66 at 1024^3); ``ms``,
    ``event_ms``, ``plain_ms`` and ``bound_ms`` are the means of
    ``build_sdf``'s two passes.  The big worlds' passes are added by
    ``phase_big_world``."""
    passes = k3_build_passes(bits, cfg, dev)
    main = passes[:2]

    def mean(key):
        return statistics.fmean(p[key] for p in main)

    return dict(ms=mean("ms"), event_ms=mean("event_ms"),
                plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
                bound_by="operations" if mean("algorithm_floor_ms")
                >= mean("bound_bytes_ms") else "bytes", library_ms=None,
                max_abs_err=0.0, taps=[p["taps"] for p in main],
                taps_exit=[p["taps_exit"] for p in main],
                mean_distance=[p["mean_distance"] for p in main],
                bound_counted=f"per pass: the larger of 2 B a cell at "
                f"{HBM_BYTES_PER_S:.3g} B/s and taps x {K3_OPS_PER_TAP} "
                f"int32 lane op at {INT32_OPS_PER_S:.4g} op/s; taps (Σ) = "
                f"sum over outputs of #{{off in [1, cap]: off^2 < "
                f"min(acc, cap^2) and min(d[i-off], d[i+off]) < cap}}, acc "
                f"the plain version's min-plus square; taps_exit drops the "
                f"second condition; the operations figure "
                f"(algorithm_floor_ms) is this loop's floor, not the "
                f"function's: a linear-time lower-envelope transform runs no "
                f"such taps",
                shape=f"{main[0]['shape']}, cap {main[0]['cap']}, per pass "
                      f"(build_sdf, axes 1 and 0)", passes=passes)


#: the in-process bench point's timed headline frames (config-4: half, at
#: least 4)
BENCH_FRAMES = 8
#: bench.py's JSON keys: the line, ``extra`` and a point's stats
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA_KEYS = {"headline", "device", "readback_s", "world_build_s",
                    "world_build_phases", "note", "config4_1080p_native_gi"}
BENCH_POINT_KEYS = {"fps", "mrays_per_s", "mrays_primary_only", "hit_frac",
                    "frames", "straggler_overflow", "rays_per_frame_mean",
                    "tier_mix", "camera_path"}
#: the default command's tiers and mean rays a frame: 10 checkerboard and
#: 22 quarter frames at 1280x800, a 32 768-cell GI window on 16 of the 32
BENCH_MIX = {"checker": 10, "quarter": 22}
BENCH_RAYS = {"primary": 336000.0, "prepass_primary": 16000.0,
              "prepass_shadow": 0.0, "cascade": 1000.0,
              "shadow_sites": 21000.0, "gi_update": 32768.0}


def bench_command(argv=(), knobs=None, timeout: float = 600.0) -> dict:
    """``python3 -m rvgrt_tpu_torch.bench`` as a user runs it, with every
    ``BENCH_*`` knob at its default (or ``knobs``): its one stdout line,
    parsed, and its wall time."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs or {})
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "rvgrt_tpu_torch.bench", *argv],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"rvgrt_tpu_torch.bench failed ({res.returncode})"
                           f":\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    return dict(out=json.loads(lines[0]), wall_s=wall,
                stderr_tail=res.stderr.strip().splitlines()[-12:])


def phase_bench(world, cube: int, dev, counts: dict,
                frames: int = BENCH_FRAMES) -> dict:
    """The port's entry point (``rvgrt_tpu_torch/bench.py``).  (a) The
    default command in a process of its own (its own 1024^3 world, 32
    headline and 16 config-4 frames): bench.py's keys, the tier mix {checker
    10, quarter 22}, the rays a frame, no overflow, a hit share in (0, 1]
    and fps > 0.  (b) ``run_point`` in this process on ``world`` at
    ``BENCH_CHECKER=4 BENCH_GI_CADENCE=1 BENCH_CONFIG4_RATE=0``: the
    headline's every frame at quarter rate with a GI window, K1 and K2 (one
    a frame, warm-ups included); config-4 at full rate, native, no K2."""
    import torch

    from rvgrt_tpu_torch import bench
    from rvgrt_tpu_torch.driver.frame_loop import WARMUP
    from rvgrt_tpu_torch.trace import wavefront

    cmd = bench_command()
    out = cmd["out"]
    head = out["extra"]["headline"]
    log(f"bench command ({cmd['wall_s']:.1f} s): {json.dumps(out)}")
    assert set(out) == BENCH_KEYS, out.keys()
    assert set(out["extra"]) == BENCH_EXTRA_KEYS, out["extra"].keys()
    for point in (head, out["extra"]["config4_1080p_native_gi"]):
        assert set(point) == BENCH_POINT_KEYS, point.keys()
    assert head["tier_mix"] == BENCH_MIX, head
    assert head["rays_per_frame_mean"] == BENCH_RAYS, head
    assert head["straggler_overflow"] == 0, head
    assert 0.0 < head["hit_frac"] <= 1.0 and head["fps"] > 0.0, head

    ecfg, opts = bench.bench_config({
        "BENCH_CUBE": str(cube), "BENCH_W": str(WIDTH),
        "BENCH_H": str(HEIGHT), "BENCH_FRAMES": str(frames),
        "BENCH_CHECKER": "4", "BENCH_GI_CADENCE": "1",
        "BENCH_CONFIG4_RATE": "0"})
    points = {}
    for name, ec, n in (
            ("headline", ecfg, frames),
            ("config4", native_config(ecfg, C4_WIDTH, C4_HEIGHT),
             max(frames // 2, 4))):
        reset_counts()
        _, stats, loop = bench.run_point(world, ec, f"bench-{name}", n, opts)
        torch.cuda.synchronize()
        c = counts[f"bench_{name}"] = read_counts()
        traces = wavefront.read_stats()["traces"]
        points[name] = dict(stats, launches=c, traces=traces,
                            gi_windows=loop.gi_windows)
        log(f"bench in process, {name}: {points[name]}")
        assert c["K1"] > 0 and c["K1"] == traces, (c, traces)
    head_q, c4 = points["headline"], points["config4"]
    n_head = frames + WARMUP
    assert head_q["tier_mix"] == {"quarter": frames}, head_q
    assert head_q["gi_windows"] == n_head, head_q
    assert head_q["launches"]["K2"] == n_head, head_q
    assert c4["tier_mix"] == {"full": max(frames // 2, 4)}, c4
    assert c4["launches"]["K2"] == 0, c4
    return dict(command=dict(json=out, wall_s=cmd["wall_s"],
                             stderr_tail=cmd["stderr_tail"]),
                in_process=points)


def phase_gi_init(eng, dev, counts: dict) -> dict:
    """The traced GI init of ``config_stage4`` (one sun-shadow ray per GI
    cell, budget 0) on the headline's world, which is stage 4's
    (``WorldConfig().with_cube(10)``): ``init_gi_strided`` at stride (1, 1),
    all 2^24 cells in one trace, and at (2, 2), 2^22 cells, each a main-path
    run with its own counts (``counts["gi_init_1x1"]``, ...) and its time
    (CUDA events, host included; and the median of 3 more runs).  Then,
    uncounted: K1 on the stride-(1, 1) trace against its plain loop
    (``check_k1``: superstep by superstep and in one launch, bit for bit,
    with its graph time and count-once bound), and the init's words against
    those of the same init with every trace run by the plain loop."""
    import torch

    from rvgrt_tpu_torch.config import config_stage4
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.ops import superstep_kernel
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.utils.timer import Timer, timed_ms

    w = eng.world
    ecfg = dataclasses.replace(config_stage4(), world=eng.ecfg.world)
    assert ecfg.gi_straggler_budget == 0 and ecfg.gi_init_mode == "traced"

    def init(stride):
        return gi_update.init_gi_strided(w.bits, w.sdf, ecfg, sky_y=w.sky_y,
                                         table=w.trace_table, stride=stride)

    out, words = {"cells": ecfg.world.gi_num_cells}, {}
    for stride in ((1, 1), (2, 2)):
        key = f"{stride[0]}x{stride[1]}"
        reset_counts()
        with Timer("", verbose=False, device=dev) as t:
            words[key] = init(stride)
        c = counts[f"gi_init_{key}"] = read_counts()
        st = wavefront.read_stats()
        assert c["K1"] == st["traces"] == 1, (c, st)
        out[f"stride_{key}"] = dict(
            s=t.elapsed_ms / 1e3, warm_s=timed_ms(
                lambda _: init(stride), dev, reps=3, warmup=0) / 1e3,
            launches=c, traces=st["traces"], supersteps=st["supersteps"])
        log(f"GI init, stride {key}: {out[f'stride_{key}']}")
    lit = int(((words["1x1"] & 0xFFFFFF) != 0).sum())
    assert 0 < lit < words["1x1"].numel(), lit
    out["lit_share"] = lit / words["1x1"].numel()

    calls = capture_k1(lambda: init((1, 1)))
    assert len(calls) == 1 and calls[0][1]["flags"].numel() == \
        ecfg.world.gi_num_cells, len(calls)
    cfg = ecfg.world
    out["k1"] = check_k1(cfg, w.trace_table, w.sky_y, *calls[0], dev,
                         plain_reps=1, what="the traced GI init")
    del calls
    log(f"K1 on the GI init: {out['k1']}")

    real = superstep_kernel.trace_supersteps
    superstep_kernel.trace_supersteps = superstep_kernel.trace_plain
    try:
        with Timer("", verbose=False, device=dev) as t:
            plain = init((1, 1))
    finally:
        superstep_kernel.trace_supersteps = real
    assert torch.equal(plain, words["1x1"]), "the GI init's words differ " \
        "from those of its plain path"
    out["plain_path_s"] = t.elapsed_ms / 1e3
    out["words_bit_exact"] = True
    return out


#: bench.py's post stages beside its default (phase 5b): (name,
#: ``BENCH_UPSCALE`` mode, ``BENCH_COMP_CADENCE``, checkpoint file)
POST_MODES = (("net", "net", 1, "upscaler.pkl"),
              ("residual", "residual", 1, "residual_head.pkl"),
              ("temporal_cadence2", "temporal", 2, None),
              ("none", "none", 1, None))
#: H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, at 700 W)
BF16_FLOPS_PER_S = 989e12
#: substrings that name a convolution's own kernels (cuDNN's, CUTLASS's)
CONV_MARKS = ("conv", "xmma", "gemm", "cutlass", "cudnn", "fprop",
              "implicit", "dgrad", "wgrad")


def conv_flops(net, height: int, width: int) -> float:
    """FLOP of ``net``'s 3x3 convs on a ``height x width`` low-res frame:
    pixels x 9 taps x sum(Cin x Cout) x 2."""
    from rvgrt_tpu_torch.upscale import model

    macs = sum(m.weight.shape[0] * m.weight.shape[1]
               for m in net.modules() if isinstance(m, model._Conv))
    return 2.0 * 9 * height * width * macs


def flop_bounds(height: int, width: int) -> dict:
    """Each learned net's conv FLOP a frame and the least time they take
    at the card's dense bf16 peak."""
    from rvgrt_tpu_torch import models
    from rvgrt_tpu_torch.upscale import residual

    nets = {v: models.get(f"upscaler/{v}") for v in ("up-s", "up-m", "up-l")}
    nets["residual_head"] = residual.ResidualHead()
    out = {}
    for k, net in nets.items():
        f = conv_flops(net, height, width)
        out[k] = dict(gflop=f / 1e9, bound_ms=f / BF16_FLOPS_PER_S * 1e3)
    return out


def load_nets(dev) -> dict:
    """The post modes' committed checkpoints on ``dev``, by mode: each
    file must exist, and each conv of the loaded module must hold the
    file's kernel (no fresh weights)."""
    import numpy as np

    from rvgrt_tpu_torch.driver import checkpoint
    from rvgrt_tpu_torch.upscale import model, residual

    nets = {}
    for _, mode, _, fname in POST_MODES:
        if fname is None:
            continue
        path = ROOT / "checkpoints" / fname
        assert path.is_file(), f"missing checkpoint {path}"
        load = model.load_checkpoint if mode == "net" else \
            residual.load_checkpoint
        net = load(str(path), device=dev)
        tree = checkpoint.load_params(str(path))["params"]["params"]
        assert sorted(tree) == sorted(n for n, m in net.named_children())
        for layer, p in tree.items():
            w = getattr(net, layer).weight.detach().cpu().numpy()
            assert np.array_equal(w, p["kernel"].transpose(3, 2, 0, 1)), \
                (fname, layer)
        nets[mode] = net
    return nets


def profile_parts(parts: dict, top: int = 6) -> dict:
    """Each ``parts`` callable under ``torch.profiler``: its device busy
    ms, launches, the device ms of its convolution kernels
    (``CONV_MARKS``) and its costliest kernels."""
    out = {}
    for name, fn in parts.items():
        wall_ms, busy_ms, launches, kernels = profiled(fn)
        kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)
        out[name] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_ms, device_launches=launches,
            conv_ms=sum(e.self_device_time_total for e in kernels
                        if any(m in e.key.lower() for m in CONV_MARKS)) / 1e3,
            top=[dict(kernel=e.key[:90], calls=e.count,
                      device_ms=e.self_device_time_total / 1e3)
                 for e in kernels[:top]])
    return out


def profile_net(mode: str, net, loop, result, cam, dev) -> dict:
    """Where a learned post-pass's device time goes, on the last frame's
    inputs: for the upscaler the history warp, the conv stack and the
    display-resolution tail (sigmoid, bilinear anchor, blend); for the
    residual head the whole head.  Each part's CUDA-event time (host
    included) and its profile, every part as served: no autograd graph."""
    import torch

    from rvgrt_tpu_torch.upscale import model, residual
    from rvgrt_tpu_torch.utils.timer import timed_ms

    o = result.out
    if mode == "net":
        hist = loop.state
        with torch.no_grad():
            warped = model.warp_history(hist, o.motion)
            up = net.stack(o.color, o.motion, o.depth, cam.jitter, warped)
        parts = {
            "warp": lambda: model.warp_history(hist, o.motion),
            "conv_stack": lambda: net.stack(o.color, o.motion, o.depth,
                                            cam.jitter, warped),
            "tail": lambda: net.blend(up, o.color, warped),
            "upscale": lambda: model.upscale(net, o.color, o.motion,
                                             o.depth, cam.jitter, hist)}
    else:
        st = loop.state
        parts = {"head": lambda: residual.apply(
            net, o.color, o.motion, o.depth, cam.jitter, st.history,
            st.conf)}
    parts = {k: torch.no_grad()(fn) for k, fn in parts.items()}
    rep = profile_parts(parts)
    for k, fn in parts.items():
        rep[k]["event_ms"] = timed_ms(lambda _, fn=fn: fn(), dev)
    return rep


def phase_post_modes(world, ecfg, pose, dev, frames: int, counts: dict,
                     modes=POST_MODES, profile: int = 0) -> dict:
    """bench.py's other post stages on the headline world, each a main
    path (``counts["post_" + name]``): each of ``modes`` (``POST_MODES``)
    for ``WARMUP`` + ``frames`` frames of ``driver/frame_loop.py`` at
    1280x800 along bench.py's path for the mode.  Per mode the frame
    median and p90, the peak device memory, launches (K1 == traces; K2 a
    frame under the accumulator, none without it) and, for the learned
    nets, where their device time goes (``profile_net``) beside the FLOP
    bound of their convs (``flop_bounds``).  ``profile`` > 0 runs that many
    more frames of each mode, each under ``torch.profiler`` (device busy
    ms, idle share, launches; not counted)."""
    import torch

    from rvgrt_tpu_torch.driver import frame_loop
    from rvgrt_tpu_torch.trace import wavefront

    nets = load_nets(dev)
    report = {"flop_bound": flop_bounds(HEIGHT, WIDTH),
              "checkpoints": {m: f for _, m, _, f in modes if f}}
    log(f"post modes: FLOP bounds at {WIDTH}x{HEIGHT}: "
        f"{report['flop_bound']}")
    for name, mode, cadence, fname in modes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident_gb = torch.cuda.memory_allocated() / 1e9
        reset_counts()
        run = run_loop(world, ecfg, pose, frames, dev, scale=3,
                       upscaler=mode, net=nets.get(mode),
                       comp_cadence=cadence)
        torch.cuda.synchronize()
        c = counts[f"post_{name}"] = read_counts()
        st = wavefront.read_stats()
        rep = loop_report(run, c, st)
        last = run["results"][-1]
        n = len(run["ms"])
        up = mode != "none"
        check_image(last.image, (3 * HEIGHT, 3 * WIDTH, 3) if up
                    else (HEIGHT, WIDTH, 3))
        assert c["K1"] == st["traces"] > 0, (c, st)
        assert c["K2"] == (n if mode in ("temporal", "residual") else 0), c
        if frame_loop.adaptive(mode):
            assert rep["tier_mix"] == expected_mix(frames), rep["tier_mix"]
        else:
            assert set(run["rates"]) == {"full"}, run["rates"]
        rep.update(mode=mode, comp_cadence=cadence, checkpoint=fname,
                   path=frame_loop.camera_path(mode),
                   render=f"{WIDTH}x{HEIGHT}" + (
                       f" -> {3 * WIDTH}x{3 * HEIGHT}" if up else " native"),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   resident_before_gb=resident_gb)
        if mode in nets:
            rep["profile"] = profile_net(mode, nets[mode], run["loop"],
                                         last, run["cams"][-1][1], dev)
        if profile:
            # frames n.. continue the loop on the last poses again
            rep["frame_profiles"] = []
            for k in range(profile):
                j = n - profile + k
                wall, busy, launches, _ = profiled(
                    lambda: run["loop"].frame(n + k, run["cams"][j][1],
                                              run["rates"][j]))
                rep["frame_profiles"].append(dict(
                    rate=run["rates"][j], gi=(n + k) % 2 == 0,
                    wall_ms=wall, device_busy_ms=busy,
                    device_idle_share=1.0 - busy / wall,
                    device_launches=launches))
        report[name] = rep
        log(f"post mode {name}: median {rep['ms_median']:.1f} ms, p90 "
            f"{rep['ms_p90']:.1f} ms, peak {rep['peak_mem_gb']:.2f} GB, "
            f"launches {c}, profile {rep.get('profile')}")
        del run, last
    return report


def round_trip_world(world, ecfg, dev) -> dict:
    """``checkpoint.save_world`` then ``load_world`` of ``world`` through
    a temporary file: each timed (host clock, the load synchronised), the
    file's size, and every array of the loaded world (``sky_y`` and
    ``trace_table`` derived again) equal to the original's."""
    import os
    import tempfile

    import torch

    from rvgrt_tpu_torch.driver import checkpoint

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "world.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_world(path, world, ecfg, frame_count=14,
                              gi_offset=4096)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back, fc, go = checkpoint.load_world(path, ecfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    assert (fc, go) == (14, 4096), (fc, go)
    for k in ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table"):
        assert torch.equal(getattr(back, k), getattr(world, k)), k
    w = ecfg.world
    return dict(world=f"{w.size_x}x{w.size_y}x{w.size_z}", save_s=save_s,
                load_s=load_s, file_mb=size / 2 ** 20, bit_exact=True)


def phase_cli_net(dev, counts: dict, frames: int = 4) -> dict:
    """The CLI with the learned upscaler, a main path
    (``counts["cli_net"]``): ``cli.main(["--config", "tiny", "--frames",
    4, "--upscale", "checkpoints/upscaler_r2.pkl", "--out", dir])`` on the
    GPU; 3x PNGs written, K1 launches == traces, no K2."""
    import tempfile

    import torch

    from rvgrt_tpu_torch.driver import cli
    from rvgrt_tpu_torch.trace import wavefront

    with tempfile.TemporaryDirectory() as out_dir:
        reset_counts()
        stats = cli.main(["--config", "tiny", "--frames", str(frames),
                          "--upscale",
                          str(ROOT / "checkpoints" / "upscaler_r2.pkl"),
                          "--out", out_dir])
        torch.cuda.synchronize(dev)
        c = counts["cli_net"] = read_counts()
        st = wavefront.read_stats()
        pngs = sorted(Path(out_dir).glob("*.png"))
        head = pngs[-1].read_bytes()[:24] if pngs else b""
    r = cli.tiny_config().render
    size = (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"))
    assert stats["written"] == len(pngs) == frames, (stats, len(pngs))
    assert size == (3 * r.width, 3 * r.height), size
    assert c["K1"] == st["traces"] > 0 and c["K2"] == 0, (c, st)
    return dict(stats, png_size=size, launches=c, traces=st["traces"],
                frame_ms_median=statistics.median(stats["frame_ms"][1:]))


#: ``tools/train_residual.py`` at its documented usage (``--cube 8
#: --low-w 128 --low-h 96 --ssaa 4 --gi``), frames and steps cut to fit the
#: run; the documented run is ``--frames 72 --steps 800``
TRAIN_RESIDUAL_ARGS = ["--cube", "8", "--low-w", "128", "--low-h", "96",
                       "--ssaa", "4", "--gi", "--frames", "24",
                       "--eval-frames", "12", "--steps", "50"]
TRAIN_RESIDUAL_DOCUMENTED = "--frames 72 --eval-frames 24 --steps 800"
#: ``python -m rvgrt_tpu_torch.upscale.train`` at the up-l width that
#: ``checkpoints/upscaler.pkl`` serves; 36 frames, as the trainer holds out
#: the last two 12-frame segments and needs one to train on
TRAIN_UPSCALER_ARGS = ["--variant", "up-l", "--cube", "8", "--frames", "36",
                       "--steps", "20"]
#: the up-s / head float32 step of the GPU-against-CPU check: the CPU
#: tests' size (tests/test_torch_train.py)
TRAIN_REF_H, TRAIN_REF_W = 16, 24
TRAIN_LR = 1e-3


def _losses_fall(losses: list) -> bool:
    k = max(1, min(10, len(losses) // 3))
    return statistics.fmean(losses[-k:]) < statistics.fmean(losses[:k])


def phase_train_residual(dev, counts: dict, out_dir: str) -> dict:
    """The residual head's trainer as its usage runs it, a main path
    (``counts["train_residual"]``): ``tools/train_residual.py`` with
    ``TRAIN_RESIDUAL_ARGS``: the pairs (two 256^3 world builds with the
    traced GI init; low-res, 3x and 4 SSAA renders a frame, GI on), the
    accumulation, 50 steps, the held-out evaluation, the checkpoint.  K1
    launches == traces over the renders, no K2 (the accumulator's default
    taps), the losses finite and falling, and the written checkpoint read
    back by ``residual.load_checkpoint`` equal to the trained module bit
    for bit."""
    import os

    import torch

    from rvgrt_tpu_torch.tools import train_residual
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.upscale import residual

    path = os.path.join(out_dir, "residual_head.pkl")
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9
    reset_counts()
    rep = train_residual.main(TRAIN_RESIDUAL_ARGS + ["--out", path])
    torch.cuda.synchronize(dev)
    c = counts["train_residual"] = read_counts()
    st = wavefront.read_stats()
    net = rep.pop("net")
    losses = rep.pop("losses")
    assert c["K1"] == st["traces"] > 0 and c["K3"] > 0 and c["K2"] == 0, \
        (c, st)
    assert all(map(math.isfinite, losses)), losses
    assert _losses_fall(losses), losses
    back = residual.load_checkpoint(path, device=dev)
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    step_ms = rep.pop("step_ms")
    rep.update(args=" ".join(TRAIN_RESIDUAL_ARGS),
               cut=f"--frames 24 --eval-frames 12 --steps 50 against the "
                   f"documented {TRAIN_RESIDUAL_DOCUMENTED}",
               loss_first=losses[0], loss_last=losses[-1],
               loss_first10=statistics.fmean(losses[:10]),
               loss_last10=statistics.fmean(losses[-10:]),
               step_ms_warmup=step_ms[:2], launches=c,
               traces=st["traces"], resident_before_gb=resident_gb,
               checkpoint_bit_exact=True)
    return rep


def phase_train_upscaler(dev, counts: dict, out_dir: str) -> dict:
    """The upscaler's closed-loop trainer, a main path
    (``counts["train_upscaler"]``): ``python -m rvgrt_tpu_torch.upscale.
    train`` with ``TRAIN_UPSCALER_ARGS`` (up-l): 36 pairs, 20 steps on the
    first segment, the evaluation of the two held-out segments, the
    checkpoint read back by ``model.load_checkpoint`` bit for bit."""
    import os

    import torch

    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.upscale import model
    from rvgrt_tpu_torch.upscale import train

    path = os.path.join(out_dir, "upscaler.pkl")
    torch.cuda.reset_peak_memory_stats(dev)
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9
    reset_counts()
    rep = train.main(TRAIN_UPSCALER_ARGS + ["--out", path])
    torch.cuda.synchronize(dev)
    c = counts["train_upscaler"] = read_counts()
    st = wavefront.read_stats()
    net = rep.pop("net")
    assert c["K1"] == st["traces"] > 0 and c["K3"] > 0 and c["K2"] == 0, \
        (c, st)
    losses = rep["losses"]
    assert all(map(math.isfinite, losses)), losses
    assert _losses_fall(losses), losses
    back = model.load_checkpoint(path, device=dev)
    assert (back.features, back.depth_layers) == (64, 4)
    for k, v in net.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    for e in rep["eval"]:
        assert all(map(math.isfinite, e.values())), e
    rep.update(args=" ".join(TRAIN_UPSCALER_ARGS), launches=c,
               traces=st["traces"], loss_first=losses[0],
               loss_last=losses[-1],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               resident_before_gb=resident_gb, checkpoint_bit_exact=True)
    return rep


def train_flop_bound(net, height: int, width: int) -> dict:
    """A training step's conv FLOP at a ``height x width`` low-res frame:
    the forward, the weight gradients (as many) and the data gradients of
    every conv but the first (the input needs none); and the least time
    at the dense bf16 peak."""
    from rvgrt_tpu_torch.upscale import model

    convs = [m for m in net.modules() if isinstance(m, model._Conv)]
    fwd = conv_flops(net, height, width)
    first = 2.0 * 9 * height * width * (convs[0].weight.shape[0]
                                        * convs[0].weight.shape[1])
    total = 2 * fwd + (fwd - first)
    return dict(forward_gflop=fwd / 1e9, weight_grad_gflop=fwd / 1e9,
                data_grad_gflop=(fwd - first) / 1e9, gflop=total / 1e9,
                bound_ms=total / BF16_FLOPS_PER_S * 1e3)


def _train_sample(kind: str, h: int, w: int, seed: int, dev):
    """A synthetic training sample on ``dev`` made from a numpy seed, with
    flat blocks at exactly 0 and 1 (ties of the clip and of the
    gradient-L1)."""
    import numpy as np
    import torch

    from rvgrt_tpu_torch.upscale import residual, train

    rng = np.random.default_rng(seed)

    def blocks(a):
        a = a.copy()
        hh, ww = a.shape[:2]
        a[:hh // 3, :ww // 3] = 1.0
        a[hh // 3:hh // 2, :ww // 3] = 0.0
        return a

    d = dict(color=blocks(rng.random((h, w, 3), np.float32)),
             motion=rng.normal(0.0, 0.01, (h, w, 2)).astype(np.float32),
             depth=rng.random((h, w), np.float32),
             jitter=np.array([0.013, -0.021], np.float32),
             target=blocks(rng.random((3 * h, 3 * w, 3), np.float32)))
    if kind == "upscaler":
        d["history"] = blocks(rng.random((3 * h, 3 * w, 3), np.float32))
        cls = train.Sample
    else:
        d["acc_out"] = blocks(rng.uniform(-0.2, 1.2, (3 * h, 3 * w, 3))
                              .astype(np.float32))
        d["acc_conf"] = rng.random((3 * h, 3 * w), np.float32) * 12
        cls = residual.ResSample
    return cls(**{k: torch.from_numpy(d[k]).to(dev) for k in cls._fields})


def phase_train_step_1280(dev) -> dict:
    """One training step at bench.py's operating point, 1280x800 ->
    3840x2400 (the nets are fully convolutional): up-l's closed-loop
    ``train_step`` and the residual head's (32x3), bf16, from a fresh
    net (``models.upscaler.init`` / ``residual.init_params``, seed 0) on
    synthetic inputs.  Each: the median of 5 steps after 2 warm-ups (CUDA
    events around each step, host included), peak memory, and one more
    step under ``torch.profiler`` - its device busy ms and its conv
    kernels' (``CONV_MARKS``: forward, data and weight gradients) beside
    the FLOP bound of the step's convs (``train_flop_bound``)."""
    import torch

    from rvgrt_tpu_torch.models import upscaler as up_family
    from rvgrt_tpu_torch.upscale import residual, train
    from rvgrt_tpu_torch.utils.timer import Timer

    out = {}
    for name in ("up-l", "residual_head"):
        g = torch.Generator().manual_seed(0)
        if name == "up-l":
            net = up_family.init("up-l", g, HEIGHT, WIDTH, device=dev)
            s = _train_sample("upscaler", HEIGHT, WIDTH, 1, dev)
            step = train.train_step
        else:
            net = residual.init_params(HEIGHT, WIDTH, generator=g,
                                       device=dev)
            s = _train_sample("residual", HEIGHT, WIDTH, 2, dev)
            step = residual.train_step
        opt = train.make_optimizer(TRAIN_LR)
        box = [opt.init(list(net.parameters()))]

        def one():
            box[0], loss, _ = step(net, opt, box[0], s)
            return loss

        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        resident_gb = torch.cuda.memory_allocated(dev) / 1e9
        ms, losses = [], []
        for _ in range(2 + 5):
            with Timer(name, verbose=False, device=dev) as t:
                losses.append(one())
            ms.append(t.elapsed_ms)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        prof = profile_parts({"step": one})["step"]
        bound = train_flop_bound(net, HEIGHT, WIDTH)
        losses = [float(v) for v in losses]
        assert all(map(math.isfinite, losses)), losses
        out[name] = dict(
            shape=f"{WIDTH}x{HEIGHT} -> {3 * WIDTH}x{3 * HEIGHT}",
            ms_median=statistics.median(ms[2:]), ms_all=ms,
            peak_mem_gb=peak, resident_before_gb=resident_gb,
            losses=losses, profile=prof,
            conv_ms=prof["conv_ms"], flop_bound=bound,
            conv_share_of_bound=(bound["bound_ms"] / prof["conv_ms"]
                                 if prof["conv_ms"] else None),
            step_share_of_bound=bound["bound_ms"] / statistics.median(
                ms[2:]))
        log(f"train step {name} at {WIDTH}x{HEIGHT}: median "
            f"{out[name]['ms_median']:.2f} ms, conv kernels "
            f"{prof['conv_ms']:.3f} ms against {bound['bound_ms']:.3f} ms "
            f"({bound['gflop']:.1f} GFLOP), peak {peak:.2f} GB")
        del net, s, box
        torch.cuda.empty_cache()
    return out


def _ref_tree(cin: int, features: int, layers: int, cout: int, seed: int,
              zero_shuffle: bool) -> dict:
    """A flax tree made from a numpy seed (tests/test_torch_train.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(layers + 1):
        ci = cin if i == 0 else features
        co = cout if i == layers else features
        k = rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)
        b = 0.1 * rng.standard_normal(co)
        if i == layers and zero_shuffle:
            k, b = np.zeros_like(k), np.zeros_like(b)
        tree["shuffle" if i == layers else f"feat{i}"] = dict(
            kernel=k.astype(np.float32), bias=b.astype(np.float32))
    return {"params": tree}


def phase_train_reference(dev) -> dict:
    """One float32 training step on the card and on the CPU from the same
    weights and inputs, at the CPU tests' size: up-s with random weights,
    and the residual head fresh (zero shuffle conv: its output is the
    clipped accumulator to the bit on both devices, so the inputs' ties at
    0 and 1 and the target's are real on both).  TF32 off for the
    check.  The losses within rtol 1e-4, every gradient within 1e-5 x its
    tensor's max |g| (tests/test_torch_train.py's float32 gate), the
    parameters after the step within 1e-3 x lr wherever |g| > 1e-6; and
    the bf16 nets' losses within rtol 1e-2."""
    import numpy as np
    import torch

    from rvgrt_tpu_torch.upscale import model, residual, train

    cpu = torch.device("cpu")
    h, w = TRAIN_REF_H, TRAIN_REF_W
    cases = {
        "up-s": ("upscaler", _ref_tree(model.IN_CHANNELS, 16, 2, 36, 3,
                                       False)),
        "residual_head": ("residual", _ref_tree(residual.IN_CHANNELS, 32,
                                                3, 27, 2, True))}
    out = {}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, (kind, tree) in cases.items():
            res = {}
            for dtype in (torch.float32, torch.bfloat16):
                got = []
                for d in (cpu, dev):
                    net = (model.UpscalerNet(16, 2, dtype=dtype)
                           if kind == "upscaler"
                           else residual.ResidualHead(dtype=dtype))
                    net.load_state_dict(model.params_from_flax(tree))
                    net = net.to(d)
                    s = _train_sample(kind, h, w, 7, d)
                    fn = (train.loss_fn if kind == "upscaler"
                          else residual.loss_fn)
                    loss, _ = fn(net, s)
                    grads = torch.autograd.grad(loss,
                                                list(net.parameters()))
                    opt = train.make_optimizer(TRAIN_LR)
                    st = opt.init(list(net.parameters()))
                    step = (train.train_step if kind == "upscaler"
                            else residual.train_step)
                    _, loss2, _ = step(net, opt, st, s)
                    got.append(dict(
                        loss=float(loss.detach()), step_loss=float(loss2),
                        grads={n: g.cpu() for (n, _), g in zip(
                            net.named_parameters(), grads)},
                        params={n: p.detach().cpu()
                                for n, p in net.named_parameters()}))
                a, b = got
                if dtype == torch.bfloat16:
                    assert math.isclose(b["loss"], a["loss"], rel_tol=1e-2), \
                        (name, a["loss"], b["loss"])
                    res["bf16_loss"] = (a["loss"], b["loss"])
                    continue
                assert math.isclose(b["loss"], a["loss"], rel_tol=1e-4), \
                    (name, a["loss"], b["loss"])
                worst = 0.0
                for k, ga in a["grads"].items():
                    gb = b["grads"][k]
                    scale = float(ga.abs().max())
                    err = float((ga - gb).abs().max())
                    assert err <= 1e-5 * scale, (name, k, err, scale)
                    if scale:
                        worst = max(worst, err / scale)
                    mask = ga.abs() > 1e-6
                    dp = (a["params"][k] - b["params"][k]).abs()[mask]
                    assert dp.numel() == 0 or \
                        float(dp.max()) <= 1e-3 * TRAIN_LR, (name, k)
                res.update(f32_loss=(a["loss"], b["loss"]),
                           f32_grad_max_rel_err=worst)
            out[name] = res
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    log(f"train GPU against CPU: {out}")
    return out


def phase_train(dev, counts: dict) -> dict:
    """Phase 5c, the training path: ``phase_train_residual`` and
    ``phase_train_upscaler`` (main paths, their checkpoints in a temporary
    directory), ``phase_train_step_1280`` and ``phase_train_reference``
    (not counted)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rep = {"train_residual": phase_train_residual(dev, counts, d)}
        log(f"train_residual: {rep['train_residual']}")
        rep["train_upscaler"] = phase_train_upscaler(dev, counts, d)
        log(f"train_upscaler: {rep['train_upscaler']}")
    rep["step_1280x800"] = phase_train_step_1280(dev)
    rep["gpu_vs_cpu"] = phase_train_reference(dev)
    return rep


def phase_cli(dev, config: str, frames: int, counts: dict) -> tuple:
    """The port's headless driver as a user runs it:
    ``cli.main(["--config", config, "--frames", frames, "--fly",
    "--upscale", "temporal", "--out", dir])`` - the world build with its
    traced GI init, ``Engine.step`` frames, the 3x temporal upscale with
    the accumulator's default ``bilinear_shift`` warp (the JAX CLI's; no
    K2) and the native PNG sink - counted as one main path
    (``counts["cli"]``).  Asserts the PNGs were written, K1 launches ==
    traces and no K2 launch.  Returns the report and the last upscale's
    history state and motion (K2 is held at that shape by a direct
    call)."""
    import tempfile

    import torch

    from rvgrt_tpu_torch.driver import cli
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.upscale import temporal

    real = temporal.temporal_upscale
    last = {}

    def hook(color, motion, depth, jitter, state, **kw):
        last.update(state=state, motion=motion)
        return real(color, motion, depth, jitter, state, **kw)

    with tempfile.TemporaryDirectory() as out_dir:
        temporal.temporal_upscale = hook
        reset_counts()
        try:
            stats = cli.main(["--config", config, "--frames", str(frames),
                              "--fly", "--upscale", "temporal", "--out",
                              out_dir])
            torch.cuda.synchronize(dev)
        finally:
            temporal.temporal_upscale = real
        c = counts["cli"] = read_counts()
        st = wavefront.read_stats()
        pngs = sorted(Path(out_dir).glob("*.png"))
        head = pngs[-1].read_bytes()[:24] if pngs else b""
    assert stats["written"] == len(pngs) == frames, (stats, len(pngs))
    assert head[:8] == b"\x89PNG\r\n\x1a\n", head
    size = (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"))
    hh, hw = last["state"].history.shape[:2]
    assert size == (hw, hh), (size, (hw, hh))
    assert c["K1"] == st["traces"] > 0 and c["K2"] == 0, (c, st)
    report = dict(stats, config=config, frames=frames, png_size=size,
                  launches=c, traces=st["traces"],
                  supersteps=st["supersteps"],
                  frame_ms_median=statistics.median(stats["frame_ms"][1:]
                                                    or stats["frame_ms"]))
    return report, last


def phase_probe(dev, counts: dict) -> dict:
    """The gather probe (``tools/probe_r7.py``): P1 and P2 at each table
    size of its ladder, the library gather and the small-table reference
    ladder, each kernel bit for bit against its plain version (with each
    hint variant and, where the table fits, the on-chip variant), then the
    edge cases.  Only the gathers themselves are counted
    (``counts["probe"]``).  Returns the checks of P1 and P2 (the kernel
    line's numbers are those of the 100 MiB table, the ladder's largest;
    every size is under ``sizes``, the edge cases under ``edges``) and the
    card's limits."""
    from rvgrt_tpu_torch.tools import probe_r7

    res = probe_r7.run(dev, counts=(reset_counts, read_counts))
    counts["probe"] = res["launches"]
    n_ladder, n_ref = len(probe_r7.SIZES_MB), len(probe_r7.REF_MB)
    assert res["launches"]["P1"] == n_ladder + n_ref and \
        res["launches"]["P2"] == n_ladder, res["launches"]
    edges = res["edges"]
    assert all(e["bit_exact"] for e in edges) and \
        {e["kernel"] for e in edges} == {"P1", "P2"}, edges
    checks = {}
    for k in ("P1", "P2"):
        rows = [r for r in res["rows"] if r["kernel"] == k]
        main = next(r for r in rows if r["kind"] == "ladder"
                    and r["table_mib"] == max(probe_r7.SIZES_MB))
        checks[k] = dict(main, shape=f"{main['table']} table "
                         f"({main['table_mib']} MiB), {main['idx']} indices",
                         sizes=rows,
                         edges=[e for e in edges if e["kernel"] == k])
    return dict(checks=checks, limits=res["limits"], skipped=res["skipped"])


#: the big worlds: name -> (bench.py's setting, WorldConfig kwargs, whether
#: the phase also runs the reference's traced GI init)
BIG_WORLDS = {"reference": ("BENCH_REF_WORLD=1", {}, True),
              "2048": ("BENCH_CUBE=11", dict(shift_x=11, shift_y=11,
                                             shift_z=11), False)}
#: the GI window of both big worlds: 2^27 cells / gi_sweep_frames (512)
BIG_GI_WINDOW = 262144
#: device memory a big world's build must stay under (the card's 80 GB)
BIG_PEAK_GB = 80.0


def timed_k1_calls(fn, dev) -> tuple:
    """``fn()`` with a ``Timer`` (CUDA events on a GPU, host included)
    around each call of K1's wrapper: (its result, each call's ms)."""
    from rvgrt_tpu_torch.ops import superstep_kernel
    from rvgrt_tpu_torch.utils.timer import Timer

    real = superstep_kernel.trace_supersteps
    ms = []

    def hook(*a, **kw):
        with Timer("", verbose=False, device=dev) as t:
            out = real(*a, **kw)
        ms.append(t.elapsed_ms)
        return out

    superstep_kernel.trace_supersteps = hook
    try:
        out = fn()
    finally:
        superstep_kernel.trace_supersteps = real
    return out, ms


def big_gi_init(world, wcfg, dev, counts: dict, key: str) -> dict:
    """The reference's ``InitialGlobalIlluminate`` on a big world:
    ``config_reference``'s GI init (traced, stride (1, 1), budget 0) over
    all 2^27 cells, ``init_gi_chunked``'s eight 2^24-cell slices, one K1
    launch each; a main-path run (``counts[key]``), timed whole and per
    trace, and the median of 3 more runs (``warm_s``).  Then, uncounted,
    one slice's trace (the middle one) against the plain loop
    (``check_k1``: superstep by superstep and in one launch, bit for bit,
    with its graph time and count-once bound)."""
    import torch

    from rvgrt_tpu_torch.config import config_reference
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.utils.timer import Timer, timed_ms

    ecfg = dataclasses.replace(config_reference(), world=wcfg)
    assert ecfg.gi_init_mode == "traced" and ecfg.gi_straggler_budget == 0
    assert tuple(ecfg.gi_init_stride) == (1, 1)
    w = world
    cells = wcfg.gi_num_cells
    slice_cells = min(1 << 24, cells)  # init_gi_chunked's default chunk

    def init():
        return gi_update.init_gi_strided(w.bits, w.sdf, ecfg, sky_y=w.sky_y,
                                         table=w.trace_table, stride=(1, 1))

    reset_counts()
    with Timer("", verbose=False, device=dev) as t:
        words, trace_ms = timed_k1_calls(init, dev)
    c = counts[key] = read_counts()
    st = wavefront.read_stats()
    traces = -(-cells // slice_cells)
    assert c["K1"] == st["traces"] == len(trace_ms) == traces, (c, st)
    lit = int(((words & 0xFFFFFF) != 0).sum())
    assert 0 < lit < words.numel(), lit
    out = dict(cells=cells, lanes_per_trace=slice_cells, s=t.elapsed_ms / 1e3,
               warm_s=timed_ms(lambda _: init(), dev, reps=3,
                               warmup=0) / 1e3,
               trace_ms=trace_ms, launches=c, traces=st["traces"],
               supersteps=st["supersteps"], lit_share=lit / words.numel())
    del words
    log(f"traced GI init: {out}")

    off = (traces // 2) * slice_cells
    calls = capture_k1(lambda: gi_update.init_gi(
        w.bits, w.sdf, ecfg, sky_y=w.sky_y, table=w.trace_table, offset=off,
        count=slice_cells))
    assert len(calls) == 1 and calls[0][1]["flags"].numel() == slice_cells
    out["k1_slice"] = dict(check_k1(
        wcfg, w.trace_table, w.sky_y, *calls[0], dev, plain_reps=1,
        what=f"the traced GI init's slice at cell {off}"), offset=off)
    del calls
    torch.cuda.empty_cache()
    log(f"K1 on GI init slice at {off}: {out['k1_slice']}")
    return out


def phase_big_world(dev, name: str, frames: int, counts: dict,
                    wcfg=None) -> dict:
    """A big world of ``BIG_WORLDS`` (``wcfg`` overrides its WorldConfig, to
    rehearse at a small size) at bench.py's operating point, as bench.py
    builds it with ``BENCH_REF_WORLD=1`` or ``BENCH_CUBE=11`` (heightfield
    GI init, stride (2, 2)):

    1. the world build (main path, ``counts[name + "_build"]``): wall time,
       phase times and each phase's peak device memory, under
       ``BIG_PEAK_GB``;
    2. K3 bit for bit against its plain version at the build's four passes,
       with its graph time, bound and the plain version's time;
    3. for the reference world, the traced GI init (``big_gi_init``);
    4. bench.py's frames (main path, ``counts[name + "_frames"]``): 2
       warm-up and ``frames`` timed frames of ``driver/frame_loop.py``, the
       tier mix, K1 launches == traces, one K2 launch a frame, the GI window
       of ``BIG_GI_WINDOW`` cells with its respite;
    5. K1 bit for bit on the last frame's checkerboard primary trace (with
       its graph time and count-once bound) and on a GI window's respite
       phases 1 and 2;
    6. the image's shape, finiteness and spread, and a non-zero hit share.

    Returns the report; ``report["k1"]`` and ``report["k3_passes"]`` feed
    the kernel line."""
    import torch

    from rvgrt_tpu_torch.config import WorldConfig
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.trace import wavefront

    bench, kw, traced = BIG_WORLDS[name]
    wcfg = wcfg or WorldConfig(**kw)
    ecfg = headline_config(wcfg, WIDTH, HEIGHT)
    report = {"world": f"{wcfg.size_x}x{wcfg.size_y}x{wcfg.size_z}",
              "bench": bench, "phase_wall_s": {}}
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        report["phase_wall_s"][what] = now - clock[0]
        clock[0] = now

    # 1. the build
    torch.cuda.empty_cache()
    phase_s, phase_gb = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    world = engine.build_world(ecfg, verbose=False, device=dev,
                               phase_times=phase_s, phase_peak_gb=phase_gb)
    torch.cuda.synchronize()
    c = counts[f"{name}_build"] = read_counts()
    peak = max(phase_gb.values()) if phase_gb else 0.0
    report["build"] = dict(wall_s=time.perf_counter() - t0, phase_s=phase_s,
                           phase_peak_gb=phase_gb, peak_mem_gb=peak,
                           launches=c, words=wcfg.num_words,
                           coarse_cells=wcfg.sdf_num_cells,
                           table_words=int(world.trace_table.numel()),
                           gi_cells=wcfg.gi_num_cells,
                           resident_gb=torch.cuda.memory_allocated() / 1e9)
    log(f"{name} world build: {report['build']}")
    assert c["K3"] == 4 and c["K1"] == 0, c
    assert peak < BIG_PEAK_GB, f"the build's peak {peak} GB"
    lap("build")

    # 2. K3 at the build's four passes
    report["k3_passes"] = k3_build_passes(world.bits, wcfg, dev, plain_reps=1)
    torch.cuda.empty_cache()
    lap("check_k3")

    # 3. the reference's traced GI init
    if traced:
        report["gi_init"] = big_gi_init(world, wcfg, dev, counts,
                                        f"{name}_gi_init")
        lap("gi_init")

    # 4. bench.py's frames
    if wcfg.gi_num_cells == 1 << 27:
        assert ecfg.gi_window == BIG_GI_WINDOW, ecfg.gi_window
    pose = headline_pose(world.bits, wcfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = run_loop(world, ecfg, pose, frames, dev, scale=3)
    torch.cuda.synchronize()
    c = counts[f"{name}_frames"] = read_counts()
    stats = wavefront.read_stats()
    rep = loop_report(run, c, stats)
    last = run["results"][-1]
    check_image(last.image, (3 * HEIGHT, 3 * WIDTH, 3))
    hit_share = float((last.out.depth != 1.0).float().mean())
    rep.update(render=f"{WIDTH}x{HEIGHT} -> {3 * WIDTH}x{3 * HEIGHT}",
               camera=pose, hit_share=hit_share, gi_window=ecfg.gi_window,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["frames"] = rep
    log(f"{name} frames: median {rep['ms_median']:.1f} ms, tiers "
        f"{rep['per_tier']}, K1 launches {c['K1']} for {stats['traces']} "
        f"traces ({stats['respites']} two-phase), overflow "
        f"{rep['straggler_overflow']}, hit share {hit_share}")
    assert 0.0 < hit_share, "every pixel is sky"
    assert rep["tier_mix"] == expected_mix(frames), rep["tier_mix"]
    check_launches(c, stats, len(run["ms"]), run["loop"].gi_windows)
    lap("frames")

    # 5. K1 on this world's traces
    cfg, w = wcfg, world
    r = ecfg.render
    cam = run["cams"][-1][1]
    del run, last
    checker = k1_primary(lambda: pipeline.render_frame(
        w.bits, w.sdf, w.gi, w.atlas, cam, ecfg, include_gi=False,
        sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
        checker_parity=1), r.height * (r.width // 2))
    k1 = check_k1(cfg, w.trace_table, w.sky_y, *checker, dev, plain_reps=1,
                  what=f"the {name} world's checkerboard primary trace")
    del checker
    calls = capture_k1(lambda: gi_update.update_gi(
        w.gi, w.bits, w.sdf, w.atlas, ecfg, 0, 0, sky_y=w.sky_y,
        table=w.trace_table))
    assert len(calls) == 4, len(calls)
    assert calls[2][0].max_supersteps == GI_BUDGET, calls[2][0]
    k1["traces"] = {"gi_phase1": check_k1_trace(cfg, w.trace_table, w.sky_y,
                                                *calls[2], dev),
                    "gi_phase2": check_k1_trace(cfg, w.trace_table, w.sky_y,
                                                *calls[3], dev)}
    del calls
    if traced:
        k1["traces"]["gi_init_slice"] = report["gi_init"]["k1_slice"]
    report["k1"] = k1
    log(f"{name} K1: {k1}")
    lap("check_k1")
    return report


#: timed frames of each render switch's loop (slim carry, fused cone),
#: after frame_loop.WARMUP
SWITCH_FRAMES = 6


def write_png(path: str, img) -> None:
    """An 8-bit RGBA PNG of the (H, W, 4) uint8 array ``img``, row y
    filtered with PNG filter y % 5 (None, Sub, Up, Average, Paeth), so
    that the decoder's every filter runs."""
    import struct
    import zlib

    import numpy as np

    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        f = y % 5
        pred = [0, left, up, (left + up) >> 1, paeth][f]
        raw.append(f)
        raw += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(bytes(raw), 6))
                + chunk(b"IEND", b""))


def k1_variant_rounds(cfg, table, sky_y, rcfg, s0, dirs, dev,
                      rounds: int = 4) -> dict:
    """K1's carried and slim variants on one trace's start state, each the
    graph-timed device time of one launch, in alternating rounds
    (carried, slim, slim, carried, ...): a graph timing depends on what
    ran before it."""
    from rvgrt_tpu_torch.ops import superstep_kernel as k1
    from rvgrt_tpu_torch.utils.timer import graph_ms

    variants = {name: dataclasses.replace(rcfg, slim_carry=name == "slim")
                for name in ("carried", "slim")}
    sk = {k: v.clone() for k, v in s0.items()}

    def reset():
        for key, v in s0.items():
            sk[key].copy_(v)

    ms = {name: [] for name in variants}
    for r in range(rounds):
        for name in (("carried", "slim") if r % 2 == 0
                     else ("slim", "carried")):
            rc = variants[name]
            ms[name].append(graph_ms(lambda rc=rc: k1.trace_supersteps(
                cfg, rc, table, dirs, sk, sky_y=sky_y), dev, setup=reset))
    return {**{f"{n}_rounds_ms": v for n, v in ms.items()},
            **{f"{n}_ms": statistics.median(v) for n, v in ms.items()}}


def read_mjpeg_part(stream) -> bytes:
    """One part of the viewer's multipart MJPEG stream: its JPEG bytes."""
    line = stream.readline()
    assert line == b"--f\r\n", line
    headers = {}
    while True:
        line = stream.readline()
        if line in (b"\r\n", b""):
            break
        key, val = line.decode().split(":", 1)
        headers[key.strip().lower()] = val.strip()
    data = stream.read(int(headers["content-length"]))
    assert stream.read(2) == b"\r\n"
    assert headers["content-type"] == "image/jpeg" and data[:2] == \
        b"\xff\xd8", headers
    return data


def phase_viewer(ecfg, world, pose, dev, counts: dict) -> dict:
    """``driver/viewer.py`` over a real engine (the headline config on the
    1024^3 world, ``Engine.step`` at full rate with GI every frame): the
    server on 127.0.0.1, port 0; three MJPEG parts fetched with urllib, one
    input POSTed (it must move the camera), the server stopped.  Counted as
    a main path (``counts["viewer"]``): K1 launches == traces."""
    import json
    import urllib.request

    import numpy as np
    import torch

    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.driver.viewer import ViewerServer
    from rvgrt_tpu_torch.trace import wavefront

    eng = engine.Engine(ecfg, verbose=False, device=dev,
                        world=engine.World(**vars(world)))
    eng.character = make_character(ecfg, pose)
    reset_counts()
    srv = ViewerServer(eng, host="127.0.0.1", port=0).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        t0 = time.perf_counter()
        arrivals, sizes = [], []
        with urllib.request.urlopen(base + "/stream", timeout=300) as s:
            for _ in range(3):
                sizes.append(len(read_mjpeg_part(s)))
                arrivals.append((time.perf_counter() - t0) * 1e3)
        pos0 = eng.character.position.copy()
        seen = srv.frame_count
        req = urllib.request.Request(
            base + "/input", data=json.dumps({"move_z": 1}).encode(),
            method="POST")
        assert urllib.request.urlopen(req, timeout=60).status == 204
        deadline = time.time() + 120
        while srv.frame_count < seen + 2 and time.time() < deadline:
            time.sleep(0.01)
        moved = float(np.linalg.norm(eng.character.position - pos0))
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=60).read())
    finally:
        srv.stop()
    torch.cuda.synchronize(dev)
    c = counts["viewer"] = read_counts()
    st = wavefront.read_stats()
    assert srv.frame_count >= seen + 2, (srv.frame_count, seen)
    assert moved > 0.0, "the posted input did not move the camera"
    assert c["K1"] == st["traces"] > 0, (c, st)
    return dict(parts_arrival_ms=arrivals, jpeg_bytes=sizes,
                frames=srv.frame_count, last_frame_ms=srv.last_frame_ms,
                stats=stats, moved=moved, launches=c,
                traces=st["traces"])


def phase_switches(eng, ecfg, pose, dev, counts: dict,
                   frames: int = SWITCH_FRAMES) -> dict:
    """The render switches the JAX package has beside the headline's
    defaults, on the 1024^3 world at 1280x800 -> 3840x2400: slim carry
    (``BENCH_SLIM=1``): bench.py's loop (``WARMUP`` + ``frames``), K1's slim
    variant bit for bit against the slim plain loop on the checkerboard
    primary trace (with its bound) and on a GI window's two respite
    phases, and graph-timed against the carried variant in alternating
    rounds; the fused cone table (``gi_fused_cone``): the loop, and a GI
    frame and one without under ``torch.profiler`` with the flag on and
    off (their eager launches), and one 64^3 frame on the card against the CPU's
    plain path (>= 50 dB); the temporal start hints: two frames, the
    second hinted from the first's prepass, against the unhinted second
    (hits within n/1000, >= 50 dB; with ``sky_start`` the flips are only
    counted); the PNG atlas: a world built with
    ``REFERENCE_PNG`` pointing at a PNG this script writes, and a
    headline base frame with it; the viewer (``phase_viewer``); and
    ``utils/profiling.device_time_ms`` on one frame beside its CUDA-event
    time.  The loops, the hinted frame and the viewer are main paths,
    each counted on its own."""
    import os
    import tempfile

    import numpy as np
    import torch

    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.driver import engine, frame_loop
    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.utils import profiling
    from rvgrt_tpu_torch.utils.timer import Timer
    from rvgrt_tpu_torch.world import atlas as atlas_mod
    from rvgrt_tpu_torch.world import gi_grid

    w, cfg = eng.world, ecfg.world
    rep = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rep.setdefault("wall_s", {})[name] = now - clock[0]
        clock[0] = now

    def switched(**render):
        return dataclasses.replace(ecfg, render=dataclasses.replace(
            ecfg.render, **render))

    # ---- slim carry: bench.py's loop with BENCH_SLIM=1 (main path) ----
    slim = switched(slim_carry=True)
    reset_counts()
    run = run_loop(w, slim, pose, frames, dev, scale=3)
    torch.cuda.synchronize(dev)
    c = counts["slim_carry"] = read_counts()
    st = wavefront.read_stats()
    loop_rep = loop_report(run, c, st)
    assert loop_rep["tier_mix"] == expected_mix(frames), loop_rep["tier_mix"]
    check_launches(c, st, len(run["ms"]), run["loop"].gi_windows)
    check_image(run["results"][-1].image, (3 * HEIGHT, 3 * WIDTH, 3))
    cam = run["cams"][-1][1]
    rs, s0, dirs = k1_primary(lambda: pipeline.render_frame(
        w.bits, w.sdf, w.gi, w.atlas, cam, slim, include_gi=False,
        sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
        checker_parity=1), HEIGHT * (WIDTH // 2))
    assert rs.slim_carry
    k1s = check_k1(cfg, w.trace_table, w.sky_y, rs, s0, dirs, dev,
                   plain_reps=1, what="the slim checkerboard primary trace")
    calls = capture_k1(lambda: gi_update.update_gi(
        w.gi, w.bits, w.sdf, w.atlas, slim, 0, 0, sky_y=w.sky_y,
        table=w.trace_table))
    assert len(calls) == 4 and all(k[0].slim_carry for k in calls), calls
    k1s["traces"] = {name: check_k1_trace(cfg, w.trace_table, w.sky_y,
                                          *calls[i], dev)
                     for name, i in (("gi_phase1", 2), ("gi_phase2", 3))}
    k1s["against_carried"] = k1_variant_rounds(cfg, w.trace_table, w.sky_y,
                                               rs, s0, dirs, dev)
    rep["slim_carry"] = dict(loop=loop_rep, k1=k1s)
    log(f"slim carry: median {loop_rep['ms_median']:.1f} ms, K1 "
        f"{c['K1']} launches for {st['traces']} traces; K1 slim "
        f"{k1s['ms']:.4f} ms (bound {k1s['bound_ms']:.4f}), rounds "
        f"{k1s['against_carried']}")
    del run, calls
    lap("slim_carry")

    # ---- the fused cone table (main path) ----
    cone = switched(gi_fused_cone=True)
    with Timer("occlusion", verbose=False, device=dev) as t:
        wc = engine.World(**{**vars(w),
                             "gi_occ": gi_grid.build_occlusion(w.sdf, cfg)})
    occ_ms = t.elapsed_ms
    reset_counts()
    runc = run_loop(wc, cone, pose, frames, dev, scale=3)
    torch.cuda.synchronize(dev)
    c = counts["fused_cone"] = read_counts()
    st = wavefront.read_stats()
    cone_rep = loop_report(runc, c, st)
    check_launches(c, st, len(runc["ms"]), runc["loop"].gi_windows)
    check_image(runc["results"][-1].image, (3 * HEIGHT, 3 * WIDTH, 3))
    per_frame = {}
    for name, e, world in (("on", cone, wc), ("off", ecfg, w)):
        loop = frame_loop.FrameLoop(world, e, scale=3)
        per_frame[name] = []
        for i in range(2):  # a GI frame and one without
            cam_i, rate_i = runc["cams"][i][1], runc["rates"][i]
            wall, busy, n, _ = profiled(
                lambda i=i, cam_i=cam_i, rate_i=rate_i: loop.frame(
                    i, cam_i, rate_i))
            per_frame[name].append(dict(
                frame=i, rate=rate_i, gi=i % frame_loop.GI_CADENCE == 0,
                wall_ms=wall, device_busy_ms=busy, device_launches=n))
        del loop
    small = headline_config(6, 128, 80)
    small = dataclasses.replace(small, render=dataclasses.replace(
        small.render, gi_fused_cone=True))
    outs = {}
    for d in (dev, "cpu"):
        e = engine.Engine(small, verbose=False, device=d)
        e.character = make_character(small, REF_POSE)
        outs[str(d)] = (u32.to_numpy(e.world.gi_occ), e.step(time_s=1.0))
    (occ_g, og), (occ_c, oc) = outs[str(dev)], outs["cpu"]
    np.testing.assert_array_equal(occ_g, occ_c, err_msg="gi_occ")
    cone_db = psnr(og.color, oc.color)
    assert cone_db >= 50.0, cone_db
    assert bool(((og.depth == 1.0).cpu() == (oc.depth == 1.0)).all())
    rep["fused_cone"] = dict(
        loop=cone_rep, occlusion_build_ms=occ_ms,
        launches_per_frame=per_frame,
        reference_64=dict(composite_psnr_db=cone_db, gi_occ_bit_exact=True,
                          hit_classification_equal=True))
    log(f"fused cone: median {cone_rep['ms_median']:.1f} ms; launches a "
        f"frame on {[f['device_launches'] for f in per_frame['on']]}, off "
        f"{[f['device_launches'] for f in per_frame['off']]}; 64^3 GPU vs "
        f"CPU {cone_db:.1f} dB")
    del runc, wc, outs
    lap("fused_cone")

    # ---- the temporal start hints (main path: the hinted frame) ----
    cams = frame_loop.path_cameras(make_character(ecfg, pose),
                                   frame_loop.path_yaws(2)[:2], time_s=1.0,
                                   device=dev)
    (_, cam0), (_, cam1) = cams

    def base(cam, **kw):
        with Timer("frame", verbose=False, device=dev) as t:
            out = pipeline.render_frame(
                w.bits, w.sdf, w.gi, w.atlas, cam, ecfg, include_gi=False,
                sky_y=w.sky_y, table=w.trace_table, **kw)
        return out, t.elapsed_ms

    out0, ms0 = base(cam0)
    wavefront.reset_stats()
    ref1, ms_ref = base(cam1)
    st_ref = wavefront.read_stats()
    ref_hit = ref1.depth < 1.0
    # sky_start (an all-sky window under a camera that did not move
    # retires the ray at once), as tests/test_temporal_starts.py passes it:
    # measured, not held - JAX's docstring warns that a start beyond
    # miss_distance - dist_bias drops distant hits the prepass missed
    hh, hf = pipeline.temporal_hints_from_prepass(
        out0.half_dist, cam1, cam0, ecfg.render, sky_start=4.0 * cfg.size_x)
    sky1, _ = base(cam1, hint_half=hh, hint_full=hf)
    sky_flipped = int((ref_hit != (sky1.depth < 1.0)).sum())
    del hh, hf, sky1
    hint_half, hint_full = pipeline.temporal_hints_from_prepass(
        out0.half_dist, cam1, cam0, ecfg.render)
    reset_counts()
    got1, ms_hint = base(cam1, hint_half=hint_half, hint_full=hint_full)
    torch.cuda.synchronize(dev)
    c = counts["hints"] = read_counts()
    st = wavefront.read_stats()
    assert c["K1"] == st["traces"] > 0, (c, st)
    got_hit = got1.depth < 1.0
    flipped = int((ref_hit != got_hit).sum())
    hint_db = psnr(got1.color, ref1.color)
    far = float(((ref1.half_dist - got1.half_dist).abs() > 0.51)
                .float().mean())
    assert flipped <= max(1, ref_hit.numel() // 1000), flipped
    assert hint_db >= 50.0, hint_db
    assert far <= 2e-3, far
    rep["hints"] = dict(flipped_hits=flipped, pixels=ref_hit.numel(),
                        flipped_hits_with_sky_start=sky_flipped,
                        color_psnr_db=hint_db, half_dist_far_share=far,
                        hinted_share=float((hint_full > 0).float().mean()),
                        frame_ms=dict(first=ms0, unhinted=ms_ref,
                                      hinted=ms_hint),
                        launches=c, traces=st["traces"],
                        supersteps=st["supersteps"],
                        supersteps_unhinted=st_ref["supersteps"])
    log(f"hints: {rep['hints']}")
    del out0, ref1, got1, hint_half, hint_full
    lap("hints")

    # ---- the PNG atlas ----
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:256, 0:256]
    img = ((np.stack([xx, yy, xx ^ yy, xx + yy], -1)
            + rng.integers(0, 40, (256, 256, 4))) & 0xFF).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "texturepack.png")
        write_png(path, img)
        real = atlas_mod.REFERENCE_PNG
        atlas_mod.REFERENCE_PNG = path
        try:
            with Timer("png", verbose=False) as t:
                wp = engine.build_world(headline_config(6, 128, 80),
                                        verbose=False, device=dev)
        finally:
            atlas_mod.REFERENCE_PNG = real
        want = atlas_mod.load_png(path, device=dev)
    proc = atlas_mod.procedural_atlas(dev)
    assert torch.equal(wp.atlas, want) and not torch.equal(want, proc)
    frames_png = {}
    for name, atl in (("png", want), ("procedural", proc)):
        out = pipeline.render_frame(
            w.bits, w.sdf, w.gi, atl, cam0, ecfg, include_gi=False,
            sky_y=w.sky_y, table=w.trace_table)
        check_image(out.color, (HEIGHT, WIDTH, 3))
        frames_png[name] = out.color
    differ = float((frames_png["png"] != frames_png["procedural"])
                   .float().mean())
    assert differ > 0.0, "the PNG atlas changed no pixel"
    rep["png_atlas"] = dict(build_64_s=t.elapsed_ms / 1e3,
                            pixels_changed_share=differ)
    del wp, frames_png
    lap("png_atlas")

    # ---- the viewer (main path) ----
    rep["viewer"] = phase_viewer(ecfg, w, pose, dev, counts)
    log(f"viewer: {rep['viewer']}")
    lap("viewer")

    # ---- the profiler on one frame ----
    loop = frame_loop.FrameLoop(w, ecfg, scale=3)
    cam_p = cams[0][1]

    def frame():
        loop.frame(0, cam_p, "checker")

    dev_ms, top = profiling.device_time_ms(frame, warmup=1)
    with Timer("frame", verbose=False, device=dev) as t:
        frame()
    assert math.isfinite(dev_ms) and 0.0 < dev_ms, dev_ms
    rep["profiler"] = dict(device_time_ms=dev_ms, event_ms=t.elapsed_ms,
                           top_kernels_ms=top)
    log(f"profiler: device {dev_ms:.2f} ms, CUDA events {t.elapsed_ms:.2f}"
        f" ms")
    lap("profiler")
    return rep


#: phase B's ring: ranks on the one card, its bounded packet, and the
#: reduced frame (the world's log2 edge and the frame's size)
RING_RANKS = 4
RING_HANDOFF_CAP = 65536
RING_FRAME = (8, 320, 200)
PARALLEL_FRAMES = 6
#: a ring trace's result fields
RING_FIELDS = ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
               "its", "t")


def headline_rays(cam, rcfg) -> list:
    """The primary rays of a frame at ``cam``, flat: the camera's position,
    ``render_slab``'s ray directions and a start distance of 0."""
    import torch

    from rvgrt_tpu_torch.render import pipeline

    dx, dy, dz = pipeline._ray_dirs(cam, rcfg.width, rcfg.height,
                                    pixel_center=False)
    n = dx.numel()
    o = [cam.pos[i].expand(n).contiguous() for i in range(3)]
    return o + [a.reshape(-1).contiguous() for a in (dx, dy, dz)] + [
        torch.zeros(n, dtype=torch.float32, device=dx.device)]


def _frame_diff(a, b) -> dict:
    """PSNR and the share of pixels off by more than 0.02 (the volume
    frame gates of tests/test_volume.py)."""
    import torch

    d = (a.double() - b.double())
    mse = float((d * d).mean())
    off = float((d.abs().amax(dim=-1) > 0.02).double().mean())
    return dict(psnr=99.0 if mse == 0 else -10.0 * math.log10(mse),
                frac_off=off, max_abs=float(d.abs().max()))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_k1_zedges(w, cfg, rcfg, cam, dev) -> dict:
    """K1's ZEDGES instantiations against the plain loop on the headline's
    primary rays, at the 1024^3 world cut into 4 z-slabs
    (``volume.slab_table``, the tables ``build_shard_tables`` gives each
    rank): slab 2, where the camera sits (on its low face), with z_edges
    (False, False) and, as if it were the world's first slab, (True,
    False); and slab 0 with (True, False), the rays moved 512 voxels down
    in z so that the camera sits on slab 0's low face, the world's own;
    each carried and slim.  The (False, False) traces also superstep by
    superstep, with their graph time and count-once bound."""
    import torch

    from rvgrt_tpu_torch.parallel import volume
    from rvgrt_tpu_torch.trace import wavefront as wf

    n_slabs = 4
    lcfg = volume.local_config(cfg, n_slabs)
    slab = lcfg.size_z
    rays = headline_rays(cam, rcfg)
    cam_slab = int(float(cam.pos[2]) // slab)
    assert cam_slab == 2, cam_slab
    rep = {"slab_depth": slab, "lanes": rays[0].numel()}
    # the camera on the low face of either slab: its local z is 0
    oz = rays[2] - float(slab * cam_slab)
    for index, edges in ((2, (False, False)), (2, (True, False)),
                         (0, (True, False))):
        table = volume.slab_table(w.bits, w.sdf, cfg, n_slabs, index)
        for slim in (False, True):
            rc = dataclasses.replace(rcfg, slim_carry=slim)
            s0, dirs = wf.start_state(lcfg, rays[0], rays[1], oz, *rays[3:],
                                      sky_y=w.sky_y, z_edges=edges)
            key = f"slab{index}{'_first' if index and edges[0] else ''}_" \
                  f"{'slim' if slim else 'carried'}"
            rep[key] = check_k1_trace(lcfg, table, w.sky_y, rc, s0, dirs,
                                      dev, z_edges=edges)
            if edges == (False, False):
                rep[key].update(check_k1(
                    lcfg, table, w.sky_y, rc, s0, dirs, dev, plain_reps=1,
                    what=f"the headline primary rays in slab {index} of 4",
                    z_edges=edges))
            del s0, dirs
        del table
    for slim in ("carried", "slim"):
        r = rep[f"slab2_{slim}"]
        assert r["exits_low"] > 0 and r["exits_high"] > 0, r
        r = rep[f"slab2_first_{slim}"]
        assert r["exits_low"] == 0 and r["exits_high"] > 0, r
        assert rep[f"slab0_{slim}"]["exits_low"] == 0, rep[f"slab0_{slim}"]
    torch.cuda.synchronize(dev)
    return rep


def phase_parallel_one(eng, ecfg, cams, dev, counts: dict,
                       frames: int = PARALLEL_FRAMES) -> dict:
    """Phase A: ``parallel/`` over a 1-rank NCCL group at the headline
    (1280x800 -> 3840x2400 on the 1024^3 world).  The sharded path
    (main path, counted): ``frames`` frames of ``render_frame_sharded``,
    ``update_gi_sharded`` every 2nd frame and ``temporal_upscale_sharded
    (warp_taps="pallas")``, each held against ``render_slab`` at full
    height, ``update_gi`` and ``temporal_upscale`` on the same inputs and
    timed beside them (CUDA events, host included; the medians leave out
    each call's first).  The volume path (main
    path, counted): ``trace_volume_sharded`` of the headline's primary rays,
    carried and slim (each bit for bit against ``trace``; the ring runs no
    respite), and
    ``render_frame_volume`` (PSNR > 30 dB, under 3 % of pixels off by more
    than 0.02, against ``render_frame``)."""
    import torch
    import torch.distributed as dist

    from rvgrt_tpu_torch.gi import update as gi_update
    from rvgrt_tpu_torch.parallel import sharding, volume
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.upscale import temporal
    from rvgrt_tpu_torch.utils.timer import Timer

    w, cfg, r = eng.world, ecfg.world, ecfg.render
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rep = {"transport": backend, "ranks": 1}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = sharding.make_mesh(1, device_type=dev.type)
        zmesh = sharding.make_mesh(1, axis="z", device_type=dev.type)

        def timed(fn):
            with Timer("", verbose=False, device=dev) as t:
                out = fn()
            return out, t.elapsed_ms

        # ---- the sharded path (main path, counted) and the same inputs
        # unsharded (not counted), interleaved a frame at a time, the
        # order alternating ----
        c = {k: 0 for k in COUNTERS}
        traces = [0]

        def counted(fn):
            wavefront.reset_stats()
            before = read_counts()
            out = timed(fn)
            traces[0] += wavefront.read_stats()["traces"]
            for k, v in read_counts().items():
                c[k] += v - before[k]
            return out

        def pair(f, sharded, unsharded):
            """(sharded result, unsharded result, (sharded ms, unsharded
            ms)), the order alternating with the frame."""
            if f % 2 == 0:
                a, ta = counted(sharded)
                b, tb = timed(unsharded)
            else:
                b, tb = timed(unsharded)
                a, ta = counted(sharded)
            return a, b, (ta, tb)

        gi, off = w.gi, 0
        packed = temporal.pack_state(temporal.init_state(r.height, r.width,
                                                         device=dev))
        st_ref = temporal.init_state(r.height, r.width, device=dev)
        frame_ms, gi_ms, up_ms = [], [], []
        up_err, packed_same = 0.0, []
        for f in range(frames):
            cam = cams[f][1]
            out, ref, ms = pair(
                f, lambda: sharding.render_frame_sharded(
                    w.bits, w.sdf, gi, w.atlas, cam, ecfg, mesh,
                    include_gi=True, gi_occ=w.gi_occ, sky_y=w.sky_y,
                    table=w.trace_table),
                lambda: pipeline.render_slab(
                    w.bits, w.sdf, gi, w.atlas, cam, ecfg, 0, r.height,
                    include_gi=True, gi_occ=w.gi_occ, sky_y=w.sky_y,
                    table=w.trace_table))
            frame_ms.append(ms)
            for a, b in zip(out, ref):
                assert torch.equal(a, b), "render_frame_sharded differs"
            if f % 2 == 0:
                gi_s, gi_u, ms = pair(
                    f, lambda: sharding.update_gi_sharded(
                        gi, w.bits, w.sdf, w.atlas, ecfg, f, off, mesh,
                        sky_y=w.sky_y, table=w.trace_table),
                    lambda: gi_update.update_gi(
                        gi, w.bits, w.sdf, w.atlas, ecfg, f, off,
                        sky_y=w.sky_y, table=w.trace_table))
                gi_ms.append(ms)
                assert torch.equal(gi_s, gi_u), "update_gi_sharded differs"
                gi = gi_s
                off = gi_update.advance_offset(off, ecfg)
            (up, packed), (uref, st_ref), ms = pair(
                f, lambda: sharding.temporal_upscale_sharded(
                    out.color, out.motion, cam.jitter, packed, mesh,
                    warp_taps="pallas"),
                lambda: temporal.temporal_upscale(
                    out.color, out.motion, out.depth, cam.jitter, st_ref,
                    warp_taps="pallas"))
            up_ms.append(ms)
            up_err = max(up_err, float((uref - up).abs().max()))
            packed_same.append(float((temporal.pack_state(st_ref)
                                      == packed).double().mean()))
        counts["sharded_n1"] = c
        assert c["K1"] == traces[0] > 0 and c["K2"] == frames, (c, traces)
        assert up_err <= 1.5 / 255, up_err
        rep["sharded"] = dict(
            frames=frames, launches=c, traces=traces[0],
            bit_exact=["render_frame_sharded (all 5 outputs)",
                       "update_gi_sharded (the words)"],
            upscale_max_abs_vs_unsharded=up_err,
            upscale_packed_words_equal_share=packed_same,
            **{f"{k}_ms_sharded_unsharded": v for k, v in (
                ("frame", frame_ms), ("gi", gi_ms), ("upscale", up_ms))},
            **{f"{k}_ms_median": dict(
                sharded=statistics.median(a for a, _ in v),
                unsharded=statistics.median(b for _, b in v))
               for k, v in (("frame", frame_ms[1:]), ("gi", gi_ms[1:]),
                            ("upscale", up_ms[1:]))})
        log(f"phase A sharded (1 rank): {rep['sharded']}")

        # ---- the volume path (main path) ----
        cam = cams[-1][1]
        rays = headline_rays(cam, r)
        ring_rep = {}
        reset_counts()
        tables, table_ms = timed(lambda: volume.build_shard_tables(
            w.bits, w.sdf, cfg, zmesh))
        ring, ring_ms = timed(lambda: volume.trace_volume_sharded(
            tables, cfg, r, zmesh, *rays, sky_y=w.sky_y, report=ring_rep))
        slim = dataclasses.replace(r, slim_carry=True)  # BENCH_SLIM=1
        ring_slim, ring_slim_ms = timed(lambda: volume.trace_volume_sharded(
            tables, cfg, slim, zmesh, *rays, sky_y=w.sky_y))
        vframe, vframe_ms = timed(lambda: volume.render_frame_volume(
            tables, w.sdf, w.gi, w.atlas, cam, ecfg, zmesh, include_gi=True,
            sky_y=w.sky_y))
        torch.cuda.synchronize(dev)
        c = counts["volume_n1"] = read_counts()
        assert c["K1_zedges"] + c["K1_zedges_slim"] == c["K1"], c
        assert c["K1_zedges"] > 0 and c["K1_zedges_slim"] > 0, c
        assert torch.equal(tables, w.trace_table)
        plain, plain_ms = timed(lambda: wavefront.trace(
            None, None, cfg, dataclasses.replace(r, straggler_budget=0),
            *rays, table=w.trace_table, sky_y=w.sky_y))
        plain_slim = wavefront.trace(
            None, None, cfg, dataclasses.replace(slim, straggler_budget=0),
            *rays, table=w.trace_table, sky_y=w.sky_y)
        for f in RING_FIELDS:
            assert torch.equal(getattr(ring, f), getattr(plain, f)), f
            assert torch.equal(getattr(ring_slim, f),
                               getattr(plain_slim, f)), f
        single, single_ms = timed(lambda: pipeline.render_frame(
            w.bits, w.sdf, w.gi, w.atlas, cam, ecfg, include_gi=True,
            gi_occ=w.gi_occ, sky_y=w.sky_y, table=w.trace_table))
        diff = _frame_diff(vframe.color, single.color)
        assert diff["psnr"] > 30.0 and diff["frac_off"] < 0.03, diff
        rep["volume"] = dict(
            launches=c, rays=rays[0].numel(), ring=ring_rep,
            ring_trace_bit_exact=True, table_ms=table_ms, ring_ms=ring_ms,
            ring_slim_ms=ring_slim_ms,
            trace_ms=plain_ms, frame_ms=vframe_ms,
            render_frame_ms=single_ms, frame_vs_render_frame=diff,
            hit_share=float(plain.hit.double().mean()))
        log(f"phase A volume (1 rank): {rep['volume']}")
    finally:
        dist.destroy_process_group()
    return rep


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ring_rank(rank: int, n: int, port: int, folder: str) -> None:
    """One rank of phase B, in a process of its own on card 0, in a gloo
    group (packets staged through host memory): the ring trace of the
    headline's primary rays, unbounded and bounded, and the reduced frame;
    each rank writes its times, reports, launch counts and (rank 0) the
    results beside the job."""
    import torch
    import torch.distributed as dist

    from rvgrt_tpu_torch.parallel import sharding, volume
    from rvgrt_tpu_torch.render.pipeline import CameraArrays
    from rvgrt_tpu_torch.trace import wavefront

    torch.set_num_threads(2)
    d = Path(folder)
    job = torch.load(d / "job.pt", weights_only=False)
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = sharding.make_mesh(n, axis="z", device_type=dev.type)
        on = lambda t: t.to(dev)  # noqa: E731
        table = on(torch.load(d / f"table_{rank}.pt"))
        rays = [on(a) for a in job["rays"]]
        out = {}
        reset_counts()
        # a first ring over 4096 of the rays takes each process's first
        # calls' set-up out of the timed rings
        volume.trace_volume_sharded(table, job["cfg"], job["rcfg"], mesh,
                                    *[a[:4096] for a in rays],
                                    sky_y=on(job["sky_y"]))
        for name, cap in (("unbounded", None),
                          ("bounded", job["handoff_cap"])):
            rep = {}
            dist.barrier()
            sync(dev)
            t0 = time.perf_counter()
            res = volume.trace_volume_sharded(
                table, job["cfg"], job["rcfg"], mesh, *rays,
                sky_y=on(job["sky_y"]), handoff_cap=cap, report=rep)
            sync(dev)
            out[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3, **rep)
            if rank == 0:
                out[name + "_res"] = {f: getattr(res, f).cpu()
                                      for f in RING_FIELDS}
            del res
        small = job["small"]
        stable = on(torch.load(d / f"small_table_{rank}.pt"))
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        frame = volume.render_frame_volume(
            stable, on(small["sdf"]), on(small["gi"]), on(small["atlas"]),
            CameraArrays(*(on(a) for a in small["cam"])), small["ecfg"],
            mesh, include_gi=True, sky_y=on(small["sky_y"]))
        sync(dev)
        out["frame_wall_ms"] = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            out["frame_color"] = frame.color.cpu()
        out["counts"] = read_counts()
        out["stats"] = wavefront.read_stats()
        torch.save(out, d / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_parallel(eng, ecfg, cams, dev, counts: dict) -> dict:
    """``parallel/`` on the card: K1's ZEDGES instantiations held against
    the plain loop (``phase_k1_zedges``, not counted), phase A over a
    1-rank NCCL group (``phase_parallel_one``) and phase B, the ring over
    four processes on the one card (``phase_volume_ring``)."""
    rep = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        rep.setdefault("wall_s", {})[name] = now - clock[0]
        clock[0] = now

    w, r = eng.world, ecfg.render
    rep["k1_zedges"] = phase_k1_zedges(w, ecfg.world, r, cams[-1][1], dev)
    log(f"K1 z_edges: {json.dumps(rep['k1_zedges'])}")
    lap("k1_zedges")
    rep["A"] = phase_parallel_one(eng, ecfg, cams, dev, counts)
    lap("A")
    rep["B"] = phase_volume_ring(w, ecfg, cams[-1][1], dev, counts)
    lap("B")
    return rep


def phase_volume_ring(w, ecfg, cam, dev, counts: dict,
                      timeout_s: float = 300.0) -> dict:
    """Phase B: the volume ring over ``RING_RANKS`` processes on the one
    card, in a gloo group (NCCL refuses two ranks on one GPU), packets
    staged through host memory - so its times are not NCCL's and not a
    multi-device result.  The parent writes each rank its slab's table
    (``volume.slab_table``), the headline's primary rays and a reduced
    world (``RING_FRAME``: 256^3, 320x200) to files, builds nothing in the
    ranks (the kernel library is already built) and spawns them.  Held:
    the ring trace against the single-device trace to
    ``tests/test_volume.py``'s thresholds; the bounded ring
    (``RING_HANDOFF_CAP``) bit-equal to the unbounded one; the reduced
    frame (``render_frame_volume``, GI on) against ``render_frame``, PSNR
    > 30 dB and under 3 % of pixels off by more than 0.02.  Every rank:
    K1 launches == traces, all of them the ZEDGES variant."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    from rvgrt_tpu_torch.driver import engine, frame_loop
    from rvgrt_tpu_torch.parallel import volume
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.trace import wavefront

    cfg, r = ecfg.world, ecfg.render
    n = RING_RANKS
    folder = ROOT / "rvgrt_tpu_torch" / "_build" / f"ring-{os.getpid()}"
    folder.mkdir(parents=True, exist_ok=True)
    t_setup = time.perf_counter()
    try:
        rays = headline_rays(cam, r)
        for i in range(n):
            torch.save(volume.slab_table(w.bits, w.sdf, cfg, n, i).cpu(),
                       folder / f"table_{i}.pt")
        shift, width, height = RING_FRAME
        secfg = headline_config(shift, width, height)
        small = engine.build_world(secfg, verbose=False, device=dev)
        scam = frame_loop.path_cameras(
            make_character(secfg, headline_pose(small.bits, secfg.world)),
            [0.0], device=dev)[0][1]
        for i in range(n):
            torch.save(volume.slab_table(small.bits, small.sdf, secfg.world,
                                         n, i).cpu(),
                       folder / f"small_table_{i}.pt")
        torch.save(dict(
            device=str(dev), cfg=cfg, rcfg=r, rays=[a.cpu() for a in rays],
            sky_y=w.sky_y.cpu(), handoff_cap=RING_HANDOFF_CAP,
            small=dict(ecfg=secfg, cam=[a.cpu() for a in scam],
                       sdf=small.sdf.cpu(), gi=small.gi.cpu(),
                       atlas=small.atlas.cpu(), sky_y=small.sky_y.cpu())),
            folder / "job.pt")
        setup_s = time.perf_counter() - t_setup

        t0 = time.perf_counter()
        ctx = mp.start_processes(_ring_rank,
                                 args=(n, free_port(), str(folder)),
                                 nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                assert time.monotonic() < deadline, \
                    f"phase B ran over {timeout_s} s"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks_s = time.perf_counter() - t0
        outs = [torch.load(folder / f"out_{i}.pt", weights_only=False)
                for i in range(n)]

        # ---- the checks, in this process ----
        plain = wavefront.trace(None, None, cfg, r, *rays,
                                table=w.trace_table, sky_y=w.sky_y)
        got = {f: v.to(dev) for f, v in outs[0]["unbounded_res"].items()}
        for f in RING_FIELDS:
            assert torch.equal(got[f], outs[0]["bounded_res"][f].to(dev)), f
        agree = got["hit"] == plain.hit
        both = got["hit"] & plain.hit & agree
        match = {f: float(torch.isclose(got[f][both], getattr(plain, f)[both],
                                        atol=2e-2, rtol=0).double().mean())
                 for f in ("px", "py", "pz", "nx", "ny", "nz", "uv_u",
                           "uv_v", "t")}
        agree_share = float(agree.double().mean())
        assert agree_share >= 0.99, agree_share
        assert min(match.values()) >= 0.995, match
        miss = ~got["hit"] & ~plain.hit
        assert bool((got["px"][miss] == wavefront.MISS_POS).all())
        single = pipeline.render_frame(
            small.bits, small.sdf, small.gi, small.atlas, scam, secfg,
            include_gi=True, gi_occ=small.gi_occ, sky_y=small.sky_y,
            table=small.trace_table)
        diff = _frame_diff(outs[0]["frame_color"].to(dev), single.color)
        assert diff["psnr"] > 30.0 and diff["frac_off"] < 0.03, diff
        summed = {k: sum(o["counts"][k] for o in outs) for k in COUNTERS}
        for o in outs:
            c, st = o["counts"], o["stats"]
            assert c["K1"] == st["traces"] == c["K1_zedges"] > 0, (c, st)
        counts["volume_ring"] = summed
        rep = dict(
            transport="gloo-host", ranks=n, device="one card, shared",
            rays=rays[0].numel(), handoff_cap=RING_HANDOFF_CAP,
            hit_agreement=agree_share, geometry_within_2e2=match,
            bounded_equals_unbounded=True, hit_share=float(
                plain.hit.double().mean()),
            frame=dict(world=f"{1 << shift}^3", render=f"{width}x{height}",
                       reduced=f"from 1024^3 and 1280x800 to {1 << shift}^3 "
                               f"and {width}x{height}", **diff),
            launches=summed, setup_s=setup_s, ranks_wall_s=ranks_s,
            per_rank=[{k: o[k] for k in ("unbounded", "bounded",
                                         "frame_wall_ms", "counts", "stats")}
                      for o in outs])
        log(f"phase B ring (gloo-host, {n} ranks on one card): "
            f"{json.dumps(rep)}")
        return rep
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def k1_instantiations(carried: dict, slim: dict, zedges: dict,
                      launches: dict) -> list:
    """K1's four template instantiations (SLIM x ZEDGES): each one's
    launches on the main paths and, on its row's trace, its graph time,
    bound and error against the plain loop."""
    rows = []
    for name, c, n in (
            ("carried", carried, launches["K1"] - launches["K1_slim"]
             - launches["K1_zedges"] - launches["K1_zedges_slim"]),
            ("slim", slim, launches["K1_slim"]),
            ("zedges", zedges["slab2_carried"], launches["K1_zedges"]),
            ("zedges_slim", zedges["slab2_slim"],
             launches["K1_zedges_slim"])):
        rows.append(dict(variant=name, launches=n, **{
            f: c[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "max_abs_err", "shape")}))
    return rows


KERNELS = {
    "K1": dict(name="trace_supersteps",
               source="rvgrt_tpu_torch/csrc/superstep_kernel.cu",
               replaces="rvgrt_tpu/ops/superstep_kernel.py:82"),
    "K2": dict(name="warp_packed_bilinear",
               source="rvgrt_tpu_torch/csrc/warp_kernels.cu",
               replaces="rvgrt_tpu/ops/warp_kernels.py:150"),
    "K3": dict(name="minconv_pass",
               source="rvgrt_tpu_torch/csrc/sdf_kernels.cu",
               replaces="rvgrt_tpu/ops/sdf_kernels.py:82"),
    "P1": dict(name="take_clip",
               source="rvgrt_tpu_torch/csrc/gather_kernels.cu",
               replaces="scripts/probe_r7.py:103"),
    "P2": dict(name="take_along_cols",
               source="rvgrt_tpu_torch/csrc/gather_kernels.cu",
               replaces="scripts/probe_r7.py:126"),
}


def run(dev, cube: int, frames: int, c4_frames: int, full_frames: int,
        profile: int = 0, cli_config: str = "stage4",
        cli_frames: int = 6, big_worlds=tuple(BIG_WORLDS),
        big_frames: int = 6, post_frames: int = 6) -> dict:
    import gc

    import torch

    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.driver.frame_loop import WARMUP
    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.trace import wavefront

    report = {}
    phase_s = report["phase_wall_s"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    _lib.library()
    lap("kernel_build")
    report["kernel_build_s"] = phase_s["kernel_build"]
    log(f"kernels built/loaded in {report['kernel_build_s']:.1f} s")

    # ---- main path: the world build ----
    ecfg = headline_config(cube, WIDTH, HEIGHT)
    torch.cuda.reset_peak_memory_stats()
    phase_times = {}
    reset_counts()
    t0 = time.perf_counter()
    eng = engine.Engine(ecfg, verbose=False, device=dev,
                        phase_times=phase_times)
    torch.cuda.synchronize()
    counts = {"build": read_counts()}
    build_s = time.perf_counter() - t0
    report["build"] = {
        "world": f"{ecfg.world.size_x}x{ecfg.world.size_y}x"
                 f"{ecfg.world.size_z}",
        "wall_s": build_s, "phase_s": phase_times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts["build"]}
    log(f"world build {build_s:.2f} s: {phase_times}")
    assert counts["build"]["K3"] >= 2, counts["build"]
    pose = headline_pose(eng.world.bits, ecfg.world)
    lap("world_build")

    # ---- main path: the headline, bench.py's frames ----
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    head = run_loop(eng.world, ecfg, pose, frames, dev, scale=3)
    torch.cuda.synchronize()
    counts["headline"] = read_counts()
    stats = wavefront.read_stats()
    rep = loop_report(head, counts["headline"], stats)
    last = head["results"][-1]
    check_image(last.image, (3 * HEIGHT, 3 * WIDTH, 3))
    hit_share = float((last.out.depth != 1.0).float().mean())
    assert 0.0 < hit_share, "every pixel is sky"
    rep.update(render=f"{WIDTH}x{HEIGHT} -> {3 * WIDTH}x{3 * HEIGHT}",
               camera=pose, hit_share=hit_share,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["headline"] = rep
    log(f"headline: median {rep['ms_median']:.1f} ms, p90 "
        f"{rep['ms_p90']:.1f} ms, tiers {rep['per_tier']}, K1 launches "
        f"{counts['headline']['K1']} for {stats['traces']} traces "
        f"({stats['respites']} two-phase), overflow "
        f"{rep['straggler_overflow']}")
    assert rep["tier_mix"] == expected_mix(frames), rep["tier_mix"]
    check_launches(counts["headline"], stats, len(head["ms"]),
                   head["loop"].gi_windows)
    lap("headline")

    # ---- main path: config-4, 1920x1080 native on the same world ----
    ecfg4 = native_config(ecfg, C4_WIDTH, C4_HEIGHT)
    reset_counts()
    c4 = run_loop(eng.world, ecfg4, pose, c4_frames, dev, scale=1)
    torch.cuda.synchronize()
    counts["config4"] = read_counts()
    stats = wavefront.read_stats()
    rep4 = loop_report(c4, counts["config4"], stats)
    check_image(c4["results"][-1].image, (C4_HEIGHT, C4_WIDTH, 3))
    rep4["render"] = f"{C4_WIDTH}x{C4_HEIGHT} native (scale 1)"
    report["config4"] = rep4
    log(f"config-4: median {rep4['ms_median']:.1f} ms, tiers "
        f"{rep4['per_tier']}")
    assert rep4["tier_mix"] == expected_mix(c4_frames), rep4["tier_mix"]
    check_launches(counts["config4"], stats, len(c4["ms"]),
                   c4["loop"].gi_windows)
    lap("config4")

    # ---- main path: the entry point, python -m rvgrt_tpu_torch.bench, and
    # its run_point at a fixed tier on this world ----
    report["bench"] = phase_bench(eng.world, cube, dev, counts)
    lap("bench")

    # ---- main path: the viewer's full-rate path ----
    eng.character = make_character(ecfg, pose)
    reset_counts()
    outs, _, ms, out = run_full_rate(eng, WARMUP + full_frames, dev)
    torch.cuda.synchronize()
    counts["full_rate"] = read_counts()
    stats = wavefront.read_stats()
    check_image(outs[-1], (3 * HEIGHT, 3 * WIDTH, 3))
    report["full_rate"] = {
        "warmup": WARMUP, "timed": full_frames,
        "ms_median": statistics.median(ms[WARMUP:]),
        "ms_p90": p90(ms[WARMUP:]), "ms_all": ms,
        "launches": counts["full_rate"], "traces": stats["traces"],
        "respites": stats["respites"],
        "k1_launches_per_frame": counts["full_rate"]["K1"] / len(ms)}
    log(f"full rate: median {report['full_rate']['ms_median']:.1f} ms")
    assert counts["full_rate"]["K1"] == stats["traces"] > 0, \
        (counts["full_rate"], stats)
    del outs
    lap("full_rate")

    # ---- main paths: parallel/ on torch.distributed - K1's ZEDGES
    # variant, the 1-rank sharded and volume paths (NCCL) and the 4-rank
    # ring on the one card (gloo) ----
    report["parallel"] = phase_parallel(eng, ecfg, head["cams"], dev, counts)
    lap("parallel")

    # ---- main paths: the render switches (slim carry, the fused cone
    # table, the temporal start hints), the PNG atlas, the viewer and the
    # profiler ----
    report["switches"] = phase_switches(eng, ecfg, pose, dev, counts)
    lap("switches")

    # ---- main paths: bench.py's other post stages, the world checkpoint
    # and the CLI with the learned upscaler ----
    report["post_modes"] = phase_post_modes(eng.world, ecfg, pose, dev,
                                            post_frames, counts)
    lap("post_modes")
    report["world_checkpoint"] = round_trip_world(eng.world, ecfg, dev)
    log(f"world checkpoint: {report['world_checkpoint']}")
    lap("world_checkpoint")
    report["cli_net"] = phase_cli_net(dev, counts)
    log(f"CLI with the learned upscaler: {report['cli_net']}")
    lap("cli_net")

    # ---- main paths: the training path (the residual head's trainer and
    # the upscaler's closed loop), a step at 1280x800, GPU against CPU ----
    report["train"] = phase_train(dev, counts)
    lap("train")

    # ---- main path: the traced GI init, 2^24 lanes in one trace ----
    report["gi_init"] = phase_gi_init(eng, dev, counts)
    report["gi_init"]["heightfield_init_s"] = \
        phase_times["initializing GI"]
    lap("gi_init")

    # ---- main path: the CLI, the port's headless driver ----
    report["cli"], cli_last = phase_cli(dev, cli_config, cli_frames,
                                        counts)
    log(f"CLI: {report['cli']}")
    lap("cli")

    # ---- the respite's cost on the card: the headline's first two
    # windows ----
    report["respite_cost"] = respite_cost(eng, dev,
                                          (0, eng.ecfg.gi_window))
    log(f"respite cost: {report['respite_cost']}")
    lap("respite_cost")

    # ---- the same paths on a small world, GPU against CPU ----
    report["reference"] = phase_reference(dev)
    log(f"reference: {report['reference']}")
    lap("reference")

    # ---- main path: the gather probe's ladder (P1, P2) ----
    probe = phase_probe(dev, counts)
    report["probe"] = {k: probe[k] for k in ("limits", "skipped")}
    log(f"probe: {probe}")
    lap("probe")

    # ---- each kernel against its plain version on the main path's
    # inputs (these launches are not counted) ----
    cfg, w = ecfg.world, eng.world
    k1_in = k1_inputs(eng, head["cams"][-1][1], ecfg4, c4["cams"][-1][1])
    k1 = check_k1(cfg, w.trace_table, w.sky_y, *k1_in["checker"], dev)
    # check_k1 held and timed the checkerboard trace; the others here
    k1["traces"] = {"checker": {f: k1[f] for f in (
        "lanes", "budget", "steps", "ms", "max_abs_err", "bit_exact")}}
    k1["traces"].update({name: check_k1_trace(cfg, w.trace_table, w.sky_y,
                                              *k1_in[name], dev)
                         for name in ("quarter", "gi_phase1", "gi_phase2",
                                      "c4_checker", "c4_quarter", "full")})
    k1["traces"]["gi_init"] = report["gi_init"]["k1"]
    k1["slim_carry"] = report["switches"]["slim_carry"]["k1"]
    log(f"K1: {k1}")
    del k1_in
    lap("check_k1")
    k2 = check_k2(head["loop"].state, last.out.motion, dev)
    k2["config4"] = check_k2(c4["loop"].state, c4["results"][-1].out.motion,
                             dev)
    k2["cli"] = check_k2(cli_last["state"], cli_last["motion"], dev)
    del head, c4, cli_last
    lap("check_k2")
    checks = {"K1": k1, "K2": k2, "K3": check_k3(w.bits, cfg, dev),
              **probe["checks"]}
    lap("check_k3")

    # ---- optional: where a frame's time goes ----
    if profile:
        report["profile"] = profile_frames(eng, pose, dev, profile)
        log(f"profile: {json.dumps(report['profile'], indent=1)}")
        lap("profile")

    # ---- main path: the big worlds, each alone on the card ----
    del eng, w, out
    gc.collect()
    torch.cuda.empty_cache()
    for name in big_worlds:
        big = report[f"world_{name}"] = phase_big_world(dev, name,
                                                        big_frames, counts)
        checks["K3"]["passes"] += [dict(p, path=f"{name}: {p['path']}")
                                   for p in big.pop("k3_passes")]
        k1_big = big.pop("k1")
        checks["K1"]["traces"][f"{name}_checker"] = k1_big
        for trace, v in k1_big.pop("traces").items():
            checks["K1"]["traces"][f"{name}_{trace}"] = v
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"world_{name}")

    launches = {k: sum(c[k] for c in counts.values()) for k in COUNTERS}
    table = []
    for k, meta in KERNELS.items():
        c = checks[k]
        row = dict(id=k, **meta, route="cuda", launches=launches[k],
                   **{f: c[f] for f in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
        row.update(kernel_ms=c["ms"], max_err=c["max_abs_err"],
                   launches_by_path={p: v[k] for p, v in counts.items()},
                   **{f: v for f, v in c.items() if f not in row})
        if k == "K1":
            row["instantiations"] = k1_instantiations(
                checks["K1"], report["switches"]["slim_carry"]["k1"],
                report["parallel"]["k1_zedges"], launches)
        table.append(row)
    report["kernels"] = table
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=10,
                    help="log2 of the world edge (default 10: 1024^3)")
    ap.add_argument("--frames", type=int, default=12,
                    help="timed headline frames, after 2 warm-ups")
    ap.add_argument("--c4-frames", type=int, default=6,
                    help="timed config-4 frames, after 2 warm-ups")
    ap.add_argument("--full-frames", type=int, default=4,
                    help="timed full-rate frames, after 2 warm-ups")
    ap.add_argument("--post-frames", type=int, default=6,
                    help="timed frames of each post mode, after 2 warm-ups")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile N more headline frames "
                         "with torch.profiler (device busy time, idle "
                         "share, top kernels)")
    ap.add_argument("--worlds", default=",".join(BIG_WORLDS),
                    help="the big worlds to build and render after the "
                         "1024^3 phases, comma-separated, of "
                         f"{', '.join(BIG_WORLDS)} (default: all; '' none)")
    ap.add_argument("--big-frames", type=int, default=6,
                    help="timed frames on each big world, after 2 warm-ups")
    ap.add_argument("--out", default="",
                    help="also write the whole report as JSON here")
    args = ap.parse_args(argv)
    worlds = [n for n in args.worlds.split(",") if n]
    for n in worlds:
        if n not in BIG_WORLDS:
            ap.error(f"--worlds: unknown world {n!r}")

    if not (ROOT / "rvgrt_tpu_torch" / "__init__.py").exists():
        log("chip_smoke.py: run it from a checkout of the repository "
            "(rvgrt_tpu_torch/ is missing beside it)")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke.py: no CUDA device; the port's kernels run only "
            "on a GPU")
        return 1
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    report = run(torch.device("cuda"), args.cube, args.frames,
                 args.c4_frames, args.full_frames, profile=args.profile,
                 big_worlds=worlds, big_frames=args.big_frames,
                 post_frames=args.post_frames)
    report["card"] = card
    report["wall_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in (
        "build", "headline", "config4", "full_rate", "gi_init", "cli",
        "respite_cost", "probe", "phase_wall_s", "wall_s")}), flush=True)
    print(json.dumps({k: report[k] for k in (
        "post_modes", "world_checkpoint", "cli_net")}), flush=True)
    print(json.dumps({"train": report["train"]}), flush=True)
    print(json.dumps({"switches": report["switches"]}), flush=True)
    print(json.dumps({"parallel": report["parallel"]}), flush=True)
    for n in worlds:
        print(json.dumps({f"world_{n}": report[f"world_{n}"]}), flush=True)
    print(json.dumps({"reference": report["reference"]}), flush=True)
    print(json.dumps({"bench": report["bench"]}), flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
