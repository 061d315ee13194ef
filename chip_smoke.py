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
5. full rate (main path): the viewer's path, ``Engine.step`` +
   ``temporal_upscale``, 2 warm-up and 4 timed frames;
6. respite cost: one GI window with straggler budget 12 and with 0, timed
   as the main path pays for it (CUDA events around ``update_gi``);
7. reference: on a 64^3 world at 128x80, on the GPU and on the CPU (where
   every kernel is its plain PyTorch version, which the CPU test suite holds
   against the JAX package): the full-rate path for 3 frames and the frame
   loop for 6 (checkerboard and quarter frames, 16 384-cell GI windows that
   engage the respite); worlds and GI words bit-exact, >= 50 dB and exact
   hit classification on every base and reconstructed frame;
8. kernels: K1, K2 and K3 against their plain versions on the inputs the
   main path gives them, with their times, the least time the card could
   take (``bound_ms``, from this run's data) and the main path's launch
   counts.  K1 on the checkerboard primary trace (superstep by superstep,
   and whole in one launch; its row's times and bound), the quarter primary
   trace, a GI window's respite phase 1 (budget 12) and phase 2, config-4's
   checkerboard and quarter primary traces and the full-rate path's primary
   trace, each bit-exact and graph-timed; K2 at the headline's (2400,
   3840) and config-4's (1080, 1920) histories; K3 at the world build's
   four passes and at the 2048^3 world's coarse shape.

Launch accounting: ``wavefront.stats["traces"]`` counts each phase of a
two-phase trace as a trace, so on every path K1 launches == traces.
Every launch counter is set to 0 just before each main-path phase and read
just after it, so the launches of the checks are not counted; the kernel
line sums each kernel's launches over the build and the three frame paths.
Times are CUDA-event medians on the card: a kernel's ``ms`` (and the
library call's) is the device time of a CUDA-graph replay of its launches,
``event_ms`` and ``plain_ms`` time the Python call itself, host included,
as the main path pays it.  The last lines are the JSON kernel table,
``{"kernels": [...]}``, and ``{"ok": true, "device": {...}}``.

The options shrink the run for debugging (``--cube 8 --frames 3``); the
defaults are the headline configuration.  ``--profile N`` adds, at the
end, N headline frames and 2 full-rate frames, each under its own
``torch.profiler``: per frame its tier, the device's busy time, idle share
and launches, and the kernels that took the most device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
GI_BUDGET = 12  # bench.py's gi_straggler_budget


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def headline_config(cube: int, width: int, height: int, scale: int = 3):
    """bench.py's operating point, built the way bench.py builds it
    (``dataclasses.replace`` on the defaults), at ``scale`` x display."""
    from rvgrt_tpu_torch.config import (EngineConfig, LightingConfig,
                                        RenderConfig, WorldConfig)

    rcfg = dataclasses.replace(
        RenderConfig(), width=width, height=height,
        display_width=scale * width, display_height=scale * height,
        prepass_divisor=8, prepass_cascade=4, shadow_site_divisor=4,
        steps_per_check=1, dda_substeps=6, sdf_probe_interval=16,
        dist_bias=4.0, fused_superstep=True, gi_res_divisor=16)
    return EngineConfig(
        world=WorldConfig().with_cube(cube), render=rcfg,
        lighting=dataclasses.replace(LightingConfig(), soft_shadows=True,
                                     soft_shadow_stride=2),
        gi_straggler_budget=GI_BUDGET, gi_init_mode="heightfield",
        gi_init_stride=(2, 2))


def native_config(ecfg, width: int, height: int):
    """bench.py's config-4 point: the same settings at ``width x height``
    native (scale-1 reconstruction)."""
    return dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, width=width, height=height, display_width=width,
        display_height=height))


def reference_loop_config():
    """The 64^3 frame-loop reference: the headline settings at 128x80,
    with ``gi_coarseness=2`` so the GI grid (32^3 cells) holds 16 384-cell
    windows, enough rays for the respite to engage (4 x 4096)."""
    ecfg = headline_config(6, 128, 80)
    return dataclasses.replace(
        ecfg, world=dataclasses.replace(ecfg.world, gi_coarseness=2),
        gi_rays_per_frame=16384)


def kernel_modules():
    from rvgrt_tpu_torch.ops import sdf_kernels, superstep_kernel, warp_kernels

    return {"K1": superstep_kernel, "K2": warp_kernels, "K3": sdf_kernels}


def reset_counts() -> None:
    from rvgrt_tpu_torch.trace import wavefront

    for m in kernel_modules().values():
        m.launches = 0
    wavefront.reset_stats()


def read_counts() -> dict:
    return {k: m.launches for k, m in kernel_modules().items()}


def timed_ms(fn, dev, reps: int = 7, warmup: int = 2, setup=None) -> float:
    """Median time of ``fn(setup())`` over ``reps`` runs after ``warmup``;
    only ``fn`` is inside the timer."""
    from rvgrt_tpu_torch.utils.timer import Timer

    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        with Timer("", verbose=False, device=dev) as t:
            fn(arg)
        if i >= warmup:
            times.append(t.elapsed_ms)
    return statistics.median(times)


def graph_ms(fn, dev, calls: int = 1, reps: int = 7, warmup: int = 2,
             setup=None) -> float:
    """The device's time for one ``fn()``: ``calls`` calls of ``fn`` are
    captured once into a CUDA graph, and the median CUDA-event time of a
    replay over ``reps`` replays after ``warmup`` is divided by ``calls``.
    A replay launches every kernel from the device's own queue, so the
    host's cost of making each launch (Python, ctypes, the wrapper's
    checks) is left out.  ``setup`` runs before the capture and before each
    replay, outside the timer: it refreshes what ``fn`` updates in place."""
    import torch

    from rvgrt_tpu_torch.utils.timer import Timer

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        if setup is not None:
            setup()
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    if setup is not None:
        setup()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for i in range(warmup + reps):
        if setup is not None:
            setup()
        with Timer("", verbose=False, device=dev) as t:
            graph.replay()
        if i >= warmup:
            times.append(t.elapsed_ms / calls)
    del graph
    return statistics.median(times)


def p90(values) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(math.ceil(0.9 * len(v))) - 1)]


def headline_pose(eng) -> dict:
    """bench.py's placement: 12 voxels above the terrain top of the world's
    centre column, looking down 0.5 along +x, as a Character pose."""
    import numpy as np
    import torch

    from rvgrt_tpu_torch.core import u32

    w = eng.ecfg.world
    cx = cz = w.size_x // 2
    vol = eng.world.bits.reshape(w.size_z, w.size_y, w.size_x // 32)
    solid = (u32.lsr(vol[cz, :, cx // 32], cx % 32) & 1).bool()
    ys = torch.arange(w.size_y, device=solid.device)
    top = float(torch.where(solid, ys, -1).max()) if bool(solid.any()) \
        else 30.0
    cam_y = min(top + 12.0, w.size_y - 2.0)
    fwd = np.array([0.87, -0.5, 0.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    # Character.direction = (sin(yaw) cos(pitch), -sin(pitch),
    # -cos(yaw) cos(pitch)); pitch in (-pi - pi/2, -pi) looks down
    return dict(position=(float(cx), cam_y, float(cz)), yaw=-math.pi / 2.0,
                pitch=-math.pi - math.asin(float(-fwd[1])))


def make_character(ecfg, pose: dict):
    """A Character at ``pose`` for ``ecfg``'s render and display sizes,
    with the 9-phase jitter of the temporal accumulator (bench.py's)."""
    import numpy as np

    from rvgrt_tpu_torch.scene.camera import Character, phase_jitter_sequence

    r = ecfg.render
    return Character(display_width=r.display_width,
                     display_height=r.display_height, render_width=r.width,
                     render_height=r.height,
                     position=np.asarray(pose["position"], np.float32),
                     yaw=pose["yaw"], pitch=pose["pitch"],
                     jitter_sequence=phase_jitter_sequence(3))


def expected_mix(frames: int) -> dict:
    """The tiers of ``frames`` timed frames along the interactive path: its
    fast third at checkerboard rate, the slow and dwell thirds at quarter
    rate (bench.py's thresholds: above 1.25 % of the width a frame, with
    hysteresis, and below 0.75 %)."""
    third = max(frames // 3, 1)
    return {"checker": third, "quarter": frames - third}


def run_loop(world, ecfg, pose: dict, frames: int, dev, scale: int,
             time_s: float = 1.0) -> dict:
    """``frame_loop.WARMUP`` + ``frames`` frames of
    ``driver/frame_loop.py`` along bench.py's interactive path from
    ``pose``, each timed with CUDA events (host included) on a GPU.
    Returns the loop, the rates, each frame's result and ms."""
    from rvgrt_tpu_torch.driver import frame_loop
    from rvgrt_tpu_torch.utils.timer import Timer

    cams = frame_loop.path_cameras(make_character(ecfg, pose),
                                   frame_loop.path_yaws(frames),
                                   time_s=time_s, device=dev)
    rates = frame_loop.rate_schedule([c for c, _ in cams], ecfg)
    loop = frame_loop.FrameLoop(world, ecfg, scale=scale)
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
    """The full-rate path and the frame loop on a 64^3 world at 128x80, on
    the GPU and on the CPU."""
    import numpy as np

    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
    from rvgrt_tpu_torch.trace import wavefront

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

    # the frame loop, 6 frames, respite engaged
    ecfg = reference_loop_config()
    loops = {}
    for d in (dev, "cpu"):
        world = engine.build_world(ecfg, verbose=False, device=d)
        wavefront.reset_stats()
        run = run_loop(world, ecfg, REF_POSE, 4, d, scale=3)
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
    base_db, up_db = [], []
    for a, b in zip(rg["results"], rc["results"]):
        assert bool((a.hit.cpu() == b.hit).all()), \
            "hit classification differs between GPU and CPU"
        base_db.append(psnr(a.out.color, b.out.color))
        up_db.append(psnr(a.image, b.image))
    assert min(base_db) >= 50.0 and min(up_db) >= 50.0, (base_db, up_db)
    return {"full_rate": full, "frame_loop": {
        "world_bit_exact": True, "gi_words_bit_exact": True,
        "rates": rg["rates"], "respites": sg["respites"],
        "straggler_overflow": [int(rg["loop"].overflow),
                               int(rc["loop"].overflow)],
        "base_color_psnr_db": base_db, "upscaled_psnr_db": up_db,
        "hit_classification_equal": True}}


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
                turned) -> int:
    """The operations one superstep needs, taking state ``s`` to ``nxt``,
    estimated per branch each lane takes (csrc/superstep_kernel.cu; DDA:
    per substep taken, from its), all charged at the int32 rate.  Marks in
    the bool mask ``gathered`` the table words the lanes gather, and in
    ``read`` (a bool mask per word of ``K1_READ_WORDS``) the lanes whose
    start value of that word this superstep reads.  ``turned`` marks the
    lanes whose cell and tMax words a turn to DDA has set; this superstep's
    turns are added to it."""
    from rvgrt_tpu_torch.trace import wavefront as wf

    pre = wf._superstep_pregather(cfg, rcfg, dirs, s, sky_y=sky_y)
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

    if sky_y is not None:
        mark(("py", "dy"), sky | sphere)  # the sky test
    mark(K1_POS, sphere | jump)  # the gather index, OOB test, march, jump
    mark(K1_DIR, march | jump)
    mark(("its",), jump | act)
    mark(K1_DD_ST, to_dda | act)  # tMax set-up, the DDA steps
    mark(K1_CELL, (probe | act) & ~turned)
    mark(K1_TM, act & ~turned)
    turned |= to_dda

    def count(m):
        return int(m.sum())

    substeps = int((nxt["its"] - s["its"])[act].sum())
    return (5 * count(live) + 4 * count(sky) + 30 * count(sphere)
            + 15 * count(to_dda) + 30 * count(probe) + 10 * count(act)
            + 15 * substeps)


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


def check_k1_trace(cfg, table, sky_y, rcfg, s0, dirs, dev) -> dict:
    """K1 (one launch) against the plain loop on one captured trace, bit
    for bit on all 11 state arrays and on ``steps``; with the launch's
    graph-timed device ms."""
    from rvgrt_tpu_torch.ops import superstep_kernel as k1

    sp = {k: v.clone() for k, v in s0.items()}
    want = int(k1.trace_plain(cfg, rcfg, table, dirs, sp, sky_y=sky_y))
    sk = {k: v.clone() for k, v in s0.items()}
    got = int(k1.trace_supersteps(cfg, rcfg, table, dirs, sk, sky_y=sky_y))
    bad = _k1_mismatches(sp, sk)
    err = _k1_max_abs(sp, sk)
    assert not bad and got == want, \
        f"K1 differs from its plain version: arrays {bad} (max abs " \
        f"{err}), steps {got} vs {want}"

    def reset():
        for key, v in s0.items():
            sk[key].copy_(v)

    ms = graph_ms(lambda: k1.trace_supersteps(cfg, rcfg, table, dirs, sk,
                                              sky_y=sky_y), dev, setup=reset)
    return dict(lanes=s0["flags"].numel(), budget=rcfg.max_supersteps,
                steps=got, ms=ms, max_abs_err=err, bit_exact=True)


def check_k1(cfg, table, sky_y, rcfg, s0, dirs, dev) -> dict:
    """K1 against the plain loop on the checkerboard primary trace, the
    largest trace of the headline's frames (config-4's checkerboard and
    the full-rate path's primary traces are about twice its size, and
    ``check_k1_trace`` holds them): superstep by superstep (``fused_superstep``, a
    budget of one superstep a launch) and the whole trace in one launch
    (``trace_supersteps``), bit for bit on all 11 state arrays and on
    ``steps``; with its graph time, event time, plain time and bound."""
    import torch

    from rvgrt_tpu_torch.ops import superstep_kernel as k1
    from rvgrt_tpu_torch.trace import wavefront as wf

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
    while steps < rcfg.max_supersteps and wf.any_live(sp["flags"]):
        for _ in range(k):
            nxt = k1.superstep_plain(cfg, rcfg, table, dirs, sp, sky_y=sky_y)
            ops_total += k1_step_ops(cfg, rcfg, dirs, sp, nxt, sky_y,
                                     gathered, read, turned)
            sp = nxt
            k1.fused_superstep(cfg, rcfg, table, dirs, sk, sky_y=sky_y)
            if _k1_mismatches(sp, sk):
                bad_steps += 1
                max_err = max(max_err, _k1_max_abs(sp, sk))
        steps += k
    assert steps > 0
    assert bad_steps == 0, f"K1 (one superstep a launch) differs from its " \
        f"plain version at {bad_steps} supersteps, max abs {max_err}"

    # the whole trace in one launch
    s = fresh()
    got = int(k1.trace_supersteps(cfg, rcfg, table, dirs, s, sky_y=sky_y))
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
        cfg, rcfg, table, dirs, graph_state, sky_y=sky_y), dev, setup=reset)
    event_ms = timed_ms(lambda s: k1.trace_supersteps(
        cfg, rcfg, table, dirs, s, sky_y=sky_y), dev, setup=fresh)
    plain_ms = timed_ms(lambda s: k1.trace_plain(
        cfg, rcfg, table, dirs, s, sky_y=sky_y), dev, reps=3, warmup=1,
        setup=fresh)
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
                shape=f"{n} lanes, {steps} supersteps (the checkerboard "
                      f"primary trace, one launch)")


def check_k2(state, motion, dev) -> dict:
    """K2 on a loop's last real history and motion."""
    import torch
    import torch.nn.functional as F

    from rvgrt_tpu_torch.ops import warp_kernels as k2
    from rvgrt_tpu_torch.upscale import temporal

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

    from rvgrt_tpu_torch.ops import sdf_kernels as k3

    got = launch(d, axis, cap)
    best = k3.min_squares_plain(d, axis, cap)
    want = torch.clamp_max(k3.isqrt(best), cap).to(torch.uint8)
    same = torch.equal(got, want)
    diff = 0 if same else int((got.int() - want.int()).abs().max())
    assert same, f"K3 differs from its plain version on axis {axis}, " \
        f"cap {cap}, shape {tuple(d.shape)}: max abs {diff}"
    cells = d.numel()
    taps, taps_exit = (int(t.sum(dtype=torch.int64))
                       for t in k3_tap_floor(d, best, axis, cap))
    del best, want
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


def capture_k3_inputs(eng) -> list:
    """The inputs of every K3 launch of the world build, as (input, axis,
    cap): ``build_sdf``'s two passes and ``extend_sdf_far``'s two, taken at
    ``minconv_pass`` while the SDF phase runs again on the world's bits."""
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.ops import sdf_kernels as k3

    real = k3.minconv_pass
    got = []

    def hook(d, axis, cap):
        got.append((d, axis, cap))
        return real(d, axis, cap)

    k3.minconv_pass = hook
    try:
        engine._sdf_phase_fn(eng.world.bits, eng.ecfg.world)
    finally:
        k3.minconv_pass = real
    return got


def check_k3(eng, dev) -> dict:
    """K3 at every shape it meets, bit for bit against its plain version:
    the world build's four passes (``build_sdf``: u8 512^3, cap 64;
    ``extend_sdf_far``: 128^3, cap 66 at the headline) on their own inputs,
    and the 2048^3 world's coarse shape (1024^3, cap 64), made by tiling
    the world's first-pass field 2x2x2.  ``ms``, ``event_ms``, ``plain_ms``
    and ``bound_ms`` are the means of ``build_sdf``'s two passes."""
    import torch

    from rvgrt_tpu_torch.ops import sdf_kernels as k3

    inputs = capture_k3_inputs(eng)
    assert len(inputs) == 4, [(tuple(d.shape), a, c) for d, a, c in inputs]
    names = ("build_sdf", "build_sdf", "extend_sdf_far", "extend_sdf_far")
    passes = []
    for name, (d, axis, cap) in zip(names, inputs):
        stats, _ = k3_pass(d, axis, cap, dev, k3.minconv_pass,
                           calls=5 if d.numel() > 2 ** 24 else 20)
        if name == "build_sdf":
            stats["event_ms"] = timed_ms(
                lambda _: k3.minconv_pass(d, axis, cap), dev)
            stats["plain_ms"] = timed_ms(
                lambda _: k3.minconv_pass_plain(d, axis, cap), dev, reps=5,
                warmup=1)
        passes.append(dict(path=name, **stats))
        log(f"K3 {name}: {passes[-1]}")
    # the 2048^3 world's coarse grid: axis 1, then axis 0 on its output
    d, _, cap = inputs[0]
    d = d.repeat(2, 2, 2)
    for axis in (1, 0):
        stats, d = k3_pass(d, axis, cap, dev, k3.minconv_pass, calls=2)
        passes.append(dict(path="2048^3 coarse grid (tiled)", **stats))
        log(f"K3 2048^3 coarse grid: {passes[-1]}")
    del d
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
}


def run(dev, cube: int, frames: int, c4_frames: int, full_frames: int,
        profile: int = 0) -> dict:
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
    pose = headline_pose(eng)
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
    log(f"K1: {k1}")
    del k1_in
    lap("check_k1")
    k2 = check_k2(head["loop"].state, last.out.motion, dev)
    k2["config4"] = check_k2(c4["loop"].state, c4["results"][-1].out.motion,
                             dev)
    del head, c4
    lap("check_k2")
    checks = {"K1": k1, "K2": k2, "K3": check_k3(eng, dev)}
    lap("check_k3")
    launches = {k: sum(c[k] for c in counts.values()) for k in KERNELS}
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
        table.append(row)
    report["kernels"] = table

    # ---- optional: where a frame's time goes ----
    if profile:
        report["profile"] = profile_frames(eng, pose, dev, profile)
        log(f"profile: {json.dumps(report['profile'], indent=1)}")
        lap("profile")
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
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile N more headline frames "
                         "with torch.profiler (device busy time, idle "
                         "share, top kernels)")
    ap.add_argument("--out", default="",
                    help="also write the whole report as JSON here")
    args = ap.parse_args(argv)

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
                 args.c4_frames, args.full_frames, profile=args.profile)
    report["card"] = card
    report["wall_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in (
        "build", "headline", "config4", "full_rate", "respite_cost",
        "phase_wall_s", "wall_s")}), flush=True)
    print(json.dumps({"reference": report["reference"]}), flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
