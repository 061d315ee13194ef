#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rvgrt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rvgrt_tpu_torch/csrc/`` into
``rvgrt_tpu_torch/_build/`` and runs these phases in order.  Any failure
ends the run with a traceback and a non-zero exit code, and no result line
is printed.

1. card: the GPU's name and power limit, as nvidia-smi gives them;
2. world build (main path, part 1): ``Engine(ecfg)`` at the headline world,
   1024^3; the SDF's min-plus passes run kernel K3;
3. frames (main path, part 2): 2 warm-up and 8 timed frames at the
   ``bench.py`` headline operating point, each ``Engine.step`` (split
   dispatch: GI update -> base frame with its G-buffer -> GI composite, at
   1280x800, every trace one launch of K1, with no host read between its
   supersteps) and ``temporal_upscale(..., warp_taps="pallas")`` to
   3840x2400 (K2);
4. reference: the same path on a 64^3 world at 128x80, on the GPU and on
   the CPU, where every kernel is its plain PyTorch version (the CPU test
   suite holds those against the JAX package): equal worlds, >= 50 dB
   frames;
5. kernels: K1, K2 and K3 against their plain versions on the inputs the
   main path gave them (the primary trace's start state, the last frame's
   history and motion, the inputs of the world build's four min-plus
   passes), with their times, the least time the card could take
   (``bound_ms``, from this run's data) and the main path's launch counts.
   K1 is held against the plain loop twice: superstep by superstep (one
   launch each, a budget of one superstep) and as the whole primary trace
   in one launch.  K3 is also held at the 2048^3 world's coarse shape
   (1024^3, the world's first-pass field tiled 2x2x2).

The kernel checks come after the frames because they take the main path's
own inputs.  Every launch counter is set to 0 just before each main-path
phase and read just after it, so the kernel checks' launches are not
counted.  Times are CUDA-event medians on the card: a kernel's ``ms`` (and
the library call's) is the device time of a CUDA-graph replay of its
launches, ``event_ms`` and ``plain_ms`` time the Python call itself, host
included, as the main path pays it.  The last lines are the
JSON kernel table, ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.

The options shrink the run for debugging (``--cube 8 --frames 2``); the
defaults are the headline configuration.  ``--profile N`` adds N frames
under ``torch.profiler`` at the end: the device's busy time and idle share
per frame and the kernels that took the most device time.
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

# the headline frame of bench.py (its defaults, gi_straggler_budget 0)
REF_POSE = dict(position=(30.0, 44.0, 60.0), yaw=math.pi + 0.25,
                pitch=-math.pi - 0.18)
PAN_RAD_PER_FRAME = 0.05  # bench.py's interactive fast-pan leg
WIDTH, HEIGHT = 1280, 800  # render resolution; displayed at 3x


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def headline_config(cube: int, width: int, height: int):
    """bench.py's headline operating point, built the way bench.py builds
    it (``dataclasses.replace`` on the defaults)."""
    from rvgrt_tpu_torch.config import (EngineConfig, LightingConfig,
                                        RenderConfig, WorldConfig)

    rcfg = dataclasses.replace(
        RenderConfig(), width=width, height=height,
        display_width=3 * width, display_height=3 * height,
        prepass_divisor=8, prepass_cascade=4, shadow_site_divisor=4,
        steps_per_check=1, dda_substeps=6, sdf_probe_interval=16,
        dist_bias=4.0, fused_superstep=True, gi_res_divisor=16)
    return EngineConfig(
        world=WorldConfig().with_cube(cube), render=rcfg,
        lighting=dataclasses.replace(LightingConfig(), soft_shadows=True,
                                     soft_shadow_stride=2),
        gi_straggler_budget=0, gi_init_mode="heightfield")


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


def place_camera(eng) -> float:
    """bench.py's placement: 12 voxels above the terrain top of the world's
    centre column, looking down 0.5 along +x.  Returns the camera y."""
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
    ch = eng.character
    ch.position = np.array([cx, cam_y, cz], np.float32)
    # Character.direction = (sin(yaw) cos(pitch), -sin(pitch),
    # -cos(yaw) cos(pitch)); pitch in (-pi - pi/2, -pi) looks down
    ch.pitch = -math.pi - math.asin(float(-fwd[1]))
    ch.yaw = -math.pi / 2.0
    return cam_y


def run_frames(eng, n: int, dev, state=None, time_s=None):
    """``n`` frames of the main path: Engine.step, then the 3x temporal
    upscale through the warp kernel.  Returns (outputs, state, per-frame
    ms, last frame outputs)."""
    import torch

    from rvgrt_tpu_torch.scene.camera import InputState
    from rvgrt_tpu_torch.upscale import temporal
    from rvgrt_tpu_torch.utils.timer import Timer

    r = eng.ecfg.render
    if state is None:
        state = temporal.init_state(r.height, r.width, device=dev)
    pan = InputState(mouse_dx=PAN_RAD_PER_FRAME
                     / eng.character.sensitivity)
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


def profile_frames(eng, state, dev, n: int, top: int = 15) -> dict:
    """``n`` more main-path frames under ``torch.profiler``: the host wall
    time, the device's busy time (the sum of its kernels' times: one
    stream, so they never overlap), the idle share, and the kernels that
    took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frames(eng, n, dev, state=state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    assert busy_ms > 0, "the profiler saw no device time"
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"frames": n, "wall_ms_per_frame": wall_ms / n,
            "device_busy_ms_per_frame": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches_per_frame": sum(e.count for e in kernels) / n,
            "device_kernels": len(kernels),
            "top": [{"kernel": e.key[:90], "calls_per_frame": e.count / n,
                     "device_ms_per_frame":
                         e.self_device_time_total / 1e3 / n}
                    for e in kernels[:top]]}


def check_image(img, shape) -> None:
    import torch

    assert tuple(img.shape) == shape, (tuple(img.shape), shape)
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    assert float(img.std()) > 1e-3, "constant image"


def psnr(a, b) -> float:
    mse = float(((a.double().cpu() - b.double().cpu()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def phase_reference(dev) -> dict:
    """The main path on a 64^3 world at 128x80 on the GPU and on the CPU."""
    import numpy as np

    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence

    ecfg = headline_config(6, 128, 80)
    runs = {}
    for d in (dev, "cpu"):
        eng = engine.Engine(ecfg, verbose=False, device=d)
        eng.character.jitter_sequence = phase_jitter_sequence(3)
        eng.character.position = np.asarray(REF_POSE["position"], np.float32)
        eng.character.yaw = REF_POSE["yaw"]
        eng.character.pitch = REF_POSE["pitch"]
        outs, _, _, last = run_frames(eng, 3, d, time_s=1.0)
        runs[str(d)] = (engine.world_to_numpy(eng.world), outs, last)
    (wg, og, lg), (wc, oc, lc) = runs[str(dev)], runs["cpu"]
    for k in wc:
        np.testing.assert_array_equal(wg[k], wc[k], err_msg=k)
    db = [psnr(a, b) for a, b in zip(og, oc)]
    base_db = psnr(lg.color, lc.color)
    hit_equal = bool(((lg.depth == 1.0).cpu() == (lc.depth == 1.0)).all())
    assert min(db) >= 50.0 and base_db >= 50.0, (db, base_db)
    assert hit_equal, "hit classification differs between GPU and CPU"
    return {"world_bit_exact": True, "upscaled_psnr_db": db,
            "base_color_psnr_db": base_db, "hit_classification_equal": True}


def capture_primary(eng, dev):
    """The primary trace's start state and direction invariants, taken at
    its K1 call during a re-render of the current pose."""
    from rvgrt_tpu_torch.ops import superstep_kernel

    r = eng.ecfg.render
    n = r.width * r.height
    real = superstep_kernel.trace_supersteps
    got = {}

    def hook(cfg, rcfg, table, dirs, s, sky_y=None, **kw):
        if "s" not in got and s["flags"].numel() == n:
            got["s"] = {k: v.clone() for k, v in s.items()}
            got["dirs"] = tuple(a.clone() for a in dirs)
        return real(cfg, rcfg, table, dirs, s, sky_y=sky_y, **kw)

    superstep_kernel.trace_supersteps = hook
    try:
        eng.render_at(eng.character.ray_jitter_ndc(), time_s=1.0)
    finally:
        superstep_kernel.trace_supersteps = real
    return got["s"], got["dirs"]


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


def check_k1(eng, dev) -> dict:
    """K1 against the plain loop on the whole primary trace: superstep by
    superstep (``fused_superstep``, a budget of one superstep a launch) and
    the whole trace in one launch (``trace_supersteps``), bit for bit on
    all 11 state arrays and on ``steps``."""
    import torch

    from rvgrt_tpu_torch.ops import superstep_kernel as k1
    from rvgrt_tpu_torch.trace import wavefront as wf

    cfg, rcfg = eng.ecfg.world, eng.ecfg.render
    w = eng.world
    table, sky_y = w.trace_table, w.sky_y
    s0, dirs = capture_primary(eng, dev)
    n = s0["flags"].numel()

    def fresh():
        return {k: v.clone() for k, v in s0.items()}

    def mismatches(a, b):
        return [k for k in wf.STATE_KEYS
                if not torch.equal(_bits(a[k]), _bits(b[k]))]

    def max_abs(a, b):
        return max([float((a[k].double() - b[k].double()).abs().max())
                    for k in wf.STATE_KEYS] + [0.0])

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
            if mismatches(sp, sk):
                bad_steps += 1
                max_err = max(max_err, max_abs(sp, sk))
        steps += k
    assert steps > 0
    assert bad_steps == 0, f"K1 (one superstep a launch) differs from its " \
        f"plain version at {bad_steps} supersteps, max abs {max_err}"

    # the whole trace in one launch
    s = fresh()
    got = int(k1.trace_supersteps(cfg, rcfg, table, dirs, s, sky_y=sky_y))
    bad = mismatches(sp, s)
    max_err = max(max_err, max_abs(sp, s))
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
        cfg, rcfg, table, dirs, s, sky_y=sky_y), dev, reps=5, warmup=1,
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
                shape=f"{n} lanes, {steps} supersteps (the primary trace, "
                      f"one launch)")


def check_k2(state, motion, dev) -> dict:
    """K2 on the last frame's real history and motion."""
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


def run(dev, cube: int, frames: int, warmup: int, profile: int = 0) -> dict:
    import torch

    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
    from rvgrt_tpu_torch.trace import wavefront

    report = {}
    t0 = time.perf_counter()
    _lib.library()
    report["kernel_build_s"] = time.perf_counter() - t0
    log(f"kernels built/loaded in {report['kernel_build_s']:.1f} s")

    # ---- main path, part 1: the world build ----
    ecfg = headline_config(cube, WIDTH, HEIGHT)
    torch.cuda.reset_peak_memory_stats()
    phase_times = {}
    reset_counts()
    t0 = time.perf_counter()
    eng = engine.Engine(ecfg, verbose=False, device=dev,
                        phase_times=phase_times)
    torch.cuda.synchronize()
    build_counts = read_counts()
    build_s = time.perf_counter() - t0
    report["build"] = {
        "world": f"{ecfg.world.size_x}x{ecfg.world.size_y}x"
                 f"{ecfg.world.size_z}",
        "wall_s": build_s, "phase_s": phase_times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": build_counts}
    log(f"world build {build_s:.2f} s: {phase_times}")
    assert build_counts["K3"] >= 2, build_counts

    # ---- main path, part 2: the frames ----
    eng.character.jitter_sequence = phase_jitter_sequence(3)
    cam_y = place_camera(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, state, ms, last = run_frames(eng, warmup + frames, dev)
    torch.cuda.synchronize()
    frame_counts = read_counts()
    stats = wavefront.read_stats()
    timed = sorted(ms[warmup:])
    check_image(outs[-1], (3 * HEIGHT, 3 * WIDTH, 3))
    hit_share = float((last.depth != 1.0).float().mean())
    assert 0.0 < hit_share, "every pixel is sky"
    report["frames"] = {
        "render": f"{WIDTH}x{HEIGHT} -> {3 * WIDTH}x{3 * HEIGHT}",
        "camera_y": cam_y, "warmup": warmup, "timed": frames,
        "ms_median": statistics.median(timed),
        "ms_p90": timed[min(len(timed) - 1,
                            int(math.ceil(0.9 * len(timed))) - 1)],
        "ms_all": ms, "hit_share": hit_share,
        "launches": frame_counts, "traces": stats["traces"],
        "k1_launches_per_frame": frame_counts["K1"] / (warmup + frames),
        "traces_per_frame": stats["traces"] / (warmup + frames),
        "supersteps": stats["supersteps"],
        "supersteps_per_trace": stats["supersteps"] / max(stats["traces"],
                                                          1),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"frames: median {report['frames']['ms_median']:.1f} ms, "
        f"p90 {report['frames']['ms_p90']:.1f} ms, hit {hit_share:.3f}, "
        f"K1 launches {frame_counts['K1']} for {stats['traces']} traces")
    assert frame_counts["K1"] > 0 and frame_counts["K2"] > 0, frame_counts
    # one launch per trace
    assert frame_counts["K1"] == stats["traces"], (frame_counts, stats)

    # ---- the same path on a small world, GPU against CPU ----
    report["reference"] = phase_reference(dev)
    log(f"reference: {report['reference']}")

    # ---- each kernel against its plain version on the main path's
    # inputs (these launches are not counted) ----
    checks = {"K1": check_k1(eng, dev), "K2": check_k2(state, last.motion,
                                                       dev),
              "K3": check_k3(eng, dev)}
    launches = {k: build_counts[k] + frame_counts[k] for k in KERNELS}
    table = []
    for k, meta in KERNELS.items():
        c = checks[k]
        row = dict(id=k, **meta, route="cuda", launches=launches[k],
                   **{f: c[f] for f in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")})
        row.update(kernel_ms=c["ms"], max_err=c["max_abs_err"],
                   **{f: v for f, v in c.items() if f not in row})
        table.append(row)
    report["kernels"] = table

    # ---- optional: where a frame's time goes ----
    if profile:
        report["profile"] = profile_frames(eng, state, dev, profile)
        log(f"profile: {json.dumps(report['profile'], indent=1)}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=10,
                    help="log2 of the world edge (default 10: 1024^3)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile N more frames with "
                         "torch.profiler (device busy time, idle share, "
                         "top kernels)")
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

    report = run(torch.device("cuda"), args.cube, args.frames, args.warmup,
                 profile=args.profile)
    report["card"] = card
    report["wall_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: report[k] for k in ("build", "frames", "wall_s")}),
          flush=True)
    print(json.dumps({"reference": report["reference"]}), flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
