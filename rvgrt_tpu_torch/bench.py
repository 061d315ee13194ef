"""Headline benchmark: FPS and Mrays/s at the repository's operating point.

The port of the repository's ``bench.py``, run as

    python -m rvgrt_tpu_torch.bench [--device cpu]

A 1024^3 world, 1280x800 with full shading (SDF-marched soft shadows,
cone-traced GI, water) and the temporal 3x upscale to 3840x2400, along
``bench.py``'s camera path; then config-4, 1920x1080 native with GI, in
``extra``.  It reads the same ``BENCH_*`` environment knobs with the same
defaults (``bench_config``), prints its diagnostics to stderr and exactly
one JSON line on stdout, with ``bench.py``'s keys and meanings:

    {"metric": ..., "value": Mrays/s, "unit": "Mrays/s",
     "vs_baseline": FPS / 30, "extra": {...}}

``main`` returns the same dict.  The device is ``cuda`` unless the caller
asks for another (``--device cpu`` runs the kernels' plain versions).

A point (``run_point``, ``bench.py:451-692``): the rate of every frame (the
scheduler over consecutive poses, or a fixed tier), two warm-up frames (the
second gives ``hit_frac``), one more warm-up frame at ``cams[1]`` for every
(rate, composite reuse) pair the timed frames use that those two did not
(on the card they take each tier's first launches, lazy kernel builds and
allocator growth, and they advance the GI words and the history as
``bench.py``'s do), then the timed frames dispatched back to back, chained
through a depth sum that one host read closes: ``fps = frames / dt`` on the
host clock.  After them one more GI window at offset 0 counts the respite's
overflowing rays, and the ray accounting (``rays_for``) turns ``fps`` into
Mrays/s.  The cameras are ``bench.py``'s: a raw ``Camera`` 12 voxels above
the terrain top of the centre column, identity matrices (every motion
vector 0), the water clock at 0, and every GI window seeded with frame 0.

Departures from ``bench.py``, each a refusal where it would fall back:

* a failed config-4 point raises (``bench.py:710-715`` logs it and exits
  0);
* a missing checkpoint raises (``bench.py:305-323`` falls back to the plain
  accumulator or to fresh weights);
* ``BENCH_FUSED=0`` raises ``ValueError``: it selects JAX's XLA superstep,
  and the port has one tracer path, K1, whose plain loop is for tests;
* a value of ``BENCH_UPSCALE``, ``BENCH_CHECKER``, ``BENCH_PATH``,
  ``BENCH_CONFIG4_RATE``, ``BENCH_WARP`` or ``BENCH_GI_INIT`` that
  ``bench.py`` does not name raises (``bench.py`` takes most as its
  fallback);
* no compile cache, no tunnel, no remote compile; ``readback_s`` is kept as
  a field, the time of one scalar read from the device;
* ``RenderConfig``'s display size is the point's upscale of its render size
  (``bench.py`` keeps the 3840x2400 default, which only a ``Character``
  reads).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from rvgrt_tpu_torch.config import (EngineConfig, LightingConfig,
                                    RenderConfig, WorldConfig)
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine, frame_loop
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.scene.camera import Camera
from rvgrt_tpu_torch.utils.device import resolve_device

#: the five checkpoints of the learned post stages
CHECKPOINTS = Path(__file__).resolve().parent.parent / "checkpoints"
#: ``BENCH_UPSCALE`` (after ``"1"`` -> ``"net"``) -> ``FrameLoop``'s mode
UP_MODES = {"temporal": "temporal", "net": "net", "residual": "residual",
            "0": "none"}
#: ``BENCH_CHECKER`` / ``BENCH_CONFIG4_RATE`` -> ``rate_schedule``'s rates
RATE_MODES = {"adaptive": "adaptive", "1": "checker", "2": "checker",
              "4": "quarter", "0": "full"}
WARP_TAPS = ("pallas", "bilinear", "bilinear_shift", "nearest",
             "catmull_shift")
#: bench.py's straggler respite on the GI bounce rays
GI_BUDGET = 12
#: config-4's native size
C4_WIDTH, C4_HEIGHT = 1920, 1080


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass(frozen=True)
class BenchOptions:
    """The run options ``bench.py`` reads beside the EngineConfig."""
    cube: int = 10
    ref_world: bool = False
    width: int = 1280
    height: int = 800
    frames: int = 32
    include_gi: bool = True
    up_mode: str = "temporal"      # BENCH_UPSCALE: a key of UP_MODES
    config4: bool = True
    soft: bool = True
    fast_trace: bool = True
    rate_mode: str = "adaptive"    # BENCH_CHECKER: a key of RATE_MODES
    cam_path: str = "interactive"
    config4_rate: str = "adaptive"
    slim: bool = False
    gi_cadence: int = 2
    comp_cadence: int = 1
    warp_taps: str = "pallas"

    @property
    def upscale(self) -> bool:
        return self.up_mode != "0"

    @property
    def upscaler(self) -> str:
        """The headline's ``FrameLoop`` mode."""
        return UP_MODES[self.up_mode]

    @property
    def adaptive(self) -> bool:
        # bench.py decides the tier before it turns "residual" into the
        # accumulator (bench.py:90, :302)
        return self.rate_mode == "adaptive" and self.up_mode == "temporal"

    @property
    def checker(self) -> bool:
        return self.rate_mode in ("1", "2") and self.up_mode == "temporal"

    @property
    def quarter(self) -> bool:
        return self.rate_mode == "4" and self.up_mode == "temporal"


def headline_config(world, width: int, height: int, scale: int = 3,
                    soft: bool = True, fast_trace: bool = True,
                    slim: bool = False, prepass_div: int | None = None,
                    shadow_sites: int | None = None, spc: int = 1,
                    gi_div: int = 16, gi_init: str = "heightfield",
                    gi_init_stride=(2, 2)) -> EngineConfig:
    """``bench.py``'s EngineConfig (``bench.py:148-219``), built the way it
    builds it, with ``dataclasses.replace`` on the defaults, at ``width x
    height`` and ``scale`` x display; the keywords are its knobs, at their
    defaults.  ``world``: a WorldConfig, or the log2 edge of a cube
    (``BENCH_CUBE``); ``WorldConfig()`` is its ``BENCH_REF_WORLD=1``
    point."""
    rcfg = dataclasses.replace(
        RenderConfig(), width=width, height=height,
        display_width=scale * width, display_height=scale * height)
    rcfg = dataclasses.replace(
        rcfg,
        prepass_divisor=(8 if soft else 4) if prepass_div is None
        else prepass_div,
        shadow_site_divisor=(4 if soft else 0) if shadow_sites is None
        else shadow_sites,
        steps_per_check=spc)
    if fast_trace:
        rcfg = dataclasses.replace(rcfg, dda_substeps=6,
                                   sdf_probe_interval=16, dist_bias=4.0)
    if slim:
        rcfg = dataclasses.replace(rcfg, slim_carry=True)
    else:
        # bench.py's fused superstep; a field without effect in the port,
        # kept so that the two packages' configs match
        rcfg = dataclasses.replace(rcfg, fused_superstep=True)
    rcfg = dataclasses.replace(rcfg, gi_res_divisor=gi_div)
    if isinstance(world, int):
        world = WorldConfig().with_cube(world)
    ecfg = EngineConfig(
        world=world, render=rcfg,
        lighting=dataclasses.replace(LightingConfig(), soft_shadows=soft,
                                     soft_shadow_stride=2),
        gi_straggler_budget=GI_BUDGET, gi_init_stride=tuple(gi_init_stride))
    if gi_init == "heightfield":
        ecfg = dataclasses.replace(ecfg, gi_init_mode="heightfield")
    return ecfg


def native_config(ecfg: EngineConfig, width: int,
                  height: int) -> EngineConfig:
    """``bench.py``'s config-4 point: the same settings at ``width x
    height`` native (scale-1 reconstruction)."""
    return dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, width=width, height=height, display_width=width,
        display_height=height))


def _choice(env, key: str, default: str, allowed) -> str:
    v = env.get(key, default)
    if v not in allowed:
        raise ValueError(f"{key}={v!r}: not one of {sorted(allowed)}")
    return v


def bench_config(env=None) -> tuple[EngineConfig, BenchOptions]:
    """The EngineConfig and run options of the ``BENCH_*`` knobs in
    ``env`` (``os.environ`` by default), with ``bench.py``'s defaults
    (``bench.py:58-219``)."""
    env = os.environ if env is None else env
    soft = env.get("BENCH_SOFT", "1") == "1"
    up_mode = env.get("BENCH_UPSCALE", "temporal")
    if up_mode == "1":
        up_mode = "net"
    if up_mode not in UP_MODES:
        raise ValueError(f"BENCH_UPSCALE={up_mode!r}: not one of "
                         f"{sorted(UP_MODES) + ['1']}")
    rate_mode = _choice(env, "BENCH_CHECKER", "adaptive", RATE_MODES)
    adaptive = rate_mode == "adaptive" and up_mode == "temporal"
    cam_path = _choice(env, "BENCH_PATH",
                       "interactive" if adaptive else "pan",
                       ("interactive", "pan"))
    config4_rate = _choice(env, "BENCH_CONFIG4_RATE", "adaptive",
                           RATE_MODES)
    if up_mode != "temporal":
        config4_rate = "0"
    slim = env.get("BENCH_SLIM", "0") == "1"
    if env.get("BENCH_FUSED", "1") != "1":
        raise ValueError(
            "BENCH_FUSED=0 selects JAX's XLA superstep; the port has one "
            "tracer path, kernel K1 (trace/wavefront.py), whose plain loop "
            "is for tests only and never runs on the card")
    gi_init = _choice(env, "BENCH_GI_INIT", "heightfield",
                      ("heightfield", "traced"))
    opts = BenchOptions(
        cube=int(env.get("BENCH_CUBE", "10")),
        ref_world=env.get("BENCH_REF_WORLD", "0") == "1",
        width=int(env.get("BENCH_W", "1280")),
        height=int(env.get("BENCH_H", "800")),
        frames=int(env.get("BENCH_FRAMES", "32")),
        include_gi=env.get("BENCH_GI", "1") == "1",
        up_mode=up_mode,
        config4=env.get("BENCH_CONFIG4", "1") == "1",
        soft=soft,
        fast_trace=env.get("BENCH_FAST_TRACE", "1") == "1",
        rate_mode=rate_mode, cam_path=cam_path, config4_rate=config4_rate,
        slim=slim,
        gi_cadence=max(int(env.get("BENCH_GI_CADENCE", "2")), 1),
        comp_cadence=max(int(env.get("BENCH_COMP_CADENCE", "1")), 1),
        warp_taps=_choice(env, "BENCH_WARP", "pallas", WARP_TAPS))
    prepass = env.get("BENCH_PREPASS_DIV")
    sites = env.get("BENCH_SHADOW_SITES")
    ecfg = headline_config(
        WorldConfig() if opts.ref_world else opts.cube, opts.width,
        opts.height, soft=soft, fast_trace=opts.fast_trace, slim=slim,
        prepass_div=None if prepass is None else int(prepass),
        shadow_sites=None if sites is None else int(sites),
        spc=int(env.get("BENCH_SPC", "1")),
        gi_div=int(env.get("BENCH_GI_DIV", "16")), gi_init=gi_init,
        gi_init_stride=(2, 2) if env.get("BENCH_GI_INIT_STRIDE", "1") == "1"
        else (1, 1))
    return ecfg, opts


def load_post_net(opts: BenchOptions, device, folder=CHECKPOINTS):
    """The learned module of the headline's post stage: the upscaler of
    ``upscaler.pkl`` under ``"net"``, the head of ``residual_head.pkl``
    under ``"residual"``, else None.  A missing file raises."""
    from rvgrt_tpu_torch.upscale import model as up_model
    from rvgrt_tpu_torch.upscale import residual

    if opts.up_mode == "net":
        path, load = Path(folder) / "upscaler.pkl", up_model.load_checkpoint
    elif opts.up_mode == "residual":
        path, load = (Path(folder) / "residual_head.pkl",
                      residual.load_checkpoint)
    else:
        return None
    if not path.exists():
        raise FileNotFoundError(
            f"{path}: BENCH_UPSCALE={opts.up_mode} needs this checkpoint "
            "(bench.py would fall back to another post stage; the port "
            "refuses)")
    log(f"loaded {opts.up_mode} post stage from {path}")
    return load(str(path), device=device)


def terrain_top(bits: torch.Tensor, wcfg: WorldConfig) -> float:
    """The highest solid voxel of the column at x = z = size_x // 2 (30 if
    it has none), found on the device; one scalar comes to the host
    (``bench.py:231-247``)."""
    cx = cz = wcfg.size_x // 2
    vol = bits.reshape(wcfg.size_z, wcfg.size_y, wcfg.size_x // 32)
    solid = (u32.lsr(vol[cz, :, cx // 32], cx % 32) & 1).bool()
    ys = torch.arange(wcfg.size_y, device=solid.device)
    top = torch.where(solid.any(), torch.where(solid, ys, -1).max(),
                      torch.full_like(ys[0], 30))
    return float(top)


def cam_at(yaw: float, pos) -> Camera:
    """``bench.py``'s raw camera at ``pos``, turned ``yaw`` rad from +x and
    looking down 0.5 (``bench.py:251-261``)."""
    fwd = np.array([math.cos(yaw) * 0.87, -0.5, math.sin(yaw) * 0.87],
                   np.float32)
    fwd /= np.linalg.norm(fwd)
    wup = np.array([0, 1, 0], np.float32)
    right = np.cross(fwd, wup)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    return Camera(pos=np.asarray(pos, np.float32), forward=fwd,
                  right=right.astype(np.float32),
                  up=(up / np.linalg.norm(up)).astype(np.float32))


def point_rates(opts: BenchOptions, headline: bool) -> str:
    """``rate_schedule``'s rates of a point (``bench.py:337-348``)."""
    if headline:
        tag = (opts.rate_mode if opts.adaptive or opts.checker
               or opts.quarter else "0")
    else:
        tag = opts.config4_rate
    return RATE_MODES[tag]


def rays_for(ecfg: EngineConfig, rate: str, gi_frame: bool) -> dict:
    """The rays of one frame at ``rate``, by stage, from the static lane
    counts (``bench.py:620-661``): the primary grid after the rate cut,
    the prepass, its shadow rays (none with decoupled soft shadows), the
    cascade, the decoupled soft-shadow sites, and on a GI frame two rays
    (sun and bounce) a cell of the window."""
    r, lt = ecfg.render, ecfg.lighting
    w_, h_ = r.width, r.height
    hw, hh = r.half_width, r.half_height
    q = r.prepass_cascade
    ssd = r.shadow_site_divisor
    decoupled = lt.soft_shadows and ssd > 0
    gh = h_ // 2 if rate == "quarter" else h_
    gw = w_ // 2 if rate in ("checker", "quarter") else w_
    rays = {
        "primary": gh * gw,
        "prepass_primary": hw * hh,
        "prepass_shadow": (0 if decoupled else
                           ((hw // lt.soft_shadow_stride)
                            * (hh // lt.soft_shadow_stride)
                            if lt.soft_shadows else hw * hh)),
        "cascade": (hw // q) * (hh // q) if q > 1 else 0,
    }
    if decoupled:
        # a[::ssd] keeps ceil(n / ssd) sites an axis
        rays["shadow_sites"] = -(-gh // ssd) * -(-gw // ssd)
    if gi_frame:
        rays["gi_update"] = 2 * ecfg.gi_window
    return rays


def ray_means(ecfg: EngineConfig, rate_seq, frames: int, include_gi: bool,
              gi_cadence: int) -> tuple[dict, dict, float]:
    """Over the timed frames ``2 .. frames + 1`` of ``rate_seq``: the mean
    rays a frame by stage (rounded to 0.1), the tier mix, and the mean
    rays a frame in all (``bench.py:663-675``)."""
    total: dict = {}
    tier_mix: dict = {}
    for i in range(frame_loop.WARMUP, frames + frame_loop.WARMUP):
        fr = rays_for(ecfg, rate_seq[i], include_gi and i % gi_cadence == 0)
        for k, v in fr.items():
            total[k] = total.get(k, 0) + v
        tier_mix[rate_seq[i]] = tier_mix.get(rate_seq[i], 0) + 1
    rays = {k: round(v / frames, 1) for k, v in total.items()}
    return rays, tier_mix, sum(total.values()) / frames


def run_point(world, ecfg: EngineConfig, label: str, frames: int,
              opts: BenchOptions, net=None):
    """Measure one operating point (``bench.py:451-692``); returns (fps,
    the stats ``bench.py`` reports, the ``FrameLoop``).  ``net``: the
    headline's learned post stage (``load_post_net``)."""
    r = ecfg.render
    dev = world.bits.device
    headline = r.width == opts.width
    rates = point_rates(opts, headline)
    temporal = (opts.up_mode in ("temporal", "residual")
                and (headline or rates != "full"))
    upscaler = opts.upscaler if headline else (
        "temporal" if temporal else "none")
    loop = frame_loop.FrameLoop(
        world, ecfg, scale=3 if headline else 1, upscaler=upscaler,
        net=net if headline else None, comp_cadence=opts.comp_cadence,
        gi_cadence=opts.gi_cadence, include_gi=opts.include_gi, gi_frame=0,
        warp_taps=opts.warp_taps)

    # the 9-phase jitter under the accumulator, else the reference's table
    seq = frame_loop.jitter_sequence(opts.upscaler)

    def jit_ndc(i):
        jx, jy = seq[i % len(seq)] * 0.5
        return (float(jx) * 2.0 / r.width, float(jy) * 2.0 / r.height)

    # the cameras and rates of every frame, made before any is timed; the
    # GI offsets are host ints the window takes as kernel arguments
    wc = ecfg.world
    top = terrain_top(world.bits, wc)
    pos = (wc.size_x // 2, min(top + 12.0, wc.size_y - 2.0), wc.size_x // 2)
    raw = [cam_at(y, pos)
           for y in frame_loop.path_yaws(frames, opts.cam_path)]
    cams = [engine.camera_arrays(c, jitter=jit_ndc(i), device=dev)
            for i, c in enumerate(raw)]
    rate_seq = frame_loop.rate_schedule(raw, ecfg, rates=rates)

    def reuse(i):
        return opts.include_gi and i % opts.comp_cadence != 0

    def frame(i, cam, acc, rate=None, advance=True):
        res = loop.frame(i, cam, rate_seq[i] if rate is None else rate,
                         advance=advance)
        # one tiny reduction chains every frame into one closing read
        return res, acc + res.out.depth.sum()

    acc = torch.zeros((), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    _, acc = frame(0, cams[0], acc)
    float(acc)
    log(f"[{label}] first frame: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    res, acc = frame(1, cams[1], acc)
    hit_frac = float((res.out.depth != 1.0).float().mean())
    log(f"[{label}] warm frame {time.perf_counter() - t0:.1f}s; "
        f"hit_frac={hit_frac:.3f}")
    # every (rate, reuse) pair of the timed frames that the two warm-ups
    # did not run, run once at cams[1] before the clock starts
    covered = {(rate_seq[i], reuse(i)) for i in range(2)}
    for i in range(2, frames + 2):
        key = (rate_seq[i], reuse(i))
        if key in covered:
            continue
        covered.add(key)
        t0 = time.perf_counter()
        _, acc = frame(1 if key[1] else opts.comp_cadence, cams[1], acc,
                       rate=key[0], advance=False)
        float(acc)
        log(f"[{label}] extra warm {key}: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    for i in range(frames):
        _, acc = frame(2 + i, cams[2 + i], acc)
    float(acc)  # one read closes the pipeline
    dt = time.perf_counter() - t0
    fps = frames / dt

    # rays that overflowed the respite's cap in one more GI window
    overflow = -1
    if opts.include_gi and ecfg.gi_straggler_budget > 0:
        w = world
        _, st = gi_update.update_gi(loop.gi, w.bits, w.sdf, w.atlas, ecfg, 0,
                                    0, sky_y=w.sky_y, table=w.trace_table,
                                    return_stats=True)
        overflow = int(st["straggler_overflow"])
        log(f"[{label}] straggler-cap overflow (1 GI window): {overflow}")

    rays, tier_mix, total = ray_means(ecfg, rate_seq, frames,
                                      opts.include_gi, opts.gi_cadence)
    mrays = total * fps / 1e6
    log(f"[{label}] {frames} frames in {dt:.2f}s -> {fps:.2f} FPS, "
        f"{mrays:.1f} Mrays/s  tier_mix={tier_mix}  "
        f"mean rays/frame={rays}")
    return fps, {
        "fps": round(fps, 3),
        "mrays_per_s": round(mrays, 2),
        "mrays_primary_only": round(rays["primary"] * fps / 1e6, 2),
        "hit_frac": round(hit_frac, 4),
        "frames": frames,
        "straggler_overflow": overflow,
        "rays_per_frame_mean": rays,
        "tier_mix": tier_mix,
        "camera_path": opts.cam_path,
    }, loop


def world_tag(ecfg: EngineConfig, opts: BenchOptions) -> str:
    wc = ecfg.world
    return (f"{wc.size_x}x{wc.size_y}x{wc.size_z}" if opts.ref_world
            else f"{2 ** opts.cube}^3")


def metric(ecfg: EngineConfig, opts: BenchOptions) -> str:
    """``bench.py``'s metric string (``bench.py:717-741``)."""
    rcfg = ecfg.render
    gi_tag = "on" if opts.include_gi else "off"
    sh_tag = "soft" if opts.soft else "hard"
    w, h = opts.width, opts.height
    op = f"{w}x{h}+3x upscale to {3 * w}x{3 * h}" if opts.upscale \
        else f"{w}x{h}"
    sem_tag = ("TPU-tuned cadence"
               if (opts.fast_trace or opts.soft or opts.checker
                   or opts.quarter or opts.adaptive or opts.slim
                   or rcfg.prepass_divisor != 2)
               else "reference-exact cadence")
    if opts.adaptive:
        sem_tag = ("motion-adaptive primaries (checker/quarter, "
                   f"{opts.cam_path} path), " + sem_tag)
    if opts.checker:
        sem_tag = "checkerboard primaries, " + sem_tag
    if opts.quarter:
        sem_tag = "quarter-rate primaries (4-phase), " + sem_tag
    if opts.include_gi and opts.gi_cadence > 1:
        sem_tag += f", GI window every {opts.gi_cadence} frames"
    if opts.include_gi and opts.comp_cadence > 1:
        sem_tag += f", GI composite every {opts.comp_cadence} frames"
    return (f"Mrays/s at {op} hybrid SDF+DDA trace "
            f"({world_tag(ecfg, opts)} world, gi={gi_tag} "
            f"div{rcfg.gi_res_divisor}, prepass 1/{rcfg.prepass_divisor}, "
            f"{sh_tag} shadows, {sem_tag}, "
            "single chip, pipelined dispatch)")


def main(argv=None, env=None, device=None) -> dict:
    """Run the benchmark; print and return its JSON object.  ``argv``: the
    command line's arguments (none by default); ``env``: the knobs
    (``os.environ`` by default); ``device`` overrides ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args([] if argv is None else argv)
    dev = resolve_device(device if device is not None else args.device)
    ecfg, opts = bench_config(env)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else str(dev)

    if dev.type == "cuda":
        from rvgrt_tpu_torch.ops import _lib

        # the kernels are built (or loaded) here, not inside the build
        t0 = time.perf_counter()
        _lib.library()
        log(f"kernels built/loaded in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    float(torch.zeros((), device=dev) + 1.0)
    log(f"device: {name}; first scalar read: "
        f"{time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    float(torch.zeros((), device=dev) + 2.0)
    readback_s = time.perf_counter() - t0
    log(f"steady-state scalar read: {readback_s:.4f}s")

    log(f"world {world_tag(ecfg, opts)}, {opts.width}x{opts.height}, "
        f"gi={opts.include_gi}, upscale={opts.upscale}, "
        f"soft_shadows={opts.soft}, fast_trace={opts.fast_trace}")
    t0 = time.perf_counter()
    phase_times: dict = {}
    world = engine.build_world(ecfg, verbose=True,
                               init_gi=opts.include_gi,
                               phase_times=phase_times, device=dev)
    build_s = time.perf_counter() - t0
    log(f"world build total: {build_s:.1f}s  phases={phase_times}")
    net = load_post_net(opts, dev)

    fps, stats, _ = run_point(world, ecfg, "headline", opts.frames, opts,
                              net=net)
    extras = {"headline": stats, "device": name,
              "readback_s": round(readback_s, 3),
              "world_build_s": round(build_s, 1),
              "world_build_phases": phase_times,
              "note": ("frames dispatched back-to-back (chained via GI/"
                       "history/accumulator), one closing readback; "
                       "Mrays counts primary+prepass+cascade+GI-update "
                       "rays (water pair excluded: scene-dependent)")}
    if opts.config4:
        _, extras["config4_1080p_native_gi"], _ = run_point(
            world, native_config(ecfg, C4_WIDTH, C4_HEIGHT),
            "config4-1080p", max(opts.frames // 2, 4), opts)
    out = {"metric": metric(ecfg, opts), "value": stats["mrays_per_s"],
           "unit": "Mrays/s", "vs_baseline": round(fps / 30.0, 4),
           "extra": extras}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
