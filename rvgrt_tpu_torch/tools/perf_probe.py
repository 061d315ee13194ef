"""Within-run cost probe: the frame's stages and K1's per-superstep floor,
timed in one process on the card.

The port of ``scripts/perf_probe.py``, with the same flags, camera and
stages in the same order.  It builds one world and times:

1. the per-superstep floor: parked full-resolution traces (every ray
   starting outside the world) at ``max_supersteps`` 2 / 8 / 32, and beside
   them the primary rays from the minDist start at the same caps; a
   least-squares line through each gives K1's slope (ns a lane a
   superstep) and its per-call intercept (ms).  A parked ray retires when
   its state is built, and K1 runs no superstep for a retired ray, so the
   parked slope is that of the launch alone;
2. each stage alone: the cascade start (1/8 of the prepass grid), the
   prepass (primary + shadow), the full-resolution primary from the
   minDist start and from 0; with ``--gi`` the primary with the GI
   gather, the split GI frame (the base frame, the primary traced again
   and the GI pass), the base frame alone and the GI pass alone;
3. the full frame.

Each stage is timed three ways over ``--reps`` calls after one warm call:
CUDA events around the call and the host clock to a synchronised finish
(median and minimum of each), then one more call recorded by
``torch.profiler`` (after one in its warm-up step; a session that lost a
K1 kernel record is run again) for the device's own time: the summed time
of every kernel the call launched and of K1's (``trace_kernel``) alone
(one call: the profiler's cost grows with the launches it records, about
15 000 in a frame).  The stages are eager PyTorch and host-bound, so the
events read the host's time too; the profiler's kernel time is what the
card spent, and the floor's lines are fitted to K1's.  There is no compile
cache and no tunnel: the first call builds nothing but the kernels.

``--sweep`` adds the ``its`` straggler analysis of the prepass's primary
and shadow traces over the script's 20x128 tile and over K1's own unit,
32 consecutive lanes in queue order (a warp's first share of K1's
persistent queue, ``csrc/superstep_kernel.cu``: a warp that kept its
first 32 rays would wait for its slowest one; K1's lanes take new rays as
theirs retire, so this is the waste a warp without that refill would
pay), then the script's knob sweeps where the port's K1 honours the knob:
``steps_per_check`` (K1's check cadence) is timed; ``trace_tile_rows``
reaches no trace (K1 runs one flat queue, the field is kept for config
parity) and is printed as such, untimed, except where it sets the
prepass's padded row count (the in-frame prepass shape and the frame
pairs), which changes the trace's lanes.

Usage (the default device is the GPU; ``--device cpu`` runs the plain
PyTorch path):

    python -m rvgrt_tpu_torch.tools.perf_probe [--cube 9 --w 1280 --h 720
        --reps 5] [--gi] [--sweep]

``main`` prints each measurement as it is taken, then one JSON line, and
returns that report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time

import numpy as np
import torch

#: the floor's superstep caps
FLOOR_CAPS = (2, 8, 32)
#: the script's retirement tile (rows x lanes) and K1's warp
TILE = (20, 128)
WARP = 32
#: the script's knob values
PRIMARY_ROWS = (8, 12, 20, 40)
SPCS = (1, 2, 4)
PREPASS_ROWS = (8, 10, 12, 15, 18, 20)
INFRAME_ROWS = (12, 15, 20)
FRAME_PAIRS = ((20, 2), (12, 1), (8, 1))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cube", type=int, default=9)
    p.add_argument("--w", type=int, default=1280)
    p.add_argument("--h", type=int, default=720)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--gi", action="store_true")
    p.add_argument("--sweep", action="store_true",
                   help="its analysis + tile/steps knob sweeps")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def probe_camera(bits: torch.Tensor, cfg):
    """The script's camera (``perf_probe.py:67-89``, bench.py's
    placement): 12 voxels above the terrain top of the centre column,
    looking down 0.5 at yaw 0.5."""
    from rvgrt_tpu_torch.core import u32
    from rvgrt_tpu_torch.scene.camera import Camera

    xw = cfg.size_x // 32
    plane = cfg.size_y * xw
    z = cfg.size_z // 2
    words = u32.to_numpy(bits[z * plane:(z + 1) * plane]).reshape(
        cfg.size_y, xw)
    col = (words[:, (cfg.size_x // 2) >> 5] >> np.uint32(
        (cfg.size_x // 2) & 31)) & 1
    ys = np.where(col)[0]
    top = float(ys.max()) if len(ys) else 30.0
    cam_y = min(top + 12.0, cfg.size_y - 2.0)
    fwd = np.array([math.cos(0.5) * 0.87, -0.5, math.sin(0.5) * 0.87],
                   np.float32)
    fwd /= np.linalg.norm(fwd)
    wup = np.array([0, 1, 0], np.float32)
    right = np.cross(fwd, wup)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    up /= np.linalg.norm(up)
    return Camera(pos=np.array([cfg.size_x / 2, cam_y, cfg.size_z / 2],
                               np.float32),
                  forward=fwd, right=right.astype(np.float32),
                  up=up.astype(np.float32))


class Stages:
    """The probe's stages on ``world`` at ``ecfg`` seen from ``cam``
    (``CameraArrays``), each a function of its inputs; ``include_gi``:
    the frames of the sweep's pairs and the full frame render GI."""

    def __init__(self, world, ecfg, cam, include_gi: bool = False):
        self.world, self.ecfg, self.cam = world, ecfg, cam
        self.include_gi = include_gi
        self.cfg, self.rcfg, self.lcfg = ecfg.world, ecfg.render, \
            ecfg.lighting

    def _trace(self, rc, ox, oy, oz, dx, dy, dz, t0, sky=True):
        from rvgrt_tpu_torch.trace import wavefront

        w = self.world
        return wavefront.trace(None, None, self.cfg, rc, ox, oy, oz, dx, dy,
                               dz, t0, table=w.trace_table,
                               sky_y=w.sky_y if sky else None)

    def parked(self, cap: int) -> torch.Tensor:
        """``its`` of the full-resolution parked trace (origins at -10,
        direction +x, no sky limit) at ``max_supersteps=cap``."""
        r = self.rcfg
        dev = self.world.trace_table.device
        park = torch.full((r.height, r.width), -10.0, device=dev)
        ones = torch.ones_like(park)
        zero = ones * 0
        return self._trace(dataclasses.replace(r, max_supersteps=cap), park,
                           park, park, ones, zero, zero, zero,
                           sky=False).its

    def cascade(self) -> torch.Tensor:
        """The prepass's cascade start map (1/8 of the prepass grid traced
        from 0)."""
        from rvgrt_tpu_torch.render import pipeline

        w, r = self.world, self.rcfg
        trace_fn = pipeline.make_trace_fn(None, None, self.cfg, r,
                                          table=w.trace_table, sky_y=w.sky_y)
        return pipeline._cascade_start(trace_fn, r, self.cam, 0,
                                       r.half_height)

    def prepass(self, rc=None, hy0: int = 0, hrows=None):
        """``half_res_prepass``: (distance - bias, shadow)."""
        from rvgrt_tpu_torch.render import pipeline

        w = self.world
        return pipeline.half_res_prepass(
            None, None, self.cfg, rc or self.rcfg, self.lcfg, self.cam,
            hy0=hy0, hrows=hrows, table=w.trace_table, sky_y=w.sky_y)

    def primary_res(self, start, rc=None):
        """The full-resolution primary trace from ``start``."""
        from rvgrt_tpu_torch.render import pipeline

        r, cam = self.rcfg, self.cam
        dx, dy, dz = pipeline._ray_dirs(cam, r.width, r.height,
                                        pixel_center=False)
        return self._trace(rc or r, cam.pos[0], cam.pos[1], cam.pos[2], dx,
                           dy, dz, start)

    def primary(self, start, rc=None) -> torch.Tensor:
        return self.primary_res(start, rc).its

    def prepass_its(self):
        """``its`` of the prepass's primary trace (from the cascade start)
        and of its sun-shadow trace from the hits."""
        from rvgrt_tpu_torch.render import pipeline

        r, cam = self.rcfg, self.cam
        dx, dy, dz = pipeline._ray_dirs(cam, r.half_width, r.half_height,
                                        pixel_center=True)
        res = self._trace(r, cam.pos[0], cam.pos[1], cam.pos[2], dx, dy, dz,
                          self.cascade())
        sun = self.lcfg.sun_dir
        sox = torch.where(res.hit, res.px + res.nx * 0.1, -10.0)
        soy = torch.where(res.hit, res.py + res.ny * 0.1, -10.0)
        soz = torch.where(res.hit, res.pz + res.nz * 0.1, -10.0)
        sh = self._trace(r, sox, soy, soz, sun[0], sun[1], sun[2],
                         torch.zeros_like(sox))
        return res.its, sh.its

    def gi_gather(self, start):
        from rvgrt_tpu_torch.render import pipeline

        w = self.world
        return pipeline.gather_gi_image(self.primary_res(start), w.gi,
                                        w.sdf, self.cfg, self.rcfg,
                                        self.lcfg)

    def frame(self, ecfg=None, include_gi: bool = False):
        from rvgrt_tpu_torch.render import pipeline

        w = self.world
        return pipeline.render_frame(
            w.bits, w.sdf, w.gi, w.atlas, self.cam, ecfg or self.ecfg,
            include_gi=include_gi, gi_occ=w.gi_occ, sky_y=w.sky_y,
            table=w.trace_table)

    def gi_pass(self, res, color):
        """The GI gather on a traced primary, its albedo-weighted light
        added to ``color`` on the hits (the script's ``gi_pass``)."""
        from rvgrt_tpu_torch.core import vecmath as vm
        from rvgrt_tpu_torch.render import pipeline
        from rvgrt_tpu_torch.world import atlas as atlas_mod

        w, lcfg = self.world, self.lcfg
        ir, ig, ib = pipeline.gather_gi_image(res, w.gi, w.sdf, self.cfg,
                                              self.rcfg, lcfg)
        alb = atlas_mod.sample_texture(w.atlas, res.uv_u, res.uv_v, res.px,
                                       res.py, res.pz)
        ind = vm.mul((ir, ig, ib), vm.scale(alb, lcfg.gi_strength))
        return color + torch.stack(ind, -1) * res.hit[..., None]


#: the substring of K1's kernel name in the profiler's events
K1_KERNEL = "trace_kernel"


#: host seconds kept clear on each side of the profiled call, inside its
#: step: the profiler drops a kernel whose device timestamp, mapped to the
#: host's clock, falls outside the step's window, and a kernel launched just
#: after the step opens can land there
PROFILE_MARGIN_S = 0.005
#: profiler sessions tried before K1's kernel time is given up as not
#: measured
PROFILE_TRIES = 5


def kernel_times(averages) -> tuple[float, float, int]:
    """From ``key_averages()``: the summed device time of every CUDA kernel
    and of K1's (ms), and the number of K1 kernels recorded."""
    from torch.autograd import DeviceType

    total = k1 = 0.0
    k1_records = 0
    for e in averages:
        # the step's own range also lies on the device's timeline
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.key.startswith("ProfilerStep"))
        if e.device_type == DeviceType.CUDA and not annotation:
            total += e.self_device_time_total
            if K1_KERNEL in e.key:
                k1 += e.self_device_time_total
                k1_records += e.count
    return total / 1e3, k1 / 1e3, k1_records


def _profile_once(fn) -> tuple[float, float, int, int]:
    """One ``torch.profiler`` session: ``fn`` in its warm-up step, then in
    its recorded step, each call ``PROFILE_MARGIN_S`` clear of the step's
    edges.  (kernel ms, K1 ms, K1 kernels recorded, K1 launches counted by
    its wrapper in the recorded step)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from rvgrt_tpu_torch.ops import superstep_kernel

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_MARGIN_S)
            n0 = superstep_kernel.launches
            fn()
            torch.cuda.synchronize()
            launched = superstep_kernel.launches - n0
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
    return (*kernel_times(prof.key_averages()), launched)


def device_ms(fn, tries: int = PROFILE_TRIES) -> tuple[float, float]:
    """One call of ``fn`` under ``torch.profiler``, after one call in the
    profiler's warm-up step (the first step a profiler records can lose
    kernel records): the device time of every CUDA kernel it launched and
    of K1's kernels alone, ms.  A session that recorded fewer K1 kernels
    than K1's wrapper launched lost records, and is run again, up to
    ``tries`` sessions; K1's time is NaN where none was whole, and both
    are NaN where the profiler saw no kernel."""
    total = k1 = math.nan
    for _ in range(tries):
        total, k1, records, launched = _profile_once(fn)
        if records == launched:
            break
        k1 = math.nan
    if total == 0.0:
        return math.nan, math.nan
    return total, k1


def timeit(name: str, fn, reps: int, dev, log=print) -> dict:
    """One warm call, then ``reps`` calls each timed by CUDA events around
    the call and by the host clock to a synchronised finish (only the host
    clock on the CPU): median and minimum of each, ms; on the card then
    ``device_ms`` of one more call: ``device_ms`` (every kernel),
    ``k1_ms`` (K1's) and ``busy`` (device over event time).  Where the
    device keeps up with a host-bound call, the events read the host's
    time too; the profiler's times are the card's."""
    cuda = dev.type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(dev)
    ev, host = [], []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            e0.record()
        fn()
        if cuda:
            e1.record()
            torch.cuda.synchronize(dev)
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev.append(e0.elapsed_time(e1))
    out = dict(host_ms=statistics.median(host), host_min_ms=min(host),
               event_ms=statistics.median(ev) if ev else None,
               event_min_ms=min(ev) if ev else None,
               device_ms=None, k1_ms=None, busy=None)
    if not cuda:
        log(f"{name:42s} {out['host_ms']:9.1f} ms   (min "
            f"{out['host_min_ms']:.1f}; host clock)")
        return out
    out["device_ms"], out["k1_ms"] = device_ms(fn)
    out["busy"] = out["device_ms"] / out["event_ms"]
    log(f"{name:42s} {out['event_ms']:9.1f} ms   (min "
        f"{out['event_min_ms']:.1f}; host {out['host_ms']:.1f}, min "
        f"{out['host_min_ms']:.1f}; device {out['device_ms']:.3f}, "
        f"K1 {out['k1_ms']:.3f})")
    return out


def floor_fit(caps, ms, lanes: int) -> dict | None:
    """The least-squares line ms = intercept + slope x cap: the slope in
    ns a lane a superstep, the intercept in ms; None where a time was not
    measured."""
    if any(m is None or math.isnan(m) for m in ms):
        return None
    b, a = np.polyfit(np.asarray(caps, np.float64),
                      np.asarray(ms, np.float64), 1)
    return dict(ns_per_lane_superstep=float(b) * 1e6 / lanes,
                intercept_ms=float(a))


def straggler(its, th: int, tw: int) -> dict:
    """``its`` over (th x tw) tiles (rows x columns of the image; th = 1
    and tw = 32 on a flattened image is K1's warp of consecutive lanes):
    its mean, p90 and max; each tile's max, its mean, p90 and max; and the
    straggler waste, the tile-max mean over the its mean."""
    a = its.detach().cpu().numpy()
    if a.ndim == 1:
        a = a[None]
    # an image smaller than the tile is one tile
    th, tw = min(th, a.shape[0]), min(tw, a.shape[1])
    hh, ww = a.shape[0] // th * th, a.shape[1] // tw * tw
    tiles = a[:hh, :ww].reshape(hh // th, th, ww // tw, tw)
    tmax = tiles.max(axis=(1, 3)).ravel()
    return dict(tile=[th, tw], mean=float(a.mean()),
                p90=float(np.percentile(a, 90)),
                max=int(a.max()), tile_max_mean=float(tmax.mean()),
                tile_max_p90=float(np.percentile(tmax, 90)),
                tile_max_max=int(tmax.max()),
                waste=float(tmax.mean() / max(a.mean(), 1)))


def _fmt_straggler(name: str, unit: str, s: dict) -> str:
    return (f"{name} ({unit}): its mean {s['mean']:.1f} p90 {s['p90']:.0f} "
            f"max {s['max']}; tile-max mean {s['tile_max_mean']:.1f} p90 "
            f"{s['tile_max_p90']:.0f} max {s['tile_max_max']} (straggler "
            f"waste {s['waste']:.1f}x)")


def sweep(st: Stages, start, reps: int, dev, log=print) -> dict:
    """``--sweep``: the its analysis and the knob sweeps (module
    docstring)."""
    rcfg, ecfg = st.rcfg, st.ecfg
    out = {"straggler": {}, "knobs": {}}
    p_its, s_its = st.prepass_its()
    for name, its in (("prepass primary", p_its), ("prepass shadow",
                                                   s_its)):
        tile = straggler(its, *TILE)
        warp = straggler(its.reshape(-1), 1, WARP)
        out["straggler"][name] = dict(tile_20x128=tile, warp_32=warp)
        log(_fmt_straggler(name, f"{TILE[0]}x{TILE[1]} tiles", tile))
        log(_fmt_straggler(name, f"{WARP} lanes in queue order", warp))
    kn = out["knobs"]
    kn["primary_tile_rows"] = (
        f"no effect on K1 (one flat queue; trace_tile_rows kept for config "
        f"parity): {PRIMARY_ROWS} not timed")
    log(f"primary tile_rows={PRIMARY_ROWS}: {kn['primary_tile_rows']}")
    for spc in SPCS:
        rc = dataclasses.replace(rcfg, steps_per_check=spc)
        kn[f"primary_spc_{spc}"] = timeit(
            f"primary steps_per_check={spc}",
            lambda rc=rc: st.primary(start, rc), reps, dev, log)
    kn["prepass_tile_rows"] = (
        f"no effect on K1 (the prepass without a padded slab traces its "
        f"grid as one queue): {PREPASS_ROWS} not timed")
    log(f"prepass tile_rows={PREPASS_ROWS}: {kn['prepass_tile_rows']}")
    d15, s15 = st.prepass(dataclasses.replace(rcfg, trace_tile_rows=15))
    d20, s20 = st.prepass(dataclasses.replace(rcfg, trace_tile_rows=20))
    same = [bool(torch.equal(d15, d20)), bool(torch.equal(s15, s20))]
    kn["prepass_rows15_vs_rows20_identical"] = same
    log(f"prepass rows15 vs rows20 identical: {same[0]} {same[1]}")
    for rows in INFRAME_ROWS:
        # the frame's shape: the traced hy0, the halo-padded row count
        rc = dataclasses.replace(rcfg, trace_tile_rows=rows)
        hrows = -(-(st.rcfg.height // 2 + 2) // rows) * rows
        kn[f"prepass_inframe_rows_{rows}"] = dict(hrows=hrows, **timeit(
            f"prepass in-frame shape rows={rows} hrows={hrows}",
            lambda rc=rc, hrows=hrows: st.prepass(rc, hy0=-1, hrows=hrows),
            reps, dev, log))
    for rows, spc in FRAME_PAIRS:
        ec = dataclasses.replace(ecfg, render=dataclasses.replace(
            rcfg, trace_tile_rows=rows, steps_per_check=spc))
        kn[f"frame_rows_{rows}_spc_{spc}"] = timeit(
            f"frame rows={rows} spc={spc}",
            lambda ec=ec: st.frame(ec, include_gi=st.include_gi).color,
            reps, dev, log)
    return out


def main(argv=None) -> dict:
    """Run the probe."""
    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
    from rvgrt_tpu_torch.driver import engine
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ecfg = EngineConfig(
        world=WorldConfig().with_cube(args.cube),
        render=dataclasses.replace(RenderConfig(), width=args.w,
                                   height=args.h))
    cfg = ecfg.world
    print(f"device={dev} ({name}) world={2 ** args.cube}^3 "
          f"{args.w}x{args.h}", flush=True)
    t0 = time.perf_counter()
    world = engine.build_world(ecfg, verbose=False, init_gi=args.gi,
                               device=dev)
    build_s = time.perf_counter() - t0
    print(f"world build {build_s:.1f}s", flush=True)
    cam = engine.camera_arrays(probe_camera(world.bits, cfg), device=dev)
    st = Stages(world, ecfg, cam, include_gi=args.gi)
    reps = args.reps

    def log(s):
        print(s, flush=True)

    def t(label, fn):
        return timeit(label, fn, reps, dev, log)

    rep = dict(tool="perf_probe", device=name, world=f"{2 ** args.cube}^3",
               render=f"{args.w}x{args.h}", reps=reps, gi=args.gi,
               build_s=build_s, stages={})
    s = rep["stages"]
    lanes = args.w * args.h

    # ---- 1. the superstep floor ----
    for cap in FLOOR_CAPS:
        s[f"parked_cap_{cap}"] = t(f"parked full-res trace (cap={cap})",
                                   lambda cap=cap: st.parked(cap))

    def fit(label, prefix):
        # K1's kernel time on the card; the host clock on the CPU
        f = floor_fit(FLOOR_CAPS, [
            s[f"{prefix}_{c}"]["k1_ms" if cuda else "host_ms"]
            for c in FLOOR_CAPS], lanes)
        if f is None:
            log(f"floor ({label}): not measured (no kernel time)")
            return None
        f["timed_by"] = "K1 kernel time" if cuda else "host clock"
        log(f"floor ({label}, {f['timed_by']}): "
            f"{f['ns_per_lane_superstep']:.4f} ns/lane/superstep, "
            f"intercept {f['intercept_ms']:.4f} ms")
        return f

    rep["floor_parked"] = fit("parked", "parked_cap")

    # ---- 2. the stages ----
    s["cascade"] = t("cascade start (1/8 res)", st.cascade)
    s["prepass"] = t("half-res prepass (primary+shadow)", st.prepass)
    hd, _ = st.prepass()
    start = pipeline.min_dist_upsample(hd)
    s["primary_mindist"] = t("full-res primary (minDist start)",
                             lambda: st.primary(start))
    s["primary_zero"] = t("full-res primary (start=0)",
                          lambda: st.primary(start * 0))
    for cap in FLOOR_CAPS:
        rc = dataclasses.replace(st.rcfg, max_supersteps=cap)
        s[f"live_cap_{cap}"] = t(f"full-res primary (minDist, cap={cap})",
                                 lambda rc=rc: st.primary(start, rc))
    rep["floor_live"] = fit("live primary", "live_cap")

    if args.sweep:
        rep["sweep"] = sweep(st, start, reps, dev, log)

    if args.gi:
        s["primary_gi_gather"] = t("primary + GI gather",
                                   lambda: st.gi_gather(start))
        # the split GI frame traces the primary again for its G-buffer (the
        # script's upper bound), then the GI pass
        def split_frame():
            out = st.frame()
            return st.gi_pass(st.primary_res(start), out.color)
        s["split_gi_frame"] = t("split GI frame (base + retrace + gi)",
                                split_frame)
        out0 = st.frame()
        res0 = st.primary_res(start)
        s["base_frame"] = t("  base frame (gi off) alone",
                            lambda: st.frame().color)
        s["gi_composite"] = t("  gi composite alone (given G-buffer)",
                              lambda: st.gi_pass(res0, out0.color))
        del out0, res0

    # ---- 3. the full frame ----
    s["full_frame"] = t("full frame",
                        lambda: st.frame(include_gi=args.gi).color)
    if cuda:
        rep["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
