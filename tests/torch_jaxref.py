"""JAX reference runs for the parity tests of ``rvgrt_tpu_torch``.

The parity tests feed the same numpy inputs to a ``rvgrt_tpu`` function and
to its ``rvgrt_tpu_torch`` counterpart.  XLA:CPU always allows FP-op fusion,
so inside any compiled graph (a ``lax.while_loop`` body, a ``jit``) it
contracts ``a + b * c`` into one FMA wherever the CPU has FMA instructions
- a rounding the reference semantics do not have and the port's kernels
refuse (``nvcc -fmad=false``).  So the JAX side runs here, in a child
process started with ``XLA_FLAGS=--xla_cpu_max_isa=AVX`` (an ISA without
FMA): every multiply and add then rounds separately, as in the port, and
the gates can be exact.  Nothing in ``rvgrt_tpu`` changes.

``run(jobs)`` takes ``[(name, kwargs), ...]`` naming the ``ref_*``
functions below (plain numpy / Python arguments) and returns their results
as numpy; ``start(jobs)`` returns at once, and its ``result()`` waits for
them.  ``spec`` arguments are nested dicts of config overrides applied
identically to both packages' configs by ``make_ecfg``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

#: the headline operating point of the port's slice (bench.py's defaults,
#: gi_straggler_budget 0), cut to a 64^3 world and a 128x80 frame; 128x80
#: divides by the prepass (8), shadow-site (4) and GI (16) divisors
SLICE_SPEC = {
    "cube": 6,
    "render": dict(width=128, height=80, display_width=384,
                   display_height=240, prepass_divisor=8, prepass_cascade=4,
                   shadow_site_divisor=4, steps_per_check=1,
                   dda_substeps=6, sdf_probe_interval=16, dist_bias=4.0,
                   gi_res_divisor=16),
    "lighting": dict(soft_shadows=True, soft_shadow_stride=2),
    "engine": dict(gi_init_mode="heightfield", gi_straggler_budget=0),
}


def with_render(spec: dict, **render) -> dict:
    """``spec`` with extra render overrides (e.g. the port's
    ``fused_superstep=True``; the JAX side runs the superstep's XLA
    body)."""
    out = dict(spec)
    out["render"] = {**spec.get("render", {}), **render}
    return out


def camera(pos, forward, jitter=(0.0, 0.0), time_s=0.25) -> dict:
    """A camera dict (basis + view-projection matrices) both packages'
    ``camera_arrays`` accept."""
    f = np.asarray(forward, np.float32)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.array([0, 1, 0], np.float32))
    r = (r / np.linalg.norm(r)).astype(np.float32)
    u = np.cross(f, r).astype(np.float32)
    u = u / np.linalg.norm(u)
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0], vp[1, 1], vp[2, 3], vp[3, 2] = 1.1, 1.7, -1.0, -0.2
    prev = vp.copy()
    prev[3, 0] = 0.03
    return dict(pos=np.asarray(pos, np.float32), forward=f.astype(np.float32),
                right=r, up=u.astype(np.float32), vp=vp, prev_vp=prev,
                jitter=np.asarray(jitter, np.float32), time=float(time_s))


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def make_ecfg(cfg_mod, spec: dict):
    """EngineConfig of ``cfg_mod`` (either package's config module) with
    the overrides in ``spec``: {"cube": int, "world": {...}, "render":
    {...}, "lighting": {...}, "engine": {...}}."""
    world = cfg_mod.WorldConfig()
    if "cube" in spec:
        world = world.with_cube(spec["cube"])
    world = dataclasses.replace(world, **spec.get("world", {}))
    return cfg_mod.EngineConfig(
        world=world,
        render=dataclasses.replace(cfg_mod.RenderConfig(),
                                   **spec.get("render", {})),
        lighting=dataclasses.replace(cfg_mod.LightingConfig(),
                                     **spec.get("lighting", {})),
        **spec.get("engine", {}))


class Child:
    """The ``ref_*`` jobs running in their child process, started by
    ``start``; ``result()`` waits for them and returns their results."""

    def __init__(self, jobs, timeout: float):
        self._dir = tempfile.TemporaryDirectory()
        src = os.path.join(self._dir.name, "in.pkl")
        self._dst = os.path.join(self._dir.name, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(list(jobs), f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_cpu_max_isa=AVX").strip()
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        self._timeout = timeout
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "tests.torch_jaxref", src, self._dst],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        try:
            try:
                _, err = self._proc.communicate(timeout=self._timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.communicate()
                raise
            if self._proc.returncode != 0:
                raise RuntimeError(f"JAX reference process failed "
                                   f"({self._proc.returncode}):\n"
                                   f"{err[-4000:]}")
            with open(self._dst, "rb") as f:
                return pickle.load(f)
        finally:
            self._dir.cleanup()


def start(jobs, timeout: float = 600.0) -> Child:
    """Start the ``ref_*`` jobs in one child process and return at once,
    so that the caller's own work overlaps the JAX side."""
    return Child(jobs, timeout)


def run(jobs, timeout: float = 600.0):
    """Run the ``ref_*`` jobs in one child process; returns their results."""
    return start(jobs, timeout).result()


# ---------------------------------------------------------------------------
# Reference functions: run in the child process only (they import jax).

def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _cfg():
    from rvgrt_tpu import config

    return config


def ref_noise(x, y, z, i, j, k):
    from rvgrt_tpu.core import noise, terrain

    return _np(dict(
        hash3=noise.hash3(i, j, k), hash2=noise.hash2(i, j),
        simplex2d=noise.simplex2d(x, z), simplex3d=noise.simplex3d(x, y, z),
        fbm2d=noise.fbm2d(x, z, 5, 0.01, 2.0, 0.5),
        fbm3d=noise.fbm3d(x, y, z, 4, 0.02, 2.1, 0.45),
        density=terrain.evaluate_density(x, y, z)))


def ref_generate(spec):
    from rvgrt_tpu.world import voxel_grid

    return np.asarray(voxel_grid.generate(make_ecfg(_cfg(), spec).world))


def ref_world(spec):
    """The engine's world build (heightfield GI init) as numpy arrays, plus
    the coarse occupancy and column heights."""
    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.world import voxel_grid

    ecfg = make_ecfg(_cfg(), spec)
    w = engine.build_world(ecfg, verbose=False)
    out = {k: np.asarray(getattr(w, k))
           for k in ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table")}
    out["coarse"] = np.asarray(voxel_grid.coarse_occupancy(w.bits,
                                                           ecfg.world))
    out["height"] = np.asarray(voxel_grid.column_height(w.bits, ecfg.world))
    return out


def ref_trace(spec, world, rays, shape):
    """``trace`` of the rays at ``shape``; with ``render.straggler_budget``
    > 0 in ``spec`` and 4 x 4096 rays or more, its two-phase respite."""
    import jax.numpy as jnp

    from rvgrt_tpu.trace import wavefront

    ecfg = make_ecfg(_cfg(), spec)
    args = [jnp.asarray(np.asarray(a).reshape(shape)) for a in rays]
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *args,
                          table=jnp.asarray(world["trace_table"]),
                          sky_y=jnp.asarray(world["sky_y"]))
    return {f: np.asarray(getattr(res, f)) for f in (
        "hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v", "its",
        "t", "exit_dir", "degraded")}


def ref_superstep(spec, world, state, dirs):
    """One superstep of the XLA body - the oracle of the fused Pallas
    kernel (tests/test_trace.py::test_fused_superstep_matches_xla)."""
    import jax.numpy as jnp

    from rvgrt_tpu.trace import wavefront

    ecfg = make_ecfg(_cfg(), spec)
    cfg, rcfg = ecfg.world, ecfg.render
    s = {k: jnp.asarray(v) for k, v in state.items()}
    d = tuple(jnp.asarray(a) for a in dirs)
    sky = jnp.asarray(world["sky_y"])
    pre = wavefront._superstep_pregather(cfg, rcfg, d, s, sky_y=sky)
    word = jnp.take(jnp.asarray(world["trace_table"]), pre["widx"],
                    mode="clip")
    ns = wavefront._superstep_update(cfg, rcfg, d,
                                     (s["tmx"], s["tmy"], s["tmz"]), s, pre,
                                     word)
    return {k: np.asarray(ns[k]) for k in state}


def ref_gi_updates(spec, world, windows, offset, stats=False):
    """GI words after ``windows`` update_gi windows from the world's GI,
    the first at cell ``offset``; ``stats``: also each window's
    ``straggler_overflow``."""
    import jax.numpy as jnp

    from rvgrt_tpu.gi import update

    ecfg = make_ecfg(_cfg(), spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    gi, off = w["gi"], offset
    overflow = []
    for frame in range(windows):
        gi = update.update_gi(gi, w["bits"], w["sdf"], w["atlas"], ecfg,
                              jnp.uint32(frame), jnp.int32(off),
                              sky_y=w["sky_y"], table=w["trace_table"],
                              return_stats=stats)
        if stats:
            gi, st = gi
            overflow.append(int(st["straggler_overflow"]))
        off = update.advance_offset(off, ecfg)
    if stats:
        return np.asarray(gi), overflow
    return np.asarray(gi)


def _camera_arrays(cam):
    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.scene.camera import Camera

    c = Camera(pos=cam["pos"], forward=cam["forward"], right=cam["right"],
               up=cam["up"])
    return engine.camera_arrays(c, cam["vp"], cam["prev_vp"],
                                cam["jitter"], cam["time"])


def ref_render(spec, world, cam, checker_parity=None, quarter_phase=None):
    """Split-dispatch frame: base frame + G-buffer, then the composite;
    at checkerboard or quarter rate when a parity or phase is given."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline

    ecfg = make_ecfg(_cfg(), spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    ca = _camera_arrays(cam)
    out, gb = pipeline.render_frame(
        w["bits"], w["sdf"], w["gi"], w["atlas"], ca, ecfg,
        include_gi=False, sky_y=w["sky_y"], table=w["trace_table"],
        return_gbuffer=True, checker_parity=checker_parity,
        quarter_phase=quarter_phase)
    comp = pipeline.gi_composite(out.color, gb, w["gi"], w["sdf"], ecfg)
    return dict(out=_np(out._asdict()), gb=_np(gb._asdict()),
                composite=np.asarray(comp))


def ref_temporal(frames, taps, scale=3, jit=False):
    """temporal_upscale over a frame sequence; returns each output.  A
    frame's optional ``valid`` mask is passed on; ``jit`` compiles the
    step once."""
    import functools

    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import temporal

    h, w = frames[0]["color"].shape[:2]
    state = temporal.init_state(h, w, scale=scale)
    step = functools.partial(temporal.temporal_upscale, warp_taps=taps)
    if jit:
        step = jax.jit(step)
    outs = []
    for fr in frames:
        valid = fr.get("valid")
        out, state = step(
            jnp.asarray(fr["color"]), jnp.asarray(fr["motion"]),
            jnp.asarray(fr["depth"]), jnp.asarray(fr["jitter"]), state,
            valid=None if valid is None else jnp.asarray(valid))
        outs.append(np.asarray(out))
    return outs


def ref_rate_schedule(width, height, fov, poses):
    """The JAX scheduler's tier for each pose after the first, from
    consecutive (pos, forward) poses."""
    from rvgrt_tpu.render.scheduler import AdaptiveRateScheduler

    sched = AdaptiveRateScheduler(width, height, fov)
    return [sched.pick(sched.motion_pixels(p0, f0, p1, f1))
            for (p0, f0), (p1, f1) in zip(poses, poses[1:])]


def ref_rate_helpers(arrays):
    """The checkerboard and quarter selects, expands and masks on each
    (H, W[, C]) array: {(name, i, parity or phase): result}."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline

    out = {}
    for i, a in enumerate(arrays):
        h, w = a.shape[:2]
        x = jnp.asarray(a)
        for p in (0, 1):
            sel = pipeline.checker_select(x, p)
            out[("checker_select", i, p)] = np.asarray(sel)
            out[("checker_expand", i, p)] = np.asarray(
                pipeline.checker_expand(sel, p))
            out[("checker_valid_mask", i, p)] = np.asarray(
                pipeline.checker_valid_mask(h, w, p))
        for p in range(4):
            sel = pipeline.quarter_select(x, p)
            out[("quarter_select", i, p)] = np.asarray(sel)
            out[("quarter_expand", i, p)] = np.asarray(
                pipeline.quarter_expand(sel, p))
            out[("quarter_valid_mask", i, p)] = np.asarray(
                pipeline.quarter_valid_mask(h, w, p))
    return out


_JITTED: dict = {}
#: lane counts of ``_flat_trace_fn``'s compiled traces (whole multiples)
_FLAT_LANES = 8192


def _flat_trace_fn(ecfg, w):
    """A ``trace_fn`` for ``render_frame`` that runs every trace flattened
    and padded to a whole multiple of ``_FLAT_LANES`` lanes through one
    jitted ``wavefront.trace`` per lane count.  Per lane this is the trace
    of any layout (a retired lane is frozen; only ``steps`` differs, and
    the renderer does not read it), and the padding lanes start outside
    the world and retire at once; what it saves is a compile per trace
    shape."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.trace import wavefront

    def trace_fn(ox, oy, oz, dx, dy, dz, t0):
        ins = (ox, oy, oz, dx, dy, dz, t0)
        shape = jnp.broadcast_shapes(*(jnp.shape(a) for a in ins))
        n = int(np.prod(shape))
        lanes = -(-n // _FLAT_LANES) * _FLAT_LANES
        pad = [-10.0, -10.0, -10.0, 1.0, 0.0, 0.0, 0.0]
        flat = [jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(a, jnp.float32), shape).reshape(-1),
            jnp.full((lanes - n,), p, jnp.float32)]) for a, p in zip(ins,
                                                                    pad)]
        key = ("trace", ecfg.world, ecfg.render, lanes)
        if key not in _JITTED:
            _JITTED[key] = jax.jit(lambda tbl, sky, *a: wavefront.trace(
                None, None, ecfg.world, ecfg.render, *a, table=tbl,
                sky_y=sky))
        res = _JITTED[key](w["trace_table"], w["sky_y"], *flat)
        return type(res)(*(f[:n].reshape(shape) for f in res))

    return trace_fn


def _bench_ops(spec):
    """``bench.py``'s per-frame functions for ``spec``, the post step and
    the GI window jitted once per child process (and rate; the parity or
    phase is traced): ``base(world, gi, cam, par, rate)`` -> (outputs,
    G-buffer) through ``_flat_trace_fn``, ``composite(color, gb, gi,
    sdf)``, ``post(out, cam, state, par, rate)`` -> expanded outputs,
    reconstruction and the next state (the exact 4-tap warp), ``gi(gi,
    world, frame, offset)`` -> (words, overflow)."""
    import functools
    import json

    import jax

    from rvgrt_tpu.gi import update
    from rvgrt_tpu.render import pipeline
    from rvgrt_tpu.upscale import temporal

    key = json.dumps(spec, sort_keys=True, default=str)
    if key in _JITTED:
        return _JITTED[key]
    ecfg = make_ecfg(_cfg(), spec)
    r = ecfg.render

    def base(w, gi, cam, par, rate):
        return pipeline.render_frame(
            w["bits"], w["sdf"], gi, w["atlas"], cam, ecfg,
            include_gi=False, sky_y=w["sky_y"], table=w["trace_table"],
            return_gbuffer=True, trace_fn=_flat_trace_fn(ecfg, w),
            checker_parity=par if rate == "checker" else None,
            quarter_phase=par if rate == "quarter" else None)

    def composite(color, gb, gi, sdf):
        return pipeline.gi_composite(color, gb, gi, sdf, ecfg)

    @functools.partial(jax.jit, static_argnames="rate")
    def post(out, cam, state, par, rate):
        valid = None
        if rate == "checker":
            def ex(a):
                return pipeline.checker_expand(a, par)
            valid = pipeline.checker_valid_mask(r.height, r.width, par)
        elif rate == "quarter":
            def ex(a):
                return pipeline.quarter_expand(a, par)
            valid = pipeline.quarter_valid_mask(r.height, r.width, par)
        if valid is not None:
            out = out._replace(color=ex(out.color), motion=ex(out.motion),
                               depth=ex(out.depth))
        hi, state = temporal.temporal_upscale(
            out.color, out.motion, out.depth, cam.jitter, state, valid=valid,
            warp_taps="bilinear")
        return out, hi, state

    @jax.jit
    def gi_window(gi, w, frame, offset):
        new, st = update.update_gi(gi, w["bits"], w["sdf"], w["atlas"], ecfg,
                                   frame, offset, sky_y=w["sky_y"],
                                   table=w["trace_table"], return_stats=True)
        return new, st["straggler_overflow"]

    _JITTED[key] = ops = dict(base=base, composite=composite, post=post,
                              gi=gi_window, ecfg=ecfg)
    return ops


def ref_render_rates(spec, world, cam, cases):
    """``ref_render`` through ``bench.py``'s jitted functions for each
    (rate, parity or phase) of ``cases``."""
    import jax.numpy as jnp

    ops = _bench_ops(spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    ca = _camera_arrays(cam)
    res = []
    for rate, par in cases:
        out, gb = ops["base"](w, w["gi"], ca, jnp.int32(par), rate=rate)
        comp = ops["composite"](out.color, gb, w["gi"], w["sdf"])
        res.append(dict(out=_np(out._asdict()), gb=_np(gb._asdict()),
                        composite=np.asarray(comp)))
    return res


def ref_frame_loop(spec, world, cams, poses, gi_cadence, scale):
    """``bench.py``'s frame loop composed of the JAX package's functions,
    jitted and called in its order, over the given cameras: the
    scheduler's rates from the poses (the first frame checkerboard), the
    parity or quarter phase of the frame index, a GI window every
    ``gi_cadence``-th frame (frame number = frame index, offset advanced
    before each window but the first), the base frame at the frame's rate,
    the composite, the expand, the valid mask and the temporal accumulator
    with the exact 4-tap warp.  Returns the rates, each frame's expanded
    base outputs, hit mask and reconstruction, the GI words and the
    summed overflow."""
    import jax.numpy as jnp

    from rvgrt_tpu.gi import update
    from rvgrt_tpu.render import pipeline
    from rvgrt_tpu.render.scheduler import AdaptiveRateScheduler
    from rvgrt_tpu.upscale import temporal

    ops = _bench_ops(spec)
    ecfg = ops["ecfg"]
    r = ecfg.render
    w = {k: jnp.asarray(v) for k, v in world.items()}
    sched = AdaptiveRateScheduler(r.width, r.height, r.fov_degrees)
    rates = ["checker"] + [
        sched.pick(sched.motion_pixels(p0, f0, p1, f1))
        for (p0, f0), (p1, f1) in zip(poses, poses[1:])]
    state = temporal.init_state(r.height, r.width, scale=scale)
    gi, off, windows, overflow = w["gi"], 0, 0, 0
    frames = []
    for i, cam in enumerate(cams):
        rate = rates[i]
        par = (pipeline.QUARTER_PHASE_ORDER[i & 3] if rate == "quarter"
               else i & 1)
        if i % gi_cadence == 0:
            if windows:
                off = update.advance_offset(off, ecfg)
            gi, ovf = ops["gi"](gi, w, jnp.uint32(i), jnp.int32(off))
            overflow += int(ovf)
            windows += 1
        ca = _camera_arrays(cam)
        out, gb = ops["base"](w, gi, ca, jnp.int32(par), rate=rate)
        out = out._replace(color=ops["composite"](out.color, gb, gi,
                                                  w["sdf"]))
        out, hi, state = ops["post"](out, ca, state, jnp.int32(par),
                                     rate=rate)
        frames.append(dict(out=_np(out._asdict()), hit=np.asarray(gb.hit),
                           image=np.asarray(hi)))
    return dict(rates=rates, frames=frames, gi=np.asarray(gi),
                overflow=overflow)


def ref_warp(packed, xs, ys):
    """The Pallas warp kernel in interpret mode and its XLA oracle."""
    import jax.numpy as jnp

    from rvgrt_tpu.ops import warp_kernels

    args = (jnp.asarray(packed), jnp.asarray(xs), jnp.asarray(ys))
    kern, ovf = warp_kernels.warp_packed_bilinear(*args, interpret=True)
    xla, _ = warp_kernels.warp_packed_bilinear_xla(*args)
    return dict(kernel=np.asarray(kern), overflow=int(ovf),
                xla=np.asarray(xla))


def ref_engine(spec, steps, pose, clock):
    """Engine: world build + ``steps`` Engine.step frames from ``pose``
    with a fixed wall clock; returns the world and each frame's outputs."""
    import time

    time.time = lambda: clock
    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.scene.camera import InputState

    eng = engine.Engine(make_ecfg(_cfg(), spec), verbose=False)
    eng.character.position = np.asarray(pose["position"], np.float32)
    eng.character.yaw = pose["yaw"]
    eng.character.pitch = pose["pitch"]
    world = {k: np.asarray(getattr(eng.world, k))
             for k in ("bits", "sdf", "gi", "atlas", "sky_y", "trace_table")}
    frames = []
    for i in range(steps):
        out = eng.step(InputState(mouse_dx=pose["mouse_dx"]))
        frames.append(_np(out._asdict()))
    return dict(world=world, frames=frames,
                gi=np.asarray(eng.world.gi))


def _main(src: str, dst: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(src, "rb") as f:
        jobs = pickle.load(f)
    results = [globals()[name](**kw) for name, kw in jobs]
    with open(dst, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
