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

#: torch's intra-op threads in a test process that imports this module (not
#: in the JAX child).  A parity test runs the port while its JAX child runs
#: beside it, and the suite runs six workers on one host, so torch's
#: default of a thread a core oversubscribes the cores; with 2 the port's
#: parity files run no slower alone, and the JAX suite's longest file,
#: which shares the host with them, gets more of it.
TORCH_THREADS = 2
if __name__ != "__main__":
    import torch

    torch.set_num_threads(TORCH_THREADS)

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


def merge_spec(spec: dict, over: dict) -> dict:
    """``spec`` with the sections of ``over`` merged into its own."""
    out = dict(spec)
    for k, v in over.items():
        out[k] = {**spec.get(k, {}), **v} if isinstance(v, dict) else v
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
    """The engine's world build (the GI init of ``spec``) as numpy arrays,
    plus the coarse occupancy and column heights."""
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


def ref_axis_distance(solid, cap, chunks):
    """``sdf._axis_distance_1d`` of ``solid`` along each axis, in
    ``chunks`` leading-axis chunks."""
    import jax.numpy as jnp

    from rvgrt_tpu.world import sdf

    return [np.asarray(sdf._axis_distance_1d(jnp.asarray(solid), axis, cap,
                                             chunks=chunks))
            for axis in range(solid.ndim)]


def ref_world_parts(spec, bits=None):
    """The world build's parts on the occupancy words ``bits`` (generated
    from ``spec`` when None): the brick words, column heights, coarse
    occupancy, the SDF phase and the trace table, each function jitted
    whole (one compile each; integer results, as eager)."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.trace import wavefront
    from rvgrt_tpu.world import voxel_grid

    cfg = make_ecfg(_cfg(), spec).world
    b = (voxel_grid.generate(cfg) if bits is None
         else jnp.asarray(np.asarray(bits, np.uint32)))
    sdf = jax.jit(lambda b: engine._sdf_phase_fn(b, cfg))(b)
    return _np(dict(
        bits=b,
        brick=jax.jit(lambda b: voxel_grid.to_brick_words(b, cfg))(b),
        height=jax.jit(lambda b: voxel_grid.column_height(b, cfg))(b),
        coarse=jax.jit(lambda b: voxel_grid.coarse_occupancy(b, cfg))(b),
        sdf=sdf,
        table=jax.jit(lambda b, s: wavefront.make_trace_table(b, s, cfg))(
            b, sdf)))


def ref_gi_init(spec, cases, chunks=()):
    """``ref_world`` of ``spec`` (with its GI init), and on that world's
    arrays the words of ``init_gi_strided`` for each ``(overrides,
    stride)`` of ``cases``, the overrides merged into ``spec`` with
    ``merge_spec``, and of ``init_gi_chunked`` for each chunk of
    ``chunks``."""
    import jax.numpy as jnp

    from rvgrt_tpu.gi import update

    world = ref_world(spec)
    w = {k: jnp.asarray(world[k]) for k in ("bits", "sdf", "sky_y",
                                            "trace_table")}
    words = []
    for over, stride in cases:
        ecfg = make_ecfg(_cfg(), merge_spec(spec, over))
        words.append(np.asarray(update.init_gi_strided(
            w["bits"], w["sdf"], ecfg, sky_y=w["sky_y"],
            table=w["trace_table"], stride=tuple(stride))))
    ecfg = make_ecfg(_cfg(), spec)
    chunked = {c: np.asarray(update.init_gi_chunked(
        w["bits"], w["sdf"], ecfg, sky_y=w["sky_y"], table=w["trace_table"],
        chunk=c)) for c in chunks}
    return dict(world=world, words=words, chunked=chunked)


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


def ref_trace_z_edges(spec, table, sky_y, rays, cases, slims=(False, True)):
    """``trace(z_edges=...)`` of flat rays against one z-slab's gather
    table (``spec``'s world is the slab), for each ``(is_first, is_last)``
    of ``cases`` and each slim-carry setting of ``slims``: one jit a
    setting, the edge flags traced."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.trace import wavefront

    out = {}
    for slim in slims:
        ecfg = make_ecfg(_cfg(), with_render(spec, slim_carry=slim))

        @jax.jit
        def run(tbl, sky, first, last, *r):
            return wavefront.trace(None, None, ecfg.world, ecfg.render, *r,
                                   table=tbl, sky_y=sky,
                                   z_edges=(first, last))

        args = [jnp.asarray(a) for a in rays]
        for first, last in cases:
            res = run(jnp.asarray(table), jnp.asarray(sky_y),
                      jnp.asarray(first), jnp.asarray(last), *args)
            out[(slim, first, last)] = {
                f: np.asarray(getattr(res, f)) for f in (
                    "hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u",
                    "uv_v", "its", "t", "exit_dir")}
    return out


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


def _frame_np(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _mesh_jobs(mesh, spec, world, cam, gi_spec, gi_cases, render_fn, gi_fn,
               gi_kw, include_gi=(True,)):
    """Sharded frames (one for each ``include_gi``) and GI windows on
    ``mesh``: ``render_fn`` / ``gi_fn`` are the ``parallel`` functions of
    one tier."""
    import jax.numpy as jnp

    ecfg = make_ecfg(_cfg(), spec)
    gi_ecfg = make_ecfg(_cfg(), gi_spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    frames = {g: _frame_np(render_fn(
        w["bits"], w["sdf"], w["gi"], w["atlas"], _camera_arrays(cam), ecfg,
        mesh, include_gi=g, sky_y=w["sky_y"], table=w["trace_table"]))
        for g in include_gi}
    kw = dict(sky_y=w["sky_y"], table=w["trace_table"]) if gi_kw else {}
    gis = [np.asarray(gi_fn(w["gi"], w["bits"], w["sdf"], w["atlas"],
                            gi_ecfg, jnp.uint32(f), jnp.int32(off), mesh,
                            **kw))
           for f, off in gi_cases]
    return dict(frame=frames, gi=gis)


def _upscale_loop(fn, state, frames, mesh, taps):
    """Two closed-loop frames of a sharded upscale from the packed
    ``state``: each frame's output and packed state."""
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import temporal

    packed = temporal.pack_state(temporal.TemporalState(
        history=jnp.asarray(state["history"]),
        conf=jnp.asarray(state["conf"])))
    outs = []
    for fr in frames:
        out, packed = fn(jnp.asarray(fr["color"]), jnp.asarray(fr["motion"]),
                         jnp.asarray(fr["jitter"]), packed, mesh,
                         warp_taps=taps)
        outs.append(dict(out=np.asarray(out), packed=np.asarray(packed)))
    return outs


def ref_sharded(spec, world, cam, gi_spec, gi_cases, state, frames, slab,
                n_dev=4):
    """``parallel/sharding.py`` on an ``n_dev`` mesh of the child's CPU
    devices: the sharded frame with and without GI, the GI windows
    ``gi_cases``
    ((frame, offset) from the world's GI), ``pack_state`` of ``state``,
    ``temporal_upscale_slab`` under each warp_taps on ``slab``'s rows of
    ``frames[0]``, and two closed-loop frames of
    ``temporal_upscale_sharded`` under "bilinear_shift" and "bilinear"."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from rvgrt_tpu.parallel import sharding
    from rvgrt_tpu.upscale import temporal

    mesh = Mesh(jax.devices()[:n_dev], ("rays",))
    out = _mesh_jobs(mesh, spec, world, cam, gi_spec, gi_cases,
                     sharding.render_frame_sharded, sharding.update_gi_sharded,
                     True, include_gi=(True, False))
    st = temporal.TemporalState(history=jnp.asarray(state["history"]),
                                conf=jnp.asarray(state["conf"]))
    packed = temporal.pack_state(st)
    out["packed"] = np.asarray(packed)
    lo0, n_lo = slab
    fr = frames[0]
    color, motion = jnp.asarray(fr["color"]), jnp.asarray(fr["motion"])
    cpad = jnp.pad(color, ((1, 2), (0, 0), (0, 0)), mode="edge")
    mpad = jnp.pad(motion, ((1, 1), (0, 0), (0, 0)), mode="edge")
    out["slab"] = {}
    for taps in ("bilinear_shift", "bilinear", "pallas"):
        o, p = temporal.temporal_upscale_slab(
            cpad[lo0:lo0 + n_lo + 3], mpad[lo0:lo0 + n_lo + 2],
            jnp.asarray(fr["jitter"]), packed, lo0, n_lo, warp_taps=taps)
        out["slab"][taps] = dict(out=np.asarray(o), packed=np.asarray(p))
    out["upscale"] = {taps: _upscale_loop(sharding.temporal_upscale_sharded,
                                          state, frames, mesh, taps)
                      for taps in ("bilinear_shift", "bilinear")}
    return out


def ref_multislice(spec, world, cam, gi_spec, gi_cases, state, frames,
                   n_slices=2, chips=2):
    """``parallel/multislice.py`` on an ``n_slices`` x ``chips`` mesh of the
    child's CPU devices: the frame (include_gi), the GI windows and two
    closed-loop frames of ``temporal_upscale_multislice``."""
    import jax

    from rvgrt_tpu.parallel import multislice

    mesh = multislice.make_mesh2d(n_slices, chips,
                                  devices=jax.devices()[:n_slices * chips])
    out = _mesh_jobs(mesh, spec, world, cam, gi_spec, gi_cases,
                     multislice.render_frame_multislice,
                     multislice.update_gi_multislice, False)
    out["upscale"] = _upscale_loop(multislice.temporal_upscale_multislice,
                                   state, frames, mesh, "bilinear_shift")
    return out


def ref_volume_ring(spec, world, rays, n_dev=4):
    """``parallel/volume.py``'s ring on an ``n_dev`` z-mesh of the child's
    CPU devices: ``trace_volume_sharded`` of flat rays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from rvgrt_tpu.parallel import volume

    ecfg = make_ecfg(_cfg(), spec)
    mesh = Mesh(jax.devices()[:n_dev], ("z",))
    w = {k: jnp.asarray(v) for k, v in world.items()}
    tables = volume.build_shard_tables(w["bits"], w["sdf"], ecfg.world, mesh)
    res = volume.trace_volume_sharded(tables, ecfg.world, ecfg.render, mesh,
                                      *[jnp.asarray(a) for a in rays],
                                      sky_y=w["sky_y"])
    return dict(tables=np.asarray(tables),
                res={f: np.asarray(getattr(res, f)) for f in (
                    "hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u",
                    "uv_v", "its", "t")})


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


def ref_temporal(frames, taps, scale=3, jit=False, depth_reject=False):
    """temporal_upscale over a frame sequence; returns each output.  A
    frame's optional ``valid`` mask is passed on; ``jit`` compiles the
    step once.  With ``depth_reject``: ``(outputs, each frame's
    state.depth)``."""
    import functools

    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import temporal

    h, w = frames[0]["color"].shape[:2]
    state = temporal.init_state(h, w, scale=scale, depth_reject=depth_reject)
    step = functools.partial(temporal.temporal_upscale, warp_taps=taps,
                             depth_reject=depth_reject)
    if jit:
        step = jax.jit(step)
    outs, depths = [], []
    for fr in frames:
        valid = fr.get("valid")
        out, state = step(
            jnp.asarray(fr["color"]), jnp.asarray(fr["motion"]),
            jnp.asarray(fr["depth"]), jnp.asarray(fr["jitter"]), state,
            valid=None if valid is None else jnp.asarray(valid))
        outs.append(np.asarray(out))
        depths.append(np.asarray(state.depth))
    return (outs, depths) if depth_reject else outs


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
    reconstruction and the next state (the exact 4-tap warp; with
    ``mode`` "net", "residual" or "none" ``bench.py``'s other
    ``BENCH_UPSCALE`` posts, the flax module ``net`` static and its
    ``params`` traced; ``taps`` the accumulator's history warp),
    ``gi(gi, world, frame, offset)`` -> (words, overflow)."""
    import functools
    import json

    import jax

    from rvgrt_tpu.gi import update
    from rvgrt_tpu.render import pipeline
    from rvgrt_tpu.upscale import model as up_model
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
        return pipeline.gi_composite(color, gb, gi, sdf, ecfg,
                                     return_addend=True)

    @functools.partial(jax.jit, static_argnames=("rate", "mode", "net",
                                                 "taps"))
    def post(out, cam, state, par, rate, mode="temporal", net=None,
             params=None, taps="bilinear"):
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
        if mode == "none":
            return out, out.color, state
        if mode == "net":
            hi, _ = up_model.upscale(net, params, out.color, out.motion,
                                     out.depth, cam.jitter, state)
            return out, hi, hi
        hi, state = temporal.temporal_upscale(
            out.color, out.motion, out.depth, cam.jitter, state, valid=valid,
            warp_taps=taps)
        if mode == "residual":
            hi = net.apply(params, out.color, out.motion, out.depth,
                           cam.jitter, hi, state.conf)
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
        comp, _ = ops["composite"](out.color, gb, w["gi"], w["sdf"])
        res.append(dict(out=_np(out._asdict()), gb=_np(gb._asdict()),
                        composite=np.asarray(comp)))
    return res


def ref_render_starts(spec, world, cam, cases):
    """The base frame + G-buffer for each render keyword dict of ``cases``
    (``hint_half`` / ``hint_full`` / ``start_override`` /
    ``shadow_override`` as numpy), eagerly through ``_flat_trace_fn``."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline

    ecfg = make_ecfg(_cfg(), spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    ca = _camera_arrays(cam)
    res = []
    for kw in cases:
        out, gb = pipeline.render_frame(
            w["bits"], w["sdf"], w["gi"], w["atlas"], ca, ecfg,
            include_gi=False, sky_y=w["sky_y"], table=w["trace_table"],
            return_gbuffer=True, trace_fn=_flat_trace_fn(ecfg, w),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        res.append(dict(out=_np(out._asdict()), gb=_np(gb._asdict())))
    return res


def ref_hints(spec, half_dist, cam, prev_cam, prepass_kw, start_kw):
    """``temporal_hints_from_prepass`` of ``half_dist`` for each keyword
    dict of ``prepass_kw``, and ``temporal_start_hint`` of the prepass grid
    distances (``half_dist`` + bias) for each ``(out_h, out_w, kw)`` of
    ``start_kw``."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline

    rcfg = make_ecfg(_cfg(), spec).render
    ca, pa = _camera_arrays(cam), _camera_arrays(prev_cam)
    hd = jnp.asarray(half_dist)
    pre = [tuple(np.asarray(h) for h in pipeline.temporal_hints_from_prepass(
        hd, ca, pa, rcfg, **kw)) for kw in prepass_kw]
    starts = [np.asarray(pipeline.temporal_start_hint(
        ca, pa, hd + jnp.float32(rcfg.dist_bias), rcfg, oh, ow, **kw))
        for oh, ow, kw in start_kw]
    return dict(prepass=pre, starts=starts)


def ref_cone(spec, world, color, gb):
    """The fused cone table's parts on ``world``: ``build_occlusion`` in
    its three modes, ``make_cone_table`` (the mean mip), the table sampled
    at the G-buffer's hits, and ``gi_composite`` of the base ``color`` and
    G-buffer ``gb`` (numpy) with ``spec``'s ``gi_fused_cone``, eagerly."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline
    from rvgrt_tpu.world import gi_grid

    ecfg = make_ecfg(_cfg(), spec)
    cfg = ecfg.world
    sdf, gi = jnp.asarray(world["sdf"]), jnp.asarray(world["gi"])
    occ = {m: gi_grid.build_occlusion(sdf, cfg, m)
           for m in ("mean", "min", "max")}
    table = gi_grid.make_cone_table(gi, occ["mean"])
    g = pipeline.GBuffer(**{k: jnp.asarray(v) for k, v in gb.items()})
    sample = gi_grid.sample_cone_table(table, cfg, g.px, g.py, g.pz)
    comp = pipeline.gi_composite(jnp.asarray(color), g, gi, sdf, ecfg)
    return dict(occ={m: np.asarray(v) for m, v in occ.items()},
                table=np.asarray(table),
                sample=[np.asarray(a) for a in sample],
                composite=np.asarray(comp))


def ref_frame_step(spec, world, steps, pose, clock):
    """The JAX ``Engine.step`` on ``world`` (numpy) with ``spec``'s
    ``gi_split_dispatch`` (False: ``frame_step``, the GI update and the
    in-slab GI frame in one jit) for ``steps`` frames from ``pose`` with a
    fixed wall clock; each frame's outputs and the GI words after."""
    import time

    import jax.numpy as jnp

    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.scene.camera import Character, InputState

    time.time = lambda: clock
    ecfg = make_ecfg(_cfg(), spec)
    eng = engine.Engine.__new__(engine.Engine)
    eng.ecfg, eng.include_gi = ecfg, True
    eng.world = engine.World(**{k: jnp.asarray(v) for k, v in world.items()})
    r = ecfg.render
    eng.character = Character(display_width=r.display_width,
                              display_height=r.display_height,
                              render_width=r.width, render_height=r.height)
    eng.frame_count, eng.gi_offset, eng.start_time = 0, 0, clock
    eng.character.position = np.asarray(pose["position"], np.float32)
    eng.character.yaw = pose["yaw"]
    eng.character.pitch = pose["pitch"]
    frames = [_np(eng.step(InputState(mouse_dx=pose["mouse_dx"]))._asdict())
              for _ in range(steps)]
    return dict(frames=frames, gi=np.asarray(eng.world.gi))


def _load_net(upscaler, path):
    """The JAX package's (net, params) of a checkpoint as ``bench.py``
    loads it for ``upscaler``, or (None, None)."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.driver import checkpoint as ck
    from rvgrt_tpu.upscale import model as up_model
    from rvgrt_tpu.upscale import residual

    if upscaler == "net":
        return up_model.load_checkpoint(path)
    if upscaler == "residual":
        blob = ck.load_params(path)
        return (residual.ResidualHead(features=blob["features"],
                                      depth_layers=blob["layers"]),
                jax.tree.map(jnp.asarray, blob["params"]))
    return None, None


def ref_frame_loop(spec, world, cams, poses, gi_cadence, scale,
                   modes=(("temporal", 1, None),), rates=None,
                   include_gi=True, gi_frame=None, warp_taps="bilinear"):
    """``bench.py``'s frame loop composed of the JAX package's functions,
    jitted and called in its order, over the given cameras: the
    scheduler's rates from the poses (the first frame checkerboard; every
    frame at full rate when the first mode is not "temporal"; ``rates``
    "checker", "quarter" or "full": every frame at that tier, as
    ``BENCH_CHECKER=2|4|0``), the parity or quarter phase of the frame
    index, a GI window every ``gi_cadence``-th frame (frame number =
    ``gi_frame``, or the frame index when None; offset advanced before each
    window but the first; with ``include_gi`` False no window and no
    composite, as ``BENCH_GI=0``), the base frame at the frame's rate, then
    for each of ``modes`` - (``BENCH_UPSCALE`` mode,
    ``BENCH_COMP_CADENCE``, checkpoint path) - ``bench.py``'s ``_post``:
    the composite or, on a reusing frame, the carried full-resolution
    addend re-selected at the frame's rate and phase, the expand, the
    valid mask and the mode's upscaler (the accumulator with the
    ``warp_taps`` warp, by default the exact 4-tap one).  The modes share
    the rates, GI windows and base frames.  Returns the rates, each mode's
    frames (expanded base outputs, hit mask and reconstruction; the first
    mode's also as ``frames``), the GI words and the summed overflow."""
    import jax.numpy as jnp

    from rvgrt_tpu.gi import update
    from rvgrt_tpu.render import pipeline
    from rvgrt_tpu.render.scheduler import AdaptiveRateScheduler
    from rvgrt_tpu.upscale import temporal

    ops = _bench_ops(spec)
    ecfg = ops["ecfg"]
    r = ecfg.render
    w = {k: jnp.asarray(v) for k, v in world.items()}
    if rates is None:
        rates = "adaptive" if modes[0][0] == "temporal" else "full"
    if rates == "adaptive":
        sched = AdaptiveRateScheduler(r.width, r.height, r.fov_degrees)
        rates = ["checker"] + [
            sched.pick(sched.motion_pixels(p0, f0, p1, f1))
            for (p0, f0), (p1, f1) in zip(poses, poses[1:])]
    else:
        rates = [rates] * len(cams)
    runs = []
    for mode, cadence, path in modes:
        net, params = _load_net(mode, path)
        if mode in ("temporal", "residual"):
            state = temporal.init_state(r.height, r.width, scale=scale)
        else:
            state = jnp.zeros((r.height * scale, r.width * scale, 3),
                              jnp.float32)
        runs.append(dict(mode=mode, cadence=cadence, net=net, params=params,
                         state=state, frames=[],
                         addend=jnp.zeros((r.height, r.width, 3),
                                          jnp.float32)))
    gi, off, windows, overflow = w["gi"], 0, 0, 0
    for i, cam in enumerate(cams):
        rate = rates[i]
        par = (pipeline.QUARTER_PHASE_ORDER[i & 3] if rate == "quarter"
               else i & 1)
        if include_gi and i % gi_cadence == 0:
            if windows:
                off = update.advance_offset(off, ecfg)
            gi, ovf = ops["gi"](gi, w, jnp.uint32(i if gi_frame is None
                                                  else gi_frame),
                                jnp.int32(off))
            overflow += int(ovf)
            windows += 1
        ca = _camera_arrays(cam)
        base, gb = ops["base"](w, gi, ca, jnp.int32(par), rate=rate)
        comp = add = None
        for run in runs:
            if not include_gi:
                col = base.color
            elif run["cadence"] > 1 and i % run["cadence"] != 0:
                a = run["addend"]
                if rate == "checker":
                    a = pipeline.checker_select(a, par)
                elif rate == "quarter":
                    a = pipeline.quarter_select(a, par)
                col = jnp.clip(base.color + a, 0.0, 1.0)
            else:
                if comp is None:
                    comp, add = ops["composite"](base.color, gb, gi,
                                                 w["sdf"])
                col = comp
                if rate == "checker":
                    run["addend"] = pipeline.checker_expand(add, par)
                elif rate == "quarter":
                    run["addend"] = pipeline.quarter_expand(add, par)
                else:
                    run["addend"] = add
            out, hi, run["state"] = ops["post"](
                base._replace(color=col), ca, run["state"], jnp.int32(par),
                rate=rate, mode=run["mode"], net=run["net"],
                params=run["params"], taps=warp_taps)
            run["frames"].append(dict(out=_np(out._asdict()),
                                      hit=np.asarray(gb.hit),
                                      image=np.asarray(hi)))
    return dict(rates=rates, frames=runs[0]["frames"],
                modes=[run["frames"] for run in runs], gi=np.asarray(gi),
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


def _flax_net(kind, features, layers, dtype):
    """A JAX ``UpscalerNet`` (``kind`` "upscaler") or ``ResidualHead``
    ("residual") in ``dtype`` (a jnp name), with its ``apply`` jitted once a
    configuration."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import model as up_model
    from rvgrt_tpu.upscale import residual

    key = ("net", kind, features, layers, dtype)
    if key not in _JITTED:
        cls = up_model.UpscalerNet if kind == "upscaler" else \
            residual.ResidualHead
        net = cls(features=features, depth_layers=layers,
                  dtype=getattr(jnp, dtype))
        _JITTED[key] = (net, jax.jit(net.apply))
    return _JITTED[key]


def ref_upscale_parts(x_hwc, s, c_out, history, motion):
    """``model.depth_to_space_cf`` of ``x_hwc``, and ``warp_history`` of
    ``history`` by ``motion`` in each of its three modes."""
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import model as up_model

    hist, mot = jnp.asarray(history), jnp.asarray(motion)
    return dict(
        d2s=np.asarray(up_model.depth_to_space_cf(jnp.asarray(x_hwc), s,
                                                  c_out)),
        warps={m: np.asarray(up_model.warp_history(hist, mot, mode=m))
               for m in ("bilinear", "bilinear_packed", "nearest_packed")})


def ref_nets(cases):
    """Each case ``dict(kind, features, layers, dtype, inputs)`` with
    ``params`` (a flax tree of numpy arrays) or ``path`` (a checkpoint,
    read as ``bench.py`` reads it), applied to ``inputs`` (the net's
    arguments by name): the upscaler's (image, alpha), the head's
    image."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.driver import checkpoint as ck
    from rvgrt_tpu.upscale import model as up_model

    res = []
    for c in cases:
        if "path" in c and c["kind"] == "upscaler":
            net, params = up_model.load_checkpoint(c["path"])
            _, apply = _flax_net("upscaler", net.features, net.depth_layers,
                                 c["dtype"])
        else:
            _, apply = _flax_net(c["kind"], c["features"], c["layers"],
                                 c["dtype"])
            params = (ck.load_params(c["path"])["params"] if "path" in c
                      else c["params"])
        params = jax.tree.map(jnp.asarray, params)
        res.append(_np(apply(params, **{k: jnp.asarray(v) for k, v in
                                        c["inputs"].items()})))
    return res


def ref_fresh(height, width, inputs, history):
    """The JAX CLI's ``--upscale fresh``: ``init_params(PRNGKey(0))`` and
    one jitted ``upscale`` of ``inputs`` (color, motion, depth, jitter)
    over ``history``; returns the image."""
    import jax
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import model as up_model

    net, params = up_model.init_params(jax.random.PRNGKey(0), height, width)
    step = jax.jit(lambda p, *a: up_model.upscale(net, p, *a)[0])
    return np.asarray(step(params, *(jnp.asarray(inputs[k]) for k in (
        "color", "motion", "depth", "jitter")), jnp.asarray(history)))


def ref_params_checkpoint(port_path, jax_path):
    """Reads the port-written parameter pickle at ``port_path`` with the
    JAX package's ``load_checkpoint``, and writes at ``jax_path`` with its
    ``save_params`` a variant-tagged ``up-s`` tree from ``models.upscaler.
    init`` with every leaf drawn at random (seed 1).  Returns what it read
    (the variant's sizes and params) and what it wrote."""
    import jax

    from rvgrt_tpu.driver import checkpoint as ck
    from rvgrt_tpu.models import upscaler
    from rvgrt_tpu.upscale import model as up_model

    net, params = up_model.load_checkpoint(port_path)
    _, fresh = upscaler.init("up-s", jax.random.PRNGKey(1), 8, 8)
    rng = np.random.default_rng(1)
    written = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), fresh)
    ck.save_params(jax_path, {"variant": "up-s", "params": written})
    return dict(features=net.features, layers=net.depth_layers,
                read=_np(params), written=written)


def ref_world_checkpoint(spec, port_path, jax_path, frame_count, gi_offset):
    """Loads the port-written world at ``port_path`` with the JAX package's
    ``load_world`` (which derives ``sky_y`` and ``trace_table``) and saves
    it with its ``save_world`` at ``jax_path`` with the given counters.
    Returns the loaded world's arrays and counters."""
    from rvgrt_tpu.driver import checkpoint as ck

    ecfg = make_ecfg(_cfg(), spec)
    world, fc, go = ck.load_world(port_path, ecfg)
    ck.save_world(jax_path, world, ecfg, frame_count=frame_count,
                  gi_offset=gi_offset)
    return dict(world={k: np.asarray(getattr(world, k)) for k in (
        "bits", "sdf", "gi", "atlas", "sky_y", "trace_table")},
        gi_occ=world.gi_occ, frame_count=fc, gi_offset=go)


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


def _jax_net(kind, features, layers, dtype):
    """A JAX ``UpscalerNet`` (``kind`` "upscaler") or ``ResidualHead``
    ("residual") in ``dtype`` (a jnp name), and its training module
    (``train`` or ``residual``)."""
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import model as up_model
    from rvgrt_tpu.upscale import residual, train

    if kind == "upscaler":
        return (up_model.UpscalerNet(features=features, depth_layers=layers,
                                     dtype=getattr(jnp, dtype)), train)
    return (residual.ResidualHead(features=features, depth_layers=layers,
                                  dtype=getattr(jnp, dtype)), residual)


def _jax_sample(kind, d):
    """A ``train.Sample`` ("upscaler") or ``residual.ResSample`` of the
    numpy arrays in ``d``."""
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import residual, train

    cls = train.Sample if kind == "upscaler" else residual.ResSample
    return cls(**{k: jnp.asarray(d[k]) for k in cls._fields})


def ref_train_grads(cases):
    """Each case ``dict(kind, features, layers, dtype, params, sample)``:
    the JAX trainer's ``loss_fn`` under ``jax.value_and_grad`` (jitted
    once a configuration): the loss, the output and the gradient tree."""
    import jax

    res = []
    for c in cases:
        net, mod = _jax_net(c["kind"], c["features"], c["layers"],
                            c["dtype"])
        key = ("grads", net)
        if key not in _JITTED:
            _JITTED[key] = jax.jit(jax.value_and_grad(
                lambda p, s, net=net, mod=mod: mod.loss_fn(p, net, s),
                has_aux=True))
        (loss, out), g = _JITTED[key](c["params"],
                                      _jax_sample(c["kind"], c["sample"]))
        res.append(dict(loss=float(loss), out=np.asarray(out), grads=_np(g)))
    return res


def ref_optimizer(params, grads, lr, decay_steps):
    """``train.make_optimizer(lr, decay_steps)``: the schedule at counts
    0 .. decay_steps + 2 (``optax.cosine_decay_schedule(lr, decay_steps,
    alpha=0.03)``, as ``make_optimizer`` builds it), and the parameters
    after each of the updates with ``grads`` (a list of trees like
    ``params``), each update and its ``apply_updates`` jitted."""
    import jax
    import jax.numpy as jnp
    import optax

    from rvgrt_tpu.upscale import train

    opt = train.make_optimizer(lr, decay_steps=decay_steps)
    sched = [] if not decay_steps else [
        np.float32(optax.cosine_decay_schedule(lr, decay_steps, alpha=0.03)(
            jnp.int32(c))) for c in range(decay_steps + 3)]

    @jax.jit
    def upd(g, st, p):
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st

    st = opt.init(params)
    out = []
    for g in grads:
        params, st = upd(g, st, params)
        out.append(_np(params))
    return dict(schedule=sched, params=out)


def ref_closed_loop(kind, features, params, segments, steps, lr, seed,
                    out_path):
    """The JAX trainers' loops, f32, from ``params`` over ``segments``
    (lists of sample dicts) with ``rng=np.random.default_rng(seed)`` and
    ``make_optimizer(lr, decay_steps=steps)``: for "upscaler"
    ``train.train_closed_loop``; for "residual" ``scripts/
    train_residual.py``'s loop (a random sample of the flattened segments
    a step, ``residual.train_step``).  Returns the losses of ``steps``
    steps, the parameters after one step and the first step's gradient;
    writes the final parameters at ``out_path`` as the JAX trainer writes
    them (``{"variant": "up-s", ...}`` / ``{"kind": "residual_head",
    ...}``)."""
    import jax

    from rvgrt_tpu.driver import checkpoint as ck
    from rvgrt_tpu.upscale import residual, train

    layers = 2 if kind == "upscaler" else 3
    net, mod = _jax_net(kind, features, layers, "float32")
    segs = [[_jax_sample(kind, s) for s in seg] for seg in segments]
    opt = train.make_optimizer(lr, decay_steps=steps)

    def run(n):
        p = jax.tree.map(np.asarray, params)
        st = opt.init(p)
        rng = np.random.default_rng(seed)
        if kind == "upscaler":
            p, st, losses = train.train_closed_loop(
                net, p, opt, st, segs, n, rng=rng, verbose=False)
            return p, losses
        flat = [s for seg in segs for s in seg]
        losses = []
        for _ in range(n):
            s = flat[rng.integers(len(flat))]
            p, st, loss, _ = residual.train_step(p, st, net, opt, s)
            losses.append(float(loss))
        return p, losses

    rng = np.random.default_rng(seed)
    if kind == "upscaler":
        seg = segs[rng.integers(len(segs))]
        s0 = seg[0]._replace(history=jax.numpy.zeros_like(seg[0].history))
    else:
        flat = [s for seg in segs for s in seg]
        s0 = flat[rng.integers(len(flat))]
    g0 = jax.grad(lambda p: mod.loss_fn(p, net, s0)[0])(params)
    p1, _ = run(1)
    final, losses = run(steps)
    blob = ({"variant": "up-s", "params": jax.device_get(final)}
            if kind == "upscaler" else
            {"kind": "residual_head", "features": features, "layers": layers,
             "params": jax.device_get(final)})
    ck.save_params(out_path, blob)
    return dict(losses=losses, params1=_np(p1), grads0=_np(g0),
                final=_np(final))


def ref_accumulate(samples):
    """``residual.accumulate_samples`` over ``samples`` (dicts of
    ``train.Sample`` fields): each accumulator output and confidence."""
    from rvgrt_tpu.upscale import residual

    segs = [_jax_sample("upscaler", s) for s in samples]
    return [dict(acc_out=np.asarray(r.acc_out),
                 acc_conf=np.asarray(r.acc_conf))
            for r in residual.accumulate_samples(segs)]


def ref_evaluate(upscaler, head):
    """The two trainers' ``evaluate``: ``upscaler`` = dict(features,
    layers, params, samples) through ``train.evaluate`` (closed loop), and
    ``head`` = dict(features, layers, params, samples) through
    ``residual.evaluate``, both nets in float32."""
    import jax

    from rvgrt_tpu.upscale import residual, train

    unet, _ = _jax_net("upscaler", upscaler["features"], upscaler["layers"],
                       "float32")
    hnet, _ = _jax_net("residual", head["features"], head["layers"],
                       "float32")
    to_j = jax.tree.map(np.asarray, upscaler["params"])
    return dict(
        upscaler=train.evaluate(unet, to_j, [_jax_sample("upscaler", s)
                                             for s in upscaler["samples"]]),
        head=residual.evaluate(hnet, head["params"],
                               [_jax_sample("residual", s)
                                for s in head["samples"]]))


def ref_render_pairs(spec, n_frames, low_w, low_h, clock, **kw):
    """``train.render_pair_dataset(ecfg, n_frames, low_w, low_h, **kw)``
    with the wall clock pinned at ``clock``: each sample's arrays."""
    import time

    time.time = lambda: clock
    from rvgrt_tpu.upscale import train

    ecfg = make_ecfg(_cfg(), spec)
    return [_np(s._asdict()) for s in train.render_pair_dataset(
        ecfg, n_frames, low_w, low_h, **kw)]


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
