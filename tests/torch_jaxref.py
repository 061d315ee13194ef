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
as numpy.  ``spec`` arguments are nested dicts of config overrides applied
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


def run(jobs, timeout: float = 600.0):
    """Run the ``ref_*`` jobs in one child process; returns their results."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.pkl")
        dst = os.path.join(d, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(list(jobs), f)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_cpu_max_isa=AVX").strip()
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
        res = subprocess.run(
            [sys.executable, "-m", "tests.torch_jaxref", src, dst],
            cwd=str(REPO), env=env, capture_output=True, text=True,
            timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"JAX reference process failed "
                               f"({res.returncode}):\n{res.stderr[-4000:]}")
        with open(dst, "rb") as f:
            return pickle.load(f)


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
    import jax.numpy as jnp

    from rvgrt_tpu.trace import wavefront

    ecfg = make_ecfg(_cfg(), spec)
    args = [jnp.asarray(np.asarray(a).reshape(shape)) for a in rays]
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *args,
                          table=jnp.asarray(world["trace_table"]),
                          sky_y=jnp.asarray(world["sky_y"]))
    return {f: np.asarray(getattr(res, f)) for f in (
        "hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v", "its",
        "t")}


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


def ref_gi_updates(spec, world, windows, offset):
    """GI words after ``windows`` update_gi windows from the world's GI,
    the first at cell ``offset``."""
    import jax.numpy as jnp

    from rvgrt_tpu.gi import update

    ecfg = make_ecfg(_cfg(), spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    gi, off = w["gi"], offset
    for frame in range(windows):
        gi = update.update_gi(gi, w["bits"], w["sdf"], w["atlas"], ecfg,
                              jnp.uint32(frame), jnp.int32(off),
                              sky_y=w["sky_y"], table=w["trace_table"])
        off = update.advance_offset(off, ecfg)
    return np.asarray(gi)


def _camera_arrays(cam):
    from rvgrt_tpu.driver import engine
    from rvgrt_tpu.scene.camera import Camera

    c = Camera(pos=cam["pos"], forward=cam["forward"], right=cam["right"],
               up=cam["up"])
    return engine.camera_arrays(c, cam["vp"], cam["prev_vp"],
                                cam["jitter"], cam["time"])


def ref_render(spec, world, cam):
    """Split-dispatch frame: base frame + G-buffer, then the composite."""
    import jax.numpy as jnp

    from rvgrt_tpu.render import pipeline

    ecfg = make_ecfg(_cfg(), spec)
    w = {k: jnp.asarray(v) for k, v in world.items()}
    ca = _camera_arrays(cam)
    out, gb = pipeline.render_frame(
        w["bits"], w["sdf"], w["gi"], w["atlas"], ca, ecfg,
        include_gi=False, sky_y=w["sky_y"], table=w["trace_table"],
        return_gbuffer=True)
    comp = pipeline.gi_composite(out.color, gb, w["gi"], w["sdf"], ecfg)
    return dict(out=_np(out._asdict()), gb=_np(gb._asdict()),
                composite=np.asarray(comp))


def ref_temporal(frames, taps):
    """temporal_upscale over a frame sequence; returns each output."""
    import jax.numpy as jnp

    from rvgrt_tpu.upscale import temporal

    h, w = frames[0]["color"].shape[:2]
    state = temporal.init_state(h, w)
    outs = []
    for fr in frames:
        out, state = temporal.temporal_upscale(
            jnp.asarray(fr["color"]), jnp.asarray(fr["motion"]),
            jnp.asarray(fr["depth"]), jnp.asarray(fr["jitter"]), state,
            warp_taps=taps)
        outs.append(np.asarray(out))
    return outs


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
