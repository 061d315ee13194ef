"""Parity of the port's entry point ``python -m rvgrt_tpu_torch.bench`` with
the repository's ``bench.py``, and of the frame loop's knobs it adds.

* End to end: the repository's ``bench.py`` runs once in a subprocess on
  the CPU (``JAX_PLATFORMS=cpu``, no FMA contraction, from a copy in a
  temporary directory so that its compile cache starts empty) at ``BENCH_CUBE=6
  BENCH_W=128 BENCH_H=80 BENCH_FRAMES=4 BENCH_CONFIG4=0 BENCH_CHECKER=2
  BENCH_GI_CADENCE=3``, a fixed tier and a GI cadence other than the
  default; ``rvgrt_tpu_torch.bench.main(device="cpu")`` runs under the same
  knobs.  ``metric``, ``unit``, ``extra``'s keys, the headline's frames,
  tier mix, mean rays a frame, camera path and overflow are equal,
  ``hit_frac`` within 1e-3, and the build's phases have the same keys in
  the same order.
* Without JAX: the ray accounting over a rate schedule gives the dicts the
  JAX entry point printed at 128x80 (the adaptive default at 6 frames, and
  the point above) and the 1280x800 headline's 406 768 rays a frame;
  ``bench_config`` sets, knob by knob, the fields ``bench.py`` sets; and
  the refusals: ``BENCH_FUSED=0``, a value ``bench.py`` does not name, a
  missing checkpoint and, on a host without CUDA, ``main()`` with no device.
* ``FrameLoop``'s knobs against the JAX loop (``torch_jaxref.
  ref_frame_loop``) at ``SLICE_SPEC`` over 2 warm-up and 2 timed frames: a
  fixed checkerboard tier, a fixed quarter tier, ``gi_cadence=3``,
  ``include_gi=False``, ``gi_frame=0`` and ``warp_taps="bilinear_shift"``,
  each alone: the rates equal, GI words bit-exact, hits exact, every frame
  >= 50 dB.  The GI window is 1024 cells (``LOOP_SPEC``): ``SLICE_SPEC``'s
  derived window, 8 cells, leaves the words of these frames as they were.
  And an extra warm-up frame (``advance=False``) keeps the GI window's
  offset, as ``bench.py``'s do.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import bench
from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine, frame_loop
from rvgrt_tpu_torch.scene.camera import Character, phase_jitter_sequence
from tests import torch_jaxref as ref

#: the end-to-end point: a fixed checkerboard tier, a GI window every 3rd
#: frame
BENCH_ENV = {"BENCH_CUBE": "6", "BENCH_W": "128", "BENCH_H": "80",
             "BENCH_FRAMES": "4", "BENCH_CONFIG4": "0", "BENCH_CHECKER": "2",
             "BENCH_GI_CADENCE": "3"}
#: the JAX entry point's run of the point above, in seconds (91 s alone)
BENCH_TIMEOUT = 600.0
#: what the JAX entry point printed (tier mix, mean rays a frame) at
#: 128x80 on 64^3, and the 1280x800 headline's accounting
RAY_CASES = {
    "adaptive_128x80": (
        {"BENCH_CUBE": "6", "BENCH_W": "128", "BENCH_H": "80",
         "BENCH_FRAMES": "6"},
        {"checker": 2, "quarter": 4},
        {"primary": 3413.3, "prepass_primary": 160.0, "prepass_shadow": 0.0,
         "cascade": 8.0, "shadow_sites": 213.3, "gi_update": 8.0}),
    "checker_cadence3_128x80": (
        BENCH_ENV, {"checker": 4},
        {"primary": 5120.0, "prepass_primary": 160.0, "prepass_shadow": 0.0,
         "cascade": 8.0, "shadow_sites": 320.0, "gi_update": 4.0}),
    "headline_1280x800": (
        {}, {"checker": 10, "quarter": 22},
        {"primary": 336000.0, "prepass_primary": 16000.0,
         "prepass_shadow": 0.0, "cascade": 1000.0, "shadow_sites": 21000.0,
         "gi_update": 32768.0}),
}
_D = tcfg.RenderConfig()
#: each knob of bench.py:58-219 alone -> the fields it sets ("world",
#: "render.x", "lighting.x", "engine.x" of the EngineConfig; "opts.x" of the
#: run options)
KNOB_CASES = {
    "defaults": ({}, {"engine.gi_straggler_budget": 12,
                      "engine.gi_init_mode": "heightfield",
                      "engine.gi_init_stride": (2, 2),
                      "render.prepass_divisor": 8,
                      "render.shadow_site_divisor": 4,
                      "render.steps_per_check": 1,
                      "render.gi_res_divisor": 16,
                      "render.fused_superstep": True,
                      "lighting.soft_shadows": True,
                      "lighting.soft_shadow_stride": 2,
                      "opts.frames": 32, "opts.cam_path": "interactive",
                      "opts.gi_cadence": 2, "opts.warp_taps": "pallas"}),
    "BENCH_CUBE": ({"BENCH_CUBE": "7"},
                   {"world": tcfg.WorldConfig().with_cube(7)}),
    "BENCH_REF_WORLD": ({"BENCH_REF_WORLD": "1"},
                        {"world": tcfg.WorldConfig(), "opts.ref_world": True}),
    "BENCH_W_H": ({"BENCH_W": "640", "BENCH_H": "400"},
                  {"render.width": 640, "render.height": 400}),
    "BENCH_FRAMES": ({"BENCH_FRAMES": "8"}, {"opts.frames": 8}),
    "BENCH_GI": ({"BENCH_GI": "0"}, {"opts.include_gi": False}),
    "BENCH_UPSCALE_net": ({"BENCH_UPSCALE": "net"},
                          {"opts.up_mode": "net", "opts.adaptive": False,
                           "opts.cam_path": "pan",
                           "opts.config4_rate": "0"}),
    "BENCH_UPSCALE_1": ({"BENCH_UPSCALE": "1"}, {"opts.up_mode": "net"}),
    "BENCH_UPSCALE_residual": ({"BENCH_UPSCALE": "residual"},
                               {"opts.upscaler": "residual",
                                "opts.adaptive": False,
                                "opts.cam_path": "pan",
                                "opts.config4_rate": "0"}),
    "BENCH_UPSCALE_0": ({"BENCH_UPSCALE": "0"},
                        {"opts.upscale": False, "opts.upscaler": "none",
                         "opts.config4_rate": "0"}),
    "BENCH_CONFIG4": ({"BENCH_CONFIG4": "0"}, {"opts.config4": False}),
    "BENCH_SOFT": ({"BENCH_SOFT": "0"},
                   {"render.prepass_divisor": 4,
                    "render.shadow_site_divisor": 0,
                    "lighting.soft_shadows": False,
                    "lighting.soft_shadow_stride": 2}),
    "BENCH_FAST_TRACE": ({"BENCH_FAST_TRACE": "0"},
                         {"render.dda_substeps": _D.dda_substeps,
                          "render.sdf_probe_interval": _D.sdf_probe_interval,
                          "render.dist_bias": _D.dist_bias}),
    "BENCH_CHECKER_2": ({"BENCH_CHECKER": "2"},
                        {"opts.checker": True, "opts.adaptive": False,
                         "opts.cam_path": "pan"}),
    "BENCH_CHECKER_4": ({"BENCH_CHECKER": "4"},
                        {"opts.quarter": True, "opts.cam_path": "pan"}),
    "BENCH_CHECKER_0": ({"BENCH_CHECKER": "0"},
                        {"opts.checker": False, "opts.quarter": False,
                         "opts.adaptive": False, "opts.cam_path": "pan"}),
    "BENCH_PATH": ({"BENCH_PATH": "pan"},
                   {"opts.cam_path": "pan", "opts.adaptive": True}),
    "BENCH_CONFIG4_RATE": ({"BENCH_CONFIG4_RATE": "0"},
                           {"opts.config4_rate": "0"}),
    "BENCH_SLIM": ({"BENCH_SLIM": "1"},
                   {"render.slim_carry": True,
                    "render.fused_superstep": False}),
    "BENCH_FUSED": ({"BENCH_FUSED": "1"}, {"render.fused_superstep": True}),
    "BENCH_GI_CADENCE": ({"BENCH_GI_CADENCE": "3"}, {"opts.gi_cadence": 3}),
    "BENCH_GI_CADENCE_0": ({"BENCH_GI_CADENCE": "0"},
                           {"opts.gi_cadence": 1}),
    "BENCH_COMP_CADENCE": ({"BENCH_COMP_CADENCE": "2"},
                           {"opts.comp_cadence": 2}),
    "BENCH_WARP": ({"BENCH_WARP": "bilinear_shift"},
                   {"opts.warp_taps": "bilinear_shift"}),
    "BENCH_PREPASS_DIV": ({"BENCH_PREPASS_DIV": "2"},
                          {"render.prepass_divisor": 2}),
    "BENCH_SHADOW_SITES": ({"BENCH_SHADOW_SITES": "0"},
                           {"render.shadow_site_divisor": 0}),
    "BENCH_SPC": ({"BENCH_SPC": "2"}, {"render.steps_per_check": 2}),
    "BENCH_GI_DIV": ({"BENCH_GI_DIV": "4"}, {"render.gi_res_divisor": 4}),
    "BENCH_GI_INIT": ({"BENCH_GI_INIT": "traced"},
                      {"engine.gi_init_mode": "traced"}),
    "BENCH_GI_INIT_STRIDE": ({"BENCH_GI_INIT_STRIDE": "0"},
                             {"engine.gi_init_stride": (1, 1)}),
}
#: FrameLoop's knobs, each alone (the JAX loop's warp is the exact 4-tap
#: one, which K2's plain version computes, unless the case names another)
LOOP_CASES = {
    "checker": dict(rates="checker"),
    "quarter": dict(rates="quarter"),
    "gi_cadence_3": dict(gi_cadence=3),
    "no_gi": dict(include_gi=False),
    "gi_frame_0": dict(gi_frame=0),
    "warp_bilinear_shift": dict(warp_taps="bilinear_shift"),
}
#: SLICE_SPEC with GI windows large enough to change words in 2 windows
LOOP_SPEC = ref.merge_spec(ref.SLICE_SPEC,
                           {"engine": {"gi_rays_per_frame": 1024}})
LOOP_TIMED = 2
LOOP_N = LOOP_TIMED + frame_loop.WARMUP
#: the 64^3 pose of tests/test_torch_rates.py: terrain and sky in view
POSE = dict(position=(30.0, 44.0, 60.0), yaw=math.pi + 0.25,
            pitch=-math.pi - 0.18)


def _start_jax_bench(folder):
    """The repository's bench.py at ``BENCH_ENV`` on the CPU, started from
    a copy in ``folder``: its compile cache (``.jax_cache/`` beside it)
    starts empty."""
    shutil.copy(ref.REPO / "bench.py", folder / "bench.py")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_ENV)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ref.REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen([sys.executable, str(folder / "bench.py")],
                            cwd=str(folder), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _jax_bench_result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _loop_ecfg():
    return ref.make_ecfg(tcfg, ref.with_render(LOOP_SPEC,
                                               fused_superstep=True))


def _loop_cameras():
    """A Character at ``POSE`` along the interactive path (the 9-phase
    jitter), and the same cameras as dicts for the JAX side."""
    r = _loop_ecfg().render
    ch = Character(display_width=r.display_width,
                   display_height=r.display_height, render_width=r.width,
                   render_height=r.height,
                   position=np.asarray(POSE["position"], np.float32),
                   yaw=POSE["yaw"], pitch=POSE["pitch"],
                   jitter_sequence=phase_jitter_sequence(3))
    cams = frame_loop.path_cameras(ch, frame_loop.path_yaws(LOOP_TIMED),
                                   time_s=0.25, device="cpu")
    dicts = [dict(pos=c.pos.numpy(), forward=c.forward.numpy(),
                  right=c.right.numpy(), up=c.up.numpy(), vp=c.vp.numpy(),
                  prev_vp=c.prev_vp.numpy(), jitter=c.jitter.numpy(),
                  time=float(c.time)) for _, c in cams]
    return cams, dicts


def _loop_job(world, cams, dicts, kw):
    return ("ref_frame_loop", dict(
        spec=LOOP_SPEC, world=world, cams=dicts,
        poses=[(c.pos, c.forward) for c, _ in cams],
        gi_cadence=kw.get("gi_cadence", frame_loop.GI_CADENCE), scale=3,
        rates=kw.get("rates"), include_gi=kw.get("include_gi", True),
        gi_frame=kw.get("gi_frame"),
        warp_taps=kw.get("warp_taps", "bilinear")))


def _port_loop(world, cams, kw):
    ecfg = _loop_ecfg()
    w = engine.world_from_numpy(world, device="cpu")
    kw = dict(kw)
    rates = frame_loop.rate_schedule([c for c, _ in cams], ecfg,
                                     rates=kw.pop("rates", "adaptive"))
    loop = frame_loop.FrameLoop(w, ecfg, scale=3, **kw)
    frames = [loop.frame(i, ca, rates[i]) for i, (_, ca) in enumerate(cams)]
    return dict(rates=rates, frames=frames, loop=loop)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX entry point's JSON and the JAX loops, with the port's entry
    point and loops run while the two JAX processes run."""
    world = engine.world_to_numpy(engine.build_world(
        _loop_ecfg(), verbose=False, device="cpu"))
    cams, dicts = _loop_cameras()
    proc = _start_jax_bench(tmp_path_factory.mktemp("jax_bench"))
    child = ref.start([_loop_job(world, cams, dicts, kw)
                       for kw in LOOP_CASES.values()])
    try:
        port = bench.main(env=BENCH_ENV, device="cpu")
        loops = {k: _port_loop(world, cams, kw)
                 for k, kw in LOOP_CASES.items()}
    finally:
        try:
            ref_loops = child.result()
        finally:
            jax_json = _jax_bench_result(proc)
    return dict(world=world, port=port, jax=jax_json, loops=loops,
                ref_loops=dict(zip(LOOP_CASES, ref_loops)))


HEADLINE_FIELDS = ["frames", "tier_mix", "rays_per_frame_mean",
                   "camera_path", "straggler_overflow"]


@pytest.mark.parametrize("field", ["metric", "unit"])
def test_bench_line_matches_jax(case, field):
    assert case["port"][field] == case["jax"][field]


def test_bench_keys_match_jax(case):
    assert case["port"].keys() == case["jax"].keys()
    assert case["port"]["extra"].keys() == case["jax"]["extra"].keys()
    assert (case["port"]["extra"]["headline"].keys()
            == case["jax"]["extra"]["headline"].keys())


@pytest.mark.parametrize("field", HEADLINE_FIELDS)
def test_bench_headline_matches_jax(case, field):
    got = case["port"]["extra"]["headline"][field]
    assert got == case["jax"]["extra"]["headline"][field]


def test_bench_hit_frac_matches_jax(case):
    got = case["port"]["extra"]["headline"]["hit_frac"]
    want = case["jax"]["extra"]["headline"]["hit_frac"]
    assert 0.0 < got <= 1.0
    assert abs(got - want) <= 1e-3


def test_bench_build_phases_match_jax(case):
    assert (list(case["port"]["extra"]["world_build_phases"])
            == list(case["jax"]["extra"]["world_build_phases"]))


def test_bench_numbers_are_consistent(case):
    """The line's value is the headline's Mrays/s, and fps and the ray
    accounting give it."""
    out = case["port"]
    head = out["extra"]["headline"]
    assert out["value"] == head["mrays_per_s"]
    assert head["fps"] > 0.0
    total = sum(head["rays_per_frame_mean"].values())
    assert head["mrays_per_s"] == pytest.approx(total * head["fps"] / 1e6,
                                                abs=0.01)
    assert out["vs_baseline"] == pytest.approx(head["fps"] / 30.0, abs=1e-3)
    assert out["extra"]["world_build_s"] > 0.0


@pytest.mark.parametrize("name", list(RAY_CASES))
def test_ray_accounting_matches_jax(name):
    env, mix, rays = RAY_CASES[name]
    ecfg, opts = bench.bench_config(env)
    raw = [bench.cam_at(y, (512.0, 300.0, 512.0))
           for y in frame_loop.path_yaws(opts.frames, opts.cam_path)]
    rate_seq = frame_loop.rate_schedule(
        raw, ecfg, rates=bench.point_rates(opts, headline=True))
    got_rays, got_mix, total = bench.ray_means(
        ecfg, rate_seq, opts.frames, opts.include_gi, opts.gi_cadence)
    assert got_mix == mix
    assert got_rays == rays
    if name == "headline_1280x800":
        assert total == 406768


def _field(ecfg, opts, path):
    head, _, name = path.partition(".")
    obj = {"world": ecfg.world, "render": ecfg.render,
           "lighting": ecfg.lighting, "engine": ecfg, "opts": opts}[head]
    return getattr(obj, name) if name else obj


@pytest.mark.parametrize("knob", list(KNOB_CASES))
def test_bench_config_sets_bench_fields(knob):
    env, want = KNOB_CASES[knob]
    ecfg, opts = bench.bench_config(env)
    for path, v in want.items():
        assert _field(ecfg, opts, path) == v, path
    if knob != "BENCH_W_H":
        assert (ecfg.render.width, ecfg.render.height) == (1280, 800)


def test_headline_config_is_bench_default():
    """chip_smoke.py's point and the entry point's default are one."""
    ecfg, opts = bench.bench_config({})
    assert ecfg == bench.headline_config(opts.cube, opts.width, opts.height)


@pytest.mark.parametrize("env,match", [
    ({"BENCH_FUSED": "0"}, "K1"),
    ({"BENCH_CHECKER": "3"}, "BENCH_CHECKER"),
    ({"BENCH_UPSCALE": "dlss"}, "BENCH_UPSCALE"),
    ({"BENCH_WARP": "cubic"}, "BENCH_WARP"),
], ids=["fused_0", "checker_3", "upscale_dlss", "warp_cubic"])
def test_bench_config_refuses(env, match):
    with pytest.raises(ValueError, match=match):
        bench.bench_config(env)


@pytest.mark.parametrize("mode", ["net", "residual"])
def test_missing_checkpoint_raises(tmp_path, mode):
    _, opts = bench.bench_config({"BENCH_UPSCALE": mode})
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        bench.load_post_net(opts, "cpu", folder=tmp_path)


def test_checkpoints_load(tmp_path):
    _, opts = bench.bench_config({"BENCH_UPSCALE": "residual"})
    assert bench.load_post_net(opts, "cpu") is not None
    _, opts = bench.bench_config({})
    assert bench.load_post_net(opts, "cpu", folder=tmp_path) is None


def test_main_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(env=BENCH_ENV)


@pytest.mark.parametrize("name", list(LOOP_CASES))
def test_loop_knob_rates_and_gi_words(case, name):
    got, want = case["loops"][name], case["ref_loops"][name]
    kw = LOOP_CASES[name]
    assert got["rates"] == want["rates"]
    if "rates" in kw:
        assert got["rates"] == [kw["rates"]] * LOOP_N
    loop = got["loop"]
    gi = u32.to_numpy(loop.gi)
    np.testing.assert_array_equal(gi, want["gi"])
    cadence = kw.get("gi_cadence", frame_loop.GI_CADENCE)
    windows = len(range(0, LOOP_N, cadence)) if kw.get("include_gi", True) \
        else 0
    assert loop.gi_windows == windows
    assert (gi != case["world"]["gi"]).any() == (windows > 0)
    if name == "gi_frame_0":
        # the same windows as the checkerboard case's but for frame 2's seed
        other = u32.to_numpy(case["loops"]["checker"]["loop"].gi)
        assert (gi != other).any()


@pytest.mark.parametrize("i", range(LOOP_N))
@pytest.mark.parametrize("name", list(LOOP_CASES))
def test_loop_knob_frames_50db(case, name, i):
    got = case["loops"][name]["frames"][i]
    want = case["ref_loops"][name]["frames"][i]
    if LOOP_CASES[name].get("include_gi", True):
        np.testing.assert_array_equal(got.hit.numpy(), want["hit"])
    else:
        assert got.hit is None and not got.gi_ran
    for f in ("color", "motion", "depth"):
        g = getattr(got.out, f).numpy()
        w = want["out"][f]
        assert g.shape == w.shape, f
        scale = max(float(np.abs(w).max()), 1.0)
        assert ref.psnr(g / scale, w / scale) >= 50.0, f
    assert got.image.shape == (240, 384, 3)
    assert ref.psnr(got.image.numpy(), want["image"]) >= 50.0


def test_extra_warm_frame_keeps_offset(case):
    """``advance=False``: the GI window of bench.py's extra warm-up frame
    reuses the last window's offset; the next window moves on from it."""
    ecfg = _loop_ecfg()
    w = engine.world_from_numpy(case["world"], device="cpu")
    cams, _ = _loop_cameras()
    loop = frame_loop.FrameLoop(w, ecfg, gi_cadence=1, gi_frame=0)
    step = ecfg.gi_window
    loop.frame(0, cams[0][1], "checker")
    loop.frame(1, cams[1][1], "checker")
    assert loop.offset == step
    res = loop.frame(1, cams[1][1], "quarter", advance=False)
    assert res.gi_ran and loop.offset == step and loop.gi_windows == 3
    loop.frame(2, cams[2][1], "quarter")
    assert loop.offset == 2 * step
