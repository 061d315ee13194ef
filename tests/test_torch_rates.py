"""Parity of the port's rate tier, respite-engaged GI and frame loop with JAX.

``bench.py`` times checkerboard and quarter-rate frames, chosen per frame by
the motion-adaptive scheduler, with a GI window every 2nd frame whose
traces run the two-phase straggler respite.  Against the JAX package:

* the scheduler's tiers along ``bench.py``'s interactive and pan paths at
  128x80, 1280x800 and 1920x1080 are JAX's;
* the checkerboard and quarter selects, expands and valid masks are
  bit-exact, for every parity and phase, on 1- and 3-channel inputs;
* ``render_frame`` at both checkerboard parities and all four quarter
  phases (64^3 world, 128x80, ``test_torch_render.py``'s camera): hits and
  normals exact, outputs, G-buffer and the rate-cut ``gi_composite`` >= 50
  dB;
* ``temporal_upscale(valid=...)`` over a checkerboard/quarter sequence at
  scale 3 and scale 1: >= 50 dB;
* the slice as a whole: 6 frames of ``driver/frame_loop.py`` along the
  interactive path (checkerboard and quarter frames, GI every 2nd frame,
  straggler budget 12, 16 384-cell windows so the respite engages) against
  the JAX functions composed in ``bench.py``'s order: the same tiers, GI
  words bit-exact, every base and reconstructed frame >= 50 dB with exact
  hit classification.

The world has ``gi_coarseness=2`` so that its GI grid (32^3 cells) holds a
16 384-cell window.  The JAX side runs without FMA contraction in one child
process (tests/torch_jaxref.py), jitted as ``bench.py`` jits it.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine, frame_loop
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import (Camera, Character,
                                          phase_jitter_sequence)
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.upscale import temporal
from tests import torch_jaxref as ref

SPEC = {**ref.SLICE_SPEC,
        "world": dict(gi_coarseness=2),
        "engine": {**ref.SLICE_SPEC["engine"], "gi_rays_per_frame": 16384,
                   "gi_straggler_budget": 12}}
CAM = ref.camera(pos=(30.0, 44.0, 60.0), forward=(0.25, -0.18, -1.0),
                 jitter=(0.0021, -0.0034), time_s=0.25)
RATE_CASES = [("checker", 0), ("checker", 1), ("quarter", 0), ("quarter", 1),
              ("quarter", 2), ("quarter", 3)]
# chip_smoke.py's 64^3 pose; 4 timed frames + 2 warm-ups of the path
POSE = dict(position=(30.0, 44.0, 60.0), yaw=math.pi + 0.25,
            pitch=-math.pi - 0.18)
LOOP_FRAMES = 4
SCHED_SIZES = [(128, 80), (1280, 800), (1920, 1080)]
SCHED_PATHS = ["interactive", "pan"]
H, W = 80, 128


def _bench_poses(path: str):
    """``bench.py``'s ``path_cams`` poses for its 32 timed frames: the
    camera fixed, looking down 0.5 and turning by the path's yaw."""
    poses = []
    for ang in frame_loop.path_yaws(32, path):
        fwd = np.array([math.cos(ang) * 0.87, -0.5, math.sin(ang) * 0.87],
                       np.float32)
        fwd /= np.linalg.norm(fwd)
        poses.append((np.array([512.0, 300.0, 512.0], np.float32), fwd))
    return poses


def _helper_inputs():
    rng = np.random.default_rng(5)
    return [rng.random((8, 12), np.float32),
            rng.random((8, 12, 3), np.float32)]


def _valid_frames():
    """A textured pan at 80x128 through a checker/quarter sequence: each
    frame's colour is traced on its valid pixels and filled elsewhere, as
    the frame loop hands it to the upscaler."""
    rng = np.random.default_rng(17)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    seq = phase_jitter_sequence(3)
    frames = []
    for i, rate in enumerate(("checker", "checker", "quarter", "quarter")):
        sx = xx + 0.7 * i
        col = np.stack([0.5 + 0.4 * np.sin(sx * 0.19 + yy * 0.05),
                        0.5 + 0.4 * np.cos(yy * 0.11 - sx * 0.07),
                        0.5 + 0.3 * np.sin((sx + yy) * 0.08)], axis=-1)
        col = np.clip(col + rng.normal(0.0, 0.02, col.shape), 0, 1)
        col = torch.from_numpy(col.astype(np.float32))
        phase = frame_loop.frame_phase(i, rate)
        if rate == "checker":
            full = pipeline.checker_expand(
                pipeline.checker_select(col, phase), phase)
            valid = pipeline.checker_valid_mask(H, W, phase)
        else:
            full = pipeline.quarter_expand(
                pipeline.quarter_select(col, phase))
            valid = pipeline.quarter_valid_mask(H, W, phase)
        mot = np.zeros((H, W, 2), np.float32)
        mot[..., 0] = 0.7 * 2.0 / W
        jit = seq[i % len(seq)] * 0.5 * 2.0 / np.array([W, H], np.float32)
        frames.append(dict(color=full.numpy(), motion=mot,
                           depth=np.ones((H, W), np.float32),
                           jitter=jit.astype(np.float32),
                           valid=valid.numpy()))
    return frames


def _loop_cameras():
    """The port's cameras for the loop: a Character at ``POSE`` along the
    interactive path, and the same cameras as dicts for the JAX side."""
    ecfg = ref.make_ecfg(tcfg, SPEC)
    r = ecfg.render
    ch = Character(display_width=r.display_width,
                   display_height=r.display_height, render_width=r.width,
                   render_height=r.height,
                   position=np.asarray(POSE["position"], np.float32),
                   yaw=POSE["yaw"], pitch=POSE["pitch"],
                   jitter_sequence=phase_jitter_sequence(3))
    cams = frame_loop.path_cameras(ch, frame_loop.path_yaws(LOOP_FRAMES),
                                   time_s=0.25, device="cpu")
    dicts = [dict(pos=c.pos.numpy(), forward=c.forward.numpy(),
                  right=c.right.numpy(), up=c.up.numpy(), vp=c.vp.numpy(),
                  prev_vp=c.prev_vp.numpy(), jitter=c.jitter.numpy(),
                  time=float(c.time)) for _, c in cams]
    return cams, dicts


def _port_renders(world):
    """The port's base frame, G-buffer and composite at each rate case."""
    ecfg = ref.make_ecfg(tcfg, ref.with_render(SPEC, fused_superstep=True))
    w = engine.world_from_numpy(world, device="cpu")
    cam = engine.camera_arrays(
        Camera(pos=CAM["pos"], forward=CAM["forward"], right=CAM["right"],
               up=CAM["up"]), CAM["vp"], CAM["prev_vp"], CAM["jitter"],
        CAM["time"], device="cpu")
    out = {}
    for rate, par in RATE_CASES:
        o, gb = pipeline.render_frame(
            w.bits, w.sdf, w.gi, w.atlas, cam, ecfg, include_gi=False,
            sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
            checker_parity=par if rate == "checker" else None,
            quarter_phase=par if rate == "quarter" else None)
        comp = pipeline.gi_composite(o.color, gb, w.gi, w.sdf, ecfg)
        out[(rate, par)] = (o, gb, comp)
    return out


def _port_loop(world, cams):
    """The port's frame loop over ``cams``, with its trace stats."""
    ecfg = ref.make_ecfg(tcfg, ref.with_render(SPEC, fused_superstep=True))
    w = engine.world_from_numpy(world, device="cpu")
    rates = frame_loop.rate_schedule([c for c, _ in cams], ecfg)
    loop = frame_loop.FrameLoop(w, ecfg, scale=3)
    wavefront.reset_stats()
    frames = [loop.frame(i, ca, rates[i]) for i, (_, ca) in enumerate(cams)]
    return dict(rates=rates, frames=frames, loop=loop,
                stats=wavefront.read_stats())


@pytest.fixture(scope="module")
def case():
    """The JAX results and the port's renders and loop; the port renders
    while the JAX child runs."""
    world = engine.world_to_numpy(engine.build_world(
        ref.make_ecfg(tcfg, SPEC), verbose=False, device="cpu"))
    cams, cam_dicts = _loop_cameras()
    jobs = [("ref_rate_schedule", dict(width=wd, height=ht, fov=60.0,
                                       poses=_bench_poses(path)))
            for path in SCHED_PATHS for wd, ht in SCHED_SIZES]
    jobs += [("ref_rate_helpers", dict(arrays=_helper_inputs())),
             ("ref_render_rates", dict(spec=SPEC, world=world, cam=CAM,
                                       cases=RATE_CASES)),
             ("ref_temporal", dict(frames=_valid_frames(), taps="bilinear",
                                   scale=3, jit=True)),
             ("ref_temporal", dict(frames=_valid_frames(), taps="bilinear",
                                   scale=1, jit=True)),
             ("ref_frame_loop", dict(spec=SPEC, world=world, cams=cam_dicts,
                                     poses=[(c.pos, c.forward)
                                            for c, _ in cams],
                                     gi_cadence=frame_loop.GI_CADENCE,
                                     scale=3))]
    child = ref.start(jobs)
    try:
        port = dict(renders=_port_renders(world),
                    loop=_port_loop(world, cams))
    finally:
        res = child.result()
    n = len(SCHED_PATHS) * len(SCHED_SIZES)
    sched = dict(zip([(p, s) for p in SCHED_PATHS for s in SCHED_SIZES],
                     res[:n]))
    helpers, renders, t3, t1, loop = res[n:]
    return dict(world=world, cams=cams, sched=sched, helpers=helpers,
                renders=dict(zip(RATE_CASES, renders)),
                temporal={3: t3, 1: t1}, loop=loop, port=port)


@pytest.fixture(scope="module")
def port_renders(case):
    return case["port"]["renders"]


@pytest.fixture(scope="module")
def port_loop(case):
    return case["port"]["loop"]


def _psnr_scaled(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    return ref.psnr(got / scale, want / scale)


@pytest.mark.parametrize("size", SCHED_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("path", SCHED_PATHS)
def test_rate_schedule_matches_jax(case, path, size):
    ecfg = ref.make_ecfg(tcfg, {"render": dict(width=size[0],
                                               height=size[1])})
    poses = [Camera(pos=p, forward=f) for p, f in _bench_poses(path)]
    got = frame_loop.rate_schedule(poses, ecfg)
    assert got == ["checker"] + case["sched"][(path, size)]


def test_bench_headline_tier_mix():
    """bench.py's 32 timed frames at 1280x800 along its interactive path:
    10 checkerboard and 22 quarter-rate frames, none at full rate."""
    ecfg = ref.make_ecfg(tcfg, {"render": dict(width=1280, height=800)})
    poses = [Camera(pos=p, forward=f)
             for p, f in _bench_poses("interactive")]
    timed = frame_loop.rate_schedule(poses, ecfg)[frame_loop.WARMUP:]
    assert timed.count("checker") == 10 and timed.count("quarter") == 22


@pytest.mark.parametrize("p", [0, 1])
@pytest.mark.parametrize("channels", [1, 3])
def test_checker_helpers_bit_exact(case, channels, p):
    i = 0 if channels == 1 else 1
    a = torch.from_numpy(_helper_inputs()[i])
    want = case["helpers"]
    sel = pipeline.checker_select(a, p)
    np.testing.assert_array_equal(sel.numpy(),
                                  want[("checker_select", i, p)])
    np.testing.assert_array_equal(pipeline.checker_expand(sel, p).numpy(),
                                  want[("checker_expand", i, p)])
    np.testing.assert_array_equal(
        pipeline.checker_valid_mask(*a.shape[:2], p).numpy(),
        want[("checker_valid_mask", i, p)])


@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("channels", [1, 3])
def test_quarter_helpers_bit_exact(case, channels, p):
    i = 0 if channels == 1 else 1
    a = torch.from_numpy(_helper_inputs()[i])
    want = case["helpers"]
    sel = pipeline.quarter_select(a, p)
    np.testing.assert_array_equal(sel.numpy(),
                                  want[("quarter_select", i, p)])
    np.testing.assert_array_equal(pipeline.quarter_expand(sel).numpy(),
                                  want[("quarter_expand", i, p)])
    np.testing.assert_array_equal(
        pipeline.quarter_valid_mask(*a.shape[:2], p).numpy(),
        want[("quarter_valid_mask", i, p)])


@pytest.mark.parametrize("rate,par", RATE_CASES)
def test_render_rate_hits_and_normals_exact(case, port_renders, rate, par):
    _, gb, _ = port_renders[(rate, par)]
    want = case["renders"][(rate, par)]["gb"]
    shape = (H, W // 2) if rate == "checker" else (H // 2, W // 2)
    assert tuple(gb.hit.shape) == shape
    assert 0.05 < want["hit"].mean() < 0.95
    for f in ("hit", "nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(gb, f).numpy(), want[f],
                                      err_msg=f)


@pytest.mark.parametrize("rate,par", RATE_CASES)
def test_render_rate_outputs_50db(case, port_renders, rate, par):
    out, gb, comp = port_renders[(rate, par)]
    want = case["renders"][(rate, par)]
    for f in ("color", "motion", "depth", "half_dist"):
        got = getattr(out, f).numpy()
        assert got.shape == want["out"][f].shape, f
        assert np.isfinite(got).all(), f
        assert _psnr_scaled(got, want["out"][f]) >= 50.0, f
    for f in ("px", "py", "pz", "t", "albedo_r", "albedo_g", "albedo_b",
              "fog"):
        assert _psnr_scaled(getattr(gb, f).numpy(), want["gb"][f]) >= 50.0, f
    assert ref.psnr(comp.numpy(), want["composite"]) >= 50.0


@pytest.mark.parametrize("scale", [3, 1])
def test_temporal_valid_sequence_50db(case, scale):
    frames = _valid_frames()
    state = temporal.init_state(H, W, scale=scale, device="cpu")
    for fr, want in zip(frames, case["temporal"][scale]):
        out, state = temporal.temporal_upscale(
            *(torch.from_numpy(fr[k]) for k in ("color", "motion", "depth",
                                                "jitter")),
            state, warp_taps="pallas", valid=torch.from_numpy(fr["valid"]))
        assert out.shape == (scale * H, scale * W, 3)
        assert ref.psnr(out.numpy(), want) >= 50.0


def test_frame_loop_tiers_and_respite(case, port_loop):
    """The loop's tiers are JAX's and include both rate cuts; the GI
    windows ran the respite (each a two-phase trace for its sun and its
    bounce rays) and overflowed as often as JAX's."""
    rates = port_loop["rates"]
    assert rates == case["loop"]["rates"]
    assert {"checker", "quarter"} <= set(rates)
    windows = port_loop["loop"].gi_windows
    assert windows == 3
    assert port_loop["stats"]["respites"] == 2 * windows
    assert int(port_loop["loop"].overflow) == case["loop"]["overflow"]


def test_frame_loop_gi_words_bit_exact(case, port_loop):
    gi = u32.to_numpy(port_loop["loop"].gi)
    assert (gi != case["world"]["gi"]).any()
    np.testing.assert_array_equal(gi, case["loop"]["gi"])


@pytest.mark.parametrize("i", range(LOOP_FRAMES + frame_loop.WARMUP))
def test_frame_loop_frames_50db(case, port_loop, i):
    got = port_loop["frames"][i]
    want = case["loop"]["frames"][i]
    np.testing.assert_array_equal(got.hit.numpy(), want["hit"])
    for f in ("color", "motion", "depth"):
        g = getattr(got.out, f).numpy()
        assert g.shape == want["out"][f].shape, f
        assert _psnr_scaled(g, want["out"][f]) >= 50.0, f
    assert got.image.shape == (3 * H, 3 * W, 3)
    assert ref.psnr(got.image.numpy(), want["image"]) >= 50.0
