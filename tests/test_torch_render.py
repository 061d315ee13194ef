"""Parity of the port's frame with the JAX package at the slice's settings.

A 64^3 world built by the port and carried to JAX through numpy
(``world_from_numpy``'s format), a 128x80 frame with the headline tiers
(prepass 1/8 with cascade starts, decoupled soft-shadow sites, GI at 1/16,
bench tracer cadence): ``render_frame(include_gi=False,
return_gbuffer=True)`` and ``gi_composite`` must classify hits exactly and
reach >= 50 dB PSNR, and the GI words after 3 ``update_gi`` windows must be
bit-exact.  The camera sees terrain, sky and water (the 64^3 world's open
half is the sea floor at y=31), so the water branch's reflection traces
run.  The JAX side runs without FMA contraction (tests/torch_jaxref.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline
from tests import torch_jaxref as ref

SPEC = ref.SLICE_SPEC
CAM = ref.camera(pos=(30.0, 44.0, 60.0), forward=(0.25, -0.18, -1.0),
                 jitter=(0.0021, -0.0034), time_s=0.25)
GI_WINDOWS = 3
# 256-cell windows from GI row z=11: the open half of the world, where the
# cells above the sea floor trace sun and bounce rays
GI_SPEC = {**SPEC, "engine": {**SPEC["engine"], "gi_rays_per_frame": 256}}
GI_OFFSET = 11 * 16 * 16


def _world():
    return engine.world_to_numpy(engine.build_world(
        ref.make_ecfg(tcfg, SPEC), verbose=False, device="cpu"))


@pytest.fixture(scope="module")
def case():
    world = _world()
    jax_gi, jax_frame = ref.run([
        ("ref_gi_updates", dict(spec=GI_SPEC, world=world,
                                windows=GI_WINDOWS, offset=GI_OFFSET)),
        ("ref_render", dict(spec=SPEC, world=world, cam=CAM)),
    ])
    # the port renders the frame through the fused-superstep wrapper
    ecfg = ref.make_ecfg(tcfg, ref.with_render(SPEC, fused_superstep=True))
    w = engine.world_from_numpy(world, device="cpu")
    cam = engine.camera_arrays(
        pipeline_camera(CAM), CAM["vp"], CAM["prev_vp"], CAM["jitter"],
        CAM["time"], device="cpu")
    out, gb = pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas, cam, ecfg,
                                    include_gi=False, sky_y=w.sky_y,
                                    table=w.trace_table, return_gbuffer=True)
    comp = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg)
    return dict(world=world, jax_gi=jax_gi, jax=jax_frame, ecfg=ecfg,
                out=out, gb=gb, comp=comp)


def pipeline_camera(cam):
    from rvgrt_tpu_torch.scene.camera import Camera

    return Camera(pos=cam["pos"], forward=cam["forward"],
                  right=cam["right"], up=cam["up"])


def test_frame_shows_terrain_sky_and_water(case):
    gb = case["jax"]["gb"]
    hit = gb["hit"]
    water = hit & (gb["py"] < tcfg.LightingConfig().water_level)
    assert 0.05 < hit.mean() < 0.95
    assert water.mean() > 0.02


def test_hit_classification_exact(case):
    np.testing.assert_array_equal(case["gb"].hit.numpy(),
                                  case["jax"]["gb"]["hit"])
    for f in ("nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(case["gb"], f).numpy(),
                                      case["jax"]["gb"][f], err_msg=f)


@pytest.mark.parametrize("field", ["color", "motion", "depth", "half_dist"])
def test_base_frame_outputs_50db(case, field):
    want = case["jax"]["out"][field]
    got = getattr(case["out"], field).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if field in ("color",):
        assert ref.psnr(got, want) >= 50.0
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        assert ref.psnr(got / scale, want / scale) >= 50.0


@pytest.mark.parametrize("field", ["px", "py", "pz", "t", "albedo_r",
                                   "albedo_g", "albedo_b", "fog"])
def test_gbuffer_close(case, field):
    want = case["jax"]["gb"][field]
    got = getattr(case["gb"], field).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert ref.psnr(got / scale, want / scale) >= 50.0


def test_gi_composite_50db(case):
    got = case["comp"].numpy()
    assert got.shape == (80, 128, 3)
    assert ref.psnr(got, case["jax"]["composite"]) >= 50.0
    # the composite adds light on lit terrain
    assert (got >= case["out"].color.numpy() - 1e-7).all()


def test_gi_words_after_three_windows(case):
    ecfg = ref.make_ecfg(tcfg, GI_SPEC)
    w = engine.world_from_numpy(case["world"], device="cpu")
    gi, off = w.gi, GI_OFFSET
    for frame in range(GI_WINDOWS):
        gi = gi_update.update_gi(gi, w.bits, w.sdf, w.atlas, ecfg, frame,
                                 off, sky_y=w.sky_y, table=w.trace_table)
        off = gi_update.advance_offset(off, ecfg)
    want = case["jax_gi"]
    assert (want != case["world"]["gi"]).any()
    np.testing.assert_array_equal(u32.to_numpy(gi), want)


def test_random_sphere_dirs_unit_and_deterministic():
    seed = torch.arange(4096, dtype=torch.int32) * 7919
    a = gi_update.random_sphere_dirs(seed)
    b = gi_update.random_sphere_dirs(seed.clone())
    n = torch.sqrt(a[0] ** 2 + a[1] ** 2 + a[2] ** 2)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
