"""Parity of the port's 2-D ('slice', 'chip') tier (``parallel/
multislice.py``) with the JAX package's, on a 4-rank gloo group as 2
slices x 2 chips against JAX's 2x2 mesh of CPU devices.

The frame, GI windows and upscale inputs of ``tests/test_torch_sharding.py``
(a 64^3 world, the slice's settings at 128x64): the multislice frame is held
at >= 50 dB against JAX's, the GI windows word for word (one at the wrap),
two closed-loop upscale frames at >= 50 dB against JAX's and against the
port's full-frame accumulator.  ``render_frame_multislice_volume`` (each
slice's row band traced through the z-slab ring over its two chips) is held
to ``tests/test_multislice.py``'s frame gate against the port's
single-device frame at that file's 32x16 frame (tier 1 here; the JAX test
is marked slow).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.render import pipeline
from tests import test_torch_sharding as ts
from tests import torch_dist
from tests import torch_jaxref as ref

SLICES, CHIPS = 2, 2
SPEC = ts.SPEC
# tests/test_multislice.py's volume frame: RenderConfig's defaults at 32x16
VOLUME_RENDER = dict(width=32, height=16)
VOLUME_CAM = ref.camera(pos=(63.0, 44.8, 49.28), forward=(-0.85, -0.5, 0.2),
                        time_s=0.0)


def _volume_ecfg():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    return dataclasses.replace(ecfg, render=dataclasses.replace(
        tcfg.RenderConfig(), **VOLUME_RENDER))


def _rank(rank, world, state, frames):
    from rvgrt_tpu_torch.parallel import multislice, volume

    mesh = multislice.make_mesh2d(SLICES, CHIPS, device_type="cpu")
    ecfg = ref.make_ecfg(tcfg, SPEC)
    gi_ecfg = ref.make_ecfg(tcfg, ts.GI_SPEC)
    w = engine.world_from_numpy(world, device="cpu")
    frame = multislice.render_frame_multislice(
        w.bits, w.sdf, w.gi, w.atlas, ts.cam_arrays(ts.CAM), ecfg, mesh,
        include_gi=True, sky_y=w.sky_y, table=w.trace_table)
    gis = [u32.to_numpy(multislice.update_gi_multislice(
        w.gi, w.bits, w.sdf, w.atlas, gi_ecfg, f, off, mesh))
        for f, off in ts.GI_CASES]
    ups = ts.port_upscale_loop(multislice.temporal_upscale_multislice, state,
                               frames, "bilinear_shift", mesh)
    vcfg = _volume_ecfg()
    tables = volume.build_shard_tables(w.bits, w.sdf, vcfg.world, mesh,
                                       axis="chip")
    vol = multislice.render_frame_multislice_volume(
        tables, w.sdf, w.gi, w.atlas, ts.cam_arrays(VOLUME_CAM), vcfg, mesh,
        include_gi=True, sky_y=w.sky_y)
    return dict(mesh=(tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                      mesh.get_local_rank("slice"),
                      mesh.get_local_rank("chip")),
                frame={k: v.numpy() for k, v in frame._asdict().items()},
                gi=gis, upscale=ups, table_len=int(tables.numel()),
                volume={k: v.numpy() for k, v in vol._asdict().items()})


@pytest.fixture(scope="module")
def case():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    world = engine.world_to_numpy(engine.build_world(ecfg, verbose=False,
                                                     device="cpu"))
    state, frames = ts.upscale_inputs()
    jax = ref.start([("ref_multislice", dict(
        spec=SPEC, world=world, cam=ts.CAM, gi_spec=ts.GI_SPEC,
        gi_cases=ts.GI_CASES, state=state, frames=frames, n_slices=SLICES,
        chips=CHIPS))])
    ranks = torch_dist.run_ranks(_rank, SLICES * CHIPS,
                                 (world, state, frames))
    w = engine.world_from_numpy(world, device="cpu")
    single = pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas,
                                   ts.cam_arrays(VOLUME_CAM), _volume_ecfg(),
                                   include_gi=True, sky_y=w.sky_y,
                                   table=w.trace_table)
    return dict(world=world, state=state, frames=frames, ranks=ranks,
                single={k: v.numpy() for k, v in single._asdict().items()},
                jax=jax.result()[0])


def test_mesh2d_is_slice_major(case):
    for rank, out in enumerate(case["ranks"]):
        shape, names, si, ci = out["mesh"]
        assert shape == (SLICES, CHIPS) and names == ("slice", "chip")
        assert (si, ci) == divmod(rank, CHIPS)
        # each rank holds one of its slice's two z-slabs
        assert out["table_len"] < case["world"]["trace_table"].shape[0]


def test_every_rank_returns_the_assembled_outputs(case):
    first = case["ranks"][0]
    for r in case["ranks"][1:]:
        for part in ("frame", "volume"):
            for k, v in first[part].items():
                np.testing.assert_array_equal(r[part][k], v, err_msg=k)
        for a, b in zip(r["gi"], first["gi"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", ["color", "motion", "depth", "half_dist",
                                   "half_shadow"])
def test_multislice_frame_matches_jax(case, field):
    got = case["ranks"][0]["frame"][field]
    want = case["jax"]["frame"][True][field]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1.0)
    assert ref.psnr(got / scale, want / scale) >= 50.0


@pytest.mark.parametrize("i", range(len(ts.GI_CASES)),
                         ids=["in_range", "wrap"])
def test_multislice_gi_words(case, i):
    got = case["ranks"][0]["gi"][i]
    want = case["jax"]["gi"][i]
    assert (want != case["world"]["gi"]).any()
    np.testing.assert_array_equal(got, want)


def test_upscale_multislice_matches_jax_and_full_frame(case):
    got = case["ranks"][0]["upscale"]
    full = ts.full_upscale_loop(case["state"], case["frames"],
                                "bilinear_shift")
    for g, want, f in zip(got, case["jax"]["upscale"], full):
        assert ref.psnr(g["out"], want["out"]) >= 50.0
        assert np.abs(g["out"] - f["out"]).max() < 1e-5
        np.testing.assert_array_equal(g["packed"], f["packed"])


def test_multislice_volume_matches_single_device(case):
    """``tests/test_multislice.py``'s frame gate: PSNR > 40 dB, under 1 % of
    pixels off by more than 0.02, and the G-buffer outputs within 2e-2 on
    more than 99 %."""
    single = case["single"]
    got = case["ranks"][0]["volume"]
    sa, sb = single["color"], got["color"]
    assert sb.shape == sa.shape == (16, 32, 3)
    assert np.isfinite(sb).all()
    mse = float(np.mean((sa - sb) ** 2))
    psnr = 99.0 if mse == 0 else 10.0 * math.log10(1.0 / mse)
    frac_off = (np.abs(sa - sb).max(axis=-1) > 0.02).mean()
    assert psnr > 40.0, (psnr, frac_off)
    assert frac_off < 0.01, (psnr, frac_off)
    for name in ("motion", "depth", "half_dist", "half_shadow"):
        va, vb = single[name], got[name]
        assert vb.shape == va.shape and np.isfinite(vb).all(), name
        assert np.isclose(va, vb, atol=2e-2).mean() > 0.99, name
