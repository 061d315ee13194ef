"""Parity of the port's volume ring (``parallel/volume.py``) with the JAX
package's, on a 4-rank gloo group against a 4-device JAX z-mesh.

A 64^3 world in 4 z-slabs of 16 at the slice's tracer cadence
(``ref.SLICE_SPEC``), with the world's ``sky_y``.  Each rank's slab table
equals its row of JAX's stacked tables; the ring's trace of 1152 rays (512
from random points in every direction, as ``tests/test_volume.py`` makes
them, 128 plunging along +z across the slabs, and 512 in every direction
from two open-air points, where most rays cross faces) equals JAX's ring
bit for bit on every field; a bounded handoff (32 rays a packet, which
overflows) equals the unbounded ring; the ring agrees with the
single-device trace to
``tests/test_volume.py``'s thresholds; on one rank the ring is the plain
trace, bit for bit.  ``render_frame_volume`` (every trace of a frame
through the ring) is held to that file's frame thresholds against the
port's single-device frame, at its 64x32 frame (tier 1 here; the JAX test
is marked slow).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.parallel import volume
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera
from rvgrt_tpu_torch.trace import wavefront
from tests import torch_dist
from tests import torch_jaxref as ref

RANKS = 4
SPEC = ref.SLICE_SPEC
FIELDS = ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v", "its",
          "t")
HANDOFF_CAP = 32
# tests/test_volume.py's frame: RenderConfig's defaults at 64x32
FRAME_RENDER = dict(width=64, height=32)


def _rays():
    rng = np.random.default_rng(3)
    n = 512
    o = rng.uniform(2.0, 62.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    m = 128
    ox = rng.uniform(4, 60, m).astype(np.float32)
    oy = rng.uniform(33, 60, m).astype(np.float32)
    # open air: the trace fan's point (slab 2) and the render camera's
    # (slab 3)
    air = np.repeat(np.array([[47.5, 36.0, 32.5], [30.0, 44.0, 60.0]],
                             np.float32), 256, axis=0)
    da = rng.normal(size=(512, 3)).astype(np.float32)
    da /= np.linalg.norm(da, axis=1, keepdims=True).astype(np.float32)
    cat = lambda *a: np.ascontiguousarray(  # noqa: E731
        np.concatenate(a).astype(np.float32))
    return [cat(o[:, 0], ox, air[:, 0]), cat(o[:, 1], oy, air[:, 1]),
            cat(o[:, 2], np.full(m, 2.0), air[:, 2]),
            cat(d[:, 0], np.zeros(m), da[:, 0]),
            cat(d[:, 1], np.full(m, -0.196), da[:, 1]),
            cat(d[:, 2], np.full(m, 0.9806), da[:, 2]),
            np.zeros(n + m + 512, np.float32)]


def _frame_camera():
    pos = np.array([63.0, 45.0, 49.0], np.float32)
    fwd = np.array([-0.85, -0.5, 0.2], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    up /= np.linalg.norm(up)
    return engine.camera_arrays(Camera(pos=pos, forward=fwd,
                                       right=right.astype(np.float32),
                                       up=up.astype(np.float32)),
                                time_s=0.0, device="cpu")


def _frame_ecfg():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    return dataclasses.replace(ecfg, render=dataclasses.replace(
        tcfg.RenderConfig(), **FRAME_RENDER))


def _rank(rank, world):
    from rvgrt_tpu_torch.parallel import sharding

    ecfg = ref.make_ecfg(tcfg, SPEC)
    mesh = sharding.make_mesh(RANKS, axis="z", device_type="cpu")
    w = engine.world_from_numpy(world, device="cpu")
    tables = volume.build_shard_tables(w.bits, w.sdf, ecfg.world, mesh)
    rays = [torch.from_numpy(a) for a in _rays()]
    out = {"table": u32.to_numpy(tables)}
    for name, cap in (("unbounded", None), ("bounded", HANDOFF_CAP)):
        rep = {}
        res = volume.trace_volume_sharded(tables, ecfg.world, ecfg.render,
                                          mesh, *rays, sky_y=w.sky_y,
                                          handoff_cap=cap, report=rep)
        out[name] = {f: getattr(res, f).numpy() for f in FIELDS}
        out[name + "_report"] = rep
    fcfg = _frame_ecfg()
    frame = volume.render_frame_volume(tables, w.sdf, w.gi, w.atlas,
                                       _frame_camera(), fcfg, mesh,
                                       include_gi=False, sky_y=w.sky_y)
    out["frame"] = {k: v.numpy() for k, v in frame._asdict().items()}
    return out


def _one_rank(rank, world):
    from rvgrt_tpu_torch.parallel import sharding

    ecfg = ref.make_ecfg(tcfg, SPEC)
    mesh = sharding.make_mesh(1, axis="z", device_type="cpu")
    w = engine.world_from_numpy(world, device="cpu")
    tables = volume.build_shard_tables(w.bits, w.sdf, ecfg.world, mesh)
    res = volume.trace_volume_sharded(tables, ecfg.world, ecfg.render, mesh,
                                      *[torch.from_numpy(a) for a in _rays()],
                                      sky_y=w.sky_y)
    return {f: getattr(res, f).numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def case():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    world = engine.world_to_numpy(engine.build_world(ecfg, verbose=False,
                                                     device="cpu"))
    jax = ref.start([("ref_volume_ring", dict(spec=SPEC, world=world,
                                              rays=_rays(), n_dev=RANKS))])
    ranks = torch_dist.run_ranks(_rank, RANKS, (world,))
    (one,) = torch_dist.run_ranks(_one_rank, 1, (world,))
    w = engine.world_from_numpy(world, device="cpu")
    rays = [torch.from_numpy(a) for a in _rays()]
    single = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                             table=w.trace_table, sky_y=w.sky_y)
    fcfg = _frame_ecfg()
    frame = pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas,
                                  _frame_camera(), fcfg, include_gi=False,
                                  sky_y=w.sky_y, table=w.trace_table)
    return dict(ranks=ranks, one=one, jax=jax.result()[0],
                single={f: getattr(single, f).numpy() for f in FIELDS},
                frame={k: v.numpy() for k, v in frame._asdict().items()})


def test_local_config():
    cfg = tcfg.WorldConfig().with_cube(6)
    assert volume.local_config(cfg, 4).size_z == 16
    assert volume.local_config(cfg, 1) == cfg
    with pytest.raises(AssertionError):
        volume.local_config(cfg, 3)


def test_pack_is_stable_valid_first():
    valid = torch.tensor([False, True, False, True, True])
    ids = torch.arange(5, dtype=torch.int32)
    vals = torch.arange(5, dtype=torch.float32) * 10
    got = volume._pack(valid, [ids, vals], 4, 99)
    assert got[0].tolist() == [1, 3, 4, 99]
    assert got[1].tolist() == [10.0, 30.0, 40.0, 0.0]
    got = volume._pack(valid, [ids, vals], 2, 99)
    assert got[0].tolist() == [1, 3]


def test_slab_tables_match_jax(case):
    for r, out in enumerate(case["ranks"]):
        np.testing.assert_array_equal(out["table"], case["jax"]["tables"][r])


@pytest.mark.parametrize("field", FIELDS)
def test_ring_bit_exact_vs_jax(case, field):
    want = case["jax"]["res"][field]
    assert 0.3 < want.astype(bool).mean() or field != "hit"
    for out in case["ranks"]:
        np.testing.assert_array_equal(out["unbounded"][field], want)


def test_ring_hands_rays_off(case):
    """Rays cross slab faces (hundreds of handoffs; some rays are handed
    on again in the second round), and the unbounded ring ran its ``n +
    2`` rounds with no retries."""
    reps = [out["unbounded_report"] for out in case["ranks"]]
    for rep in reps:
        assert rep["rounds"] == RANKS + 2
        assert not any(rep["stayed"])
    assert sum(sum(rep["handoffs"]) for rep in reps) > 100
    assert any(rep["handoffs"][1] > 0 for rep in reps)


def test_bounded_handoff_equals_unbounded(case):
    """``handoff_cap`` with overflow retry gives the unbounded ring's result
    exactly, ``its`` included (a stayer re-exits from its out-of-slab start
    without marching); its packets are bounded and it ran more rounds."""
    for out in case["ranks"]:
        for f in FIELDS:
            np.testing.assert_array_equal(out["bounded"][f],
                                          out["unbounded"][f], err_msg=f)
        rep = out["bounded_report"]
        assert rep["rounds"] > RANKS + 2
        assert max(rep["packet_bytes"]) == 2 * 10 * HANDOFF_CAP * 4
        assert max(rep["handoffs"]) <= 2 * HANDOFF_CAP
    # the bound bites: exits stay for a retry
    assert any(sum(out["bounded_report"]["stayed"]) > 0
               for out in case["ranks"])


def test_ring_matches_single_device(case):
    """``tests/test_volume.py``'s thresholds: hits agree on >= 99 % of the
    rays, and where both hit the geometry within 2e-2 on >= 99.5 %."""
    v, s = case["ranks"][0]["unbounded"], case["single"]
    agree = v["hit"] == s["hit"]
    assert agree.mean() >= 0.99, agree.mean()
    both = v["hit"] & s["hit"] & agree
    for f in ("px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v", "t"):
        match = np.isclose(v[f][both], s[f][both], atol=2e-2)
        assert match.mean() >= 0.995, (f, match.mean())
    miss = ~v["hit"] & ~s["hit"]
    assert np.all(v["px"][miss] == wavefront.MISS_POS)


def test_one_rank_ring_is_the_plain_trace(case):
    """On one rank there is no handoff: the ring's result is the plain
    trace's (straggler respite off), bit for bit."""
    for f in FIELDS:
        np.testing.assert_array_equal(case["one"][f], case["single"][f],
                                      err_msg=f)


def test_render_frame_volume_matches_single_device(case):
    """``tests/test_volume.py``'s frame gate: PSNR > 30 dB and under 3 % of
    pixels off by more than 0.02 (a handed-off ray restarts its stepping at
    the slab face), at its 64x32 frame, every trace through the ring."""
    a = case["frame"]["color"]
    for out in case["ranks"]:
        b = out["frame"]["color"]
        assert b.shape == a.shape == (32, 64, 3)
        assert np.isfinite(b).all()
        diff = np.abs(a - b).max(axis=-1)
        frac_off = (diff > 0.02).mean()
        mse = float(np.mean((a - b) ** 2))
        psnr = 99.0 if mse == 0 else 10.0 * math.log10(1.0 / mse)
        assert psnr > 30.0, (psnr, frac_off)
        assert frac_off < 0.03, (psnr, frac_off)
        assert np.isfinite(out["frame"]["depth"]).all()
