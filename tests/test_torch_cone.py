"""Parity of the port's fused cone table (``RenderConfig.gi_fused_cone``)
with the JAX package's, at the slice's settings (``ref.SLICE_SPEC``).

``gi_grid.build_occlusion`` in its three modes ("mean" with its uint16 sum,
"min", "max") and ``make_cone_table`` equal JAX's bit for bit on the
port's 64^3 world, and so does ``sample_cone_table`` at a frame's hits.
``gi_composite`` with the flag (one gather a cone step: radiance and the
occlusion mip in one word) matches JAX's at >= 50 dB, and bit for bit,
on the same base frame and G-buffer, and differs from the two-gather composite.
``build_world`` with the flag builds ``World.gi_occ`` (JAX's mean mip),
``Engine.step`` passes it to the composite, and ``load_world`` rebuilds it
bit for bit.  The JAX side runs without FMA contraction
(tests/torch_jaxref.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import checkpoint, engine
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera
from rvgrt_tpu_torch.world import gi_grid
from tests import torch_jaxref as ref

SPEC = ref.with_render(ref.SLICE_SPEC, gi_fused_cone=True)
CAM = ref.camera(pos=(30.0, 44.0, 60.0), forward=(0.25, -0.18, -1.0),
                 jitter=(0.0021, -0.0034), time_s=0.25)
MODES = ("mean", "min", "max")


@pytest.fixture(scope="module")
def case():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    w = engine.build_world(ecfg, verbose=False, device="cpu")
    world = engine.world_to_numpy(w)
    cam = engine.camera_arrays(
        Camera(pos=CAM["pos"], forward=CAM["forward"], right=CAM["right"],
               up=CAM["up"]), CAM["vp"], CAM["prev_vp"], CAM["jitter"],
        CAM["time"], device="cpu")
    out, gb = pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas, cam, ecfg,
                                    include_gi=False, sky_y=w.sky_y,
                                    table=w.trace_table, return_gbuffer=True)
    gb_np = {k: v.numpy() for k, v in gb._asdict().items()}
    want = ref.run([("ref_cone", dict(spec=SPEC, world=world,
                                      color=out.color.numpy(), gb=gb_np))])[0]
    return dict(ecfg=ecfg, w=w, out=out, gb=gb, want=want)


@pytest.mark.parametrize("mode", MODES)
def test_build_occlusion_bit_exact(case, mode):
    cfg = case["ecfg"].world
    got = u32.to_numpy(gi_grid.build_occlusion(case["w"].sdf, cfg, mode))
    np.testing.assert_array_equal(got, case["want"]["occ"][mode])
    assert got.shape == (cfg.gi_num_cells,)
    assert not (got & 0x00FFFFFF).any()


def test_occlusion_modes_differ(case):
    occ = case["want"]["occ"]
    lo, mid, hi = (occ[m] >> 24 for m in ("min", "mean", "max"))
    assert (lo <= mid).all() and (mid <= hi).all()
    assert (lo < hi).any()


def test_cone_table_bit_exact(case):
    w = case["w"]
    table = gi_grid.make_cone_table(w.gi, w.gi_occ)
    np.testing.assert_array_equal(u32.to_numpy(table), case["want"]["table"])
    gb = case["gb"]
    got = gi_grid.sample_cone_table(table, case["ecfg"].world, gb.px, gb.py,
                                    gb.pz)
    for g, want in zip(got, case["want"]["sample"]):
        np.testing.assert_array_equal(g.numpy(), want)


def test_world_gi_occ_is_the_mean_mip(case):
    np.testing.assert_array_equal(u32.to_numpy(case["w"].gi_occ),
                                  case["want"]["occ"]["mean"])


def test_fused_cone_composite_50db(case):
    ecfg, w, out, gb = case["ecfg"], case["w"], case["out"], case["gb"]
    got = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg,
                                gi_occ=w.gi_occ)
    want = case["want"]["composite"]
    assert got.shape == want.shape
    assert ref.psnr(got.numpy(), want) >= 50.0
    # on the same G-buffer the march is the same arithmetic: bit for bit
    np.testing.assert_array_equal(got.numpy(), want)
    # gi_occ=None builds the same mip from the SDF
    again = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    # the fused table is a different march from the two-gather one
    two = pipeline.gi_composite(out.color, gb, w.gi, w.sdf,
                                dataclasses.replace(ecfg, render=dataclasses
                                                    .replace(ecfg.render,
                                                             gi_fused_cone=False)))
    assert float((two - got).abs().max()) > 0.0


def test_engine_step_with_the_fused_cone(case):
    """``Engine.step`` (split dispatch) runs the fused composite on the
    world's mip."""
    ecfg, w = case["ecfg"], case["w"]
    seen = []
    real = pipeline.gi_composite

    def spy(*a, gi_occ=None, **kw):
        seen.append(gi_occ)
        return real(*a, gi_occ=gi_occ, **kw)

    eng = engine.Engine(ecfg, verbose=False, device="cpu",
                        world=engine.World(**vars(w)))
    eng.character.position = np.asarray(CAM["pos"], np.float32)
    pipeline.gi_composite = spy
    try:
        out = eng.step()
    finally:
        pipeline.gi_composite = real
    assert len(seen) == 1 and seen[0] is w.gi_occ
    assert torch.isfinite(out.color).all()


def test_load_world_rebuilds_gi_occ(case, tmp_path):
    ecfg, w = case["ecfg"], case["w"]
    path = str(tmp_path / "world.npz")
    checkpoint.save_world(path, w, ecfg)
    got, _, _ = checkpoint.load_world(path, ecfg, device="cpu")
    np.testing.assert_array_equal(u32.to_numpy(got.gi_occ),
                                  u32.to_numpy(w.gi_occ))
    plain = ref.make_ecfg(tcfg, ref.SLICE_SPEC)
    assert checkpoint.load_world(path, plain, device="cpu")[0].gi_occ is None
