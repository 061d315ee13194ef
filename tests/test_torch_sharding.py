"""Parity of the port's pixel-row sharding (``parallel/sharding.py``) with
the JAX package's, on a 4-rank gloo group against a 4-device JAX mesh.

A 64^3 world at the slice's settings (``ref.SLICE_SPEC``; the frame cut to
128x64, since a slab must hold whole prepass rows: 80 rows do not split
into 4 slabs of a multiple of 8).  Those settings decouple the soft-shadow
sites (``shadow_site_divisor`` 4), so the sharded frame without GI is also
``tests/test_sharding.py``'s seam case: against the port's single-device
frame, rows away from the slab seams match exactly.  The sharded frames,
with GI and without, are held at >= 50 dB against JAX's sharded frames,
the sharded GI windows word
for word (one window in range, one that runs past the grid's last cell and
is clamped as JAX's ``dynamic_slice`` clamps it), ``pack_state`` word for
word, ``temporal_upscale_slab`` under each warp_taps and two closed-loop
frames of ``temporal_upscale_sharded`` at >= 50 dB, and the sharded
upscale against the port's full-frame accumulator as
``tests/test_sharding.py`` holds JAX's.  Every rank must return the same
assembled outputs.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera
from rvgrt_tpu_torch.upscale import temporal
from tests import torch_dist
from tests import torch_jaxref as ref

RANKS = 4
SPEC = ref.merge_spec(ref.SLICE_SPEC,
                      {"render": dict(height=64, display_height=192)})
CAM = ref.camera(pos=(30.0, 44.0, 60.0), forward=(0.25, -0.18, -1.0),
                 jitter=(0.0021, -0.0034), time_s=0.25)
# 1536-cell windows (384 a rank) of the 4096-cell grid: one in range, one
# at the wrap (2816 + 1536 runs past 4096; JAX clamps it to 2560)
GI_SPEC = {**SPEC, "engine": {**SPEC["engine"], "gi_rays_per_frame": 1536}}
GI_CASES = ((0, 2048), (1, 2816))
UPSCALE_TAPS = ("bilinear_shift", "bilinear")
SLAB_TAPS = ("bilinear_shift", "bilinear", "pallas")
# the upscale's low-res frame: the display (96 x 384) is wide enough for
# the JAX Pallas warp's window; rank 1's slab for the slab gates
UP_H, UP_W = 32, 128
SLAB = (8, 8)


def cam_arrays(cam):
    return engine.camera_arrays(
        Camera(pos=cam["pos"], forward=cam["forward"], right=cam["right"],
               up=cam["up"]),
        cam["vp"], cam["prev_vp"], cam["jitter"], cam["time"], device="cpu")


def upscale_inputs(seed: int = 7):
    """A random history (as ``tests/test_sharding.py`` makes it) and two
    frames of color, motion and jitter."""
    rng = np.random.default_rng(seed)
    h, w = UP_H, UP_W
    state = dict(
        history=rng.random((3 * h, 3 * w, 3)).astype(np.float32),
        conf=(rng.random((3 * h, 3 * w)) * 8).astype(np.float32))
    frames = [dict(color=rng.random((h, w, 3)).astype(np.float32),
                   motion=rng.normal(0, 0.02, (h, w, 2)).astype(np.float32),
                   jitter=np.asarray([(0.3 - i) / w, (0.2 * i - 0.4) / h],
                                     np.float32))
              for i in range(2)]
    return state, frames


def packed_state(state) -> torch.Tensor:
    return temporal.pack_state(temporal.TemporalState(
        history=torch.from_numpy(state["history"]),
        conf=torch.from_numpy(state["conf"]), depth=torch.zeros(1, 1)))


def port_upscale_loop(fn, state, frames, taps, *extra):
    packed = packed_state(state)
    outs = []
    for fr in frames:
        out, packed = fn(torch.from_numpy(fr["color"]),
                         torch.from_numpy(fr["motion"]),
                         torch.from_numpy(fr["jitter"]), packed, *extra,
                         warp_taps=taps)
        outs.append(dict(out=out.numpy(), packed=packed.numpy()))
    return outs


def full_upscale_loop(state, frames, taps):
    """The port's full-frame accumulator over the same frames."""
    st = temporal.TemporalState(history=torch.from_numpy(state["history"]),
                                conf=torch.from_numpy(state["conf"]),
                                depth=torch.zeros(1, 1))
    outs = []
    for fr in frames:
        out, st = temporal.temporal_upscale(
            torch.from_numpy(fr["color"]), torch.from_numpy(fr["motion"]),
            torch.ones(UP_H, UP_W), torch.from_numpy(fr["jitter"]), st,
            warp_taps=taps)
        outs.append(dict(out=out.numpy(),
                         packed=temporal.pack_state(st).numpy()))
    return outs


def _rank(rank, world, state, frames):
    from rvgrt_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(RANKS, device_type="cpu")
    ecfg = ref.make_ecfg(tcfg, SPEC)
    gi_ecfg = ref.make_ecfg(tcfg, GI_SPEC)
    w = engine.world_from_numpy(world, device="cpu")
    frames_out = {g: sharding.render_frame_sharded(
        w.bits, w.sdf, w.gi, w.atlas, cam_arrays(CAM), ecfg, mesh,
        include_gi=g, sky_y=w.sky_y, table=w.trace_table)
        for g in (True, False)}
    gis = [u32.to_numpy(sharding.update_gi_sharded(
        w.gi, w.bits, w.sdf, w.atlas, gi_ecfg, f, off, mesh, sky_y=w.sky_y,
        table=w.trace_table)) for f, off in GI_CASES]
    ups = {taps: port_upscale_loop(sharding.temporal_upscale_sharded, state,
                                   frames, taps, mesh)
           for taps in UPSCALE_TAPS}
    # a broadcast from rank 0 of a tensor only rank 0 holds
    (rep,) = sharding.replicate(mesh, torch.full((3,), float(rank)))
    return dict(frame={g: {k: v.numpy() for k, v in f._asdict().items()}
                       for g, f in frames_out.items()},
                gi=gis, upscale=ups, replicated=rep.numpy())


@pytest.fixture(scope="module")
def case():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    world = engine.world_to_numpy(engine.build_world(ecfg, verbose=False,
                                                     device="cpu"))
    state, frames = upscale_inputs()
    jax = ref.start([("ref_sharded", dict(
        spec=SPEC, world=world, cam=CAM, gi_spec=GI_SPEC, gi_cases=GI_CASES,
        state=state, frames=frames, slab=SLAB, n_dev=RANKS))])
    ranks = torch_dist.run_ranks(_rank, RANKS, (world, state, frames))
    w = engine.world_from_numpy(world, device="cpu")
    single = pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas,
                                   cam_arrays(CAM), ecfg, include_gi=False,
                                   sky_y=w.sky_y, table=w.trace_table)
    return dict(world=world, state=state, frames=frames, ranks=ranks,
                single={k: v.numpy() for k, v in single._asdict().items()},
                jax=jax.result()[0])


def test_every_rank_returns_the_assembled_outputs(case):
    first = case["ranks"][0]
    assert first["frame"][True]["color"].shape == (64, 128, 3)
    for r in case["ranks"][1:]:
        for g in (True, False):
            for k, v in first["frame"][g].items():
                np.testing.assert_array_equal(r["frame"][g][k], v, err_msg=k)
        for a, b in zip(r["gi"], first["gi"]):
            np.testing.assert_array_equal(a, b)
        for taps in UPSCALE_TAPS:
            for a, b in zip(r["upscale"][taps], first["upscale"][taps]):
                np.testing.assert_array_equal(a["packed"], b["packed"])
    # replicate broadcasts rank 0's tensor
    for r in case["ranks"]:
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))


@pytest.mark.parametrize("field", ["color", "motion", "depth", "half_dist",
                                   "half_shadow"])
@pytest.mark.parametrize("gi", [True, False], ids=["gi", "no_gi"])
def test_sharded_frame_matches_jax(case, gi, field):
    got = case["ranks"][0]["frame"][gi][field]
    want = case["jax"]["frame"][gi][field]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1.0)
    assert ref.psnr(got / scale, want / scale) >= 50.0


def test_sharded_decoupled_shadow_seam(case):
    """``tests/test_sharding.py``'s seam gate on the port: the sharded frame
    without GI against the single-device one, PSNR > 40 dB, under 2 % of
    pixels off by more than 0.02, and rows away from the slab seams (the
    last ``shadow_site_divisor - 1`` rows of each slab, where
    ``_expand_even`` clamps at the slab's bottom edge) equal to 1e-5."""
    sa = case["single"]["color"]
    sb = case["ranks"][0]["frame"][False]["color"]
    mse = float(np.mean((sa - sb) ** 2))
    psnr = 99.0 if mse == 0 else 10.0 * math.log10(1.0 / mse)
    frac_off = (np.abs(sa - sb).max(axis=-1) > 0.02).mean()
    assert psnr > 40.0, (psnr, frac_off)
    assert frac_off < 0.02, (psnr, frac_off)
    ssd = ref.make_ecfg(tcfg, SPEC).render.shadow_site_divisor
    slab_h = sa.shape[0] // RANKS
    seam = np.zeros(sa.shape[0], bool)
    for k in range(1, RANKS):
        seam[slab_h * k - (ssd - 1):slab_h * k] = True
    assert np.abs(sa[~seam] - sb[~seam]).max() < 1e-5


@pytest.mark.parametrize("i", range(len(GI_CASES)),
                         ids=["in_range", "wrap"])
def test_sharded_gi_words(case, i):
    frame, offset = GI_CASES[i]
    n = ref.make_ecfg(tcfg, GI_SPEC).gi_window
    cells = case["world"]["gi"].shape[0]
    assert (offset + n > cells) == (i == 1)
    got = case["ranks"][0]["gi"][i]
    want = case["jax"]["gi"][i]
    assert (want != case["world"]["gi"]).any()
    np.testing.assert_array_equal(got, want)


def test_pack_state_words(case):
    np.testing.assert_array_equal(u32.to_numpy(packed_state(case["state"])),
                                  case["jax"]["packed"])


@pytest.mark.parametrize("taps", SLAB_TAPS)
def test_upscale_slab_matches_jax(case, taps):
    """Rank 1's display slab of frame 0, under each warp_taps ("pallas"
    runs K2's plain version on the CPU, JAX its Pallas kernel in interpret
    mode)."""
    from rvgrt_tpu_torch.parallel import sharding

    fr = case["frames"][0]
    lo0, n_lo = SLAB
    cpad, mpad = sharding._halo_pad(torch.from_numpy(fr["color"]),
                                    torch.from_numpy(fr["motion"]))
    out, pk = temporal.temporal_upscale_slab(
        cpad[lo0:lo0 + n_lo + 3], mpad[lo0:lo0 + n_lo + 2],
        torch.from_numpy(fr["jitter"]), packed_state(case["state"]), lo0,
        n_lo, warp_taps=taps)
    want = case["jax"]["slab"][taps]
    assert out.shape == want["out"].shape == (3 * n_lo, 3 * UP_W, 3)
    assert ref.psnr(out.numpy(), want["out"]) >= 50.0
    got_b = u32.to_numpy(pk).view(np.uint8).astype(np.int32)
    want_b = want["packed"].view(np.uint8).astype(np.int32)
    assert np.abs(got_b - want_b).max() <= 1


@pytest.mark.parametrize("taps", UPSCALE_TAPS)
def test_upscale_sharded_matches_jax_and_full_frame(case, taps):
    """Two closed-loop frames: >= 50 dB against JAX's sharded upscale, and
    against the port's full-frame accumulator as ``tests/test_sharding.py``
    holds JAX's (bilinear_shift: 1e-5 and the packed state word for word;
    the true 4-tap warp: 1.5/255 and each packed byte within 2)."""
    got = case["ranks"][0]["upscale"][taps]
    full = full_upscale_loop(case["state"], case["frames"], taps)
    for g, want, f in zip(got, case["jax"]["upscale"][taps], full):
        assert g["out"].shape == (3 * UP_H, 3 * UP_W, 3)
        assert ref.psnr(g["out"], want["out"]) >= 50.0
        diff = np.abs(g["out"] - f["out"]).max()
        if taps == "bilinear_shift":
            assert diff < 1e-5, diff
            np.testing.assert_array_equal(g["packed"], f["packed"])
        else:
            assert diff <= 1.5 / 255, diff
            a = g["packed"].view(np.uint8).astype(np.int32)
            b = f["packed"].view(np.uint8).astype(np.int32)
            assert np.abs(a - b).max() <= 2
