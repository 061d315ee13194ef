"""Parity of the port's temporal start hints and start/shadow overrides
with the JAX package's (``rvgrt_tpu/render/pipeline.py``), at the slice's
settings (``ref.SLICE_SPEC``: a 64^3 world, 128x80, prepass 1/8).

``temporal_hints_from_prepass`` and ``temporal_start_hint`` equal JAX's bit
for bit on the port's prepass distances, under a still camera (window 0),
a rotation (with ``sky_start``) and a rotation with translation.  The
three cases of ``tests/test_temporal_starts.py`` run on the port's
renders, with the JAX functions' hints: the self-projection identity, the
hinted frame matching the unhinted one (hits within n/1000, >= 50 dB)
under rotation and under translation, and the hints' conservatism (here
against the primary trace's own hit distance).  The hinted render and a
render with ``start_override`` + ``shadow_override`` equal JAX's at >= 50
dB with the same hits, and a start override without a shadow override on
coupled shadows raises in both packages.  The JAX side runs without FMA
contraction (tests/torch_jaxref.py); the error case runs in this process.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera
from tests import torch_jaxref as ref

SPEC = ref.SLICE_SPEC
POS0 = np.array([30.0, 44.0, 60.0], np.float32)
FWD0 = (0.25, -0.18, -1.0)
TURN = 0.12
SHIFT = np.array([0.6, -0.2, 0.4], np.float32)
SKY_START = 4.0 * 64


def _turned(f, a):
    return (math.cos(a) * f[0] + math.sin(a) * f[2], f[1],
            -math.sin(a) * f[0] + math.cos(a) * f[2])


CAMS = {
    "still": ref.camera(POS0, FWD0),
    "rotate": ref.camera(POS0, _turned(FWD0, TURN)),
    "translate": ref.camera(POS0 + SHIFT, _turned(FWD0, TURN)),
}
#: the motions' hint options (the JAX test's)
HINT_KW = {"still": dict(window=0), "rotate": dict(sky_start=SKY_START),
           "translate": dict(sky_start=SKY_START)}


def _arrays(cam):
    return engine.camera_arrays(
        Camera(pos=cam["pos"], forward=cam["forward"], right=cam["right"],
               up=cam["up"]), cam["vp"], cam["prev_vp"], cam["jitter"],
        cam["time"], device="cpu")


def _render(w, ecfg, cam, **kw):
    return pipeline.render_frame(w.bits, w.sdf, w.gi, w.atlas, _arrays(cam),
                                 ecfg, include_gi=False, sky_y=w.sky_y,
                                 table=w.trace_table, return_gbuffer=True,
                                 **kw)


def _shadow_map(shape):
    rng = np.random.default_rng(3)
    return rng.uniform(0.4, 1.0, shape).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    ecfg = ref.make_ecfg(tcfg, SPEC)
    rcfg = ecfg.render
    w = engine.build_world(ecfg, verbose=False, device="cpu")
    world = engine.world_to_numpy(w)
    base, _ = _render(w, ecfg, CAMS["still"])
    half0 = base.half_dist.numpy()
    hints = {m: pipeline.temporal_hints_from_prepass(
        base.half_dist, _arrays(CAMS[m]), _arrays(CAMS["still"]), rcfg,
        **HINT_KW[m]) for m in CAMS}
    override = dict(start_override=hints["translate"][1].numpy(),
                    shadow_override=_shadow_map((rcfg.height, rcfg.width)))
    starts = [(rcfg.height, rcfg.width, dict(prev_pixel_center=False,
                                             window=1, margin=3.0)),
              (rcfg.half_height, rcfg.half_width,
               dict(pixel_center=True, bias=1.5))]
    # two children side by side: the renders are mostly XLA compiles
    children = [ref.start([("ref_render_starts", dict(
        spec=SPEC, world=world, cam=CAMS["translate"],
        cases=[dict(hint_half=hints["translate"][0].numpy(),
                    hint_full=hints["translate"][1].numpy()), override]))]),
                ref.start([("ref_hints", dict(
                    spec=SPEC, half_dist=half0, cam=CAMS[m],
                    prev_cam=CAMS["still"], prepass_kw=[HINT_KW[m]],
                    start_kw=starts)) for m in CAMS])]
    got = {}
    for m in ("rotate", "translate"):
        got[m] = dict(ref=_render(w, ecfg, CAMS[m]),
                      hinted=_render(w, ecfg, CAMS[m],
                                     hint_half=hints[m][0],
                                     hint_full=hints[m][1]))
    got["override"] = _render(
        w, ecfg, CAMS["translate"],
        **{k: torch.from_numpy(v) for k, v in override.items()})
    prev_t = base.half_dist + rcfg.dist_bias
    got["starts"] = [pipeline.temporal_start_hint(
        _arrays(CAMS[m]), _arrays(CAMS["still"]), prev_t, rcfg, oh, ow, **kw)
        for m in CAMS for oh, ow, kw in starts]
    renders = children[0].result()[0]
    want = dict(zip(CAMS, children[1].result()))
    return dict(ecfg=ecfg, w=w, world=world, base=base, hints=hints,
                want=want, renders=renders, got=got)


@pytest.mark.parametrize("motion", list(CAMS))
def test_hints_bit_exact(case, motion):
    want = case["want"][motion]
    for got, w in zip(case["hints"][motion], want["prepass"][0]):
        np.testing.assert_array_equal(got.numpy(), w)
    k = list(CAMS).index(motion)
    for got, w in zip(case["got"]["starts"][2 * k:2 * k + 2],
                      want["starts"]):
        np.testing.assert_array_equal(got.numpy(), w)


def test_self_projection_identity(case):
    """An unchanged camera reads each pixel's own previous value: the hint
    is the prepass distance wherever the previous frame hit, and 0 on its
    misses (no ``sky_start``)."""
    rcfg = case["ecfg"].render
    hint_half, hint_full = case["hints"]["still"]
    prev_t = case["base"].half_dist.numpy() + rcfg.dist_bias
    hit = prev_t < rcfg.miss_distance - 0.5
    expect = np.maximum(prev_t - rcfg.dist_bias, 0.0)
    got = hint_half.numpy()
    assert hit.any() and (~hit).any()
    assert np.allclose(got[hit], expect[hit], atol=1e-3)
    assert (got[~hit] == 0.0).all()
    assert tuple(hint_full.shape) == (rcfg.height, rcfg.width)


@pytest.mark.parametrize("motion", ["rotate", "translate"])
def test_hinted_render_matches(case, motion):
    (ref1, _), (got1, _) = case["got"][motion]["ref"], \
        case["got"][motion]["hinted"]
    ref_hit = ref1.depth.numpy() < 1.0
    got_hit = got1.depth.numpy() < 1.0
    assert (ref_hit != got_hit).sum() <= max(1, ref_hit.size // 1000)
    assert ref.psnr(got1.color.numpy(), ref1.color.numpy()) >= 50.0
    d_ref, d_got = ref1.half_dist.numpy(), got1.half_dist.numpy()
    assert (np.abs(d_ref - d_got) > 0.51).mean() <= 2e-3
    # the hints did start rays later
    assert float(case["hints"][motion][1].max()) > 0.0


def test_hints_are_conservative(case):
    """No hinted start overshoots the primary trace's own hit distance (one
    voxel of slack for the fp16 start and the warp's rounding)."""
    _, gb = case["got"]["translate"]["ref"]
    hint = case["hints"]["translate"][1].numpy()
    t, hit = gb.t.numpy(), gb.hit.numpy()
    assert hit.any()
    assert (hint[hit] > t[hit] + 1.0).mean() <= 1e-3


@pytest.mark.parametrize("which", ["hinted", "override"])
def test_render_with_starts_matches_jax(case, which):
    out, gb = (case["got"]["translate"]["hinted"] if which == "hinted"
               else case["got"]["override"])
    want = case["renders"][0 if which == "hinted" else 1]
    np.testing.assert_array_equal(gb.hit.numpy(), want["gb"]["hit"])
    for f in ("color", "motion", "depth", "half_dist", "half_shadow"):
        g, w = getattr(out, f).numpy(), want["out"][f]
        assert g.shape == w.shape, f
        scale = max(float(np.abs(w).max()), 1.0)
        assert ref.psnr(g / scale, w / scale) >= 50.0, f
    if which == "override":
        # the prepass was skipped: placeholder half buffers
        assert (out.half_dist.numpy() == 0.0).all()
        assert (out.half_shadow.numpy() == 1.0).all()


def test_start_override_needs_decoupled_shadows(case):
    from rvgrt_tpu.render import pipeline as jpipe

    spec = ref.merge_spec(SPEC, {"lighting": dict(soft_shadows=False)})
    ecfg = ref.make_ecfg(tcfg, spec)
    w, rcfg = case["w"], ecfg.render
    start = torch.zeros(rcfg.height, rcfg.width)
    with pytest.raises(ValueError, match="decoupled shadow sites"):
        _render(w, ecfg, CAMS["still"], start_override=start)
    jw = case["world"]
    with pytest.raises(AssertionError, match="decoupled shadow sites"):
        jpipe.render_frame(jw["bits"], jw["sdf"], jw["gi"], jw["atlas"],
                           ref._camera_arrays(CAMS["still"]),
                           ref.make_ecfg(ref._cfg(), spec),
                           include_gi=False, table=jw["trace_table"],
                           start_override=start.numpy())
