"""Parity of the port's temporal upscaler and history warp (kernel K2).

``temporal_upscale(..., warp_taps="pallas")`` over an 8-frame moving
sequence must reach >= 50 dB per frame against the JAX accumulator with
its XLA oracle warp (``"bilinear"``, the same 4 taps); the Pallas warp
kernel itself runs once in interpret mode and must agree with the port's
plain warp to 1e-6 (the kernel blends weights first, the oracle taps
first).  Over the same sequence, the ``"nearest"`` and ``"catmull_shift"``
taps, and depth rejection (the sequence with a depth field whose
occluder moves against the motion vectors, so that history is rejected):
>= 50 dB a frame, and the carried ``state.depth`` exact.  The JAX side
runs without FMA contraction (tests/torch_jaxref.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.ops import warp_kernels
from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
from rvgrt_tpu_torch.upscale import temporal
from tests import torch_jaxref as ref

H, W = 80, 128          # low-res frame; display 240x384 (3 x 128 lanes)
N_FRAMES = 8


def _frames():
    """A textured scene panning right, with smooth motion vectors and the
    9-phase jitter, made from a seed."""
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    seq = phase_jitter_sequence(3)
    frames = []
    for f in range(N_FRAMES):
        sx = xx + 0.8 * f
        col = np.stack([0.5 + 0.4 * np.sin(sx * 0.21 + yy * 0.07),
                        0.5 + 0.4 * np.cos(yy * 0.13 - sx * 0.05),
                        0.5 + 0.3 * np.sin((sx + yy) * 0.09)], axis=-1)
        col = col + rng.normal(0.0, 0.02, col.shape)
        mot = np.zeros((H, W, 2), np.float32)
        mot[..., 0] = 0.8 * 2.0 / W + 0.002 * np.sin(yy * 0.05)
        mot[..., 1] = 0.0008 * np.cos(xx * 0.1)
        jit = seq[f % len(seq)] * 0.5 * 2.0 / np.array([W, H], np.float32)
        frames.append(dict(color=np.clip(col, 0, 1).astype(np.float32),
                           motion=mot, depth=np.ones((H, W), np.float32),
                           jitter=jit.astype(np.float32)))
    return frames


def _depth_frames():
    """``_frames()`` with a depth field: far ground at 0.999 and a near
    box (0.95) that moves left while the motion vectors pan right, so its
    old and new edges disagree with the warped depth."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for f, fr in enumerate(_frames()):
        x0 = 70 - 3 * f
        box = (xx >= x0) & (xx < x0 + 30) & (yy >= 20) & (yy < 50)
        frames.append(dict(fr, depth=np.where(box, 0.95, 0.999).astype(
            np.float32)))
    return frames


TAPS = ["nearest", "catmull_shift"]


def _warp_inputs():
    rng = np.random.default_rng(21)
    hh, hw = 64, 512
    packed = rng.integers(0, 2 ** 32, (hh, hw),
                          dtype=np.uint64).astype(np.uint32)
    xs = (np.arange(hw, dtype=np.float32)[None, :] * 0.97
          + rng.random((hh, 1), np.float32) * 3).clip(0, hw - 1.001)
    ys = (np.arange(hh, dtype=np.float32)[:, None] * 0.6
          + rng.random((1, hw), np.float32) * 2).clip(0, hh - 1.001)
    return dict(packed=packed, xs=np.broadcast_to(xs, (hh, hw)).copy(),
                ys=np.broadcast_to(ys, (hh, hw)).copy())


@pytest.fixture(scope="module")
def jax_ref():
    oracle, shift, warp, *taps, depth = ref.run([
        ("ref_temporal", dict(frames=_frames(), taps="bilinear")),
        ("ref_temporal", dict(frames=_frames()[:3],
                              taps="bilinear_shift")),
        ("ref_warp", _warp_inputs()),
        *[("ref_temporal", dict(frames=_frames(), taps=t, jit=True))
          for t in TAPS],
        ("ref_temporal", dict(frames=_depth_frames(), taps="bilinear",
                              jit=True, depth_reject=True)),
    ])
    return dict(oracle=oracle, shift=shift, warp=warp,
                taps=dict(zip(TAPS, taps)), depth=depth)


def _run(frames, taps, depth_reject=False):
    state = temporal.init_state(H, W, device="cpu",
                                depth_reject=depth_reject)
    outs, depths = [], []
    for fr in frames:
        out, state = temporal.temporal_upscale(
            *(torch.from_numpy(fr[k]) for k in ("color", "motion", "depth",
                                                "jitter")),
            state, warp_taps=taps, depth_reject=depth_reject)
        outs.append(out.numpy())
        depths.append(state.depth.numpy())
    return (outs, depths) if depth_reject else (outs, state)


@pytest.fixture(scope="module")
def port_pallas():
    return _run(_frames(), "pallas")


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_temporal_pallas_sequence_50db(jax_ref, port_pallas, frame):
    got = port_pallas[0][frame]
    want = jax_ref["oracle"][frame]
    assert got.shape == (3 * H, 3 * W, 3)
    assert np.isfinite(got).all()
    assert ref.psnr(got, want) >= 50.0


def test_temporal_static_accumulates_confidence():
    """Still camera: the sample count grows frame over frame (capped)."""
    still = [dict(f, color=_frames()[0]["color"],
                  motion=np.zeros((H, W, 2), np.float32))
             for f in _frames()[:6]]
    _, state = _run(still, "pallas")
    _, first = _run(still[:1], "pallas")
    assert float(state.conf.mean()) > 2.0 * float(first.conf.mean())
    assert float(state.conf.max()) <= 12.0


def test_bilinear_shift_taps_50db(jax_ref):
    got, _ = _run(_frames()[:3], "bilinear_shift")
    for g, w in zip(got, jax_ref["shift"]):
        assert ref.psnr(g, w) >= 50.0


@pytest.mark.parametrize("taps", TAPS)
def test_temporal_taps_sequence_50db(jax_ref, taps):
    got, _ = _run(_frames(), taps)
    for i, (g, w) in enumerate(zip(got, jax_ref["taps"][taps])):
        assert np.isfinite(g).all(), i
        assert ref.psnr(g, w) >= 50.0, i


def test_temporal_depth_reject_50db(jax_ref):
    frames = _depth_frames()
    got, depths = _run(frames, "bilinear", depth_reject=True)
    want, want_depths = jax_ref["depth"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert ref.psnr(g, w) >= 50.0, i
    for g, w, fr in zip(depths, want_depths, frames):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, fr["depth"])
    # the rejection changed the reconstruction
    plain, _ = _run(frames, "bilinear")
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, plain)) \
        > 0.01


def test_warp_plain_matches_pallas_interpret_and_oracle(jax_ref):
    inp = _warp_inputs()
    got, ovf = warp_kernels.warp_packed_bilinear(
        u32.from_numpy(inp["packed"]), torch.from_numpy(inp["xs"]),
        torch.from_numpy(inp["ys"]))
    assert int(ovf) == 0 and jax_ref["warp"]["overflow"] == 0
    assert got.shape == (4, 64, 512)
    np.testing.assert_allclose(got.numpy(), jax_ref["warp"]["kernel"],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy(), jax_ref["warp"]["xla"])


def test_state_numpy_round_trip():
    st = temporal.init_state(4, 6, device="cpu")
    st = st._replace(history=torch.rand(12, 18, 3), conf=torch.rand(12, 18))
    back = temporal.state_from_numpy(temporal.state_to_numpy(st),
                                     device="cpu")
    for a, b in zip(st, back):
        assert torch.equal(a, b)


def test_pack_unpack_rgbn_round_trip():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, (7, 9, 3)).astype(np.float32) / 255.0
    n = rng.integers(0, 256, (7, 9)).astype(np.float32) * 12.0 / 255.0
    word = temporal._pack_rgbn(torch.from_numpy(q), torch.from_numpy(n))
    rgb, cnt = temporal._unpack_rgbn_cf(word)
    np.testing.assert_allclose(rgb.permute(1, 2, 0).numpy(), q, atol=1e-6)
    np.testing.assert_allclose(cnt.numpy(), n, atol=1e-5)
