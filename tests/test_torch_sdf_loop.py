"""K3's offset loop (``rvgrt_tpu_torch/csrc/sdf_kernels.cu``), modelled in
numpy on the CPU and held against the plain pass ``minconv_pass_plain``.

The CUDA kernel cannot run here, so this file proves its arithmetic:
squares of ``min(d, cap)`` staged as u16 with ``cap^2`` outside the
volume; each thread reduces ``kRows`` rows of two columns; it leaves its
offset loop at the first chunk start where ``off^2`` reaches the larger of
its running minima (the packed pair's shared exit); a warp (64 columns)
skips a chunk whose rows are all far (every column at cap or outside) and
stops where every row left is far; the u16 halves wrap as the hardware's
do; above cap 181 the 32-bit loop.  The GPU tests in
``tests/test_torch_kernels.py`` hold the kernel itself against the plain
pass on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from rvgrt_tpu_torch.ops import sdf_kernels

ROWS = 8  # kRows, the kernel's
CAPS = (1, 64, 66, 181, 182, 255)


def _isqrt(a: np.ndarray) -> np.ndarray:
    d = np.sqrt(a.astype(np.float32)).astype(np.int64)
    d = np.where(d * d > a, d - 1, d)
    return np.where((d + 1) * (d + 1) <= a, d + 1, d)


def kernel_loop(vol: np.ndarray, cap: int, wide: bool | None = None):
    """The kernel's pass along axis 1 of a u8 (outer, n, inner) volume:
    (u8 output, tap offsets each output's thread ran).  ``wide`` picks the
    32-bit loop; by default the kernel's choice, 2 cap^2 > 65535."""
    if wide is None:
        wide = 2 * cap * cap > 65535
    outer, n, inner = vol.shape
    # offset cap never lowers acc: the loop runs 1 .. top = cap - 1
    top, halo, groups, pairs = cap - 1, cap, -(-n // ROWS), -(-inner // 2)
    rows, strips = groups * ROWS, -(-pairs // 32)
    acc_t = np.uint32 if wide else np.uint16
    sq = np.full((outer, rows + 2 * halo, 64 * strips), cap * cap, np.int64)
    sq[:, halo:halo + n, :inner] = np.minimum(vol, cap).astype(np.int64) ** 2
    # near rows before each row, per 64-column strip (a warp's columns)
    near = (sq < cap * cap).reshape(outer, -1, strips, 64).any(axis=3)
    before = np.concatenate([np.zeros((outer, 1, strips), np.int64),
                             near.cumsum(axis=1)], axis=1)
    r0 = halo + ROWS * np.arange(groups)  # the row of each group's output 0
    warp = np.arange(pairs) // 32

    def far(a, b):  # per (outer, group, pair): rows a..b of its strip
        return (before[:, b + 1] == before[:, a])[:, :, warp]

    sq = sq[:, :, :2 * pairs].astype(np.uint16)  # cap^2 <= 65025
    y, x = np.arange(rows)[:, None], np.arange(2 * pairs)[None, :]
    acc = np.where((y < n) & (x < inner), sq[:, halo:halo + rows], 0)
    acc = acc.astype(acc_t).reshape(outer, groups, ROWS, pairs, 2)
    live = np.ones((outer, groups, pairs), bool)
    taps = np.zeros((outer, groups, pairs), np.int64)
    for off in range(1, top + 1, ROWS):
        live &= off * off < acc.max(axis=(2, 4)).astype(np.int64)
        last = min(off + ROWS - 1, top)
        live &= ~(far(r0 - top, r0 + ROWS - 1 - off)
                  & far(r0 + off, r0 + ROWS - 1 + top))
        run = live & ~(far(r0 - last, r0 + ROWS - 1 - off)
                       & far(r0 + off, r0 + ROWS - 1 + last))
        for o in range(off, last + 1):
            m = np.minimum(sq[:, halo - o:halo - o + rows],
                           sq[:, halo + o:halo + o + rows])
            m = m.reshape(acc.shape).astype(acc_t)
            cand = m + acc_t(o * o)  # u16 wraps, as a u16x2 half does
            keep = run[:, :, None, :, None]
            acc = np.where(keep, np.minimum(acc, cand), acc)
            taps += run
    out = _isqrt(acc.astype(np.int64)).reshape(outer, rows, 2 * pairs)
    taps = np.broadcast_to(taps[:, :, None, :, None], acc.shape)
    taps = taps.reshape(outer, rows, 2 * pairs)
    return (out[:, :n, :inner].astype(np.uint8),
            taps[:, :n, :inner])


def _check(vol: np.ndarray, cap: int) -> None:
    """The model equals the plain pass, and every output's thread ran at
    least the taps ``chip_smoke.k3_tap_floor`` charges to its bound."""
    got, taps = kernel_loop(vol, cap)
    t = torch.from_numpy(vol)
    want = sdf_kernels.minconv_pass_plain(t, axis=1, cap=cap).numpy()
    np.testing.assert_array_equal(got, want)
    floor, _ = chip_smoke.k3_tap_floor(
        t, sdf_kernels.min_squares_plain(t, axis=1, cap=cap), 1, cap)
    assert (taps >= floor.numpy()).all()


def _volume(kind: str, shape, cap: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "full_range":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "sparse":  # like a distance field: mostly cap, a few near
        v = rng.integers(0, cap + 1, shape).astype(np.uint8)
        v[rng.random(shape) < 0.9] = cap
        return v
    v = np.full(shape, 0 if kind == "zeros" else cap, np.uint8)
    if kind == "single_zero":
        v[tuple(int(rng.integers(0, s)) for s in shape)] = 0
    return v


#: named shapes: (outer, n, inner); n < cap for every cap but 1
SHAPES = {"n_below_cap": (2, 37, 5), "n1": (3, 1, 4), "inner1": (2, 20, 1),
          "odd_inner": (1, 19, 7), "tall": (1, 300, 3)}
KINDS = ("full_range", "cap", "zeros", "single_zero", "sparse")


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_loop_is_exact(kind, cap):
    """Every volume kind at every cap, over the named shapes."""
    for i, shape in enumerate(SHAPES.values()):
        _check(_volume(kind, shape, cap, seed=cap * 31 + i), cap)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(cap=st.sampled_from(CAPS), kind=st.sampled_from(KINDS),
       outer=st.integers(1, 3), n=st.integers(1, 45),
       inner=st.integers(1, 9), seed=st.integers(0, 2 ** 31))
def test_kernel_loop_is_exact_on_random_volumes(cap, kind, outer, n, inner,
                                                seed):
    _check(_volume(kind, (outer, n, inner), cap, seed), cap)


def test_axis0_is_the_flattened_view():
    """Axis 0 of (Z, Y, X) is the kernel's axis 1 of (1, Z, Y*X)."""
    vol = _volume("sparse", (21, 3, 5), 64, seed=4)
    got, _ = kernel_loop(vol.reshape(1, 21, 15), 64)
    want = sdf_kernels.minconv_pass_plain(torch.from_numpy(vol), 0, 64)
    np.testing.assert_array_equal(got.reshape(vol.shape), want.numpy())


def test_u16_loop_would_wrap_above_181():
    """At cap 182 a candidate passes 65535: the u16 loop wraps and is
    wrong, so the kernel takes the 32-bit loop there.  Row 180 is near,
    so the last chunk of row 0 runs (100^2 + 180^2 > 182^2: row 0 is at
    cap) and its tap at 181 passes 65535."""
    vol = np.full((1, 200, 2), 255, np.uint8)
    vol[0, 180] = 100
    want = sdf_kernels.minconv_pass_plain(torch.from_numpy(vol), 1,
                                          182).numpy()
    assert (want[0, 0] == 182).all()
    assert not np.array_equal(kernel_loop(vol, 182, wide=False)[0], want)
    np.testing.assert_array_equal(kernel_loop(vol, 182)[0], want)
    for cap in (64, 181):
        np.testing.assert_array_equal(
            kernel_loop(vol, cap, wide=False)[0],
            sdf_kernels.minconv_pass_plain(torch.from_numpy(vol), 1,
                                           cap).numpy())
