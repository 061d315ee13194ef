"""P1 and P2, the gather probe's kernels, against the JAX functions they
replace, on the CPU (their plain versions).

P1 (``ops/gather_kernels.take_clip``) is ``jnp.take(tbl, idx,
mode="clip")``: indices below 0 read word 0, at or above n word n - 1.  P2
(``take_along_cols``) is ``jnp.take_along_axis(t2, i2, axis=0)``; fed by
the probe's prologue (``tala_inputs``: ``t2 = tbl[:S*C].reshape(S, C)``,
``i2 = idx % S``) and also with indices outside [0, S), where
``take_along_axis`` counts a negative index from the end once and fills
with 0xFFFFFFFF.  Inputs are seeded numpy arrays; the gathers are integer,
so the JAX side runs here.  Also: the probe tool's tables and indices are
the TPU probe's.  The kernels themselves run on the card
(``tests/test_torch_kernels.py -m cuda``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.ops import gather_kernels as g
from rvgrt_tpu_torch.tools import probe_r7

#: name -> (table words, index shape, index range beyond [0, n))
SHAPES = {
    "tiny": (5, (3, 7), 4),
    "ragged": (1000, (37, 128), 300),
    "probe_rows": (4 * 128 + 3, (64, 128), 1 << 20),
}


def _inputs(name: str, seed: int = 0):
    n, shape, beyond = SHAPES[name]
    rng = np.random.RandomState(seed)
    tbl = (np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
           ^ rng.randint(0, 1 << 16, n).astype(np.uint32))
    idx = rng.randint(-beyond, n + beyond, size=shape).astype(np.int32)
    idx.flat[:2] = (-1, n)  # both edges, whatever the draw
    return tbl, idx


@pytest.mark.parametrize("name", list(SHAPES))
def test_take_clip_plain_equals_jnp_take_clip(name):
    tbl, idx = _inputs(name)
    want = np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(idx),
                               mode="clip"))
    got = g.take_clip(u32.from_numpy(tbl), torch.from_numpy(idx))
    assert got.shape == idx.shape
    np.testing.assert_array_equal(u32.to_numpy(got), want)
    assert g.take_clip_launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("name", [n for n in SHAPES if n != "tiny"])
def test_take_along_cols_plain_equals_jnp_on_the_probes_inputs(name):
    """The probe's pallas_tala: t2 and i2 = idx % S formed outside."""
    tbl, idx = _inputs(name)
    t2, i2 = g.tala_inputs(u32.from_numpy(tbl), torch.from_numpy(idx))
    s = len(tbl) // 128
    assert tuple(t2.shape) == (s, 128)
    want_t2 = tbl[:s * 128].reshape(s, 128)
    want_i2 = np.asarray(jnp.asarray(idx) % s)
    np.testing.assert_array_equal(i2.numpy(), want_i2)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(want_t2),
                                          jnp.asarray(want_i2), axis=0))
    np.testing.assert_array_equal(u32.to_numpy(g.take_along_cols(t2, i2)),
                                  want)
    assert g.take_along_cols_launches == 0


@pytest.mark.parametrize("name", [n for n in SHAPES if n != "tiny"])
def test_take_along_cols_plain_equals_jnp_out_of_range(name):
    tbl, idx = _inputs(name, seed=1)
    s = len(tbl) // 128
    t2 = tbl[:s * 128].reshape(s, 128)
    i2 = np.clip(idx, -2 * s - 1, 2 * s + 1)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(t2), jnp.asarray(i2),
                                          axis=0))
    got = g.take_along_cols(u32.from_numpy(t2), torch.from_numpy(i2))
    np.testing.assert_array_equal(u32.to_numpy(got), want)
    assert (want == 0xFFFFFFFF).any() and (i2 < 0).any()


def test_probe_tool_inputs_are_the_tpu_probes():
    """The same tables (``arange(n) * 2654435761`` then ``arange(n)``) and
    the same index draws, in the probe's order, from RandomState(0)."""
    ins = probe_r7.inputs("cpu")
    assert [(k, mb) for k, mb, _ in ins] == (
        [("ladder", mb) for mb in (2, 8, 32, 64, 100)]
        + [("reference", mb) for mb in (2, 64, 256)])
    rng = np.random.RandomState(0)
    n2 = 2 * (1 << 20) // 4
    want_idx = rng.randint(0, n2, size=(8192, 128))
    tbl, idx = ins[0][2]()
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(
        u32.to_numpy(tbl), np.arange(n2, dtype=np.uint32)
        * np.uint32(2654435761))
    out = probe_r7.gather(tbl, idx)
    np.testing.assert_array_equal(
        u32.to_numpy(out["P1"]), u32.to_numpy(tbl)[want_idx])
