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
the TPU probe's, and its edge cases through the plain versions equal
``jnp``.  The kernels themselves run on the card
(``tests/test_torch_kernels.py -m cuda``); what the wrapper decides in
Python for them is tested here: ``launch_plan`` (vector or scalar lanes,
the on-chip variant's threshold, the grid from an SM count and an
occupancy), its constants against the CUDA source, and a numpy model of
the schedule it gives the kernels.
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


# ---- the launch plan of the CUDA kernels (ops/gather_kernels.launch_plan)
# and a model of the schedule it gives them, on the CPU ----

#: an H100's limits as ``gather_limits`` reads them (132 SMs, 227 KB of
#: shared memory a block may opt in to); blocks and clusters are inputs
H100 = dict(sms=132, blocks_per_sm=8, smem_optin=232448, clusters=8)
LANES = 8192 * 128


def _plan(lanes=LANES, words=1 << 21, cols=None, idx_off=0, out_off=0,
          tbl_off=0, limits=None, on_chip=None):
    return g.launch_plan(lanes, words, cols,
                         (0x7F0000 + idx_off, 0x900000 + out_off,
                          0xA00000 + tbl_off), limits or H100, on_chip)


def test_gather_constants_match_the_cuda_source():
    """The plan's constants are the kernel's."""
    import re
    from pathlib import Path

    src = (Path(g.__file__).resolve().parent.parent / "csrc"
           / "gather_kernels.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items() if k in (
        "kV", "kBlock", "kClusterSize", "kClusterBlock", "kBarrierBytes")} \
        == dict(kV=g.V, kBlock=g.BLOCK, kClusterSize=g.CLUSTER,
                kClusterBlock=g.CLUSTER_BLOCK, kBarrierBytes=g.BARRIER_BYTES)
    hints = dict(re.findall(r"(kStream|kKeep) = (\d+)", src))
    assert (int(hints["kStream"]), int(hints["kKeep"])) == (
        g.HINT_STREAM, g.HINT_KEEP)


@pytest.mark.parametrize("extra", range(8))
def test_launch_plan_vector_groups_and_scalar_tail(extra):
    """Whole groups of V lanes take 16 B accesses; lanes % V go scalar."""
    p = _plan(lanes=LANES + extra)
    assert (p.groups, p.tail) == ((LANES + extra) // g.V, extra % g.V)
    assert p.groups * g.V + p.tail == LANES + extra
    assert not p.on_chip and p.slice_words == 0


@pytest.mark.parametrize("case", ["idx_offset_4", "idx_offset_8",
                                  "out_offset_4", "cols_7", "cols_6",
                                  "cols_128", "cols_12"])
def test_launch_plan_scalar_where_the_vector_path_does_not_apply(case):
    """Indices or output off 16 B, or P2 rows not a multiple of V wide:
    every lane scalar, no copy; else whole groups."""
    kw = dict(idx_off=4 if case == "idx_offset_4" else
              8 if case == "idx_offset_8" else 0,
              out_off=4 if case == "out_offset_4" else 0)
    cols = int(case[5:]) if case.startswith("cols") else None
    p = _plan(lanes=LANES + 3, cols=cols, **kw)
    if case in ("cols_128", "cols_12"):
        assert (p.groups, p.tail) == (LANES // g.V, 3)
    else:
        assert (p.groups, p.tail) == (0, LANES + 3)


@pytest.mark.parametrize("lanes,sms,blocks,want", [
    (LANES, 132, 8, 1024),           # the probe: a group a thread, 1 wave
    (1 << 24, 132, 8, 1056),         # more groups than resident threads
    (1 << 24, 114, 7, 798),          # another card's SMs and occupancy
    (5, 132, 8, 1),                  # a tail only
    (0, 132, 8, 1),
])
def test_launch_plan_grid_from_sms_and_occupancy(lanes, sms, blocks, want):
    p = _plan(lanes=lanes, limits=dict(H100, sms=sms, blocks_per_sm=blocks))
    assert p.grid == want


def test_launch_plan_grid_of_a_scalar_launch_counts_its_lanes():
    p = _plan(lanes=LANES, idx_off=4)
    assert p.grid == min(132 * 8, LANES // g.BLOCK) == 1056


@pytest.mark.parametrize("delta", [-2, -1, 0, 1, 2])
def test_launch_plan_on_chip_threshold(delta):
    """The on-chip variant takes tables up to 16 CTAs' shared memory (less
    each CTA's barrier, in 16 B units), and only when asked: never a table
    one word over; the path reads through L2."""
    top = g.on_chip_words_max(H100["smem_optin"])
    assert top == 16 * ((232448 - 16) // 16 * 4)
    assert 4 * top <= 16 * H100["smem_optin"] < 4 * (top + 16 * 4 + 16)
    words = top + delta
    assert not _plan(words=words).on_chip
    assert (g.on_chip_slice(words, H100["smem_optin"]) > 0) == (delta <= 0)
    if delta <= 0:
        q = _plan(words=words, on_chip=True)
        assert q.on_chip and q.slice_words % 4 == 0
        assert g.CLUSTER * q.slice_words >= words
        assert g.BARRIER_BYTES + 4 * q.slice_words <= H100["smem_optin"]
        assert q.grid == g.CLUSTER * 8  # 1M lanes fill the 8 clusters
    else:
        with pytest.raises(ValueError):
            _plan(words=words, on_chip=True)
    assert not _plan(words=words, on_chip=False).on_chip


@pytest.mark.parametrize("case", ["table_offset_4", "no_cluster"])
def test_launch_plan_on_chip_refused(case):
    """A table off 16 B (bulk copies move 16 B units) or a card that holds
    no cluster: a ValueError when the on-chip variant is asked for."""
    kw = (dict(tbl_off=4) if case == "table_offset_4"
          else dict(limits=dict(H100, clusters=0)))
    assert _plan(words=1 << 19, on_chip=True, tbl_off=0).on_chip
    with pytest.raises(ValueError):
        _plan(words=1 << 19, on_chip=True, **kw)


def _model(kind: str, tbl: np.ndarray, idx: np.ndarray, cols, plan):
    """The kernels' schedule in numpy: each thread's groups of V lanes in
    strides of the grid (P2's first column advanced by stride * V mod cols
    a step, never divided), then the scalar lanes; on chip each word read
    from CTA j // slice of the 16.  Returns the words and how many times
    each lane was written."""
    n, lanes = tbl.size, idx.size
    idx = idx.reshape(-1).astype(np.int64)
    rows = n // cols if cols else 0
    if plan.on_chip:
        parts = np.zeros((g.CLUSTER, plan.slice_words), np.uint32)
        for r in range(g.CLUSTER):
            begin = r * plan.slice_words
            mine = max(0, min(plan.slice_words, n - begin))
            bulk = mine // 4 * 4  # whole 16 B units; the rest word by word
            parts[r, :bulk] = tbl[begin:begin + bulk]
            parts[r, bulk:mine] = tbl[begin + bulk:begin + mine]
        assert g.CLUSTER * plan.slice_words >= n

    def word(i, c):
        if kind == "P1":
            j, ok = np.clip(i, 0, n - 1), np.ones(i.shape, bool)
        else:
            r = np.where(i < 0, i + rows, i)
            ok = (r >= 0) & (r < rows)
            j = np.where(ok, r * cols + c, 0)
        if plan.on_chip:
            rank = j // plan.slice_words
            w = parts[rank, j - rank * plan.slice_words]
        else:
            w = tbl[j]
        return np.where(ok, w, np.uint32(0xFFFFFFFF))

    out = np.zeros(lanes, np.uint32)
    hits = np.zeros(lanes, np.int64)
    stride = plan.grid * (g.CLUSTER_BLOCK if plan.on_chip else g.BLOCK)
    grp = np.arange(min(stride, plan.groups))
    if kind == "P2" and grp.size:
        c0, step = grp * g.V % cols, stride * g.V % cols
    while grp.size:
        for k in range(g.V):
            e = grp * g.V + k
            out[e] = word(idx[e], c0 + k if kind == "P2" else None)
            hits[e] += 1
        grp = grp + stride
        keep = grp < plan.groups
        grp = grp[keep]
        if kind == "P2":
            c0 = c0[keep] + step
            c0 = np.where(c0 >= cols, c0 - cols, c0)
    e = plan.groups * g.V + np.arange(stride)
    while (e := e[e < lanes]).size:
        out[e] = word(idx[e], e % cols if kind == "P2" else None)
        hits[e] += 1
        e = e + stride
    return out, hits


@pytest.mark.parametrize("case", [
    "P1_vector", "P1_tail_3", "P1_scalar_offset", "P1_on_chip",
    "P1_on_chip_odd_table", "P2_cols_128", "P2_cols_36", "P2_cols_7",
    "P2_on_chip"])
def test_kernel_schedule_model_equals_plain(case):
    """The schedule ``launch_plan`` gives the kernels writes every lane
    once, and its word arithmetic (P2's advancing column, the on-chip
    slices) gives the plain version's words.  A small grid (3 SMs, one
    block each) makes each thread take several groups."""
    kind = case[:2]
    rng = np.random.default_rng(sum(map(ord, case)))
    limits = dict(H100, sms=3, blocks_per_sm=1, clusters=1)
    cols = None
    if kind == "P1":
        n = 4099 if case.endswith("odd_table") else 4096
        lanes = 5000 + (3 if case.endswith("tail_3") else 0)
        shape = (lanes,)
    else:
        cols = int(case.split("_")[-1]) if "cols" in case else 128
        n, shape = 37 * cols, (601, cols)
    tbl = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    rows = n // cols if cols else n
    idx = rng.integers(-2 * rows - 1, 2 * rows + 2, shape).astype(np.int32)
    plan = g.launch_plan(
        idx.size, n, cols, (4 if "offset" in case else 0, 0, 0), limits,
        on_chip="on_chip" in case)
    assert plan.groups == (0 if "offset" in case or cols == 7
                           else idx.size // g.V)
    if kind == "P2" and plan.groups:  # the first column advances and wraps
        assert 0 < plan.grid * g.BLOCK * g.V % cols and \
            plan.groups > 2 * plan.grid * g.BLOCK or cols == 128
    got, hits = _model(kind, tbl, idx, cols, plan)
    assert (hits == 1).all()
    if kind == "P1":
        want = g.take_clip_plain(u32.from_numpy(tbl), torch.from_numpy(idx))
    else:
        want = g.take_along_cols_plain(u32.from_numpy(tbl).view(-1, cols),
                                       torch.from_numpy(idx))
    np.testing.assert_array_equal(got, u32.to_numpy(want).reshape(-1))


def test_probe_edge_cases_plain_equal_jnp():
    """The probe's edge cases (``edge_cases``: lanes 1-7 past a multiple of
    8, an index view 4 B off, indices beyond the table and at the int32
    extremes, P2 with 7 columns, tables at the on-chip threshold) through
    the plain versions equal ``jnp.take(mode="clip")`` /
    ``jnp.take_along_axis``; the view is 4 B past an aligned address."""
    cases = probe_r7.edge_cases("cpu", H100["smem_optin"])
    names = [(k, name) for name, k, _ in cases]
    assert [n for n in names if n[1].startswith("lanes_mod8")] == [
        ("P1", f"lanes_mod8_{k}") for k in range(1, 8)]
    assert ("P2", "cols_7") in names and ("P1", "index_offset_4B") in names
    top = g.on_chip_words_max(H100["smem_optin"])
    for name, kern, make in cases:
        tbl, idx, fits = make()
        t, i = u32.to_numpy(tbl), idx.numpy()
        if name.startswith("threshold"):
            assert fits == (t.size <= top), name
        if "offset" in name:
            assert idx.data_ptr() % 16 == 4
        if kern == "P1":
            want = np.asarray(jnp.take(jnp.asarray(t.reshape(-1)),
                                       jnp.asarray(i), mode="clip"))
            got = g.take_clip(tbl, idx)
        else:
            want = np.asarray(jnp.take_along_axis(jnp.asarray(t),
                                                  jnp.asarray(i), axis=0))
            got = g.take_along_cols(tbl, idx)
        np.testing.assert_array_equal(u32.to_numpy(got), want, err_msg=name)
