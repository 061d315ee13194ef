"""Parity of the port's traced GI init with the JAX package's, at 64^3.

``build_world`` with ``gi_init_mode="traced"`` (stride (1, 1): one
sun-shadow ray per GI cell, ``init_gi_chunked`` -> ``init_gi``) builds the
same world and GI words bit for bit; ``init_gi_strided`` at stride (2, 2)
(a ray per 2 x 2 block of cells, replicated), and at gi_coarseness 2 with
``gi_straggler_budget=12`` (32 768 cells: the two-phase respite engages),
gives the same words.  ``init_gi_chunked`` in slices of 1024, 1536 and
1280 cells (full slices and, at 1536 and 1280, a tail window anchored at
``cells - pad``) equals the whole init, and each slice is one trace; at
1280 (three full slices and a tail) it also equals the JAX package's
``init_gi_chunked(chunk=1280)``.  The JAX side runs in one child
process without FMA contraction (tests/torch_jaxref.py), started first so
that it overlaps the port's own work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.gi import update
from rvgrt_tpu_torch.trace import wavefront
from tests import torch_jaxref as ref

SPEC = ref.merge_spec(ref.SLICE_SPEC, {"engine": dict(
    gi_init_mode="traced", gi_init_stride=(1, 1))})
#: name -> (overrides of SPEC, stride, traces, respites)
CASES = {
    "stride_2x2": ({}, (2, 2), 1, 0),
    "coarse2_budget12": ({"world": dict(gi_coarseness=2),
                          "engine": dict(gi_straggler_budget=12)},
                         (1, 1), 2, 1),
}
#: chunk -> traces of init_gi_chunked over the 4096 cells of 64^3
CHUNKS = {1024: 4, 1536: 3, 1280: 4}
#: the chunks the JAX package's init_gi_chunked also runs
JAX_CHUNKS = (1280,)


def _traced(fn):
    wavefront.reset_stats()
    out = fn()
    return out, wavefront.read_stats()


@pytest.fixture(scope="module")
def inits():
    child = ref.start([("ref_gi_init", dict(
        spec=SPEC, cases=[(over, stride)
                          for over, stride, _, _ in CASES.values()],
        chunks=JAX_CHUNKS))])
    ecfg = ref.make_ecfg(tcfg, SPEC)
    world, build_stats = _traced(lambda: engine.build_world(
        ecfg, verbose=False, device="cpu"))
    w = dict(bits=world.bits, sdf=world.sdf, sky_y=world.sky_y,
             table=world.trace_table)
    got = {}
    for name, (over, stride, _, _) in CASES.items():
        ec = ref.make_ecfg(tcfg, ref.merge_spec(SPEC, over))
        got[name] = _traced(lambda: update.init_gi_strided(
            w["bits"], w["sdf"], ec, sky_y=w["sky_y"], table=w["table"],
            stride=stride))
    chunked = {chunk: _traced(lambda: update.init_gi_chunked(
        w["bits"], w["sdf"], ecfg, sky_y=w["sky_y"], table=w["table"],
        chunk=chunk)) for chunk in CHUNKS}
    want = child.result()[0]
    return dict(world=world, build_stats=build_stats, got=got,
                chunked=chunked, want=want)


def test_build_world_traced_init_bit_exact(inits):
    got = engine.world_to_numpy(inits["world"])
    want = inits["want"]["world"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the whole 16^3-cell init is one trace; some cells are sunlit, some
    # in shadow
    assert inits["build_stats"]["traces"] == 1
    lit = int(((got["gi"] & 0xFFFFFF) != 0).sum())
    assert 0 < lit < got["gi"].size


@pytest.mark.parametrize("case", list(CASES))
def test_init_gi_strided_bit_exact(inits, case):
    words, stats = inits["got"][case]
    want = inits["want"]["words"][list(CASES).index(case)]
    np.testing.assert_array_equal(u32.to_numpy(words), want)
    _, _, traces, respites = CASES[case]
    assert (stats["traces"], stats["respites"]) == (traces, respites)


@pytest.mark.parametrize("chunk", list(CHUNKS))
def test_init_gi_chunked_equals_whole_init(inits, chunk):
    words, stats = inits["chunked"][chunk]
    np.testing.assert_array_equal(u32.to_numpy(words),
                                  inits["want"]["world"]["gi"])
    assert stats["traces"] == CHUNKS[chunk]
    if chunk in JAX_CHUNKS:
        np.testing.assert_array_equal(u32.to_numpy(words),
                                      inits["want"]["chunked"][chunk])


def test_build_world_still_refuses_the_fused_cone():
    """NOTE: this test checks the opposite of its name.  The name is kept
    from when the port refused ``gi_fused_cone`` (a test whose check
    changes keeps its name, so its record carries on).  Now that the
    fused cone table is ported, ``build_world`` with the flag builds the
    world's cone occlusion mip (``World.gi_occ``), and without it builds
    none.  ``tests/test_torch_cone.py`` holds ``gi_occ`` against JAX's."""
    from rvgrt_tpu_torch.world import gi_grid

    ecfg = ref.make_ecfg(tcfg, SPEC)
    fused = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, gi_fused_cone=True))
    w = engine.build_world(fused, verbose=False, init_gi=False,
                           device="cpu")
    assert w.gi_occ is not None, "gi_fused_cone=True built no World.gi_occ"
    np.testing.assert_array_equal(
        u32.to_numpy(w.gi_occ),
        u32.to_numpy(gi_grid.build_occlusion(w.sdf, ecfg.world)),
        err_msg="World.gi_occ is not build_occlusion of the world's SDF")
    plain = engine.build_world(ecfg, verbose=False, init_gi=False,
                               device="cpu")
    assert plain.gi_occ is None, "gi_fused_cone=False built a World.gi_occ"
    np.testing.assert_array_equal(u32.to_numpy(plain.trace_table),
                                  u32.to_numpy(w.trace_table))
