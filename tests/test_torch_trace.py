"""Parity of the port's wavefront tracer (kernel K1's path) with JAX.

Random rays through a 64^3 world: ``hit/px/py/pz/nx/ny/nz/uv_u/uv_v/its/t``
bit-exact against ``rvgrt_tpu``'s ``trace`` at the reference cadence and at
the bench cadence, with ``fused_superstep`` off and on (the port ignores
the field: every superstep goes through K1's wrapper, which on the CPU runs
K1's plain version, so both settings must give the JAX result), and at the
bench cadence with a superstep budget that cuts rays mid-flight.  One
superstep of K1's plain version is also held against the JAX XLA body (the
oracle of the Pallas kernel) on real mid-trace states.  ``steps`` is not
compared: it counts the TPU's row-tile cost.

The two-phase straggler respite, on ``tests/test_trace.py``'s 128 x 128 ray
fan: budgets 4, 8 and 12 at cap fractions 1.0 and 0.25, and a forced-tiny
cap, bit-exact on every traced field and on ``degraded`` and ``exit_dir``,
engaged at exactly 4 x 4096 rays and not one ray below; and the GI window's
overflow count with the respite engaged.  Slim carry (tMax recomputed
each superstep, ``RenderConfig.slim_carry``) at the bench cadence and
through the respite's two phases, bit-exact against JAX's slim path.  The
volume-sharded ``z_edges`` mode on one z-slab of the world, for all four
(is_first, is_last) pairs, carried and slim, bit-exact on every field and
on ``exit_dir``.  The JAX side runs without FMA contraction
(tests/torch_jaxref.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.ops import superstep_kernel
from rvgrt_tpu_torch.parallel import volume
from rvgrt_tpu_torch.trace import wavefront
from tests import torch_jaxref as ref

WORLD = {"cube": 6, "engine": dict(gi_init_mode="heightfield")}
CADENCES = {
    "reference": {},
    "bench": dict(dda_substeps=6, sdf_probe_interval=16, dist_bias=4.0,
                  steps_per_check=1),
}
FIELDS = ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v", "its",
          "t")
# the bench cadence with a superstep budget that cuts rays: batches of 4,
# so a lane stops at retirement or after 16 supersteps
CAPPED = ref.with_render(ref.with_render(WORLD, **CADENCES["bench"]),
                         max_supersteps=13, steps_per_check=4)
SHAPE = (48, 64)
# the two-phase straggler respite: (budget, cap fraction, render extras) at
# the bench cadence.  The fan is 128 x 128 = 4 x 4096 rays, exactly where
# it engages; "below" drops one ray, so both packages trace in one phase.
# "tiny" forces the slots far below the unfinished lanes (over-cap lanes
# read as misses flagged degraded), with a budget of 5 in batches of 2.
RESPITE = {
    **{f"b{b}_f{f}": (b, f, {}) for b in (4, 8, 12) for f in (1.0, 0.25)},
    "tiny": (5, 1e-6, dict(steps_per_check=2)),
    "below": (12, 0.25, {}),
}
FAN = (128, 128)
# the volume-sharded mode: slab 1 of the world cut into 4 z-slabs of 16,
# at the bench cadence, for every (is_first, is_last) pair
Z_SLABS, Z_SLAB = 4, 1
Z_SPEC = ref.merge_spec(ref.with_render(WORLD, **CADENCES["bench"]),
                        {"world": dict(shift_z=4)})
Z_EDGES = [(False, False), (True, False), (False, True), (True, True)]
# a GI window of 16 384 cells (a 64^3 world with gi_coarseness 2: the grid's
# upper half, the lower half is buried), budget 4 and a forced-tiny cap, so
# that the window overflows
GI_OFFSET = 16384
GI_SPEC = {**ref.with_render(WORLD, **CADENCES["bench"],
                             straggler_cap_frac=1e-6),
           "world": dict(gi_coarseness=2),
           "engine": dict(gi_init_mode="heightfield",
                          gi_rays_per_frame=16384, gi_straggler_budget=4)}


def _rays():
    rng = np.random.default_rng(7)
    n = SHAPE[0] * SHAPE[1]
    o = rng.uniform(2.0, 62.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(32.0, 62.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    t0 = rng.uniform(0.0, 6.0, n).astype(np.float32)
    # a few rays start out of the world or straight up (init retirement)
    o[:8, 0] = -3.0
    d[8:16] = np.array([0.0, 1.0, 0.0], np.float32)
    return [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t0]


def _slab_rays():
    """Rays from inside the slab (and 16 from just beyond each z face, which
    exit or miss at init), every direction, so lanes leave through both
    faces in both phases."""
    rng = np.random.default_rng(11)
    n = 3072
    o = rng.uniform(1.0, 63.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(20.0, 62.0, n)
    o[:, 2] = rng.uniform(0.0, 16.0, n)
    o[:16, 2] = -0.5
    o[16:32, 2] = 16.25
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    t0 = rng.uniform(0.0, 3.0, n).astype(np.float32)
    return [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t0]


def _slab_table(world):
    w = engine.world_from_numpy(world, device="cpu")
    cfg = ref.make_ecfg(tcfg, WORLD).world
    return volume.slab_table(w.bits, w.sdf, cfg, Z_SLABS, Z_SLAB), w.sky_y


def _spec(cadence, slim: bool = False):
    spec = ref.with_render(WORLD, **CADENCES[cadence])
    return ref.with_render(spec, slim_carry=True) if slim else spec


#: the respite cases traced with slim carry too
SLIM_RESPITE = ("b12_f0.25",)


def _fan(case):
    """``tests/test_trace.py``'s straggler fan: 128 x 128 rays from an
    open-air spot (a mix of quick converges, long marches and grazers),
    flat; one ray fewer for the "below" case."""
    h, w = FAN
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = -0.6 + 1.4 * (xs / w)
    dy = 0.55 - 1.3 * (ys / h)
    dz = -0.6 + 1.4 * (ys / h)
    n_ = np.sqrt(dx * dx + dy * dy + dz * dz + 1e-8)
    z = np.zeros(h * w, np.float32)
    rays = [z + 47.5, z + 36.0, z + 32.5, (dx / n_).reshape(-1),
            (dy / n_).reshape(-1), (dz / n_).reshape(-1), z]
    n = h * w - (case == "below")
    return [np.ascontiguousarray(a[:n], np.float32) for a in rays]


def _respite_spec(case, slim: bool = False):
    budget, frac, extra = RESPITE[case]
    return ref.with_render(WORLD, **{**CADENCES["bench"], **extra},
                           straggler_budget=budget, straggler_cap_frac=frac,
                           slim_carry=slim)


def _states(world, cadence):
    """Real mid-trace states: the port's trace of the test rays stopped
    after 0, 3 and 9 supersteps."""
    ecfg = ref.make_ecfg(tcfg, _spec(cadence))
    w = engine.world_from_numpy(world, device="cpu")
    rays = [torch.from_numpy(a) for a in _rays()]
    out = []
    for n_steps in (0, 3, 9):
        s, dirs = wavefront.start_state(ecfg.world, *rays, sky_y=w.sky_y)
        for _ in range(n_steps):
            s.update(superstep_kernel.superstep_plain(
                ecfg.world, ecfg.render, w.trace_table, dirs, s,
                sky_y=w.sky_y))
        out.append(({k: v.numpy() for k, v in s.items()},
                    tuple(a.numpy() for a in dirs)))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    # the world is an input here (its build is gated in test_torch_world)
    world = engine.world_to_numpy(engine.build_world(
        ref.make_ecfg(tcfg, WORLD), verbose=False, device="cpu"))
    jobs, keys = [], []
    for cad in CADENCES:
        jobs.append(("ref_trace", dict(spec=_spec(cad), world=world,
                                       rays=_rays(), shape=SHAPE)))
        keys.append(("trace", cad))
        for i, (s, dirs) in enumerate(_states(world, cad)):
            jobs.append(("ref_superstep", dict(spec=_spec(cad), world=world,
                                               state=s, dirs=dirs)))
            keys.append(("superstep", cad, i))
    jobs.append(("ref_trace", dict(spec=CAPPED, world=world, rays=_rays(),
                                   shape=SHAPE)))
    keys.append(("trace", "capped"))
    for case in RESPITE:
        rays = _fan(case)
        jobs.append(("ref_trace", dict(spec=_respite_spec(case), world=world,
                                       rays=rays, shape=rays[0].shape)))
        keys.append(("respite", case))
    jobs.append(("ref_trace", dict(spec=_spec("bench", slim=True),
                                   world=world, rays=_rays(), shape=SHAPE)))
    keys.append(("slim", "bench"))
    for case in SLIM_RESPITE:
        rays = _fan(case)
        jobs.append(("ref_trace", dict(spec=_respite_spec(case, slim=True),
                                       world=world, rays=rays,
                                       shape=rays[0].shape)))
        keys.append(("slim_respite", case))
    table, sky_y = _slab_table(world)
    jobs.append(("ref_trace_z_edges", dict(
        spec=Z_SPEC, table=table.numpy(), sky_y=sky_y.numpy(),
        rays=_slab_rays(), cases=Z_EDGES)))
    keys.append("z_edges")
    gi_world = engine.world_to_numpy(engine.build_world(
        ref.make_ecfg(tcfg, GI_SPEC), verbose=False, device="cpu"))
    jobs.append(("ref_gi_updates", dict(spec=GI_SPEC, world=gi_world,
                                        windows=1, offset=GI_OFFSET,
                                        stats=True)))
    keys.append("gi")
    out = dict(zip(keys, ref.run(jobs)))
    out["world"] = world
    out["gi_world"] = gi_world
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("cadence", list(CADENCES))
def test_trace_bit_exact(jax_ref, cadence, fused):
    ecfg = ref.make_ecfg(tcfg, ref.with_render(_spec(cadence),
                                               fused_superstep=fused))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a.reshape(SHAPE)) for a in _rays()]
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                          table=w.trace_table, sky_y=w.sky_y)
    want = jax_ref[("trace", cadence)]
    assert 0.2 < want["hit"].mean() < 0.95
    for f in FIELDS:
        got = getattr(res, f).numpy()
        assert got.shape == SHAPE
        np.testing.assert_array_equal(got, want[f], err_msg=f)


def test_slim_trace_bit_exact(jax_ref):
    """``slim_carry=True`` at the slice's cadence (``ref.SLICE_SPEC``'s):
    every traced field equals JAX's slim path (tMax recomputed from the
    DDA-entry position each superstep and in the payload), bit for bit."""
    ecfg = ref.make_ecfg(tcfg, _spec("bench", slim=True))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a.reshape(SHAPE)) for a in _rays()]
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                          table=w.trace_table, sky_y=w.sky_y)
    want = jax_ref[("slim", "bench")]
    assert 0.2 < want["hit"].mean() < 0.95
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(), want[f],
                                      err_msg=f)


@pytest.mark.parametrize("case", SLIM_RESPITE)
def test_slim_respite_bit_exact(jax_ref, case):
    """Both phases of the respite carry ``slim_carry``, as JAX's
    ``dataclasses.replace`` does: the two-phase slim trace equals JAX's on
    every field, ``degraded`` and ``exit_dir`` included."""
    ecfg = ref.make_ecfg(tcfg, _respite_spec(case, slim=True))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a) for a in _fan(case)]
    seen = []
    real = superstep_kernel.trace_supersteps

    def spy(cfg, rcfg, *a, **kw):
        seen.append(rcfg.slim_carry)
        return real(cfg, rcfg, *a, **kw)

    superstep_kernel.trace_supersteps = spy
    try:
        res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                              table=w.trace_table, sky_y=w.sky_y)
    finally:
        superstep_kernel.trace_supersteps = real
    assert seen == [True, True]
    want = jax_ref[("slim_respite", case)]
    for f in FIELDS + ("degraded", "exit_dir"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), want[f],
                                      err_msg=f)


def test_slim_leaves_tmax_words_alone(jax_ref):
    """A slim superstep neither reads nor writes the tMax words: garbage in
    them changes nothing, and they come out as they went in."""
    ecfg = ref.make_ecfg(tcfg, _spec("bench", slim=True))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    s_np, dirs_np = _states(jax_ref["world"], "bench")[2]
    dirs = tuple(torch.from_numpy(a) for a in dirs_np)
    outs = []
    for fill in (0.0, 1234.5):
        s = {k: torch.from_numpy(v.copy()) for k, v in s_np.items()}
        for k in ("tmx", "tmy", "tmz"):
            s[k].fill_(fill)
        for _ in range(4):
            superstep_kernel.fused_superstep(ecfg.world, ecfg.render,
                                             w.trace_table, dirs, s,
                                             sky_y=w.sky_y)
        assert all(bool((s[k] == fill).all()) for k in ("tmx", "tmy",
                                                         "tmz"))
        outs.append(s)
    for k in wavefront.STATE_KEYS[:8]:
        np.testing.assert_array_equal(outs[0][k].numpy(), outs[1][k].numpy(),
                                      err_msg=k)


def test_z_edges_raises(jax_ref):
    """The volume-sharded ``z_edges`` mode (named for the error the port
    raised before it had the mode) on slab 1 of 4: for each (is_first,
    is_last) pair, carried and slim, every traced field and ``exit_dir``
    equal JAX's bit for bit; lanes leave through both interior faces, and
    an edge face turns its exits into misses."""
    table, sky_y = _slab_table(jax_ref["world"])
    rays = [torch.from_numpy(a) for a in _slab_rays()]
    for slim in (False, True):
        ecfg = ref.make_ecfg(tcfg, ref.with_render(Z_SPEC, slim_carry=slim))
        assert ecfg.world.size_z == 16
        for edges in Z_EDGES:
            res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                                  table=table, sky_y=sky_y, z_edges=edges)
            want = jax_ref["z_edges"][(slim, *edges)]
            for f in FIELDS + ("exit_dir",):
                np.testing.assert_array_equal(
                    getattr(res, f).numpy(), want[f],
                    err_msg=f"{f} slim={slim} z_edges={edges}")
            ed = want["exit_dir"]
            assert (ed < 0).any() != edges[0] and (ed > 0).any() != edges[1]
            assert want["hit"].any()


def test_trace_capped_budget_bit_exact(jax_ref):
    """A budget that stops rays mid-flight: every lane of the port's trace
    stops where the JAX tiles' loops stop it, bit for bit on the traced
    fields; the port's ``steps`` is the rounded-up budget."""
    ecfg = ref.make_ecfg(tcfg, CAPPED)
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a.reshape(SHAPE)) for a in _rays()]
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                          table=w.trace_table, sky_y=w.sky_y)
    want = jax_ref[("trace", "capped")]
    # the budget does cut rays: fewer hits than the uncut trace
    assert want["hit"].sum() < jax_ref[("trace", "bench")]["hit"].sum()
    assert bool((res.steps == 16).all())
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(), want[f],
                                      err_msg=f)


@pytest.mark.parametrize("case", list(RESPITE))
def test_respite_bit_exact(jax_ref, case):
    """The port's two-phase trace equals JAX's bit for bit on every traced
    field and on ``degraded`` and ``exit_dir``; it engages exactly where
    JAX's does (4 x 4096 rays)."""
    ecfg = ref.make_ecfg(tcfg, _respite_spec(case))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a) for a in _fan(case)]
    wavefront.reset_stats()
    res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                          table=w.trace_table, sky_y=w.sky_y)
    stats = wavefront.read_stats()
    engaged = case != "below"
    assert rays[0].numel() >= wavefront.RESPITE_MIN_RAYS or not engaged
    assert stats["respites"] == engaged
    assert stats["traces"] == 1 + engaged
    want = jax_ref[("respite", case)]
    for f in FIELDS + ("degraded", "exit_dir"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), want[f],
                                      err_msg=f)
    assert not want["exit_dir"].any()
    # a cap of every lane holds every straggler; the tiny cap overflows
    frac = RESPITE[case][1]
    if frac >= 1.0:
        assert not want["degraded"].any()
    if case == "tiny":
        assert want["degraded"].any()


def test_respite_changes_its_not_hits(jax_ref):
    """Against the single-phase trace of the same fan, the respite keeps
    every hit flag and normal, and re-entry changes ``its`` of resumed
    lanes (the documented accounting)."""
    ecfg = ref.make_ecfg(tcfg, _respite_spec("b4_f1.0"))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    rays = [torch.from_numpy(a) for a in _fan("b4_f1.0")]
    one = wavefront.trace(None, None, ecfg.world,
                          dataclasses.replace(ecfg.render,
                                              straggler_budget=0),
                          *rays, table=w.trace_table, sky_y=w.sky_y)
    two = jax_ref[("respite", "b4_f1.0")]
    np.testing.assert_array_equal(one.hit.numpy(), two["hit"])
    assert (one.its.numpy() != two["its"]).any()


def test_gi_overflow_matches_jax(jax_ref):
    """``update_gi(return_stats=True)`` on a 16 384-cell window with a
    forced-tiny cap: the overflow count (a 0-d device tensor) and the GI
    words equal JAX's."""
    ecfg = ref.make_ecfg(tcfg, GI_SPEC)
    w = engine.world_from_numpy(jax_ref["gi_world"], device="cpu")
    gi, st = gi_update.update_gi(w.gi, w.bits, w.sdf, w.atlas, ecfg, 0,
                                 GI_OFFSET, sky_y=w.sky_y,
                                 table=w.trace_table, return_stats=True)
    want_gi, want_overflow = jax_ref["gi"]
    assert st["straggler_overflow"].ndim == 0
    assert int(st["straggler_overflow"]) == want_overflow[0] > 0
    np.testing.assert_array_equal(u32.to_numpy(gi), want_gi)


@pytest.mark.parametrize("n,frac,slots", [(16384, 0.25, 4096),
                                          (32768, 0.25, 8192),
                                          (16384, 1.0, 16384),
                                          (16385, 1.0, 20480),
                                          (20000, 1e-6, 4096)])
def test_respite_slots(n, frac, slots):
    assert wavefront.respite_slots(n, frac) == slots


@pytest.mark.parametrize("budget,k,cap", [(2048, 1, 2048), (13, 4, 16),
                                          (12, 4, 12), (1, 2, 2), (0, 4, 0)])
def test_step_cap_rounds_up_to_whole_batches(budget, k, cap):
    rcfg = tcfg.RenderConfig(max_supersteps=budget, steps_per_check=k)
    assert superstep_kernel.step_cap(rcfg) == cap


@pytest.mark.parametrize("which", [0, 1, 2], ids=["start", "step3",
                                                  "step9"])
@pytest.mark.parametrize("cadence", list(CADENCES))
def test_superstep_plain_matches_xla_body(jax_ref, cadence, which):
    ecfg = ref.make_ecfg(tcfg, _spec(cadence))
    w = engine.world_from_numpy(jax_ref["world"], device="cpu")
    s_np, dirs_np = _states(jax_ref["world"], cadence)[which]
    s = {k: torch.from_numpy(v) for k, v in s_np.items()}
    dirs = tuple(torch.from_numpy(a) for a in dirs_np)
    superstep_kernel.fused_superstep(ecfg.world, ecfg.render, w.trace_table,
                                     dirs, s, sky_y=w.sky_y)
    want = jax_ref[("superstep", cadence, which)]
    for k in wavefront.STATE_KEYS:
        np.testing.assert_array_equal(s[k].numpy(), want[k], err_msg=k)
