"""Parity of the port's wavefront tracer (kernel K1's path) with JAX.

Random rays through a 64^3 world: ``hit/px/py/pz/nx/ny/nz/uv_u/uv_v/its/t``
bit-exact against ``rvgrt_tpu``'s ``trace`` at the reference cadence and at
the bench cadence, with ``fused_superstep`` off and on (the port ignores
the field: every superstep goes through K1's wrapper, which on the CPU runs
K1's plain version, so both settings must give the JAX result), and at the
bench cadence with a superstep budget that cuts rays mid-flight.  One
superstep of K1's plain version is also held against the JAX XLA body (the
oracle of the Pallas kernel) on real mid-trace states.  ``steps`` is not
compared: it counts the TPU's row-tile cost.  The JAX side runs without FMA
contraction (tests/torch_jaxref.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.ops import superstep_kernel
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


def _spec(cadence):
    return ref.with_render(WORLD, **CADENCES[cadence])


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
    out = dict(zip(keys, ref.run(jobs)))
    out["world"] = world
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
