"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

K1 (the tracer: a whole trace in one launch, and one superstep per launch),
K2 (history warp), K3 (SDF min-plus pass), and P1 and P2 (the gather
probe's flat clamped take and per-column take) at small shapes: a 64^3
world built by the port, random rays, a random packed history, random
tables and indices.  Also on the card against the CPU: the two-phase
straggler respite (two K1 launches, no host read), checkerboard and
quarter-rate frames, the traced GI init, and K1's volume-sharded ZEDGES
variants on a z-slab of the world.  Every test here
needs a CUDA GPU and skips without one (a CUDA kernel has no interpret
mode).  The file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed; the suite's
``conftest.py`` sets up JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda -q

``chip_smoke.py`` repeats these comparisons at the main path's shapes.
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
from rvgrt_tpu_torch.ops import (gather_kernels, sdf_kernels,
                                 superstep_kernel, warp_kernels)
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.world import sdf, voxel_grid

pytestmark = pytest.mark.cuda

CADENCES = {
    "reference": {},
    "bench": dict(dda_substeps=6, sdf_probe_interval=16, dist_bias=4.0,
                  steps_per_check=1),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++")
    return torch.device("cuda")


def _ecfg(**render):
    return tcfg.EngineConfig(
        world=tcfg.WorldConfig().with_cube(6),
        render=dataclasses.replace(tcfg.RenderConfig(), **render),
        gi_init_mode="heightfield")


@pytest.fixture(scope="module")
def worlds(cuda):
    """The same 64^3 world built on the GPU (through K3) and on the CPU."""
    ecfg = _ecfg()
    return (engine.build_world(ecfg, verbose=False, device=cuda),
            engine.build_world(ecfg, verbose=False, device="cpu"))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_build_world_gpu_matches_cpu(worlds):
    got = engine.world_to_numpy(worlds[0])
    want = engine.world_to_numpy(worlds[1])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("cadence", list(CADENCES))
def test_superstep_kernel_matches_plain(cuda, worlds, cadence):
    """One K1 launch per superstep equals the plain superstep, bit for bit,
    on every state of a whole trace of random rays."""
    ecfg = _ecfg(**CADENCES[cadence])
    w = worlds[0]
    rng = np.random.default_rng(7)
    n = 48 * 64
    o = rng.uniform(2.0, 62.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True).astype(np.float32)
    t0 = rng.uniform(0.0, 6.0, n).astype(np.float32)
    rays = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                      t0)]
    s, dirs = wavefront.start_state(ecfg.world, *rays, sky_y=w.sky_y)
    steps = 0
    while wavefront.any_live(s["flags"]) and steps < 600:
        want = superstep_kernel.superstep_plain(
            ecfg.world, ecfg.render, w.trace_table, dirs, s, sky_y=w.sky_y)
        n0 = superstep_kernel.launches
        superstep_kernel.fused_superstep(ecfg.world, ecfg.render,
                                         w.trace_table, dirs, s,
                                         sky_y=w.sky_y)
        assert superstep_kernel.launches == n0 + 1
        for k in wavefront.STATE_KEYS:
            assert _bits_equal(s[k], want[k]), (steps, k)
        steps += 1
    assert 10 < steps < 600


def _rays(shape, seed, retired_at_start=False):
    """Random rays in the 64^3 world as numpy arrays (ox, oy, oz, dx, dy,
    dz, t0); ``retired_at_start``: every ray starts outside the world
    (x = -3, t0 = 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(2.0, 62.0, (3,) + shape).astype(np.float32)
    d = rng.normal(size=(3,) + shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True).astype(np.float32)
    t0 = rng.uniform(0.0, 6.0, shape).astype(np.float32)
    if retired_at_start:
        o[0] = -3.0
        t0[:] = 0.0
    return [np.ascontiguousarray(a) for a in (*o, *d, t0)]


#: the cases of test_trace_launches_k1_whatever_the_setting: render
#: overrides on the bench cadence, the ray shape, and the trace's steps on
#: both devices where the case fixes it
TRACE_CASES = {
    "unfused": dict(render=dict(fused_superstep=False), shape=(24, 32)),
    "fused": dict(render=dict(fused_superstep=True), shape=(24, 32)),
    # a budget that cuts rays: batches of 4, so every lane stops at 16
    "capped": dict(render=dict(max_supersteps=13, steps_per_check=4),
                   shape=(24, 32), steps=16),
    # not a multiple of 32: the last warp's queue is ragged
    "n1000": dict(render={}, shape=(1000,)),
    "retired_at_start": dict(render={}, shape=(24, 32), retired=True,
                             steps=0),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_launches_k1_whatever_the_setting(cuda, worlds, case):
    """On the GPU a whole ``trace`` is ONE K1 launch, with
    ``fused_superstep`` off (the config's default) as with it on, at a cut
    superstep budget and at a ragged ray count; the traced fields and
    ``steps`` equal the CPU trace's (the plain loop), and the superstep
    stats agree."""
    spec = TRACE_CASES[case]
    ecfg = _ecfg(**{**CADENCES["bench"], **spec["render"]})
    arrays = _rays(spec["shape"], 11, spec.get("retired", False))
    res, ran = {}, {}
    for w in worlds:
        dev = w.bits.device
        rays = [torch.from_numpy(a).to(dev) for a in arrays]
        n0 = superstep_kernel.launches
        wavefront.reset_stats()
        res[dev.type] = wavefront.trace(None, None, ecfg.world, ecfg.render,
                                        *rays, table=w.trace_table,
                                        sky_y=w.sky_y)
        stats = wavefront.read_stats()
        assert stats["traces"] == 1
        ran[dev.type] = stats["supersteps"]
        assert superstep_kernel.launches - n0 == (dev.type == "cuda")
    assert ran["cuda"] == ran["cpu"]
    if "steps" in spec:
        assert ran["cpu"] == spec["steps"]
    else:
        assert ran["cpu"] > 0
    assert torch.equal(res["cuda"].steps.cpu(), res["cpu"].steps)
    for f in ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t"):
        assert _bits_equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f
    if spec.get("retired"):
        # the kernel writes no word of a ray retired at start
        w = worlds[0]
        s, dirs = wavefront.start_state(
            ecfg.world, *(torch.from_numpy(a.reshape(-1)).to(cuda)
                          for a in arrays), sky_y=w.sky_y)
        before = {k: v.clone() for k, v in s.items()}
        steps = superstep_kernel.trace_supersteps(
            ecfg.world, ecfg.render, w.trace_table, dirs, s, sky_y=w.sky_y)
        assert int(steps) == 0
        for k in wavefront.STATE_KEYS:
            assert _bits_equal(s[k], before[k]), k


@pytest.mark.parametrize("cadence", list(CADENCES))
def test_trace_supersteps_matches_plain_state(cuda, worlds, cadence):
    """The one-launch trace leaves all 11 state arrays bit-equal to the
    plain loop's, and a second trace over the retired state changes no
    word and runs 0 supersteps."""
    ecfg = _ecfg(**CADENCES[cadence])
    w = worlds[0]
    rays = [torch.from_numpy(a).to(cuda) for a in _rays((48 * 64,), 7)]
    s, dirs = wavefront.start_state(ecfg.world, *rays, sky_y=w.sky_y)
    sp = {k: v.clone() for k, v in s.items()}
    want = superstep_kernel.trace_plain(ecfg.world, ecfg.render,
                                        w.trace_table, dirs, sp,
                                        sky_y=w.sky_y)
    got = superstep_kernel.trace_supersteps(ecfg.world, ecfg.render,
                                            w.trace_table, dirs, s,
                                            sky_y=w.sky_y)
    assert int(got) == int(want) > 10
    for k in wavefront.STATE_KEYS:
        assert _bits_equal(s[k], sp[k]), k
    before = {k: v.clone() for k, v in s.items()}
    again = superstep_kernel.trace_supersteps(ecfg.world, ecfg.render,
                                              w.trace_table, dirs, s,
                                              sky_y=w.sky_y)
    assert int(again) == 0
    for k in wavefront.STATE_KEYS:
        assert _bits_equal(s[k], before[k]), k


@pytest.mark.parametrize("cadence", list(CADENCES))
def test_slim_trace_supersteps_matches_plain_state(cuda, worlds, cadence):
    """K1's slim-carry variant (one launch) leaves all 11 state arrays
    bit-equal to the slim plain loop's - the tMax words untouched - and
    the slim trace's fields equal the CPU's."""
    ecfg = _ecfg(**CADENCES[cadence], slim_carry=True)
    w = worlds[0]
    rays = [torch.from_numpy(a).to(cuda) for a in _rays((48 * 64,), 7)]
    s, dirs = wavefront.start_state(ecfg.world, *rays, sky_y=w.sky_y)
    for k in ("tmx", "tmy", "tmz"):
        s[k].fill_(-7.0)
    sp = {k: v.clone() for k, v in s.items()}
    want = superstep_kernel.trace_plain(ecfg.world, ecfg.render,
                                        w.trace_table, dirs, sp,
                                        sky_y=w.sky_y)
    n0 = superstep_kernel.launches
    got = superstep_kernel.trace_supersteps(ecfg.world, ecfg.render,
                                            w.trace_table, dirs, s,
                                            sky_y=w.sky_y)
    assert superstep_kernel.launches - n0 == 1
    assert int(got) == int(want) > 10
    for k in wavefront.STATE_KEYS:
        assert _bits_equal(s[k], sp[k]), k
    assert bool((s["tmx"] == -7.0).all())
    res = {}
    for dev, world in (("cuda", w), ("cpu", worlds[1])):
        r = [torch.from_numpy(a).to(dev) for a in _rays((48 * 64,), 7)]
        res[dev] = wavefront.trace(None, None, ecfg.world, ecfg.render, *r,
                                   table=world.trace_table,
                                   sky_y=world.sky_y)
    for f in ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t"):
        assert _bits_equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f


@pytest.mark.parametrize("slim", [False, True], ids=["carried", "slim"])
@pytest.mark.parametrize("edges", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_zedges_trace_supersteps_matches_plain_state(cuda, worlds, edges,
                                                     slim):
    """K1's ZEDGES variants (one launch) on slab 1 of the world cut into 4
    z-slabs: all 11 state arrays and ``steps`` bit-equal to the plain
    loop's, rays leaving through each interior face; the traces' fields
    and ``exit_dir`` equal the CPU's."""
    from rvgrt_tpu_torch.parallel import volume

    ecfg = _ecfg(**CADENCES["bench"], slim_carry=slim)
    lcfg = volume.local_config(ecfg.world, 4)
    res = {}
    for dev, world in (("cuda", worlds[0]), ("cpu", worlds[1])):
        table = volume.slab_table(world.bits, world.sdf, ecfg.world, 4, 1)
        r = [torch.from_numpy(a).to(dev) for a in _rays((48 * 64,), 11)]
        r[2] = r[2] * 0.25  # origins in the slab's 16 cells of depth
        if dev == "cuda":
            s, dirs = wavefront.start_state(lcfg, *r, sky_y=world.sky_y,
                                            z_edges=edges)
            sp = {k: v.clone() for k, v in s.items()}
            want = superstep_kernel.trace_plain(
                lcfg, ecfg.render, table, dirs, sp, sky_y=world.sky_y,
                z_edges=edges)
            n0 = superstep_kernel.zedges_slim_launches if slim \
                else superstep_kernel.zedges_launches
            got = superstep_kernel.trace_supersteps(
                lcfg, ecfg.render, table, dirs, s, sky_y=world.sky_y,
                z_edges=edges)
            n1 = superstep_kernel.zedges_slim_launches if slim \
                else superstep_kernel.zedges_launches
            assert n1 - n0 == 1
            assert int(got) == int(want) > 5
            for k in wavefront.STATE_KEYS:
                assert _bits_equal(s[k], sp[k]), k
        res[dev] = wavefront.trace(None, None, lcfg, ecfg.render, *r,
                                   table=table, sky_y=world.sky_y,
                                   z_edges=edges)
    for f in ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t", "exit_dir"):
        assert _bits_equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f
    ed = res["cpu"].exit_dir
    assert bool((ed < 0).any()) != edges[0]
    assert bool((ed > 0).any()) != edges[1]


def _fan():
    """``tests/test_trace.py``'s straggler fan: 128 x 128 = 4 x 4096 rays
    from an open-air spot of the 64^3 world, where the respite engages."""
    h = w = 128
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = -0.6 + 1.4 * (xs / w)
    dy = 0.55 - 1.3 * (ys / h)
    dz = -0.6 + 1.4 * (ys / h)
    n_ = np.sqrt(dx * dx + dy * dy + dz * dz + 1e-8)
    z = np.zeros((h, w), np.float32)
    return [np.ascontiguousarray(a, np.float32)
            for a in (z + 47.5, z + 36.0, z + 32.5, dx / n_, dy / n_,
                      dz / n_, z)]


def test_trace_makes_no_host_read(cuda, worlds):
    """``wavefront.trace`` on a CUDA table runs under
    ``set_sync_debug_mode("error")``: no host read anywhere on its path,
    for a one-phase trace (one K1 launch) and for a trace that engages the
    two-phase respite (two launches, the compaction on the device)."""
    one = _ecfg(**CADENCES["bench"])
    two = _ecfg(**CADENCES["bench"], straggler_budget=12)
    w = worlds[0]
    cases = [(one, [torch.from_numpy(a).to(cuda)
                    for a in _rays((24, 32), 3)], 1),
             (two, [torch.from_numpy(a).to(cuda) for a in _fan()], 2)]
    for ecfg, rays, launched in cases:
        # a first trace builds and loads the kernel library outside the
        # check
        wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                        table=w.trace_table, sky_y=w.sky_y)
        n0 = superstep_kernel.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = wavefront.trace(None, None, ecfg.world, ecfg.render, *rays,
                                  table=w.trace_table, sky_y=w.sky_y)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert superstep_kernel.launches == n0 + launched
        assert bool(res.hit.any())


#: two-phase traces of the fan: (budget, cap fraction, render extras)
RESPITE_CASES = {
    "b12_f0.25": (12, 0.25, {}),
    "b4_f1.0": (4, 1.0, {}),
    "tiny_cap": (5, 1e-6, dict(steps_per_check=2)),
}


@pytest.mark.parametrize("case", list(RESPITE_CASES))
def test_respite_trace_gpu_matches_cpu(cuda, worlds, case):
    """The two-phase trace on the card equals its CPU run bit for bit, on
    every traced field, ``degraded``, ``exit_dir`` and ``steps``: two K1
    launches, each phase one trace."""
    budget, frac, extra = RESPITE_CASES[case]
    ecfg = _ecfg(**{**CADENCES["bench"], **extra}, straggler_budget=budget,
                 straggler_cap_frac=frac)
    res = {}
    for w in worlds:
        dev = w.bits.device
        rays = [torch.from_numpy(a).to(dev) for a in _fan()]
        n0 = superstep_kernel.launches
        wavefront.reset_stats()
        res[dev.type] = wavefront.trace(None, None, ecfg.world, ecfg.render,
                                        *rays, table=w.trace_table,
                                        sky_y=w.sky_y)
        stats = wavefront.read_stats()
        assert stats["traces"] == 2 and stats["respites"] == 1
        assert superstep_kernel.launches - n0 == 2 * (dev.type == "cuda")
    for f in ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t", "exit_dir", "steps", "degraded"):
        assert _bits_equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f
    assert bool(res["cpu"].degraded.any()) == (case == "tiny_cap")


@pytest.mark.parametrize("rate", ["checker", "quarter"])
def test_rate_cut_frame_gpu_matches_cpu(cuda, worlds, rate):
    """A checkerboard (parity 1) and a quarter-rate (phase 3) frame of the
    64^3 world at 128x80 with the headline's settings, base and GI
    composite, on the card against the CPU: the same hits, >= 50 dB."""
    from rvgrt_tpu_torch.render import pipeline
    from rvgrt_tpu_torch.scene.camera import Camera

    ecfg = dataclasses.replace(
        _ecfg(**CADENCES["bench"], width=128, height=80, prepass_divisor=8,
              shadow_site_divisor=4, gi_res_divisor=16),
        lighting=dataclasses.replace(tcfg.LightingConfig(),
                                     soft_shadows=True,
                                     soft_shadow_stride=2))
    fwd = np.array([0.25, -0.18, -1.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right).astype(np.float32)
    cam = Camera(pos=np.array([30.0, 44.0, 60.0], np.float32), forward=fwd,
                 right=right, up=up)
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0], vp[1, 1], vp[2, 3], vp[3, 2] = 1.1, 1.7, -1.0, -0.2
    kw = (dict(checker_parity=1) if rate == "checker"
          else dict(quarter_phase=3))
    got = {}
    for w in worlds:
        dev = w.bits.device
        ca = engine.camera_arrays(cam, vp, vp, (0.0021, -0.0034), 0.25,
                                  device=dev)
        out, gb = pipeline.render_frame(
            w.bits, w.sdf, w.gi, w.atlas, ca, ecfg, include_gi=False,
            sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True, **kw)
        comp = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg)
        got[dev.type] = (gb.hit.cpu(), comp.cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    assert 0.05 < float(got["cpu"][0].float().mean()) < 0.95
    mse = float(((got["cuda"][1].double() - got["cpu"][1].double()) ** 2)
                .mean())
    assert mse == 0.0 or 10.0 * np.log10(1.0 / mse) >= 50.0


def test_warp_kernel_matches_plain(cuda):
    rng = np.random.default_rng(21)
    hh, hw = 64, 512
    packed = rng.integers(0, 2 ** 32, (hh, hw),
                          dtype=np.uint64).astype(np.uint32)
    xs = (np.arange(hw, dtype=np.float32)[None, :] * 0.97
          + rng.random((hh, hw), np.float32) * 3).clip(0, hw - 1)
    ys = (np.arange(hh, dtype=np.float32)[:, None] * 0.6
          + rng.random((hh, hw), np.float32) * 2).clip(0, hh - 1)
    args = (u32.from_numpy(packed, cuda),
            torch.from_numpy(xs.astype(np.float32)).to(cuda),
            torch.from_numpy(ys.astype(np.float32)).to(cuda))
    n0 = warp_kernels.launches
    got, ovf = warp_kernels.warp_packed_bilinear(*args)
    assert warp_kernels.launches == n0 + 1 and int(ovf) == 0
    want, _ = warp_kernels.warp_packed_bilinear_plain(*args)
    assert got.shape == (4, hh, hw)
    assert float((got - want).abs().max()) <= 1e-6


#: the cases of test_minconv_kernel_matches_plain: (Z, Y, X) shape, axis,
#: cap, input.  "full" is full-range u8, "sparse" mostly cap with a few
#: near distances, "world" the 64^3 world's own first-pass field.  Caps up
#: to 181 run the kernel's u16 loop, 182 and 255 its 32-bit loop; a block
#: covers 64 columns and 128 rows.
MINCONV_CASES = {
    "world_axis1": ((32, 32, 32), 1, 64, "world"),
    "world_axis0": ((32, 32, 32), 0, 64, "world"),
    "cap1": ((3, 150, 100), 1, 1, "full"),
    "cap64": ((3, 150, 100), 1, 64, "full"),
    "cap66": ((3, 150, 100), 1, 66, "full"),
    "cap182": ((3, 150, 100), 1, 182, "full"),
    "cap255": ((3, 150, 100), 1, 255, "full"),
    "cap255_axis0": ((150, 3, 40), 0, 255, "full"),
    "n_below_cap": ((4, 40, 70), 1, 64, "sparse"),
    "n1": ((5, 1, 33), 1, 64, "full"),
    "inner1": ((6, 45, 1), 1, 66, "sparse"),
    "inner_ragged": ((2, 300, 130), 1, 64, "sparse"),
    "odd_inner": ((3, 50, 7), 1, 182, "full"),
    "axis0_inner_yx": ((40, 12, 10), 0, 64, "sparse"),
    "odd_address": ((4, 33, 20), 1, 64, "full"),
    # rows of 16-byte multiples: the staging's 16-byte loads
    "cap64_inner_x16": ((3, 150, 96), 1, 64, "full"),
    "cap255_inner_x16": ((2, 90, 48), 1, 255, "full"),
    "cap182_axis0_x16": ((70, 4, 8), 0, 182, "full"),
}


@pytest.mark.parametrize("case", list(MINCONV_CASES))
def test_minconv_kernel_matches_plain(cuda, request, case):
    """K3 equals its plain version bit for bit, in one launch."""
    shape, axis, cap, kind = MINCONV_CASES[case]
    if kind == "world":
        cfg = tcfg.WorldConfig().with_cube(6)
        coarse = voxel_grid.coarse_occupancy(
            request.getfixturevalue("worlds")[0].bits, cfg)
        vol = sdf._axis_distance_1d(coarse, axis=2, cap=cfg.sdf_max_dist)
        assert tuple(vol.shape) == shape
    else:
        rng = np.random.default_rng(sum(map(ord, case)))
        d = rng.integers(0, 256, shape).astype(np.uint8)
        if kind == "sparse":
            d = np.minimum(d, cap)
            d[rng.random(shape) < 0.9] = cap
        vol = torch.from_numpy(d).to(cuda)
        if case == "odd_address":  # a contiguous view one byte in
            buf = torch.empty(vol.numel() + 1, dtype=torch.uint8,
                              device=cuda)
            buf[1:].copy_(vol.reshape(-1))
            vol = buf[1:].view(shape)
            assert vol.data_ptr() % 2 == 1
    n0 = sdf_kernels.launches
    got = sdf_kernels.minconv_pass(vol, axis=axis, cap=cap)
    assert sdf_kernels.launches == n0 + 1
    want = sdf_kernels.minconv_pass_plain(vol, axis=axis, cap=cap)
    assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor the kernel does not take raises: no fallback."""
    with pytest.raises(ValueError):
        sdf_kernels.minconv_pass(torch.zeros(4, 4, 4, device=cuda), 2, 64)
    with pytest.raises(ValueError):
        sdf_kernels.minconv_pass(torch.zeros(4, 4, 4, device=cuda), 1, 64)
    with pytest.raises(ValueError):
        sdf_kernels.minconv_pass(
            torch.zeros(4, 4, 4, dtype=torch.uint8, device=cuda), 1, 256)
    with pytest.raises(ValueError):
        warp_kernels.warp_packed_bilinear(
            torch.zeros(8, 8, dtype=torch.int32, device=cuda),
            torch.zeros(8, 4, device=cuda), torch.zeros(8, 4, device=cuda))
    with pytest.raises(ValueError):
        gather_kernels.take_clip(
            torch.zeros(8, dtype=torch.int32, device=cuda),
            torch.zeros(8, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        gather_kernels.take_along_cols(
            torch.zeros(8, 4, dtype=torch.int32, device=cuda),
            torch.zeros(8, 3, dtype=torch.int32, device=cuda))


#: the cases of the gather kernels: (table words, index shape, spread of
#: the indices beyond [0, n), options); 37 x 128 lanes is no multiple of
#: a block's 1024 lanes, 8192 x 128 is the probe's shape.  Options:
#: ``offset`` indices in a view 4 B past an aligned address (the scalar
#: path), ``cols`` P2's row width, ``threshold`` the table's words past the
#: on-chip variant's largest (``None`` for n: the card sets it)
GATHER_CASES = {
    "tiny": (5, (3, 7), 4, {}),
    "ragged": (1000, (37, 128), 300, {}),
    "probe": (8 * (1 << 20) // 4, (8192, 128), 1000, {}),
    **{f"lanes_mod8_{k}": (1 << 21, (8192 * 128 + k,), 1000, {})
       for k in range(1, 8)},
    "index_offset_4B": (1 << 21, (8192, 128), 1000, dict(offset=True)),
    "cols_7": (16384 * 7, (149797, 7), 1000, dict(cols=7)),
    **{f"threshold_{d:+d}_word": (None, (8192, 128), 1000,
                                  dict(threshold=d)) for d in (-1, 0, 1)},
}


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a contiguous view 4 B past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    out = buf[1:].view(t.shape)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_kernels_match_plain(cuda, case):
    """P1 and P2 equal their plain versions bit for bit, one launch each,
    indices outside the table included; through the path the wrapper
    plans, the L2 path with each hint variant, and the on-chip variant
    where the table fits it (a ValueError where it does not)."""
    n, shape, beyond, opt = GATHER_CASES[case]
    if n is None:
        smem = gather_kernels.gather_limits(cuda)[0]["smem_optin"]
        n = gather_kernels.on_chip_words_max(smem) + opt["threshold"]
    rng = np.random.default_rng(sum(map(ord, case)))
    tbl = u32.from_numpy(rng.integers(0, 2 ** 32, n, dtype=np.uint64)
                         .astype(np.uint32), cuda)
    idx = torch.from_numpy(rng.integers(-beyond, n + beyond, shape)
                           .astype(np.int32)).to(cuda)
    if opt.get("offset"):
        idx = _offset_view(idx)
    smem = gather_kernels.gather_limits(cuda)[0]["smem_optin"]

    def check(kernel, plain, args, words):
        want = plain(*args)
        name = kernel.__name__.replace("_cuda", "_launches")
        n0 = getattr(gather_kernels, name)
        got = kernel(*args)
        assert getattr(gather_kernels, name) == n0 + 1
        assert torch.equal(got, want)
        for hints in (0, 1, 2, 3):
            assert torch.equal(kernel(*args, hints=hints, on_chip=False),
                               want)
        if gather_kernels.on_chip_slice(words, smem) and \
                args[0].data_ptr() % 16 == 0:
            assert torch.equal(kernel(*args, on_chip=True), want)
        else:
            with pytest.raises(ValueError):
                kernel(*args, on_chip=True)

    if "cols" not in opt:
        check(gather_kernels.take_clip_cuda, gather_kernels.take_clip_plain,
              (tbl, idx), n)
        # the L2 path under an L2 access-policy window (the probe's
        # measurement), half the table persisting
        gather_kernels.set_persisting_l2(1 << 20)
        try:
            got = gather_kernels.take_clip_l2(tbl, idx, 4 * n, 0.5)
        finally:
            gather_kernels.set_persisting_l2(0)
        assert torch.equal(got, gather_kernels.take_clip_plain(tbl, idx))
    cols = opt.get("cols", 128)
    if n < cols or idx.ndim != 2 or idx.shape[1] != cols:
        return
    t2, i2 = gather_kernels.tala_inputs(tbl, idx, cols)
    rows = t2.shape[0]
    wild = torch.remainder(idx, 4 * rows + 3) - (2 * rows + 1)
    for ix in (i2, wild.to(torch.int32)):  # the probe's i2; wrap and fill
        if opt.get("offset"):
            ix = _offset_view(ix)
        check(gather_kernels.take_along_cols_cuda,
              gather_kernels.take_along_cols_plain, (t2, ix), t2.numel())


def test_traced_gi_init_gpu_matches_cpu(cuda, worlds):
    """The traced GI init (K1) gives the CPU's words, at stride 1 and 2."""
    ecfg = dataclasses.replace(_ecfg(), gi_init_mode="traced")
    for stride in ((1, 1), (2, 2)):
        got = {}
        for w in worlds:
            got[w.bits.device.type] = gi_update.init_gi_strided(
                w.bits, w.sdf, ecfg, sky_y=w.sky_y, table=w.trace_table,
                stride=stride).cpu()
        assert torch.equal(got["cuda"], got["cpu"]), stride
