"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

K1 (tracer superstep), K2 (history warp) and K3 (SDF min-plus pass) at small
shapes: a 64^3 world built by the port, random rays, a random packed
history.  Every test here needs a CUDA GPU and skips without one (a CUDA
kernel has no interpret mode).  The file imports neither jax nor the JAX
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
from rvgrt_tpu_torch.ops import sdf_kernels, superstep_kernel, warp_kernels
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


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trace_launches_k1_whatever_the_setting(cuda, worlds, fused):
    """On the GPU every superstep of ``trace`` is one K1 launch, with
    ``fused_superstep`` off (the config's default) as with it on, and the
    traced fields equal the CPU trace's."""
    ecfg = _ecfg(fused_superstep=fused, **CADENCES["bench"])
    rng = np.random.default_rng(11)
    shape = (24, 32)
    o = rng.uniform(2.0, 62.0, (3,) + shape).astype(np.float32)
    d = rng.normal(size=(3,) + shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True).astype(np.float32)
    t0 = rng.uniform(0.0, 6.0, shape).astype(np.float32)
    res = {}
    for w in worlds:
        dev = w.bits.device
        rays = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (*o, *d, t0)]
        n0, s0 = superstep_kernel.launches, wavefront.stats["supersteps"]
        res[dev.type] = wavefront.trace(None, None, ecfg.world, ecfg.render,
                                        *rays, table=w.trace_table,
                                        sky_y=w.sky_y)
        ran = wavefront.stats["supersteps"] - s0
        assert ran > 0
        assert superstep_kernel.launches - n0 == (ran if dev.type == "cuda"
                                                  else 0)
    for f in ("hit", "px", "py", "pz", "nx", "ny", "nz", "uv_u", "uv_v",
              "its", "t"):
        assert _bits_equal(getattr(res["cuda"], f).cpu(),
                           getattr(res["cpu"], f)), f


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


@pytest.mark.parametrize("axis", [0, 1])
def test_minconv_kernel_matches_plain(cuda, worlds, axis):
    """K3 on random distances and on the world's real first-pass field."""
    rng = np.random.default_rng(5 + axis)
    d = rng.integers(0, 65, (8, 40, 24)).astype(np.uint8)
    d[rng.random(d.shape) < 0.9] = 64
    cfg = tcfg.WorldConfig().with_cube(6)
    coarse = voxel_grid.coarse_occupancy(worlds[0].bits, cfg)
    real = sdf._axis_distance_1d(coarse, axis=2, cap=cfg.sdf_max_dist)
    for vol in (torch.from_numpy(d).to(cuda), real):
        n0 = sdf_kernels.launches
        got = sdf_kernels.minconv_pass(vol, axis=axis, cap=64)
        assert sdf_kernels.launches == n0 + 1
        want = sdf_kernels.minconv_pass_plain(vol, axis=axis, cap=64)
        assert torch.equal(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor the kernel does not take raises: no fallback."""
    with pytest.raises(ValueError):
        sdf_kernels.minconv_pass(torch.zeros(4, 4, 4, device=cuda), 2, 64)
    with pytest.raises(ValueError):
        sdf_kernels.minconv_pass(torch.zeros(4, 4, 4, device=cuda), 1, 64)
    with pytest.raises(ValueError):
        warp_kernels.warp_packed_bilinear(
            torch.zeros(8, 8, dtype=torch.int32, device=cuda),
            torch.zeros(8, 4, device=cuda), torch.zeros(8, 4, device=cuda))
