"""Parity of the port's world build with the JAX package, on the CPU.

Config presets, noise/terrain, voxel words, the SDF (kernel K3's plain
version), the trace table, the sky limit and the heightfield GI init must
be bit-exact.  The JAX side runs in a child process without FMA
contraction (tests/torch_jaxref.py).  Also: the port imports neither jax
nor rvgrt_tpu, and its entry points refuse to run without a GPU unless
given device="cpu".
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from rvgrt_tpu import config as jcfg
from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.core import noise, terrain, u32
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.ops import sdf_kernels
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.upscale import temporal
from rvgrt_tpu_torch.world import voxel_grid
from tests import torch_jaxref as ref

WORLDS = {"32^3": {"cube": 5}, "64^3": {"cube": 6},
          "64x32x128": {"world": dict(shift_x=6, shift_y=5, shift_z=7)}}
HEAD = ref.SLICE_SPEC


def _noise_inputs():
    rng = np.random.default_rng(11)
    n = 4096
    x = rng.uniform(-300, 300, n).astype(np.float32)
    y = rng.uniform(-40, 300, n).astype(np.float32)
    z = rng.uniform(-300, 300, n).astype(np.float32)
    i, j, k = (rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
               .astype(np.int32) for _ in range(3))
    return dict(x=x, y=y, z=z, i=i, j=j, k=k)


@pytest.fixture(scope="module")
def jax_ref():
    jobs = [("ref_noise", _noise_inputs())]
    jobs += [("ref_generate", {"spec": s}) for s in WORLDS.values()]
    jobs += [("ref_world", {"spec": HEAD})]
    res = ref.run(jobs)
    return dict(noise=res[0], words=dict(zip(WORLDS, res[1:1 + len(WORLDS)])),
                world=res[-1])


@pytest.mark.parametrize("preset", ["config_stage1", "config_stage2",
                                    "config_stage3", "config_stage4",
                                    "config_stage5", "config_reference"])
def test_config_presets_match(preset):
    a = dataclasses.asdict(getattr(jcfg, preset)())
    b = dataclasses.asdict(getattr(tcfg, preset)())
    assert a == b
    getattr(tcfg, preset)().world.validate()


def test_config_defaults_and_derived_sizes_match():
    a, b = jcfg.EngineConfig(), tcfg.EngineConfig()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for w_j, w_t in ((a.world, b.world),
                     (jcfg.WorldConfig().with_cube(10),
                      tcfg.WorldConfig().with_cube(10))):
        for prop in ("num_words", "sdf_num_cells", "gi_num_cells"):
            assert getattr(w_j, prop) == getattr(w_t, prop)
    assert a.gi_window == b.gi_window


@pytest.mark.parametrize("fn", ["hash3", "hash2", "simplex2d", "simplex3d",
                                "fbm2d", "fbm3d", "density"])
def test_noise_and_terrain_bit_exact(jax_ref, fn):
    inp = {k: torch.from_numpy(v) for k, v in _noise_inputs().items()}
    x, y, z = inp["x"], inp["y"], inp["z"]
    got = {
        "hash3": lambda: u32.to_numpy(noise.hash3(inp["i"], inp["j"],
                                                  inp["k"])),
        "hash2": lambda: u32.to_numpy(noise.hash2(inp["i"], inp["j"])),
        "simplex2d": lambda: noise.simplex2d(x, z).numpy(),
        "simplex3d": lambda: noise.simplex3d(x, y, z).numpy(),
        "fbm2d": lambda: noise.fbm2d(x, z, 5, 0.01, 2.0, 0.5).numpy(),
        "fbm3d": lambda: noise.fbm3d(x, y, z, 4, 0.02, 2.1, 0.45).numpy(),
        "density": lambda: terrain.evaluate_density(x, y, z).numpy(),
    }[fn]()
    want = jax_ref["noise"][fn]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(WORLDS))
def test_voxel_words_bit_exact(jax_ref, name):
    cfg = ref.make_ecfg(tcfg, WORLDS[name]).world
    got = u32.to_numpy(voxel_grid.generate(cfg, device="cpu"))
    np.testing.assert_array_equal(got, jax_ref["words"][name])


def test_voxel_words_multi_chunk(jax_ref):
    """Many small chunks give the words of one chunk (and of JAX)."""
    cfg = ref.make_ecfg(tcfg, WORLDS["64x32x128"]).world
    got = voxel_grid.generate(cfg, device="cpu", chunk_words=1000)
    np.testing.assert_array_equal(u32.to_numpy(got),
                                  jax_ref["words"]["64x32x128"])


@pytest.mark.parametrize("op", ["lsr_int", "lsr_tensor", "shl_tensor", "lt",
                                "to_f32"])
def test_u32_helpers_match_numpy_uint32(op):
    """The int32-carried u32 steps give numpy's uint32 results."""
    rng = np.random.default_rng(17)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 0x7FFFFFFF, 0x80000000]
    b[:4] = [0xFFFFFFFF, 0, 0x80000000, 0x7FFFFFFF]
    k = rng.integers(0, 32, 4096).astype(np.int32)
    k[:2] = [0, 31]
    ta, tb, tk = u32.from_numpy(a), u32.from_numpy(b), torch.from_numpy(k)
    if op == "lsr_int":
        for s in (0, 1, 8, 24, 31):
            np.testing.assert_array_equal(u32.to_numpy(u32.lsr(ta, s)),
                                          a >> np.uint32(s))
    elif op == "lsr_tensor":
        np.testing.assert_array_equal(u32.to_numpy(u32.lsr(ta, tk)),
                                      a >> k.astype(np.uint32))
    elif op == "shl_tensor":
        np.testing.assert_array_equal(u32.to_numpy(u32.shl(ta, tk)),
                                      a << k.astype(np.uint32))
    elif op == "lt":
        np.testing.assert_array_equal(u32.lt(ta, tb).numpy(), a < b)
    else:
        np.testing.assert_array_equal(u32.to_f32(ta).numpy(),
                                      a.astype(np.float32))
    assert u32.c(0xFFFFFFFF) == -1 and u32.c(0x7FFFFFFF) == 2 ** 31 - 1


def test_unpack_inverts_pack():
    rng = np.random.default_rng(2)
    solid = torch.from_numpy(rng.random((3, 5, 64)) < 0.4)
    words = voxel_grid.pack_bits_x(solid)
    assert torch.equal(voxel_grid.unpack_bits_x(words), solid)


def test_sdf_bit_exact_vs_sdf_phase_fn(jax_ref):
    w = jax_ref["world"]
    cfg = ref.make_ecfg(tcfg, HEAD).world
    bits = u32.from_numpy(w["bits"])
    coarse = voxel_grid.coarse_occupancy(bits, cfg)
    np.testing.assert_array_equal(coarse.numpy(), w["coarse"])
    got = engine._sdf_phase_fn(bits, cfg)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), w["sdf"])


@pytest.mark.parametrize("axis", [0, 1])
def test_minconv_plain_matches_jax_pass(axis):
    """K3's plain version equals the JAX ``_minconv_pass`` (run in
    process: a single eager pass has no multiply-add to contract)."""
    import jax.numpy as jnp

    from rvgrt_tpu.world import sdf as jsdf

    rng = np.random.default_rng(5 + axis)
    d = rng.integers(0, 65, (8, 40, 24)).astype(np.uint8)
    d[rng.random(d.shape) < 0.9] = 64
    want = np.asarray(jsdf._minconv_pass(jnp.asarray(d), axis=axis, cap=64))
    got = sdf_kernels.minconv_pass(torch.from_numpy(d), axis=axis, cap=64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_trace_table_word_for_word(jax_ref):
    w = jax_ref["world"]
    cfg = ref.make_ecfg(tcfg, HEAD).world
    got = wavefront.make_trace_table(u32.from_numpy(w["bits"]),
                                     torch.from_numpy(w["sdf"]), cfg)
    np.testing.assert_array_equal(u32.to_numpy(got), w["trace_table"])


def test_sky_limit_and_column_height(jax_ref):
    w = jax_ref["world"]
    cfg = ref.make_ecfg(tcfg, HEAD).world
    bits = u32.from_numpy(w["bits"])
    assert float(voxel_grid.sky_limit(bits, cfg)) == float(w["sky_y"])
    np.testing.assert_array_equal(
        voxel_grid.column_height(bits, cfg).numpy(), w["height"])


def test_init_gi_heightfield_words(jax_ref):
    w = jax_ref["world"]
    ecfg = ref.make_ecfg(tcfg, HEAD)
    got = gi_update.init_gi_heightfield(u32.from_numpy(w["bits"]), ecfg)
    np.testing.assert_array_equal(u32.to_numpy(got), w["gi"])


def test_build_world_matches_and_round_trips(jax_ref):
    want = {k: v for k, v in jax_ref["world"].items()
            if k not in ("coarse", "height")}
    world = engine.build_world(ref.make_ecfg(tcfg, HEAD), verbose=False,
                               device="cpu")
    got = engine.world_to_numpy(world)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    again = engine.world_to_numpy(engine.world_from_numpy(want,
                                                          device="cpu"))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


ENTRY_POINTS = {
    "build_world": lambda: engine.build_world(
        ref.make_ecfg(tcfg, HEAD), verbose=False),
    "Engine": lambda: engine.Engine(ref.make_ecfg(tcfg, HEAD),
                                    verbose=False),
    "init_state": lambda: temporal.init_state(8, 8),
    "generate": lambda: voxel_grid.generate(tcfg.WorldConfig().with_cube(5)),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_refuse_cpu_without_device(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_port_imports_neither_jax_nor_rvgrt_tpu():
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "rvgrt_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "rvgrt_tpu", "flax", "optax"):
                    bad.append(f"{f.relative_to(root)}: {n}")
    assert not bad, bad
