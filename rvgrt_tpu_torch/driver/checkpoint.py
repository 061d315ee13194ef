"""Checkpoint / resume.

The port of ``rvgrt_tpu/driver/checkpoint.py``.  The reference has none
(SURVEY.md §5.4): the world regenerates deterministically from the pure
noise function at every launch (``State.cpp:44-54``), and (config, seed) ->
identical world stays the primary checkpoint.  This module serialises what
the reference lacked: the world arrays (so big worlds skip the rebuild),
the evolving GI radiance cache, the engine's frame counters, and the learned
upscaler's parameters.

The formats are the JAX package's, so that a file written by either package
loads in the other: a world is one ``.npz`` (``meta`` JSON bytes, ``bits``,
``sdf``, ``gi``, ``atlas``), parameters a pickle of a tree of numpy arrays
(flax's layout, ``upscale/model.params_to_flax``).  Every write is atomic
(a temporary file, then a rename).
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile

import numpy as np

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.utils.device import resolve_device

FORMAT_VERSION = 1


def _atomic_write(path: str, write_fn):
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_world(path: str, world, ecfg: EngineConfig,
               frame_count: int = 0, gi_offset: int = 0) -> None:
    """Serialise the world (``engine.World``) and the engine's counters;
    only its four arrays come to the host (the derived ones are not
    stored)."""
    meta = dict(
        version=FORMAT_VERSION,
        shift_x=ecfg.world.shift_x,
        shift_y=ecfg.world.shift_y,
        shift_z=ecfg.world.shift_z,
        frame_count=frame_count,
        gi_offset=gi_offset,
    )

    def write(f):
        np.savez_compressed(
            f,
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            bits=u32.to_numpy(world.bits),
            sdf=world.sdf.detach().cpu().numpy(),
            gi=u32.to_numpy(world.gi), atlas=u32.to_numpy(world.atlas))

    _atomic_write(path, write)


def load_world(path: str, ecfg: EngineConfig, device=None):
    """Load a world checkpoint onto ``device``; its dimensions must be the
    config's.  ``sky_y`` and ``trace_table`` are derived again
    (``voxel_grid.sky_limit``, ``wavefront.make_trace_table``), and so is
    ``gi_occ`` (``gi_grid.build_occlusion``) when the config sets
    ``gi_fused_cone``.

    Returns (World, frame_count, gi_offset)."""
    from rvgrt_tpu_torch.driver.engine import world_from_numpy
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.world import gi_grid, voxel_grid

    dev = resolve_device(device)
    with np.load(path) as d:
        meta = json.loads(bytes(d["meta"]).decode())
        assert meta["version"] == FORMAT_VERSION, meta
        for k in ("shift_x", "shift_y", "shift_z"):
            assert meta[k] == getattr(ecfg.world, k), (
                f"checkpoint {k}={meta[k]} != config {getattr(ecfg.world, k)}")
        world = world_from_numpy({k: d[k] for k in ("bits", "sdf", "gi",
                                                     "atlas")}, device=dev)
    if ecfg.render.gi_fused_cone:
        world.gi_occ = gi_grid.build_occlusion(world.sdf, ecfg.world)
    world.sky_y = voxel_grid.sky_limit(world.bits, ecfg.world)
    world.trace_table = wavefront.make_trace_table(world.bits, world.sdf,
                                                   ecfg.world)
    return world, int(meta["frame_count"]), int(meta["gi_offset"])


def save_params(path: str, params) -> None:
    """Upscaler (or any) parameters: a tree of numpy arrays
    (``model.params_to_flax``), pickled."""
    _atomic_write(path, lambda f: pickle.dump(params, f))


def load_params(path: str):
    """The tree of a parameter pickle.  numpy >= 2 pickles arrays by
    ``numpy._core`` (the committed checkpoints too), which numpy 1.x cannot
    read."""
    with open(path, "rb") as f:
        return pickle.load(f)
