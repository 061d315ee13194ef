"""Cross-slice scaling: a 2-D ('slice', 'chip') mesh tier.

The port of ``rvgrt_tpu/parallel/multislice.py`` on ``torch.distributed``.
``sharding.py`` adds the within-slice pixel axis and ``volume.py`` the
z-slab volume ring; this module composes them over two mesh axes,
following the bandwidth hierarchy of the JAX package (TPU slices joined by
data-center network):

* the slow ``slice`` axis carries only embarrassingly parallel traffic: the
  frame's pixel rows are banded across slices, so what crosses it is the
  assembly of image bands, once a frame;
* the fast ``chip`` axis carries either nothing (the world replicated per
  device, rows further split - ``render_frame_multislice``) or the
  ray-handoff ring of the z-slab volume shards
  (``render_frame_multislice_volume``: each slice holds one whole copy of
  the world split across its devices; slices render different row bands).

The JAX package prefers ``mesh_utils.create_hybrid_device_mesh``, which
places the ``slice`` axis on the data-center network; torch has no
counterpart, so ``make_mesh2d`` reshapes the ranks slice-major (ranks
``s * chips .. (s + 1) * chips - 1`` form slice ``s``), the JAX fallback's
order.  Outputs are assembled over ``chip`` first, then ``slice``.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.parallel import sharding, volume
from rvgrt_tpu_torch.parallel.sharding import _gather_frame, _gather_rows
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.render.pipeline import CameraArrays, FrameOutputs

_AXES = ("chip", "slice")  # assembly order: the innermost axis first


def make_mesh2d(n_slices: int, chips_per_slice: int | None = None,
                device_type: str = "cuda") -> DeviceMesh:
    """('slice', 'chip') mesh over the caller's process group, slice-major
    (see the module docstring on placement)."""
    if chips_per_slice is None:
        n = dist.get_world_size()
        assert n % n_slices == 0, (n, n_slices)
        chips_per_slice = n // n_slices
    return init_device_mesh(device_type, (n_slices, chips_per_slice),
                            mesh_dim_names=("slice", "chip"))


def _linear(mesh: DeviceMesh) -> tuple[int, int, int]:
    """(this rank's slice-major index, slices, chips a slice)."""
    ns, nc = mesh.size(0), mesh.size(1)
    si = mesh.get_local_rank("slice")
    ci = mesh.get_local_rank("chip")
    return si * nc + ci, ns, nc


def render_frame_multislice(bits, sdf, gi, atlas, cam: CameraArrays,
                            ecfg: EngineConfig, mesh: DeviceMesh,
                            include_gi: bool = True, sky_y=None,
                            table=None) -> FrameOutputs:
    """Pixel-parallel rendering over a ('slice', 'chip') mesh: rows banded
    over ``slice``, each band split over ``chip``, the world replicated;
    every rank returns the assembled FrameOutputs."""
    r, ns, nc = _linear(mesh)
    h = ecfg.render.height
    assert h % (2 * ns * nc) == 0, (h, ns, nc)
    slab_h = h // (ns * nc)
    gi_occ, sky_y, table = sharding._world_defaults(bits, sdf, ecfg, None,
                                                    sky_y, table)
    out = pipeline.render_slab(bits, sdf, gi, atlas, cam, ecfg,
                               y0=r * slab_h, slab_h=slab_h,
                               include_gi=include_gi, gi_occ=gi_occ,
                               sky_y=sky_y, table=table)
    return _gather_frame(out, mesh, _AXES)


def temporal_upscale_multislice(color, motion, jitter_ndc, packed,
                                mesh: DeviceMesh,
                                warp_taps: str = "bilinear_shift"):
    """3x temporal super-resolution with display rows banded over both mesh
    axes; see ``sharding.temporal_upscale_sharded`` for the state
    contract."""
    r, ns, nc = _linear(mesh)
    out, pk = sharding._upscale_slab(color, motion, jitter_ndc, packed, r,
                                     ns * nc, warp_taps)
    for axis in _AXES:
        out = _gather_rows(out, mesh, axis)
        pk = _gather_rows(pk, mesh, axis)
    return out, pk


def render_frame_multislice_volume(tables, sdf_replicated, gi, atlas,
                                   cam: CameraArrays, ecfg: EngineConfig,
                                   mesh: DeviceMesh, include_gi: bool = True,
                                   sky_y=None, rounds: int | None = None,
                                   handoff_cap: int | None = None
                                   ) -> FrameOutputs:
    """The streaming shape across slices: each slice's devices hold the
    world as z-slabs (the ray ring over ``chip``); slices render disjoint
    row bands (assembled over ``slice``).  ``tables``: this rank's slab,
    from ``volume.build_shard_tables(..., mesh, axis="chip")``."""
    ns = mesh.size(0)
    rcfg = ecfg.render
    h = rcfg.height
    assert h % (2 * ns) == 0, (h, ns)
    band_h = h // ns
    trace_fn = volume.ring_trace_fn(tables, ecfg.world, rcfg, mesh, "chip",
                                    sky_y=sky_y, rounds=rounds,
                                    handoff_cap=handoff_cap)
    out = pipeline.render_slab(
        None, sdf_replicated, gi, atlas, cam, ecfg,
        y0=mesh.get_local_rank("slice") * band_h, slab_h=band_h,
        include_gi=include_gi, sky_y=sky_y, trace_fn=trace_fn)
    return _gather_frame(out, mesh, ("slice",))


def update_gi_multislice(gi, bits, sdf, atlas, ecfg: EngineConfig, frame,
                         offset, mesh: DeviceMesh):
    """The progressive GI window split over every device of the 2-D mesh;
    the gathered window is written back.  What crosses ``slice`` is the
    window's bytes, not the world's.  As the JAX function, it builds the
    gather table each call and retires no ray at ``sky_y``."""
    r, _, _ = _linear(mesh)
    return sharding._update_gi_window(gi, bits, sdf, atlas, ecfg, frame,
                                      offset, mesh, r, _AXES)
