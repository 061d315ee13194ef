"""Multi-device scaling: pixel-row data parallelism over a device mesh.

The port of ``rvgrt_tpu/parallel/sharding.py`` on ``torch.distributed``.
One process per rank; a 1-D ``DeviceMesh`` over a ``rays`` axis stands where
the JAX ``Mesh`` stood.  The world (bits / SDF / GI / atlas) is replicated
on every rank and the frame's pixel rows are sharded: rank ``i`` renders
its row slab with ``render_slab`` (recomputing a one-row half-res halo
instead of exchanging boundaries).  The collectives are the all-gathers
that assemble the frame, the GI window and the upscaled slabs, so every
rank returns the whole result, as ``jax.device_get`` of the JAX result
gives it.  The caller initialises the process group (its address, world
size and rank) and builds the mesh over it with ``make_mesh``.

The collective helpers here (``_ppermute``, ``_psum``, ``_gather_rows``,
``_broadcast``) are shared with ``volume.py`` and ``multislice.py``.  Their
one difference between backends: gloo has no CUDA send / receive, so under
gloo a CUDA tensor is staged through host memory; under NCCL device tensors
move as they are.  On a 1-rank axis a ppermute is the identity (no
self-send), as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.gi import update as gi_update
from rvgrt_tpu_torch.render import pipeline


def make_mesh(n_devices: int | None = None, axis: str = "rays",
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the caller's
    process group (all of them by default)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


# ---------------------------------------------------------------------
# collective helpers
# ---------------------------------------------------------------------

def _axis(mesh: DeviceMesh, axis: str | None) -> str:
    if axis is None:
        assert mesh.ndim == 1, mesh.mesh_dim_names
        return mesh.mesh_dim_names[0]
    return axis


def _index(mesh: DeviceMesh, axis: str | None = None) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(_axis(mesh, axis))


def _group(mesh: DeviceMesh, axis: str | None):
    group = mesh.get_group(_axis(mesh, axis))
    # the helpers order a group's parts by mesh coordinate
    assert dist.get_rank(group) == _index(mesh, axis)
    return group


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend sends it: a host copy under gloo (no
    CUDA send / receive there), a contiguous copy on its device else."""
    if dist.get_backend(group) == "gloo":
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone().contiguous()


def _ppermute(t: torch.Tensor, mesh: DeviceMesh, axis: str | None,
              shift: int) -> torch.Tensor:
    """Rank ``i`` sends ``t`` to rank ``(i + shift) % n`` of the axis and
    returns what rank ``(i - shift) % n`` sent it (``jax.lax.ppermute``
    with a ring permutation).  A 1-rank axis returns ``t``."""
    n = mesh.size(mesh.mesh_dim_names.index(_axis(mesh, axis)))
    if n == 1:
        return t
    group = _group(mesh, axis)
    i = _index(mesh, axis)
    send = _wire(t, group)
    recv = torch.empty_like(send)
    # a P2POp's peer is a global rank
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return recv.to(t.device)


def _psum(t: torch.Tensor, mesh: DeviceMesh,
          axis: str | None) -> torch.Tensor:
    """The sum of ``t`` over the axis, on every rank of it."""
    if mesh.size(mesh.mesh_dim_names.index(_axis(mesh, axis))) == 1:
        return t
    group = _group(mesh, axis)
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return w.to(t.device)


def _gather_rows(t: torch.Tensor, mesh: DeviceMesh,
                 axis: str | None) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in mesh order, on every
    rank of the axis (the assembly of row-sharded outputs)."""
    n = mesh.size(mesh.mesh_dim_names.index(_axis(mesh, axis)))
    if n == 1:
        return t
    group = _group(mesh, axis)
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts).to(t.device)


def _broadcast(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Mesh coordinate 0's ``t`` on every rank of the mesh: one broadcast
    along each axis, the first axis first."""
    for axis in mesh.mesh_dim_names:
        if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
            continue
        group = _group(mesh, axis)
        w = _wire(t, group)
        dist.broadcast(w, src=dist.get_global_rank(group, 0), group=group)
        t = w.to(t.device)
    return t


def _gather_frame(out: pipeline.FrameOutputs, mesh: DeviceMesh,
                  axes) -> pipeline.FrameOutputs:
    """Row-sharded FrameOutputs assembled over ``axes``, the innermost
    first."""
    fields = list(out)
    for axis in axes:
        fields = [_gather_rows(a, mesh, axis) for a in fields]
    return pipeline.FrameOutputs(*fields)


# ---------------------------------------------------------------------
# the sharded frame
# ---------------------------------------------------------------------

def _world_defaults(bits, sdf, ecfg: EngineConfig, gi_occ, sky_y, table):
    from rvgrt_tpu_torch.trace import wavefront
    from rvgrt_tpu_torch.world import gi_grid, voxel_grid

    if gi_occ is None and ecfg.render.gi_fused_cone:
        gi_occ = gi_grid.build_occlusion(sdf, ecfg.world)
    if sky_y is None:
        sky_y = voxel_grid.sky_limit(bits, ecfg.world)
    if table is None:
        table = wavefront.make_trace_table(bits, sdf, ecfg.world)
    return gi_occ, sky_y, table


def render_frame_sharded(bits, sdf, gi, atlas, cam: pipeline.CameraArrays,
                         ecfg: EngineConfig, mesh: DeviceMesh,
                         include_gi: bool = True, gi_occ=None, sky_y=None,
                         table=None) -> pipeline.FrameOutputs:
    """Render with pixel rows sharded over the mesh's axis: rank ``i``
    renders rows ``[i * slab_h, (i + 1) * slab_h)`` with ``render_slab``;
    every rank returns the assembled FrameOutputs."""
    n = mesh.size()
    h = ecfg.render.height
    assert h % (2 * n) == 0, (h, n)
    slab_h = h // n
    gi_occ, sky_y, table = _world_defaults(bits, sdf, ecfg, gi_occ, sky_y,
                                           table)
    out = pipeline.render_slab(bits, sdf, gi, atlas, cam, ecfg,
                               y0=_index(mesh) * slab_h, slab_h=slab_h,
                               include_gi=include_gi, gi_occ=gi_occ,
                               sky_y=sky_y, table=table)
    return _gather_frame(out, mesh, (None,))


def _update_gi_window(gi, bits, sdf, atlas, ecfg: EngineConfig, frame,
                      offset, mesh: DeviceMesh, rank: int, axes,
                      sky_y=None, table=None):
    """Rank ``rank`` (its linear index over the mesh) updates its
    ``per_dev`` sub-window of the window at ``offset``; the sub-windows are
    gathered over ``axes`` (innermost first) and written back."""
    n_dev = mesh.size()
    n = ecfg.gi_window
    assert n % n_dev == 0, (n, n_dev)
    per_dev = n // n_dev
    sub = dataclasses.replace(ecfg, gi_rays_per_frame=per_dev)
    assert sub.gi_window == per_dev, (sub.gi_window, per_dev)
    my_off = int(offset) + rank * per_dev
    updated = gi_update.update_gi(gi, bits, sdf, atlas, sub, frame, my_off,
                                  sky_y=sky_y, table=table)
    cells = gi.shape[0]
    s = gi_update.window_start(my_off, per_dev, cells)
    window = updated[s:s + per_dev]
    for axis in axes:
        window = _gather_rows(window, mesh, axis)
    out = gi.clone()
    s = gi_update.window_start(offset, n, cells)
    out[s:s + n] = window
    return out


def update_gi_sharded(gi, bits, sdf, atlas, ecfg: EngineConfig, frame,
                      offset, mesh: DeviceMesh, sky_y=None, table=None):
    """Distributed progressive GI: each rank updates a sub-window of the
    round-robin cell slice (``gi_rays_per_frame=per_dev``), the sub-windows
    are all-gathered and written back; every rank returns the new grid.

    Pass the world's ``sky_y`` and ``trace_table``: without them every
    sharded GI frame builds the gather table again."""
    return _update_gi_window(gi, bits, sdf, atlas, ecfg, frame, offset, mesh,
                             _index(mesh), (None,), sky_y=sky_y, table=table)


def replicate(mesh: DeviceMesh, *tensors):
    """The tensors of the mesh's first rank on every rank (a broadcast;
    each rank passes tensors of the same shapes and dtypes)."""
    return tuple(_broadcast(t, mesh) for t in tensors)


# ---------------------------------------------------------------------
# the sharded upscale
# ---------------------------------------------------------------------

def _halo_pad(color: torch.Tensor, motion: torch.Tensor):
    """Edge-clamped row halos at full-frame level: color rows (1, 2),
    motion rows (1, 1)."""
    cpad = torch.cat([color[:1], color, color[-1:], color[-1:]])
    mpad = torch.cat([motion[:1], motion, motion[-1:]])
    return cpad, mpad


def _upscale_slab(color, motion, jitter_ndc, packed, rank: int, n: int,
                  warp_taps: str):
    from rvgrt_tpu_torch.upscale import temporal

    h = color.shape[0]
    assert h % n == 0, (h, n)
    n_lo = h // n
    cpad, mpad = _halo_pad(color, motion)
    lo0 = rank * n_lo
    return temporal.temporal_upscale_slab(
        cpad[lo0:lo0 + n_lo + 3], mpad[lo0:lo0 + n_lo + 2], jitter_ndc,
        packed, lo0, n_lo, warp_taps=warp_taps)


def temporal_upscale_sharded(color, motion, jitter_ndc, packed,
                             mesh: DeviceMesh,
                             warp_taps: str = "bilinear_shift"):
    """Temporal 3x super-resolution with display rows sharded over the mesh.

    The state travels as the packed (H, W) RGBN word
    (``temporal.pack_state``): each rank warps its display-row slab from
    the whole packed history and makes its packed slab; the slabs are
    all-gathered.  Returns ``(out, packed_next)``, both assembled on every
    rank; feed ``packed_next`` back as ``packed``."""
    out, pk = _upscale_slab(color, motion, jitter_ndc, packed, _index(mesh),
                            mesh.size(), warp_taps)
    return _gather_rows(out, mesh, None), _gather_rows(pk, mesh, None)
