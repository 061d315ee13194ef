"""Coarse signed-distance field: separable distance transform.

The port of ``rvgrt_tpu/world/sdf.py``: the same uint8 field as the
reference's three CUDA passes (``CoarseArray.cu:37-152``) - for each coarse
cell, the Euclidean distance (in coarse cells) to the nearest solid coarse
cell, computed axis by axis and clamped to ``SDF_MAX_DIST`` (64), each pass
truncating to uint8.

* pass X: cummax/cummin of the last/next solid index (exact 1-D distance);
* passes Y and Z: bounded min-plus convolutions.  On a CUDA tensor both go
  through kernel K3 (``ops/sdf_kernels.py``) at every grid size; on the CPU
  through its plain version, which is ``_minconv_pass`` below.
"""

from __future__ import annotations

import torch

from .config import WorldConfig
from . import plain_ops as sdf_kernels

_I32 = torch.int32
_BIG = 1 << 20  # "infinity" index sentinel, safely squarable in int32

# the plain min-plus pass (the counterpart of the JAX ``_minconv_pass``)
_minconv_pass = sdf_kernels.minconv_pass_plain


def _axis_distance_1d(solid: torch.Tensor, axis: int, cap: int,
                      chunks: int | None = None) -> torch.Tensor:
    """Distance (in cells) along ``axis`` to the nearest solid cell, capped,
    as uint8 (``computeDistX``, ``CoarseArray.cu:37-75``).

    The scan's temporaries are int32 values and int64 indices several times
    the volume, so it runs in ``chunks`` slices of the leading axis, by
    default enough to bound an int32 temporary to about 256 MB (the JAX
    package's rule); unchunked along axis 0 or where the leading size does
    not divide."""
    if chunks is None:
        chunks = max(1, solid.numel() * 4 // (256 * 1024 * 1024))
    lead = solid.shape[0]
    if axis != 0 and chunks > 1 and lead % chunks == 0:
        out = torch.empty(solid.shape, dtype=torch.uint8,
                          device=solid.device)
        step = lead // chunks
        for z0 in range(0, lead, step):
            out[z0:z0 + step] = _axis_distance_1d(solid[z0:z0 + step], axis,
                                                  cap, chunks=1)
        return out
    n = solid.shape[axis]
    shape = [1] * solid.ndim
    shape[axis] = n
    idx = torch.arange(n, dtype=_I32, device=solid.device).reshape(shape)
    last_solid = torch.cummax(torch.where(solid, idx, -_BIG), dim=axis)[0]
    nxt = torch.where(solid, idx, _BIG).flip(axis)
    next_solid = torch.cummin(nxt, dim=axis)[0].flip(axis)
    dist = torch.minimum(idx - last_solid, next_solid - idx)
    return torch.clamp_max(dist, cap).to(torch.uint8)


def build_sdf(coarse_solid: torch.Tensor, cfg: WorldConfig) -> torch.Tensor:
    """(SZ, SY, SX) bool coarse occupancy -> (SZ*SY*SX,) flat uint8 SDF
    (``CoarseArray::GenerateSDF``, ``CoarseArray.cu:173-208``): X scan ->
    XY min-conv -> XYZ min-conv, uint8 truncation between passes."""
    cap = cfg.sdf_max_dist
    # axis order in the tensor is (z, y, x)
    # each pass's input is freed as the next pass returns: at 2^30 coarse
    # cells every one is 1 GiB
    d = _axis_distance_1d(coarse_solid, axis=2, cap=cap)
    d = sdf_kernels.minconv_pass(d, axis=1, cap=cap)
    d = sdf_kernels.minconv_pass(d, axis=0, cap=cap)
    return d.reshape(-1)


def extend_sdf_far(sdf: torch.Tensor, coarse_solid: torch.Tensor,
                   cfg: WorldConfig) -> torch.Tensor:
    """Inflate far-field SDF values from a coarser mip.

    See ``rvgrt_tpu/world/sdf.py::extend_sdf_far`` for the derivation: a
    second distance transform over ``sdf_far_level``-voxel blocks gives
    conservative far values d' = floor((F*(v - 1.75) - 1) / coarseness),
    maxed into the base field.  Its two min-plus passes (cap 66 at the
    default levels) run through the same kernel as ``build_sdf``; the pass
    is exact either way."""
    F = cfg.sdf_far_level
    c = cfg.sdf_coarseness
    if not F or F <= c:
        return sdf
    f = F // c
    occ = coarse_solid
    for axis in (0, 1, 2):
        acc = None
        for k in range(f):
            sl = [slice(None)] * 3
            sl[axis] = slice(k, None, f)
            part = occ[tuple(sl)]
            acc = part if acc is None else (acc | part)
        occ = acc
    cap = min(255, (255 * c + 1) // F + 3)
    dist_x = _axis_distance_1d(occ, axis=2, cap=cap)
    dist_xy = sdf_kernels.minconv_pass(dist_x, axis=1, cap=cap)
    v = sdf_kernels.minconv_pass(dist_xy, axis=0, cap=cap).to(_I32)
    # integer form of floor((F*(v - 1.75) - 1) / c)
    dp = torch.clamp((F * (4 * v - 7) - 4) // (4 * c), 0, 255)
    dp = dp.to(torch.uint8)
    for axis in (0, 1, 2):
        dp = torch.repeat_interleave(dp, f, dim=axis)
    return torch.maximum(sdf, dp.reshape(-1))


def sample_sdf_at_voxel(sdf: torch.Tensor, cfg: WorldConfig, vx, vy, vz):
    """Gather SDF (coarse cells) at *fine* integer voxel coords
    (``getDistance``, ``raytracing_functions.cuh:35-67``): coarse index =
    voxel // coarseness, clamped into the grid.  Returns int32 distances."""
    c = cfg.sdf_coarseness
    cx = torch.clamp(vx // c, 0, cfg.sdf_size_x - 1)
    cy = torch.clamp(vy // c, 0, cfg.sdf_size_y - 1)
    cz = torch.clamp(vz // c, 0, cfg.sdf_size_z - 1)
    cidx = (cz * (cfg.sdf_size_x * cfg.sdf_size_y)
            + cy * cfg.sdf_size_x + cx)
    cidx = torch.clamp(cidx, 0, cfg.sdf_num_cells - 1)
    return sdf[cidx.long()].to(_I32)
