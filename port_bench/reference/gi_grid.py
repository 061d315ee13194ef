"""GI radiance grid: RGBA8 cells packed one per u32 word.

The port of ``rvgrt_tpu/world/gi_grid.py``.  Each cell is one u32 word
(R | G<<8 | B<<16 | A<<24, carried as int32), stored as
``trunc(min(c,1) * 255)`` like the reference's float->uchar casts
(``CoarseArray.cu:351-354``).  The fused cone table of
``RenderConfig.gi_fused_cone`` (``build_occlusion``, ``make_cone_table``,
``sample_cone_table``) puts a GI-resolution occlusion byte in each word's
alpha, so one cone step reads radiance and occlusion in one gather.
"""

from __future__ import annotations

import torch

from .config import WorldConfig
from . import u32

_F32 = torch.float32
_I32 = torch.int32


def pack_rgba8(r, g, b, a=None):
    """float [0,1] channels -> u32 RGBA words (truncating quantize)."""
    def q(c):
        return (torch.clamp_max(c, 1.0) * 255.0).to(_I32)
    qa = torch.full_like(r, 255, dtype=_I32) if a is None else q(a)
    return q(r) | (q(g) << 8) | (q(b) << 16) | u32.shl(qa, 24)


def unpack_rgba8(words):
    """u32 RGBA words -> (r, g, b, a) float32 in [0,1]."""
    inv = 1.0 / 255.0
    r = (words & 0xFF).to(_F32) * inv
    g = (u32.lsr(words, 8) & 0xFF).to(_F32) * inv
    b = (u32.lsr(words, 16) & 0xFF).to(_F32) * inv
    a = (u32.lsr(words, 24) & 0xFF).to(_F32) * inv
    return r, g, b, a


def cell_index(cfg: WorldConfig, gx, gy, gz):
    """Linear GI-cell index (z-major, x fastest) like the reference's
    ``gz*GX*GY + gy*GX + gx`` (``raytracing_functions.cu:254``)."""
    return (gz * (cfg.gi_size_x * cfg.gi_size_y)
            + gy * cfg.gi_size_x + gx)


def sample_at_world(gi: torch.Tensor, cfg: WorldConfig, wx, wy, wz):
    """Gather radiance at world-space float positions
    (``raytracing_functions.cu:247-252``).  Returns (r, g, b, a, in_bounds);
    out-of-bounds positions read a clamped cell and are masked by the
    caller."""
    c = cfg.gi_coarseness
    gx = torch.floor(wx).to(_I32) // c
    gy = torch.floor(wy).to(_I32) // c
    gz = torch.floor(wz).to(_I32) // c
    ok = ((gx >= 0) & (gx < cfg.gi_size_x)
          & (gy >= 0) & (gy < cfg.gi_size_y)
          & (gz >= 0) & (gz < cfg.gi_size_z))
    idx = cell_index(cfg, torch.clamp(gx, 0, cfg.gi_size_x - 1),
                     torch.clamp(gy, 0, cfg.gi_size_y - 1),
                     torch.clamp(gz, 0, cfg.gi_size_z - 1))
    idx = torch.clamp(idx, 0, cfg.gi_num_cells - 1)
    r, g, b, a = unpack_rgba8(gi[idx.long()])
    return r, g, b, a, ok


def build_occlusion(sdf: torch.Tensor, cfg: WorldConfig,
                    mode: str = "mean") -> torch.Tensor:
    """Cone-occlusion mip at GI resolution, pre-shifted into the alpha
    byte: each GI cell's coarse-SDF cells reduced by ``mode`` ("mean", the
    default: the sum in uint16 floor-divided by the cell count; "min";
    "max"), in SDF-cell units, as u32 words (int32 bits).  Built once per
    world; the JAX ``build_occlusion``, reduced over r^3 strided slices."""
    r = cfg.gi_coarseness // cfg.sdf_coarseness
    vol = sdf.reshape(cfg.sdf_size_z, cfg.sdf_size_y, cfg.sdf_size_x)
    if r > 1:
        acc = None
        for dz in range(r):
            for dy in range(r):
                for dx in range(r):
                    part = vol[dz::r, dy::r, dx::r]
                    if mode == "min":
                        acc = part if acc is None else torch.minimum(acc,
                                                                     part)
                    elif mode == "max":
                        acc = part if acc is None else torch.maximum(acc,
                                                                     part)
                    else:  # mean; sums fit uint16 (255 * r^3 <= 65535)
                        p = part.to(torch.int32)
                        acc = p if acc is None else (acc + p) & 0xFFFF
        if mode == "mean":
            acc = (acc // (r * r * r)).to(sdf.dtype)
        vol = acc
    return u32.shl(vol.reshape(-1).to(_I32), 24)


def make_cone_table(gi: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Fused per-frame cone-march table: radiance RGB | occlusion byte (the
    radiance alpha it replaces is 255 in every stored cell)."""
    return (gi & 0x00FFFFFF) | occ


def sample_cone_table(tbl: torch.Tensor, cfg: WorldConfig, wx, wy, wz):
    """Gather (r, g, b, scene_dist_fine, in_bounds) from the fused table:
    the occlusion byte times ``sdf_coarseness`` is the fine-voxel scene
    distance."""
    c = cfg.gi_coarseness
    gx = torch.floor(wx).to(_I32) // c
    gy = torch.floor(wy).to(_I32) // c
    gz = torch.floor(wz).to(_I32) // c
    ok = ((gx >= 0) & (gx < cfg.gi_size_x)
          & (gy >= 0) & (gy < cfg.gi_size_y)
          & (gz >= 0) & (gz < cfg.gi_size_z))
    idx = cell_index(cfg, torch.clamp(gx, 0, cfg.gi_size_x - 1),
                     torch.clamp(gy, 0, cfg.gi_size_y - 1),
                     torch.clamp(gz, 0, cfg.gi_size_z - 1))
    idx = torch.clamp(idx, 0, cfg.gi_num_cells - 1)
    words = tbl[idx.long()]
    inv = 1.0 / 255.0
    r = (words & 0xFF).to(_F32) * inv
    g = (u32.lsr(words, 8) & 0xFF).to(_F32) * inv
    b = (u32.lsr(words, 16) & 0xFF).to(_F32) * inv
    dist = (u32.lsr(words, 24) & 0xFF).to(_F32) * float(cfg.sdf_coarseness)
    return r, g, b, dist, ok


def cell_world_centers(cfg: WorldConfig, idx):
    """World position of GI cell centers: (c + 0.5) * COARSENESSGI
    (``CoarseArray.cu:291-293``)."""
    gx = idx % cfg.gi_size_x
    gy = (idx // cfg.gi_size_x) % cfg.gi_size_y
    gz = idx // (cfg.gi_size_x * cfg.gi_size_y)
    s = float(cfg.gi_coarseness)
    return ((gx.to(_F32) + 0.5) * s,
            (gy.to(_F32) + 0.5) * s,
            (gz.to(_F32) + 0.5) * s)
