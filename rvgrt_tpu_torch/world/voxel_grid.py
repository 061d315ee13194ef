"""Bit-packed voxel occupancy grid.

The port of ``rvgrt_tpu/world/voxel_grid.py`` (the reference's ``CArray``):
a flat buffer of u32 words (carried as int32, see ``core.u32``), 1 bit per
voxel, x-fastest - word ``w`` holds voxels ``x = 32*w .. 32*w+31`` at fixed
(y, z), and the linear bit index is ``x | y << shift_x | z << (shift_x +
shift_y)`` (``toIndex``, ``cumath.cuh:33-45``).  ``generate`` is the
``fillKernel`` equivalent (``CArray.cu:8-30``).
"""

from __future__ import annotations

import torch

from rvgrt_tpu_torch.config import TerrainConfig, WorldConfig
from rvgrt_tpu_torch.core import terrain, u32
from rvgrt_tpu_torch.utils.device import resolve_device

_I32 = torch.int32
_F32 = torch.float32


def pack_bits_x(solid: torch.Tensor) -> torch.Tensor:
    """Pack a (..., X) bool tensor into (..., X//32) u32 words, x-fastest."""
    *lead, x = solid.shape
    assert x % 32 == 0
    grouped = solid.reshape(*lead, x // 32, 32).to(_I32)
    weights = u32.shl(torch.ones(32, dtype=_I32, device=solid.device),
                      torch.arange(32, device=solid.device))
    # distinct bits: the wrapping int32 sum equals the OR
    return (grouped * weights).sum(dim=-1, dtype=_I32)


def unpack_bits_x(words: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bits_x: (..., W) u32 words -> (..., W*32) bool."""
    *lead, w = words.shape
    shifts = torch.arange(32, dtype=_I32, device=words.device)
    bits = u32.lsr(words[..., None], shifts) & 1
    return bits.reshape(*lead, w * 32).to(torch.bool)


# Words per generate chunk.  The JAX package chunks at 2^19 words to keep
# one small XLA executable; here the only limit is memory: 2^20 words =
# 2^25 voxels, whose float32 temps are 128 MB each.
GENERATE_CHUNK_WORDS = 1 << 20


def generate(cfg: WorldConfig, tcfg: TerrainConfig = TerrainConfig(),
             device=None, chunk_words: int = GENERATE_CHUNK_WORDS
             ) -> torch.Tensor:
    """Procedurally generate the world -> flat (num_words,) u32 words.

    Pure function of (cfg, tcfg): deterministic regeneration is the
    checkpoint format, as in the reference (State.cpp:44-54).  One torch
    pass over all words, in chunks sized by memory."""
    dev = resolve_device(device)
    cfg.validate()
    n = cfg.num_words
    chunk = min(chunk_words, n)
    wpx_mask = cfg.size_x // 32 - 1
    wpx_shift = cfg.shift_x - 5
    sy_mask = cfg.size_y - 1
    lanes = torch.arange(32, dtype=_I32, device=dev)
    out = torch.empty(n, dtype=_I32, device=dev)
    for w0 in range(0, n, chunk):
        wi = w0 + torch.arange(min(chunk, n - w0), dtype=_I32, device=dev)
        # word -> (x0, y, z): x-fastest words (toIndex, cumath.cuh:33-45)
        x0 = (wi & wpx_mask) << 5
        rest = wi >> wpx_shift
        y = rest & sy_mask
        z = rest >> cfg.shift_y
        xs = (x0[:, None] + lanes).to(_F32)
        ys = y.to(_F32)[:, None]
        zs = z.to(_F32)[:, None]
        density = terrain.evaluate_density(xs, ys, zs, tcfg)  # (chunk, 32)
        out[w0:w0 + wi.shape[0]] = pack_bits_x(
            density > cfg.solid_threshold)[:, 0]
    return out


def word_index(cfg: WorldConfig, x, y, z):
    """Word + bit position of voxel (x, y, z); int32-safe for all configs."""
    wi = ((x >> 5)
          | (y << (cfg.shift_x - 5))
          | (z << (cfg.shift_x + cfg.shift_y - 5)))
    return wi, x & 31


def is_solid(bits: torch.Tensor, cfg: WorldConfig, x, y, z):
    """Gather occupancy bits at int voxel coords (``IsSolid``,
    ``raytracing_functions.cuh:23-26``); coordinates wrap modulo the world
    size like ``toIndex``."""
    x = x & (cfg.size_x - 1)
    y = y & (cfg.size_y - 1)
    z = z & (cfg.size_z - 1)
    wi, bit = word_index(cfg, x, y, z)
    wi = torch.clamp(wi, 0, cfg.num_words - 1)
    words = bits[wi.long()]
    return (u32.lsr(words, bit) & 1).to(torch.bool)


# Brick shape for the tracer's DDA gather table: each u32 word holds a
# 4x2x4 (x,y,z) neighborhood instead of the storage layout's 32x1x1 x-run.
BRICK_X, BRICK_Y, BRICK_Z = 4, 2, 4


def to_brick_words(bits: torch.Tensor, cfg: WorldConfig) -> torch.Tensor:
    """Repack canonical x-run occupancy words into 4x2x4 brick words.

    Brick word index = (x>>2) | (y>>1) << (sx-2) | (z>>2) << (sx-2+sy-1);
    bit within word = (x&3) | (y&1)<<2 | (z&3)<<3.  Same total size as the
    canonical packing.  Brick word ``i`` along x takes its 4-voxel quad
    ``i & 7`` from canonical word ``i >> 3`` (the dense formulation of
    ``rvgrt_tpu``'s ``to_brick_words_dense``, bit-equal to its
    ``to_brick_words``)."""
    xw = cfg.size_x // 32
    vol = bits.reshape(cfg.size_z, cfg.size_y, xw)
    nib_shift = 4 * (torch.arange(xw * 8, dtype=_I32, device=bits.device) & 7)
    acc = None
    for bz in range(BRICK_Z):
        for by in range(BRICK_Y):
            sub = vol[bz::BRICK_Z, by::BRICK_Y]              # (czb, yb, xw)
            rep = torch.repeat_interleave(sub, 8, dim=-1)   # (czb, yb, xw*8)
            quad = u32.lsr(rep, nib_shift) & 0xF
            part = quad << (4 * by + 8 * bz)
            acc = part if acc is None else acc | part
    return acc.reshape(-1)


def sky_limit(bits: torch.Tensor, cfg: WorldConfig) -> torch.Tensor:
    """1 + the highest solid voxel's y (f32 0-d tensor), for the tracer's
    sky early-exit (``wavefront.trace(sky_y=...)``)."""
    y_any = (bits.reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
             != 0).any(dim=2).any(dim=0)
    ys = torch.arange(1, cfg.size_y + 1, dtype=_I32, device=bits.device)
    top = torch.where(y_any, ys, 0).max()
    return top.to(_F32)


def column_height(bits: torch.Tensor, cfg: WorldConfig) -> torch.Tensor:
    """(size_z, size_x) i32: 1 + the highest solid voxel's y per column
    (0 = empty column) - the per-column refinement of ``sky_limit``."""
    words = bits.reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
    ylev = torch.arange(1, cfg.size_y + 1, dtype=_I32,
                        device=bits.device)[None, :, None]
    out = torch.empty(cfg.size_z, cfg.size_x, dtype=_I32, device=bits.device)
    for b in range(32):
        anyb = u32.lsr(words, b) & 1
        out[:, b::32] = (anyb * ylev).amax(dim=1)
    return out


def coarse_occupancy(bits: torch.Tensor, cfg: WorldConfig,
                     coarseness: int | None = None) -> torch.Tensor:
    """(SZ, SY, SX) bool: coarse cell solid iff any fine voxel inside is
    (``isCoarseBlockSolid``, ``CoarseArray.cu:11-32``).  OR-reduces words
    over the coarse block in y/z, then folds 32-voxel words down to
    per-coarse-cell booleans along x."""
    c = cfg.sdf_coarseness if coarseness is None else coarseness
    sx, sy, sz = cfg.size_x, cfg.size_y, cfg.size_z
    words = bits.reshape(sz, sy, sx // 32)
    acc = None
    for dz in range(c):
        for dy in range(c):
            part = words[dz::c, dy::c, :]
            acc = part if acc is None else acc | part
    return _fold_x(acc, sx, c)


def _fold_x(w: torch.Tensor, sx: int, c: int) -> torch.Tensor:
    """Fold (..., sx//32) OR-ed u32 words into (..., sx//c) bools."""
    cells_per_word = 32 // c
    mask = (1 << c) - 1
    shifts = torch.arange(cells_per_word, dtype=_I32, device=w.device) * c
    groups = u32.lsr(w[..., None], shifts) & mask
    return (groups != 0).reshape(*w.shape[:-1], sx // c)
