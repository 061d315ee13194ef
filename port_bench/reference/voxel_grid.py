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

from .config import TerrainConfig, WorldConfig
from . import terrain, u32
from .device import resolve_device

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


# Words per generate chunk.  The JAX package chunks at 2^19 words to keep
# one small XLA executable; here the only limit is memory: 2^20 words =
# 2^25 voxels, whose float32 temps are 128 MB each.
GENERATE_CHUNK_WORDS = 1 << 20


def generate(cfg: WorldConfig, tcfg: TerrainConfig = TerrainConfig(),
             device=None, chunk_words: int = GENERATE_CHUNK_WORDS,
             lowp: bool = False) -> torch.Tensor:
    """Procedurally generate the world -> flat (num_words,) u32 words.

    Pure function of (cfg, tcfg): deterministic regeneration is the
    checkpoint format, as in the reference (State.cpp:44-54).  One torch
    pass over all words, in chunks sized by memory.  The word index and its
    decode stay int32 at every supported world: 2^33 voxels are 2^28 words
    (256 chunks), and x0 < 2^12.  ``lowp``: the density is rounded to
    bfloat16 before the threshold (the benchmark's control)."""
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
        if lowp:
            density = density.to(torch.bfloat16).to(_F32)
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


def to_brick_words(bits: torch.Tensor, cfg: WorldConfig,
                   chunks: int | None = None) -> torch.Tensor:
    """Repack canonical x-run occupancy words into 4x2x4 brick words.

    Brick word index = (x>>2) | (y>>1) << (sx-2) | (z>>2) << (sx-2+sy-1);
    bit within word = (x&3) | (y&1)<<2 | (z&3)<<3.  Same total size as the
    canonical packing.  Brick word ``i`` along x takes its 4-voxel quad
    ``i & 7`` from canonical word ``i >> 3`` (the dense formulation of
    ``rvgrt_tpu``'s ``to_brick_words_dense``, bit-equal to its
    ``to_brick_words``).  Runs in ``chunks`` z-slabs, by default the JAX
    package's rule (temporaries of about 256 MB), cut down until each slab
    is whole bricks."""
    xw = cfg.size_x // 32
    vol = bits.reshape(cfg.size_z, cfg.size_y, xw)
    if chunks is None:
        chunks = max(1, (vol.numel() * 4) >> 28)
    while chunks > 1 and (cfg.size_z % chunks
                          or (cfg.size_z // chunks) % BRICK_Z):
        chunks -= 1
    nib_shift = 4 * (torch.arange(xw * 8, dtype=_I32, device=bits.device) & 7)
    out = torch.empty(bits.numel(), dtype=_I32, device=bits.device)
    step = cfg.size_z // chunks
    for z0 in range(0, cfg.size_z, step):
        v = vol[z0:z0 + step]
        acc = None
        for bz in range(BRICK_Z):
            for by in range(BRICK_Y):
                sub = v[bz::BRICK_Z, by::BRICK_Y]          # (czb, yb, xw)
                rep = torch.repeat_interleave(sub, 8, -1)  # (.., xw*8)
                quad = u32.lsr(rep, nib_shift) & 0xF
                part = quad << (4 * by + 8 * bz)
                acc = part if acc is None else acc | part
        # z is the slowest axis of both layouts: a slab is a run of words
        out[z0 * cfg.size_y * xw:(z0 + step) * cfg.size_y * xw] = \
            acc.reshape(-1)
    return out


def sky_limit(bits: torch.Tensor, cfg: WorldConfig) -> torch.Tensor:
    """1 + the highest solid voxel's y (f32 0-d tensor), for the tracer's
    sky early-exit (``wavefront.trace(sky_y=...)``)."""
    y_any = (bits.reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
             != 0).any(dim=2).any(dim=0)
    ys = torch.arange(1, cfg.size_y + 1, dtype=_I32, device=bits.device)
    top = torch.where(y_any, ys, 0).max()
    return top.to(_F32)


def column_height(bits: torch.Tensor, cfg: WorldConfig,
                  chunks: int | None = None) -> torch.Tensor:
    """(size_z, size_x) i32: 1 + the highest solid voxel's y per column
    (0 = empty column) - the per-column refinement of ``sky_limit``.  Each
    per-bit pass makes int32 temporaries the size of the words it covers,
    so it runs in ``chunks`` z-slabs, by default the JAX package's rule
    (about 128 MB each); unchunked where ``size_z`` does not divide."""
    words = bits.reshape(cfg.size_z, cfg.size_y, cfg.size_x // 32)
    if chunks is None:
        chunks = max(1, (words.numel() * 4) >> 27)
    if cfg.size_z % chunks:
        chunks = 1
    ylev = torch.arange(1, cfg.size_y + 1, dtype=_I32,
                        device=bits.device)[None, :, None]
    out = torch.empty(cfg.size_z, cfg.size_x, dtype=_I32, device=bits.device)
    step = cfg.size_z // chunks
    for z0 in range(0, cfg.size_z, step):
        w = words[z0:z0 + step]
        for b in range(32):
            anyb = u32.lsr(w, b) & 1
            out[z0:z0 + step, b::32] = (anyb * ylev).amax(dim=1)
    return out


def coarse_occupancy(bits: torch.Tensor, cfg: WorldConfig,
                     coarseness: int | None = None,
                     chunk_z: int | None = None) -> torch.Tensor:
    """(SZ, SY, SX) bool: coarse cell solid iff any fine voxel inside is
    (``isCoarseBlockSolid``, ``CoarseArray.cu:11-32``).  OR-reduces words
    over the coarse block in y/z, then folds 32-voxel words down to
    per-coarse-cell booleans along x.  ``_fold_x``'s temporary is (32 / c)
    int32 a coarse row entry, so it runs in z-slabs of ``chunk_z`` fine
    planes, by default the JAX package's rule: a power of two times c that
    bounds the temporary, padded to a TPU's 128 lanes, to about 256 MB."""
    c = cfg.sdf_coarseness if coarseness is None else coarseness
    sx, sy, sz = cfg.size_x, cfg.size_y, cfg.size_z
    words = bits.reshape(sz, sy, sx // 32)
    if chunk_z is None:
        padded_plane = (sy // c) * (sx // 32) * 128 * 4
        chunk_out = max(1, (256 << 20) // max(padded_plane, 1))
        chunk_z = c
        while chunk_z * 2 <= chunk_out * c and sz % (chunk_z * 2) == 0 \
                and chunk_z * 2 < sz:
            chunk_z *= 2
    assert chunk_z % c == 0 and sz % chunk_z == 0, (chunk_z, c, sz)
    out = torch.empty(sz // c, sy // c, sx // c, dtype=torch.bool,
                      device=bits.device)
    for z0 in range(0, sz, chunk_z):
        wc = words[z0:z0 + chunk_z]
        acc = None
        for dz in range(c):
            for dy in range(c):
                part = wc[dz::c, dy::c, :]
                acc = part if acc is None else acc | part
        out[z0 // c:(z0 + chunk_z) // c] = _fold_x(acc, sx, c)
    return out


def _fold_x(w: torch.Tensor, sx: int, c: int) -> torch.Tensor:
    """Fold (..., sx//32) OR-ed u32 words into (..., sx//c) bools."""
    cells_per_word = 32 // c
    mask = (1 << c) - 1
    shifts = torch.arange(cells_per_word, dtype=_I32, device=w.device) * c
    groups = u32.lsr(w[..., None], shifts) & mask
    return (groups != 0).reshape(*w.shape[:-1], sx // c)
