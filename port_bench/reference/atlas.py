"""Texture atlas: 256x256 RGBA of 16x16-pixel tiles + procedural block IDs.

The port of ``rvgrt_tpu/world/atlas.py`` (the reference's ``Texturepack``
and the per-voxel block-ID selection of ``sampleTexture``,
``raytracing_functions.cu:28-62``): two blended simplex3D fields
thresholded into 8 Minecraft-ish tiles, point-sampled with the reference's
(v, u) coordinate swap.  The atlas is a (256*256,) tensor of packed u32
words, so a texel fetch is one gather + shift-unpack.

``default_atlas`` loads the reference's texture pack (``REFERENCE_PNG``,
``resources/texturepack.png`` in this repository) when that file exists
and decodes, as the JAX package does with its own path, and builds the
procedural look-alike otherwise.  ``load_png`` decodes with ``zlib`` and
``struct`` (``decode_png``: 8-bit RGB or RGBA, not interlaced, all five
row filters), as Pillow's ``convert("RGB")`` reads those two types.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from . import noise
from .device import resolve_device
from .gi_grid import pack_rgba8, unpack_rgba8

_F32 = torch.float32
_I32 = torch.int32

ATLAS_SIZE = 256
TILE = 16

# Tile coordinates (u, v) in units of 1/16, matching sampleTexture's IDs
# (raytracing_functions.cu:30-37).
TILE_STONE = (0, 1)
TILE_DIRT = (0, 2)
TILE_COBBLE = (1, 0)
TILE_IRON = (2, 1)
TILE_DIAMOND = (3, 2)
TILE_STONE2 = (0, 0)
TILE_SANDSTONE = (11, 0)
TILE_COAL = (2, 2)

# Base colors for the procedural look-alike tiles (RGB in [0,1]).
_TILE_COLORS = {
    TILE_STONE: (0.48, 0.48, 0.48),
    TILE_DIRT: (0.55, 0.39, 0.27),
    TILE_COBBLE: (0.42, 0.42, 0.44),
    TILE_IRON: (0.56, 0.50, 0.44),
    TILE_DIAMOND: (0.45, 0.70, 0.72),
    TILE_STONE2: (0.52, 0.52, 0.50),
    TILE_SANDSTONE: (0.76, 0.70, 0.50),
    TILE_COAL: (0.33, 0.33, 0.33),
}


def _hash2_np(xi, yi):
    """numpy twin of ``noise.hash2`` (bit-identical uint32 wraparound)."""
    key = xi.astype(np.uint32) * np.uint32(73856093)
    key ^= yi.astype(np.uint32) * np.uint32(19349663)
    key = (key ^ np.uint32(61)) ^ (key >> np.uint32(16))
    key = key * np.uint32(9)
    key ^= key >> np.uint32(4)
    key = key * np.uint32(0x27D4EB2D)
    key ^= key >> np.uint32(15)
    return key


def procedural_atlas(device=None) -> torch.Tensor:
    """Deterministic 256x256 atlas -> flat (256*256,) u32 RGBA words."""
    dev = resolve_device(device)
    img = np.full((ATLAS_SIZE, ATLAS_SIZE, 3), 0.5, np.float32)
    yy, xx = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    for (tu, tv), base in _TILE_COLORS.items():
        h = _hash2_np(xx + tu * 131, yy + tv * 173)
        n = (h.astype(np.float64) / 2**32).astype(np.float32)  # [0,1)
        shade = 0.78 + 0.44 * n  # +-22% brightness speckle
        tile = np.stack([base[0] * shade, base[1] * shade, base[2] * shade],
                        axis=-1)
        # atlas rows are the *u* axis (see sample_atlas): texel
        # (u_px, v_px) lives at img[u_px, v_px]
        u0, v0 = tu * TILE, tv * TILE
        img[u0:u0 + TILE, v0:v0 + TILE] = np.clip(tile, 0.0, 1.0)
    flat = torch.from_numpy(img.reshape(-1, 3).copy()).to(dev)
    return pack_rgba8(flat[:, 0], flat[:, 1], flat[:, 2])


#: the reference's own texture pack (embedded into its binary by
#: ``embed.py``), looked for inside this repository only, so that nothing
#: outside the checkout changes which atlas a world gets.  The pack is not
#: committed: until it is, ``default_atlas`` builds the procedural atlas.
#: (The JAX package names the pack by an absolute path of its own.)
REFERENCE_PNG = str(Path(__file__).resolve().parents[2] / "resources"
                    / "texturepack.png")

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG as an (H, W, 3 or 4) uint8
    array; every row filter (None, Sub, Up, Average, Paeth) is undone.
    Any other colour type, bit depth or interlace raises ``ValueError``."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    chans = {2: 3, 6: 4}.get(ctype)
    if chans is None or depth != 8 or interlace != 0:
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth "
                         f"{depth}, interlace {interlace} (8-bit RGB or "
                         f"RGBA, not interlaced, only)")
    raw = zlib.decompress(b"".join(idat))
    stride = w * chans
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG data of the wrong length")
    out = np.zeros((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        f = raw[y * (stride + 1)]
        row = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        if f == 0:
            cur = np.frombuffer(row, np.uint8)
        elif f == 1:  # Sub: a running sum per channel
            r = np.frombuffer(row, np.uint8).reshape(w, chans)
            cur = (np.cumsum(r, axis=0, dtype=np.int64) & 0xFF).reshape(-1)
        elif f == 2:  # Up
            cur = np.frombuffer(row, np.uint8) + np.frombuffer(prev,
                                                               np.uint8)
        elif f in (3, 4):  # Average, Paeth: each byte needs its left
            line = bytearray(stride)
            for i in range(stride):
                a = line[i - chans] if i >= chans else 0
                b = prev[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, prev[i - chans] if i >= chans
                                  else 0)
                line[i] = (row[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(line), np.uint8)
        else:
            raise ValueError(f"PNG row filter {f} unknown")
        out[y] = cur
        prev = out[y].tobytes()
    return out.reshape(h, w, chans)


def load_png(path: str, device=None) -> torch.Tensor:
    """A 256x256 texture pack from disk (8-bit RGB or RGBA; alpha dropped),
    as the JAX ``load_png`` reads it: scaled by 1/255 in float32, stored
    transposed (so ``sample_atlas``'s (u, v) indexing matches the
    reference's swapped ``tex2D(texObj, uv.y, uv.x)``) and packed."""
    with open(path, "rb") as f:
        rgb = decode_png(f.read())[..., :3]
    img = rgb.astype(np.float32) / np.float32(255.0)
    assert img.shape[:2] == (ATLAS_SIZE, ATLAS_SIZE), img.shape
    img = np.ascontiguousarray(np.transpose(img, (1, 0, 2)).reshape(-1, 3))
    flat = torch.from_numpy(img).to(resolve_device(device))
    return pack_rgba8(flat[:, 0], flat[:, 1], flat[:, 2])


def default_atlas(device=None) -> torch.Tensor:
    """The reference's texture pack (``REFERENCE_PNG``) when it exists and
    loads, else the procedural look-alike (both deterministic)."""
    if os.path.exists(REFERENCE_PNG):
        try:
            return load_png(REFERENCE_PNG, device)
        except Exception:
            pass
    return procedural_atlas(device)


def select_tile(px, py, pz):
    """Procedural block ID from two blended simplex3D fields
    (``raytracing_functions.cu:41-54``).  Returns (tile_u, tile_v) floats in
    units of 1/16 of the atlas."""
    freq = 0.05
    fx = torch.floor(px)
    fy = torch.floor(py)
    fz = torch.floor(pz)
    e1 = noise.simplex3d(fx * freq, fy * freq, fz * freq)
    e2 = noise.simplex3d(torch.floor(px + 121.3) * freq * 0.3,
                         torch.floor(py + 1321.3) * freq * 0.3,
                         torch.floor(pz + 721.5) * freq * 0.3)
    ev = e1 * 0.4 + e2 * 0.6

    # Threshold ladder (first match wins), default stone.
    tiles = [
        (-1.3, TILE_STONE), (-1.2, TILE_DIAMOND), (-0.7, TILE_IRON),
        (0.0, TILE_STONE), (0.1, TILE_COAL), (0.4, TILE_COBBLE),
        (0.8, TILE_DIRT), (1.2, TILE_STONE2),
    ]
    tu = torch.full_like(ev, float(TILE_STONE[0]))
    tv = torch.full_like(ev, float(TILE_STONE[1]))
    # Build from the last threshold down so the first (smallest) match wins.
    for thresh, (u, v) in reversed(tiles):
        sel = ev < thresh
        tu = torch.where(sel, float(u), tu)
        tv = torch.where(sel, float(v), tv)
    return tu / 16.0, tv / 16.0


def sample_atlas(atlas: torch.Tensor, u, v):
    """Point-sample the atlas at normalized (u, v) with wrap addressing
    (``tex2D(texObj, uv.y, uv.x)``: the atlas is stored transposed, so
    indexing rows by u and columns by v reproduces the swap)."""
    up = (u * ATLAS_SIZE).to(_I32) & (ATLAS_SIZE - 1)
    vp = (v * ATLAS_SIZE).to(_I32) & (ATLAS_SIZE - 1)
    idx = torch.clamp(up * ATLAS_SIZE + vp, 0, ATLAS_SIZE * ATLAS_SIZE - 1)
    r, g, b, _ = unpack_rgba8(atlas[idx.long()])
    return r, g, b


def sample_texture(atlas: torch.Tensor, uv_u, uv_v, px, py, pz):
    """Full sampleTexture: block-ID select + face-UV -> atlas texel
    (``raytracing_functions.cu:28-62``)."""
    tu, tv = select_tile(px, py, pz)
    u = uv_u * (1.0 / 16.0) + tu
    v = uv_v * (1.0 / 16.0) + tv
    return sample_atlas(atlas, u, v)
