"""Vectorized simplex noise / fBm, bit-compatible with the reference.

The port of ``rvgrt_tpu/core/noise.py`` (the reference's device noise
library, ``include/TerrainGeneration.cuh``): spatial hash = 3 large primes
XOR-folded + Thomas Wang mix (lines 25-62), gradients computed from the hash
instead of a table (lines 65-79, 161-175), simplex2D/3D (lines 81-142,
178-254) and fbm2D/3D (lines 259-280).

These functions define the world, so they must be *bit-stable*: float32
math in the same operation order as the JAX package, and the u32 hash
carried as int32 words through ``core.u32`` (multiplication wraps the same;
right shifts are logical).  Scalar constants are Python floats, which
PyTorch rounds to float32 before the op - the value JAX's ``_F32(c)`` has.
"""

from __future__ import annotations

import numpy as np
import torch

from rvgrt_tpu_torch.core import u32

_F32 = torch.float32
_I32 = torch.int32

# Simplex skew constants.
_F2 = (3.0 ** 0.5 - 1.0) * 0.5
_G2 = (3.0 - 3.0 ** 0.5) * 0.5
_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0


def _wang_mix(key):
    """Thomas Wang 32-bit integer finalizer (TerrainGeneration.cuh:37-42)."""
    key = (key ^ 61) ^ u32.lsr(key, 16)
    key = key * 9
    key = key ^ u32.lsr(key, 4)
    key = key * 0x27D4EB2D
    key = key ^ u32.lsr(key, 15)
    return key


def hash3(xi, yi, zi):
    """Spatial hash of 3 int32 lattice coords -> u32 word (as int32)."""
    key = xi * 73856093
    key = key ^ (yi * 19349663)
    key = key ^ (zi * 83492791)
    return _wang_mix(key)


def hash2(xi, yi):
    key = xi * 73856093
    key = key ^ (yi * 19349663)
    return _wang_mix(key)


def _grad2(h):
    """12-gradient-free 2D gradient from hash (TerrainGeneration.cuh:65-79)."""
    h = h & 7
    gx = torch.where((h & 1) != 0, 1.0, -1.0)
    gy = torch.where((h & 2) != 0, 1.0, -1.0)
    small = h < 4
    gx = torch.where(small, gx, 0.0)
    gy = torch.where(small, 0.0, gy)
    return gx, gy


def _grad3(h):
    """16-case 3D gradient from hash bits (TerrainGeneration.cuh:161-175)."""
    h = h & 15
    gx = torch.where((h & 1) != 0, 1.0, -1.0)
    gy = torch.where((h & 2) != 0, 1.0, -1.0)
    gz = torch.where((h & 4) != 0, 1.0, -1.0)
    gz = torch.where(h < 8, 0.0, gz)
    gx = torch.where((h >= 8) & (h < 12), 0.0, gx)
    gy = torch.where(h >= 12, 0.0, gy)
    return gx, gy, gz


def _falloff(t, gdot):
    """n = max(0, t)^4-ish contribution: t = r2 - d2; squared twice."""
    t = torch.clamp_min(t, 0.0)
    t = t * t
    return t * t * gdot


def simplex2d(px, py):
    """2D simplex noise, approx [-1, 1] (TerrainGeneration.cuh:81-142)."""
    s = (px + py) * _F2
    i = torch.floor(px + s).to(_I32)
    j = torch.floor(py + s).to(_I32)

    t = (i + j).to(_F32) * _G2
    x0 = px - i.to(_F32) + t
    y0 = py - j.to(_F32) + t

    gtr = x0 > y0  # pick second simplex vertex
    i1 = gtr.to(_I32)
    j1 = 1 - i1

    x1 = x0 - i1.to(_F32) + _G2
    y1 = y0 - j1.to(_F32) + _G2
    x2 = x0 - 1.0 + 2.0 * _G2
    y2 = y0 - 1.0 + 2.0 * _G2

    g0x, g0y = _grad2(hash2(i, j))
    g1x, g1y = _grad2(hash2(i + i1, j + j1))
    g2x, g2y = _grad2(hash2(i + 1, j + 1))

    n0 = _falloff(0.5 - x0 * x0 - y0 * y0, g0x * x0 + g0y * y0)
    n1 = _falloff(0.5 - x1 * x1 - y1 * y1, g1x * x1 + g1y * y1)
    n2 = _falloff(0.5 - x2 * x2 - y2 * y2, g2x * x2 + g2y * y2)

    return 70.0 * (n0 + n1 + n2)


def simplex3d(px, py, pz):
    """3D simplex noise with branchless corner selection
    (TerrainGeneration.cuh:178-254)."""
    s = (px + py + pz) * _F3
    i = torch.floor(px + s).to(_I32)
    j = torch.floor(py + s).to(_I32)
    k = torch.floor(pz + s).to(_I32)

    t = (i + j + k).to(_F32) * _G3
    x0 = px - (i.to(_F32) - t)
    y0 = py - (j.to(_F32) - t)
    z0 = pz - (k.to(_F32) - t)

    c_xy = (x0 >= y0).to(_I32)
    c_xz = (x0 >= z0).to(_I32)
    c_yz = (y0 >= z0).to(_I32)

    i1 = c_xy & c_xz
    j1 = (1 - c_xy) & c_yz
    k1 = (1 - c_xz) & (1 - c_yz)

    i2 = 1 - ((1 - c_xy) & (1 - c_xz))  # 1 - x0_is_smallest
    j2 = 1 - (c_xy & (1 - c_yz))        # 1 - y0_is_smallest
    k2 = 1 - (c_xz & c_yz)              # 1 - z0_is_smallest

    x1 = x0 - i1.to(_F32) + _G3
    y1 = y0 - j1.to(_F32) + _G3
    z1 = z0 - k1.to(_F32) + _G3

    x2 = x0 - i2.to(_F32) + 2.0 * _G3
    y2 = y0 - j2.to(_F32) + 2.0 * _G3
    z2 = z0 - k2.to(_F32) + 2.0 * _G3

    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3

    g0x, g0y, g0z = _grad3(hash3(i, j, k))
    g1x, g1y, g1z = _grad3(hash3(i + i1, j + j1, k + k1))
    g2x, g2y, g2z = _grad3(hash3(i + i2, j + j2, k + k2))
    g3x, g3y, g3z = _grad3(hash3(i + 1, j + 1, k + 1))

    n0 = _falloff(0.5 - x0 * x0 - y0 * y0 - z0 * z0,
                  g0x * x0 + g0y * y0 + g0z * z0)
    n1 = _falloff(0.5 - x1 * x1 - y1 * y1 - z1 * z1,
                  g1x * x1 + g1y * y1 + g1z * z1)
    n2 = _falloff(0.5 - x2 * x2 - y2 * y2 - z2 * z2,
                  g2x * x2 + g2y * y2 + g2z * z2)
    n3 = _falloff(0.5 - x3 * x3 - y3 * y3 - z3 * z3,
                  g3x * x3 + g3y * y3 + g3z * z3)

    return 96.0 * (n0 + n1 + n2 + n3)


def _octaves(n: int, frequency: float, lacunarity: float,
             persistence: float):
    """(frequency, amplitude) per octave, advanced in float32 like the
    scalar code."""
    amplitude = np.float32(1.0)
    freq = np.float32(frequency)
    lac = np.float32(lacunarity)
    pers = np.float32(persistence)
    out = []
    for _ in range(n):
        out.append((float(freq), float(amplitude)))
        freq = np.float32(freq * lac)
        amplitude = np.float32(amplitude * pers)
    return out


def fbm3d(x, y, z, octaves: int, frequency: float, lacunarity: float,
          persistence: float):
    """Fractional Brownian motion over simplex3d (TerrainGeneration.cuh:259-268)."""
    total = None
    for freq, amp in _octaves(octaves, frequency, lacunarity, persistence):
        term = simplex3d(x * freq, y * freq, z * freq) * amp
        total = term if total is None else total + term
    return total


def fbm2d(x, z, octaves: int, frequency: float, lacunarity: float,
          persistence: float):
    """2D fBm (TerrainGeneration.cuh:271-280)."""
    total = None
    for freq, amp in _octaves(octaves, frequency, lacunarity, persistence):
        term = simplex2d(x * freq, z * freq) * amp
        total = term if total is None else total + term
    return total
