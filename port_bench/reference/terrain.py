"""Terrain density function - the pure function that *is* the world.

The port of ``rvgrt_tpu/core/terrain.py``: the reference's ``Evaluate(x,y,z)``
(``TerrainGeneration.cuh:284-356``) as a vectorized float32 function - solid
sea floor below y=30, a 2D-simplex biome factor blending plains (amplitude
60) against mountains (amplitude 400), a 7-octave surface fbm, and two cave
carvers (spaghetti tunnels + cavern regions).  A voxel is solid iff
``density > solid_threshold`` (0.7, ``CArray.cu:27``).
"""

from __future__ import annotations

import torch

from .config import TerrainConfig
from . import noise


def evaluate_density(x, y, z, cfg: TerrainConfig = TerrainConfig()):
    """Density at float32 voxel coordinates; broadcasts over tensors."""
    biome_factor = (noise.simplex2d(x * cfg.biome_frequency,
                                    z * cfg.biome_frequency) + 1.0) * 0.5
    terrain_amplitude = cfg.plains_amplitude + biome_factor * (
        cfg.mountain_amplitude - cfg.plains_amplitude)

    density = cfg.ground_level - y
    surface = noise.fbm3d(x, y, z, cfg.surface_octaves, cfg.surface_frequency,
                          cfg.surface_lacunarity, cfg.surface_persistence)
    density = density + surface * terrain_amplitude

    # Cave carving only applies where the point is already solid ground.
    cave_raw = noise.fbm3d(x + 123.456, y, z, cfg.cave_octaves,
                           cfg.cave_frequency, cfg.surface_lacunarity,
                           cfg.surface_persistence)
    cave_norm = (cave_raw + 1.0) * 0.5
    is_spaghetti = torch.abs(cave_raw) < cfg.spaghetti_threshold

    cavern_region = (noise.simplex3d(x * cfg.cavern_region_freq,
                                     y * cfg.cavern_region_freq,
                                     z * cfg.cavern_region_freq) + 1.0) * 0.5
    is_cavern = (cavern_region > 0.65) & (cave_norm < cfg.cavern_threshold)

    carve = (density > 0.0) & (is_spaghetti | is_cavern)
    density = torch.where(carve, density - cfg.cave_carve_value, density)

    # Hard sea floor overrides everything below water_floor_y.
    return torch.where(y <= cfg.water_floor_y, 100.0, density)
