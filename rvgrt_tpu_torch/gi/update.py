"""Progressive GI radiance-cache update.

The port of ``rvgrt_tpu/gi/update.py`` (the reference's ``GlobalIlluminate``,
``CoarseArray.cu:273-355``): every frame a contiguous window of GI cells
each casts one sun-shadow ray and one random bounce ray through the tracer
and EMA-blends the new sample into the cell at rate 0.04.  The RNG is the
reference's xorshift32 per cell, seeded ``idx + frame * 198491317``, so both
packages draw the same bits; the sphere direction is rejection-sampled over
a fixed 8 attempts.

The GI traces run the two-phase straggler respite when
``gi_straggler_budget`` > 0 (``bench.py`` runs 12).  The GI init is the
ray-free heightfield one (``init_gi_heightfield``).  Not ported yet: the
traced ``init_gi``, ``init_gi_chunked`` and ``init_gi_strided``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.render import shading
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.world import atlas as atlas_mod
from rvgrt_tpu_torch.world import gi_grid, voxel_grid

_F32 = torch.float32
_I32 = torch.int32


def _xorshift(state):
    state = state ^ (state << 13)
    state = state ^ u32.lsr(state, 17)
    state = state ^ (state << 5)
    return state


def _rand01(state):
    """xorshift32 -> float in [0,1] (CoarseArray.cu:255-262)."""
    state = _xorshift(state)
    return state, u32.to_f32(state) * (1.0 / 4294967295.0)


def random_sphere_dirs(seed, attempts: int = 8):
    """Rejection-sampled uniform sphere directions (CoarseArray.cu:263-271),
    fixed-attempt vectorized: keep the first candidate with |p|^2 < 1."""
    state = seed
    px = torch.zeros(seed.shape, dtype=_F32, device=seed.device)
    py = torch.zeros_like(px)
    pz = torch.zeros_like(px)
    done = torch.zeros(seed.shape, dtype=torch.bool, device=seed.device)
    for _ in range(attempts):
        state, rx = _rand01(state)
        state, ry = _rand01(state)
        state, rz = _rand01(state)
        cx = rx * 2.0 - 1.0
        cy = ry * 2.0 - 1.0
        cz = rz * 2.0 - 1.0
        ok = (cx * cx + cy * cy + cz * cz) < 1.0
        take = ok & ~done
        px = torch.where(take, cx, px)
        py = torch.where(take, cy, py)
        pz = torch.where(take, cz, pz)
        done = done | ok
    # fall-through lanes: use the last candidate (normalized below)
    px = torch.where(done, px, cx)
    py = torch.where(done, py, cy)
    pz = torch.where(done, pz, cz)
    inv = 1.0 / torch.sqrt(torch.clamp_min(px * px + py * py + pz * pz,
                                           1e-12))
    return px * inv, py * inv, pz * inv


def _shift_zero(a: torch.Tensor, oz: int, ox: int) -> torch.Tensor:
    """out[z, x] = a[z + oz, x + ox], zero beyond the borders (outside the
    world there are no occluders)."""
    if oz == 0 and ox == 0:
        return a
    pz_lo, pz_hi = max(-oz, 0), max(oz, 0)
    px_lo, px_hi = max(-ox, 0), max(ox, 0)
    p = torch.nn.functional.pad(a, (px_lo, px_hi, pz_lo, pz_hi))
    return p[oz + pz_lo:oz + pz_lo + a.shape[0],
             ox + px_lo:ox + px_lo + a.shape[1]]


def sun_shadow_height(height: torch.Tensor, ecfg: EngineConfig
                      ) -> torch.Tensor:
    """(size_z, size_x) f32 shadow height: a point (x, y, z) is sunlit by
    the heightfield iff ``y >= S[z, x]`` (horizon mapping: 4 linear
    near-field steps + log-doubling for the far field)."""
    cfg, lcfg = ecfg.world, ecfg.lighting
    s = lcfg.sun_dir
    hn = math.sqrt(s[0] * s[0] + s[2] * s[2])
    assert s[1] > 0 and hn > 0, s
    ux, uz = s[0] / hn, s[2] / hn
    rise = s[1] / hn
    S = height.to(_F32)
    H = S
    for t in (1, 2, 3):
        S = torch.maximum(S, _shift_zero(H, round(t * uz), round(t * ux))
                          - t * rise)
    d = 4.0
    while d * rise < cfg.size_y:
        S = torch.maximum(S, _shift_zero(S, round(d * uz), round(d * ux))
                          - d * rise)
        d *= 2.0
    return S


def init_gi_heightfield(bits, ecfg: EngineConfig,
                        height: torch.Tensor | None = None) -> torch.Tensor:
    """Ray-free GI init from the terrain's sun-shadow heightfield: a cell
    starts at the sun color iff its centre is above the shadow height."""
    cfg, lcfg = ecfg.world, ecfg.lighting
    if height is None:
        height = voxel_grid.column_height(bits, cfg)
    S = sun_shadow_height(height, ecfg)
    c = cfg.gi_coarseness
    # GI cell column centers sit at (g + 0.5) * c -> nearest column c//2
    S_g = S[c // 2::c, c // 2::c]                      # (gz, gx)
    wy = (torch.arange(cfg.gi_size_y, dtype=_F32, device=S.device)
          + 0.5) * float(c)
    lit = wy[None, :, None] >= S_g[:, None, :]         # (gz, gy, gx)
    r = torch.where(lit, lcfg.sun_color[0], 0.0)
    g = torch.where(lit, lcfg.sun_color[1], 0.0)
    b = torch.where(lit, lcfg.sun_color[2], 0.0)
    return gi_grid.pack_rgba8(r, g, b).reshape(-1)


def update_gi(gi: torch.Tensor, bits, sdf, atlas, ecfg: EngineConfig,
              frame: int, offset: int, sky_y=None, table=None,
              return_stats: bool = False):
    """One progressive sweep slice: update ``ecfg.gi_window`` cells starting
    at ``offset`` (GlobalIlluminate, CoarseArray.cu:273-355).  Returns the
    new grid (``gi`` itself is not modified).

    ``ecfg.gi_straggler_budget > 0`` runs both traces with the two-phase
    straggler respite (``wavefront._trace_two_phase``, engaged from 4 x
    4096 cells).  ``return_stats``: also return ``{"straggler_overflow":
    0-d int32 tensor}``, the rays of this window that overflowed the
    respite's slots and read as misses; it stays on the device."""
    cfg, lcfg, rcfg = ecfg.world, ecfg.lighting, ecfg.render
    if ecfg.gi_straggler_budget > 0:
        rcfg = dataclasses.replace(rcfg,
                                   straggler_budget=ecfg.gi_straggler_budget)
    n = ecfg.gi_window
    dev = gi.device
    if table is None:
        table = wavefront.make_trace_table(bits, sdf, cfg)
    idx = offset + torch.arange(n, dtype=_I32, device=dev)
    # 2-D ray batch, the JAX package's layout
    idx = idx.reshape(-1, min(n, 4096))
    wx, wy, wz = gi_grid.cell_world_centers(cfg, idx)

    # cells inside solid voxels are kept unchanged (lines 296-300): park
    # their rays out of bounds so they retire at once
    inside = voxel_grid.is_solid(
        bits, cfg,
        torch.floor(wx).to(_I32),
        torch.floor(wy).to(_I32),
        torch.floor(wz).to(_I32))
    wx = torch.where(inside, -10.0, wx)
    wy = torch.where(inside, -10.0, wy)
    wz = torch.where(inside, -10.0, wz)

    sun = lcfg.sun_dir
    shadow = wavefront.trace(bits, sdf, cfg, rcfg, wx, wy, wz,
                             torch.full_like(wx, sun[0]),
                             torch.full_like(wx, sun[1]),
                             torch.full_like(wx, sun[2]),
                             torch.full_like(wx, 0.001), table=table,
                             sky_y=sky_y)
    new_r = torch.where(~shadow.hit, lcfg.sun_color[0], 0.0)
    new_g = torch.where(~shadow.hit, lcfg.sun_color[1], 0.0)
    new_b = torch.where(~shadow.hit, lcfg.sun_color[2], 0.0)

    # one random bounce ray; seed = idx + frame * 198491317 (line 252),
    # u32 arithmetic on int32 words
    seed = idx + u32.c(frame * 198491317)
    bdx, bdy, bdz = random_sphere_dirs(seed)
    bounce = wavefront.trace(bits, sdf, cfg, rcfg, wx, wy, wz,
                             bdx, bdy, bdz, torch.full_like(wx, 0.001),
                             table=table, sky_y=sky_y)

    # hit: previous radiance at the hit cell x surface albedo
    br, bg, bb, _, ok = gi_grid.sample_at_world(gi, cfg, bounce.px,
                                                bounce.py, bounce.pz)
    alb = atlas_mod.sample_texture(atlas, bounce.uv_u, bounce.uv_v,
                                   bounce.px, bounce.py, bounce.pz)
    hit_contrib = (br * alb[0], bg * alb[1], bb * alb[2])
    sky_col = shading.sample_sky((bdx, bdy, bdz), lcfg)
    use_hit = bounce.hit & ok
    adds = [torch.where(use_hit, hit_contrib[k],
                        torch.where(bounce.hit, 0.0, sky_col[k]))
            for k in range(3)]
    new_r = new_r + adds[0]
    new_g = new_g + adds[1]
    new_b = new_b + adds[2]

    # EMA blend into the previous quantized value (lines 339-354)
    prev_words = gi[offset:offset + n].reshape(idx.shape)
    pr, pg, pb, _ = gi_grid.unpack_rgba8(prev_words)
    lr = lcfg.gi_learning_rate
    fr = pr + (new_r - pr) * lr
    fg = pg + (new_g - pg) * lr
    fb = pb + (new_b - pb) * lr
    packed = gi_grid.pack_rgba8(fr, fg, fb)
    packed = torch.where(inside, prev_words, packed)
    new_gi = gi.clone()
    new_gi[offset:offset + n] = packed.reshape(-1)
    if return_stats:
        overflow = (shadow.degraded.sum(dtype=_I32)
                    + bounce.degraded.sum(dtype=_I32))
        return new_gi, {"straggler_overflow": overflow}
    return new_gi


def gi_delta(prev: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Mean absolute per-channel radiance change between two GI grids, in
    [0, 1] units (the convergence metric for BASELINE config 4)."""
    pr, pg, pb, _ = gi_grid.unpack_rgba8(prev)
    nr, ng, nb, _ = gi_grid.unpack_rgba8(new)
    return (torch.abs(nr - pr) + torch.abs(ng - pg)
            + torch.abs(nb - pb)).mean() / 3.0


def advance_offset(offset: int, ecfg: EngineConfig) -> int:
    """Round-robin window walk, wrapping at the grid size
    (CoarseArray.cu:392-394)."""
    n = ecfg.gi_window
    if offset + n >= ecfg.world.gi_num_cells:
        return 0
    return offset + n
