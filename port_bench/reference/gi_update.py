"""Progressive GI radiance-cache update.

The port of ``rvgrt_tpu/gi/update.py`` (the reference's ``GlobalIlluminate``,
``CoarseArray.cu:273-355``): every frame a contiguous window of GI cells
each casts one sun-shadow ray and one random bounce ray through the tracer
and EMA-blends the new sample into the cell at rate 0.04.  The RNG is the
reference's xorshift32 per cell, seeded ``idx + frame * 198491317``, so both
packages draw the same bits; the sphere direction is rejection-sampled over
a fixed 8 attempts.

The GI traces run the two-phase straggler respite when
``gi_straggler_budget`` > 0 (``bench.py`` runs 12).  The GI init is either
traced (``init_gi`` / ``init_gi_chunked`` / ``init_gi_strided``: one
sun-shadow ray per cell, the reference's ``InitialGlobalIlluminate``,
``CoarseArray.cu:211-245``) or the ray-free heightfield one
(``init_gi_heightfield``).  Each traced slice is one ``wavefront.trace``
call: one K1 launch, or two when the respite engages.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import EngineConfig
from . import u32
from . import shading
from . import wavefront
from . import atlas as atlas_mod
from . import gi_grid, voxel_grid

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


def _gi_rcfg(ecfg: EngineConfig):
    """The GI traces' render config: the straggler respite at
    ``gi_straggler_budget`` when it is > 0."""
    if ecfg.gi_straggler_budget > 0:
        return dataclasses.replace(ecfg.render,
                                   straggler_budget=ecfg.gi_straggler_budget)
    return ecfg.render


def _init_cells(bits, sdf, ecfg: EngineConfig, idx, sky_y=None,
                table=None) -> torch.Tensor:
    """Init words for a (2-D) batch of GI cell indices: one sun-shadow ray
    per cell from its centre, sunlit cells at the sun colour
    (InitialGlobalIlluminate semantics).  Returns words of ``idx``'s
    shape."""
    cfg, lcfg = ecfg.world, ecfg.lighting
    wx, wy, wz = gi_grid.cell_world_centers(cfg, idx)
    sun = lcfg.sun_dir
    res = wavefront.trace(bits, sdf, cfg, _gi_rcfg(ecfg), wx, wy, wz,
                          torch.full_like(wx, sun[0]),
                          torch.full_like(wx, sun[1]),
                          torch.full_like(wx, sun[2]),
                          torch.full_like(wx, 0.0001), sky_y=sky_y,
                          table=table)
    lit = ~res.hit
    r = torch.where(lit, lcfg.sun_color[0], 0.0)
    g = torch.where(lit, lcfg.sun_color[1], 0.0)
    b = torch.where(lit, lcfg.sun_color[2], 0.0)
    return gi_grid.pack_rgba8(r, g, b)


def init_gi(bits, sdf, ecfg: EngineConfig, sky_y=None, table=None,
            offset: int = 0, count: int | None = None) -> torch.Tensor:
    """One sun-shadow ray per cell of the slice ``[offset, offset +
    count)`` (the whole grid by default), in one trace."""
    count = ecfg.world.gi_num_cells if count is None else count
    idx = offset + torch.arange(count, dtype=_I32, device=bits.device)
    # 2-D ray batch, the JAX package's layout
    idx = idx.reshape(-1, min(count, 4096))
    return _init_cells(bits, sdf, ecfg, idx, sky_y=sky_y,
                       table=table).reshape(-1)


def init_gi_chunked(bits, sdf, ecfg: EngineConfig, sky_y=None, table=None,
                    chunk: int = 1 << 24) -> torch.Tensor:
    """The whole grid's init in slices of at most ``chunk`` cells, one
    trace each.  A tail shorter than a chunk is traced as a window of
    ``pad`` cells anchored at ``cells - pad`` (the JAX package's rule), so
    its leading cells repeat ones already traced and are dropped."""
    cells = ecfg.world.gi_num_cells
    if cells <= chunk:
        return init_gi(bits, sdf, ecfg, sky_y=sky_y, table=table)
    full = cells - cells % chunk
    parts = [init_gi(bits, sdf, ecfg, sky_y=sky_y, table=table, offset=off,
                     count=chunk) for off in range(0, full, chunk)]
    rem = cells - full
    if rem:
        pad = min(-(-rem // 4096) * 4096, chunk)
        tail = init_gi(bits, sdf, ecfg, sky_y=sky_y, table=table,
                       offset=cells - pad, count=pad)
        parts.append(tail[pad - rem:])
    return torch.cat(parts)


def init_gi_strided(bits, sdf, ecfg: EngineConfig, sky_y=None, table=None,
                    stride=(2, 2), chunk: int = 1 << 24) -> torch.Tensor:
    """The init from a strided sun-visibility lattice: one ray per
    (stride_x x stride_z) block of cells, replicated to its neighbours
    (nearest); stride (1, 1) is ``init_gi_chunked``.  The lattice is
    padded to whole rows of 4096 rays with copies of its last cell."""
    cfg = ecfg.world
    sx, sz = stride
    if sx <= 1 and sz <= 1:
        return init_gi_chunked(bits, sdf, ecfg, sky_y=sky_y, table=table,
                               chunk=chunk)
    dev = bits.device
    nx, ny, nz = cfg.gi_size_x, cfg.gi_size_y, cfg.gi_size_z
    nxc, nzc = -(-nx // sx), -(-nz // sz)
    gx = torch.clamp_max(sx // 2 + sx * torch.arange(nxc, dtype=_I32,
                                                     device=dev), nx - 1)
    gz = torch.clamp_max(sz // 2 + sz * torch.arange(nzc, dtype=_I32,
                                                     device=dev), nz - 1)
    gy = torch.arange(ny, dtype=_I32, device=dev)
    idx = gi_grid.cell_index(cfg, gx[None, None, :], gy[None, :, None],
                             gz[:, None, None]).reshape(-1)
    total = idx.numel()
    step = min(chunk, -(-total // 4096) * 4096)
    pad = -(-total // 4096) * 4096 - total
    if pad:
        idx = torch.cat([idx, idx[-1:].expand(pad)])
    parts = [_init_cells(bits, sdf, ecfg,
                         idx[off:off + step].reshape(-1, 4096), sky_y=sky_y,
                         table=table).reshape(-1)
             for off in range(0, total + pad, step)]
    words = torch.cat(parts)[:total].reshape(nzc, ny, nxc)
    # nearest replication back to the full lattice
    words = torch.repeat_interleave(words, sz, dim=0)[:nz]
    words = torch.repeat_interleave(words, sx, dim=2)[:, :, :nx]
    return words.reshape(-1)


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
              return_stats: bool = False, lowp: bool = False):
    """One progressive sweep slice: update ``ecfg.gi_window`` cells starting
    at ``offset`` (GlobalIlluminate, CoarseArray.cu:273-355).  Returns the
    new grid (``gi`` itself is not modified).

    ``ecfg.gi_straggler_budget > 0`` runs both traces with the two-phase
    straggler respite (``wavefront._trace_two_phase``, engaged from 4 x
    4096 cells).  ``return_stats``: also return ``{"straggler_overflow":
    0-d int32 tensor}``, the rays of this window that overflowed the
    respite's slots and read as misses; it stays on the device.
    ``lowp``: the blended radiance is rounded to bfloat16 before it is
    packed (the benchmark's control)."""
    cfg, lcfg = ecfg.world, ecfg.lighting
    rcfg = _gi_rcfg(ecfg)
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
    start = window_start(offset, n, gi.shape[0])
    prev_words = gi[start:start + n].reshape(idx.shape)
    pr, pg, pb, _ = gi_grid.unpack_rgba8(prev_words)
    lr = lcfg.gi_learning_rate
    fr = pr + (new_r - pr) * lr
    fg = pg + (new_g - pg) * lr
    fb = pb + (new_b - pb) * lr
    if lowp:
        fr, fg, fb = (a.to(torch.bfloat16).to(torch.float32)
                      for a in (fr, fg, fb))
    packed = gi_grid.pack_rgba8(fr, fg, fb)
    packed = torch.where(inside, prev_words, packed)
    new_gi = gi.clone()
    new_gi[start:start + n] = packed.reshape(-1)
    if return_stats:
        overflow = (shadow.degraded.sum(dtype=_I32)
                    + bounce.degraded.sum(dtype=_I32))
        return new_gi, {"straggler_overflow": overflow}
    return new_gi


def window_start(offset: int, n: int, cells: int) -> int:
    """Where an ``n``-cell window at ``offset`` is read and written: the
    start clamped into the grid, as JAX's ``dynamic_slice`` /
    ``dynamic_update_slice`` clamp it (a window that runs past the last
    cell lands on the grid's last ``n`` cells)."""
    return min(max(int(offset), 0), cells - n)


def advance_offset(offset: int, ecfg: EngineConfig) -> int:
    """Round-robin window walk, wrapping at the grid size
    (CoarseArray.cu:392-394)."""
    n = ecfg.gi_window
    if offset + n >= ecfg.world.gi_num_cells:
        return 0
    return offset + n
