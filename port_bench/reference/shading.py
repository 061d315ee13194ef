"""Shading: sky, cone-traced GI gather, soft shadows, water Fresnel, fog.

The port of ``rvgrt_tpu/render/shading.py``: the reference's per-pixel
shading (``computeColor``, ``StateRender.cu:33-146``) and cone marcher
(``traceCone``, ``raytracing_functions.cu:212-273``) as masked SoA
arithmetic over whole pixel buffers.  A cone step reads the SDF and the
GI grid (two gathers), or one word of the fused cone table
(``gi_grid.make_cone_table``, ``RenderConfig.gi_fused_cone``).
"""

from __future__ import annotations

import math

import torch

from .config import LightingConfig, WorldConfig
from . import noise, vecmath as vm
from . import gi_grid, sdf as sdf_mod

_F32 = torch.float32
_I32 = torch.int32


def sample_sky(d, lcfg: LightingConfig):
    """Sun disc above 0.999 cos, else horizon->zenith lerp on dir.y
    (``sampleSky``, raytracing_functions.cu:10-26)."""
    sun = vm.v3(*lcfg.sun_dir)
    sun_dot = vm.dot(d, sun)
    t = torch.clamp(0.5 * (d[1] + 1.0), 0.0, 1.0)
    sky = vm.lerp(vm.v3(*lcfg.sky_horizon), vm.v3(*lcfg.sky_zenith), t)
    return vm.where(sun_dot > lcfg.sun_disc_cos,
                    vm.splat(lcfg.sun_color, sun_dot), sky)


def max_cone_steps(lcfg: LightingConfig) -> int:
    """Iterations until a cone provably exceeds ``gi_max_distance`` (15 at
    the reference constants); capped at the reference's 20."""
    tan_half = 0.5 * math.tan(lcfg.cone_angle)
    cur, n = 2.0 * lcfg.gi_step_size, 0
    while cur <= lcfg.gi_max_distance and n < 20:
        cur += max(lcfg.gi_step_size, tan_half * cur)
        n += 1
    return n


def trace_cone(px, py, pz, dx, dy, dz, gi, sdf, cfg: WorldConfig,
               lcfg: LightingConfig, steps: int | None = None,
               cone_table=None):
    """Front-to-back cone march through the GI grid with SDF occlusion: a
    fixed trip count with an activity mask; one SDF gather + one GI gather
    per step, or one gather of ``cone_table`` (radiance + the occlusion
    mip; its alpha reads as 1)."""
    if steps is None:
        steps = max_cone_steps(lcfg)
    shape = torch.broadcast_shapes(px.shape, dx.shape)
    tan_angle = vm.f32(math.tan(lcfg.cone_angle))
    px, py, pz, dx, dy, dz = (a.broadcast_to(shape)
                              for a in (px, py, pz, dx, dy, dz))

    zf = torch.zeros(shape, dtype=_F32, device=px.device)
    acc_r, acc_g, acc_b, acc_a = zf, zf, zf, zf
    cur = zf + lcfg.gi_step_size * 2.0
    for _ in range(steps):
        active = (acc_a <= 0.99) & (cur <= lcfg.gi_max_distance)
        cx = px + dx * cur
        cy = py + dy * cur
        cz = pz + dz * cur
        if cone_table is not None:
            r, g, b, scene_dist, ok = gi_grid.sample_cone_table(
                cone_table, cfg, cx, cy, cz)
            a = torch.ones_like(r)
        else:
            vx = torch.floor(cx).to(_I32)
            vy = torch.floor(cy).to(_I32)
            vz = torch.floor(cz).to(_I32)
            scene_dist = sdf_mod.sample_sdf_at_voxel(sdf, cfg, vx, vy, vz)\
                .to(_F32) * float(cfg.sdf_coarseness)
            r, g, b, a, ok = gi_grid.sample_at_world(gi, cfg, cx, cy, cz)
        cone_w = cur * tan_angle
        occluded = active & (scene_dist < cone_w)
        acc_a = torch.where(occluded, 1.0, acc_a)

        sample = active & ~occluded
        blend = torch.where(sample & ok, (1.0 - acc_a) * a, 0.0)
        acc_r = acc_r + r * blend
        acc_g = acc_g + g * blend
        acc_b = acc_b + b * blend
        acc_a = acc_a + blend
        cur = torch.where(sample,
                          cur + torch.clamp_min(cone_w * 0.5,
                                                lcfg.gi_step_size), cur)
    return acc_r, acc_g, acc_b


def soft_shadow_march(px, py, pz, nx, ny, nz, hit, sdf,
                      cfg: WorldConfig, lcfg: LightingConfig,
                      sky_y=None, steps: int | None = None):
    """SDF-marched penumbra shadow: factor in [shadow_factor, 1]
    (``min(k * h / t)`` along the sun ray, one u8 gather per step, a fixed
    unrolled trip count; starts 1.25 cells off the face and 2 cells along
    the sun)."""
    steps = lcfg.soft_shadow_steps if steps is None else steps
    c = float(cfg.sdf_coarseness)
    sx, sy, sz = (vm.f32(v) for v in lcfg.sun_dir)
    k = vm.f32(lcfg.sun_softness)
    max_t = lcfg.soft_shadow_max_t

    ox = px + nx * (1.25 * c)
    oy = py + ny * (1.25 * c)
    oz = pz + nz * (1.25 * c)

    t = torch.full_like(px, 2.0 * c)
    res = torch.ones_like(px)
    done = ~hit

    for _ in range(steps):
        cx = ox + sx * t
        cy = oy + sy * t
        cz = oz + sz * t
        if sky_y is not None:
            # the sun rises (+y): above the highest solid voxel nothing
            # can occlude
            done = done | (cy >= sky_y)
        done = done | (t > max_t)
        h = sdf_mod.sample_sdf_at_voxel(
            sdf, cfg,
            torch.floor(cx).to(_I32),
            torch.floor(cy).to(_I32),
            torch.floor(cz).to(_I32)).to(_F32) * c
        res = torch.where(done, res, torch.minimum(res, k * h / t))
        done = done | (res <= 0.01)
        t = torch.where(done, t, t + torch.clamp_min(h, 1.5))

    sf = vm.f32(lcfg.shadow_factor)
    factor = sf + (1.0 - sf) * torch.clamp(res, 0.0, 1.0)
    return torch.where(hit, factor, 1.0)


def _normalize_safe(v, fallback=(1.0, 0.0, 0.0)):
    l = vm.length(v)
    ok = l > 1e-8
    inv = torch.where(ok, 1.0 / torch.clamp_min(l, 1e-8), 0.0)
    return vm.where(ok, vm.scale(v, inv), vm.splat(fallback, l))


def cone_directions(n):
    """The 6 VCT cone directions in the normal's hemisphere
    (StateRender.cu:104-115): up, 4 half-lerps to right/forward, 1
    diagonal (non-unit, as in the reference).  Degenerate normals fall back
    to an axis-aligned basis."""
    up = n
    right = _normalize_safe(vm.cross(up, vm.splat((0.577, 0.577, 0.577),
                                                  n[0])))
    fwd = _normalize_safe(vm.cross(up, right), fallback=(0.0, 0.0, 1.0))
    neg = vm.f32(-1.0)
    return [
        up,
        vm.lerp(up, right, 0.5),
        vm.lerp(up, vm.scale(right, neg), 0.5),
        vm.lerp(up, fwd, 0.5),
        vm.lerp(up, vm.scale(fwd, neg), 0.5),
        vm.lerp(up, vm.lerp(right, fwd, 0.5), 0.5),
    ]


def gather_gi(hit_pos, normal, gi, sdf, cfg: WorldConfig,
              lcfg: LightingConfig, cone_table=None):
    """6-cone VCT gather, averaged (StateRender.cu:101-121).  Returns the
    *unmodulated* indirect light.  ``cone_table``: see ``trace_cone``."""
    dirs = cone_directions(normal)
    tr = tg = tb = None
    for d in dirs:
        r, g, b = trace_cone(hit_pos[0], hit_pos[1], hit_pos[2],
                             d[0], d[1], d[2], gi, sdf, cfg, lcfg,
                             cone_table=cone_table)
        tr = r if tr is None else tr + r
        tg = g if tg is None else tg + g
        tb = b if tb is None else tb + b
    inv = 1.0 / lcfg.num_cones
    return tr * inv, tg * inv, tb * inv


def water_normal(hit_pos, normal, time, lcfg: LightingConfig):
    """fbm-distorted water normal (StateRender.cu:56-58)."""
    t = time
    nx_w = noise.fbm3d(hit_pos[0], hit_pos[2], t, 3, 0.06, 2.0, 0.6)
    ny_w = noise.fbm3d(hit_pos[2], hit_pos[0], t + 112.0, 3, 0.06, 2.0, 0.6)
    distorted = vm.add(normal, (nx_w * 0.1, ny_w * 0.1,
                                torch.zeros_like(nx_w)))
    return _normalize_safe(distorted)


def fresnel_schlick(n_dot_v, base_reflectivity):
    """Schlick's approximation (StateRender.cu:81-82)."""
    base = vm.f32(base_reflectivity)
    return base + (1.0 - base) * torch.pow(1.0 - n_dot_v, 5.0)
