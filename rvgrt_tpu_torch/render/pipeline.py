"""Per-frame render pipeline over whole-image SoA buffers.

The port of ``rvgrt_tpu/render/pipeline.py`` (the reference's
``distApproximationKernel`` + ``renderKernel``, ``StateRender.cu:200-346``),
single slab, at full, checkerboard or quarter rate - the branches
``bench.py``'s frames take:

  1. prepass at 1/prepass_divisor res, started from an even coarser cascade
     trace: distance (biased, miss = 300) and, when coupled, a shadow factor;
  2. conservative distance upsample and shadow upsample;
  3. full-res primary trace from the conservative start;
  4. shading: water (fbm normal, reflection + reflection-shadow traces,
     Schlick Fresnel) / solid (atlas albedo, Lambert x shadow - soft shadows
     marched at decoupled sites -, optional 6-cone VCT GI, sky ambient) /
     miss (sky); exponential fog;
  5. motion vectors and clip depth from the two view-projection matrices.

Every trace goes through ``wavefront.trace`` and so, on a GPU, kernel K1;
on a GPU the GI gather and composite are the two kernels of
``ops/gi_kernels.py``, and their plain versions stay here.
The checker and quarter rates cut the primary grid before the primary
trace (``checker_select`` / ``quarter_select``); their expands and valid
masks are here too, and ``gi_composite(return_addend=True)`` hands out
the added light for the composite-cadence reuse.  The temporal start
hints (``temporal_start_hint`` / ``temporal_hints_from_prepass``: the
previous frame's prepass distances as conservative starts) and the
start/shadow overrides of ``render_slab`` are here; the fused cone table
(``RenderConfig.gi_fused_cone``) reaches the GI gather through
``gi_occ``.  Not ported yet: the sharded slab halo.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rvgrt_tpu_torch.config import EngineConfig
from rvgrt_tpu_torch.core import vecmath as vm
from rvgrt_tpu_torch.ops import gi_kernels
from rvgrt_tpu_torch.render import shading
from rvgrt_tpu_torch.trace import wavefront
from rvgrt_tpu_torch.utils import profiling
from rvgrt_tpu_torch.world import atlas as atlas_mod
from rvgrt_tpu_torch.world import gi_grid

_F32 = torch.float32
_I32 = torch.int32


class FrameOutputs(NamedTuple):
    color: torch.Tensor        # (H, W, 3) float32 in [0,1]
    motion: torch.Tensor       # (H, W, 2) float32, NDC delta, y negated
    depth: torch.Tensor        # (H, W) float32 clip z/w
    half_dist: torch.Tensor    # (H/d, W/d) float32 (biased)
    half_shadow: torch.Tensor  # (H/d, W/d) float32


class GBuffer(NamedTuple):
    """Primary-hit geometry + material for deferred (split-dispatch) GI.
    ``fog`` is the fog transmittance the base color was composited with."""
    hit: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    t: torch.Tensor
    albedo_r: torch.Tensor
    albedo_g: torch.Tensor
    albedo_b: torch.Tensor
    fog: torch.Tensor


class CameraArrays(NamedTuple):
    """Camera basis + matrices as float32 tensors on the render device."""
    pos: torch.Tensor          # (3,)
    forward: torch.Tensor      # (3,)
    right: torch.Tensor        # (3,)
    up: torch.Tensor           # (3,)
    vp: torch.Tensor           # (4,4) current unjittered view-projection
    prev_vp: torch.Tensor      # (4,4) previous unjittered view-projection
    jitter: torch.Tensor       # (2,) NDC jitter
    time: torch.Tensor         # () seconds, for water waves


def _ray_dirs(cam: CameraArrays, width: int, height: int,
              pixel_center: bool, y0: int = 0, rows: int | None = None):
    """Primary ray directions: dir = normalize(fo + ndc.x*ri + ndc.y*up);
    the prepass samples at (i+0.5)/n, the main pass at i/n; row indices
    clamp to the image (halo rows duplicate the edge)."""
    dev = cam.pos.device
    off = 0.5 if pixel_center else 0.0
    rows = height if rows is None else rows
    xs = (torch.arange(width, dtype=_F32, device=dev) + off) / width
    iy = torch.clamp(y0 + torch.arange(rows, dtype=_I32, device=dev),
                     0, height - 1)
    ys = (iy.to(_F32) + off) / height
    ndc_x = xs[None, :] * 2.0 - 1.0 + cam.jitter[0]
    ndc_y = ys[:, None] * 2.0 - 1.0 + cam.jitter[1]
    fo, ri, up = cam.forward, cam.right, cam.up
    dx = fo[0] + ndc_x * ri[0] + ndc_y * up[0]
    dy = fo[1] + ndc_x * ri[1] + ndc_y * up[1]
    dz = fo[2] + ndc_x * ri[2] + ndc_y * up[2]
    inv = 1.0 / vm.sqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv


def make_trace_fn(bits, sdf, cfg, rcfg, table=None, sky_y=None):
    """Default ray-cast closure: ``trace_fn(ox, oy, oz, dx, dy, dz, t0)``."""
    if table is None:
        table = wavefront.make_trace_table(bits, sdf, cfg)

    def trace_fn(ox, oy, oz, dx, dy, dz, t0):
        return wavefront.trace(None, None, cfg, rcfg, ox, oy, oz,
                               dx, dy, dz, t0, table=table, sky_y=sky_y)

    return trace_fn


def _shadow_trace(trace_fn, hit, hpos, normal, sun, offset: float):
    """Sun-shadow ray from hit + normal*offset; misses parked OOB."""
    ox = torch.where(hit, hpos[0] + normal[0] * offset, -10.0)
    oy = torch.where(hit, hpos[1] + normal[1] * offset, -10.0)
    oz = torch.where(hit, hpos[2] + normal[2] * offset, -10.0)
    res = trace_fn(ox, oy, oz, sun[0], sun[1], sun[2], torch.zeros_like(ox))
    return res.hit


def _clamped_shift(c, delta: int, axis: int):
    """``out[i] = c[clip(i + delta, 0, n-1)]`` along ``axis``."""
    if delta == 0:
        return c
    n = c.shape[axis]
    idx = torch.clamp(torch.arange(n, device=c.device) + delta, 0, n - 1)
    return c.index_select(axis, idx)


def _phase_expand(c, d: int, off: int, delta: int, axis: int):
    """Upsample by ``d`` along ``axis`` with nearest-coarse replication:
    ``out[y] = c[clip(i0(y) + delta)]`` with ``i0(y) = floor((y-off)/d)``."""
    if d == 1:
        return _clamped_shift(c, delta, axis)
    phases = [_clamped_shift(c, delta + (0 if r >= off else -1), axis)
              for r in range(d)]
    st = torch.stack(phases, dim=axis + 1)
    shape = list(c.shape)
    shape[axis] *= d
    return st.reshape(shape)


def _min_expand_axis(c, q: int, off: int, n_out: int, axis: int):
    """Conservative upsample-by-q along ``axis``: min over the coarse
    samples at offsets {-1, 0, +1, +2} around each output position."""
    e = [_phase_expand(c, q, off, delta, axis) for delta in (-1, 0, 1, 2)]
    m = torch.minimum(torch.minimum(e[0], e[1]), torch.minimum(e[2], e[3]))
    return m.narrow(axis, 0, n_out)


_HINT_BIG = 1.0e9


def temporal_start_hint(cam: CameraArrays, prev_cam: CameraArrays,
                        prev_t: torch.Tensor, rcfg, out_h: int, out_w: int,
                        *, pixel_center: bool = False,
                        prev_pixel_center: bool = True, window: int = 2,
                        bias: float | None = None, margin: float = 2.0,
                        sky_start: float | None = None) -> torch.Tensor:
    """Conservative trace-start distances from the previous frame's
    hit-distance map ``prev_t`` (the JAX ``temporal_start_hint``: the world
    is static, so last frame's visibility bounds this frame's).

    Each current-grid ray direction is projected into the previous ray grid
    through the previous camera's basis, the windowed min of ``prev_t`` is
    read there, and the bound is tightened by the camera's translation and
    ``bias``; reads closer than the parallax gate give 0 (no hint).  Sky
    lanes (``prev_t >= _HINT_BIG / 2``) give ``sky_start`` under a camera
    that did not move, else 0.  Returns an (out_h, out_w) float32 map (0 =
    no hint), to be maximum-combined with the same-frame starts."""
    bias_f = float(rcfg.dist_bias if bias is None else bias)
    ph, pw = prev_t.shape
    m = prev_t
    for ax in (0, 1):
        acc = m
        for dlt in range(1, window + 1):
            acc = torch.minimum(acc, _clamped_shift(m, dlt, ax))
            acc = torch.minimum(acc, _clamped_shift(m, -dlt, ax))
        m = acc
    dx, dy, dz = _ray_dirs(cam, out_w, out_h, pixel_center=pixel_center)
    fo, ri, up = prev_cam.forward, prev_cam.right, prev_cam.up
    dfo = dx * fo[0] + dy * fo[1] + dz * fo[2]
    ahead = dfo > 1e-6
    dsafe = torch.where(ahead, dfo, 1.0)
    ndc_x = (dx * ri[0] + dy * ri[1] + dz * ri[2]) / dsafe \
        - prev_cam.jitter[0]
    ndc_y = (dx * up[0] + dy * up[1] + dz * up[2]) / dsafe \
        - prev_cam.jitter[1]
    poff = 0.5 if prev_pixel_center else 0.0
    fx = (ndc_x + 1.0) * (0.5 * pw) - poff
    fy = (ndc_y + 1.0) * (0.5 * ph) - poff
    inside = (ahead & (fx >= -0.5) & (fx <= pw - 0.5)
              & (fy >= -0.5) & (fy <= ph - 0.5))
    ix = torch.clamp(torch.round(fx).to(_I32), 0, pw - 1)
    iy = torch.clamp(torch.round(fy).to(_I32), 0, ph - 1)
    g = m[iy.long(), ix.long()]
    dp = cam.pos - prev_cam.pos
    delta = vm.sqrt(dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2])
    # parallax gate: the window covers the warp's translation error only
    # beyond this distance
    t_gate = (margin * 0.5 * pw / max(window, 0.5)) * delta
    sky = g >= _HINT_BIG * 0.5
    hint = torch.clamp_min(g - delta - bias_f, 0.0)
    hint = torch.where(g >= t_gate, hint, 0.0)
    sky_hint = 0.0
    if sky_start is not None:
        sky_hint = torch.where(delta < 1e-5, float(sky_start), 0.0)
    hint = torch.where(sky, sky_hint, hint)
    return torch.where(inside, hint, 0.0)


def temporal_hints_from_prepass(prev_half_dist: torch.Tensor,
                                cam: CameraArrays, prev_cam: CameraArrays,
                                rcfg, *, window: int = 2,
                                bias: float | None = None,
                                margin: float = 2.0,
                                sky_start: float | None = None):
    """(hint_half, hint_full) for this frame from the previous frame's
    prepass distances (``FrameOutputs.half_dist``: biased, miss =
    ``miss_distance``): the prepass grid's and the primary grid's
    ``temporal_start_hint``."""
    prev_t = prev_half_dist + rcfg.dist_bias
    prev_t = torch.where(prev_t >= rcfg.miss_distance - 0.5, _HINT_BIG,
                         prev_t)
    kw = dict(window=window, bias=bias, margin=margin, sky_start=sky_start)
    hint_half = temporal_start_hint(
        cam, prev_cam, prev_t, rcfg, rcfg.half_height, rcfg.half_width,
        pixel_center=True, **kw)
    hint_full = temporal_start_hint(
        cam, prev_cam, prev_t, rcfg, rcfg.height, rcfg.width,
        pixel_center=False, **kw)
    return hint_half, hint_full


def _take_rows(full: torch.Tensor, y0: int, rows: int, n: int):
    """Rows [y0, y0 + rows) of a full-frame map, edge-clamped like the ray
    grids."""
    iy = torch.clamp(y0 + torch.arange(rows, device=full.device), 0, n - 1)
    return full[iy]


def _cascade_start(trace_fn, rcfg, cam: CameraArrays, hy0: int, hrows: int,
                   hint_rows=None):
    """Start distances for the prepass from an even coarser trace: rays at
    1/prepass_cascade of the prepass grid trace from scratch (or from
    ``hint_rows``, this slab's rows of a temporal start hint, where it is
    larger), and every prepass ray starts at (min over the surrounding
    coarse samples) - dist_bias."""
    dev = cam.pos.device
    hw = rcfg.half_width
    q = rcfg.prepass_cascade
    while q > 1 and hw % q:
        q //= 2
    if q <= 1:
        return torch.zeros(hrows, hw, dtype=_F32, device=dev)
    off = q // 2
    crows = -(-hrows // q) + 1
    ccols = hw // q
    ly = torch.clamp(off + q * torch.arange(crows, dtype=_I32, device=dev),
                     0, hrows - 1)
    gy = torch.clamp(hy0 + ly, 0, rcfg.half_height - 1)
    lx = torch.clamp(off + q * torch.arange(ccols, dtype=_I32, device=dev),
                     0, hw - 1)
    ys = (gy.to(_F32) + 0.5) / rcfg.half_height
    xs = (lx.to(_F32) + 0.5) / hw
    ndc_x = xs[None, :] * 2.0 - 1.0 + cam.jitter[0]
    ndc_y = ys[:, None] * 2.0 - 1.0 + cam.jitter[1]
    dx = cam.forward[0] + ndc_x * cam.right[0] + ndc_y * cam.up[0]
    dy = cam.forward[1] + ndc_x * cam.right[1] + ndc_y * cam.up[1]
    dz = cam.forward[2] + ndc_x * cam.right[2] + ndc_y * cam.up[2]
    inv = 1.0 / vm.sqrt(dx * dx + dy * dy + dz * dz)
    zeros = torch.zeros(crows, ccols, dtype=_F32, device=dev)
    cstart = zeros
    if hint_rows is not None:
        cstart = torch.maximum(cstart, hint_rows[ly.long()][:, lx.long()])
    res = trace_fn(cam.pos[0] + zeros, cam.pos[1], cam.pos[2],
                   dx * inv, dy * inv, dz * inv, cstart)
    dist = torch.where(res.hit, _distance(res, cam), rcfg.miss_distance)
    m = _min_expand_axis(dist, q, off, hrows, 0)
    m = _min_expand_axis(m, q, off, hw, 1)
    return torch.clamp_min(m - rcfg.dist_bias, 0.0)


def _distance(res, cam: CameraArrays):
    """Hit distance from the camera, correctly rounded on every device
    (``vecmath.sqrt``), as the JAX package's."""
    ex = res.px - cam.pos[0]
    ey = res.py - cam.pos[1]
    ez = res.pz - cam.pos[2]
    return vm.sqrt(ex * ex + ey * ey + ez * ez)


def half_res_prepass(bits, sdf, cfg, rcfg, lcfg, cam: CameraArrays,
                     hy0: int = 0, hrows: int | None = None, table=None,
                     sky_y=None, trace_fn=None, start_hint=None,
                     want_shadow: bool = True):
    """distApproximationKernel (StateRender.cu:255-286): distance - bias
    (miss -> 300) and a shadow factor at prepass resolution, for the
    (edge-clamped) row slab ``hy0 .. hy0 + hrows``.  ``start_hint``: an
    optional full-frame (half_height, half_width) conservative start map
    (``temporal_start_hint``), maximum-combined with the cascade start.
    ``want_shadow=False`` (decoupled shadow sites) skips the shadow
    estimate."""
    if trace_fn is None:
        trace_fn = make_trace_fn(bits, sdf, cfg, rcfg, table=table,
                                 sky_y=sky_y)
    hw, hh = rcfg.half_width, rcfg.half_height
    hrows = hh if hrows is None else hrows
    dx, dy, dz = _ray_dirs(cam, hw, hh, pixel_center=True, y0=hy0,
                           rows=hrows)
    hint_rows = None
    if start_hint is not None:
        hint_rows = _take_rows(start_hint, hy0, hrows, hh)
    start = _cascade_start(trace_fn, rcfg, cam, hy0, hrows,
                           hint_rows=hint_rows)
    if hint_rows is not None:
        start = torch.maximum(start, hint_rows)
    res = trace_fn(cam.pos[0] + torch.zeros_like(dx), cam.pos[1],
                   cam.pos[2], dx, dy, dz, start)
    dist = torch.where(res.hit, _distance(res, cam), rcfg.miss_distance)

    if not want_shadow:
        shadow = torch.ones_like(dist)
    elif lcfg.soft_shadows:
        s = lcfg.soft_shadow_stride
        if s > 1:
            # march every s-th prepass pixel and lerp between the sites
            def sub(a):
                return a[::s, ::s]
            q = shading.soft_shadow_march(
                sub(res.px), sub(res.py), sub(res.pz),
                sub(res.nx), sub(res.ny), sub(res.nz), sub(res.hit),
                sdf, cfg, lcfg, sky_y=sky_y)
            shadow = _expand_even(q, s, res.hit.shape)
        else:
            shadow = shading.soft_shadow_march(
                res.px, res.py, res.pz, res.nx, res.ny, res.nz, res.hit,
                sdf, cfg, lcfg, sky_y=sky_y)
    else:
        sun = vm.splat(lcfg.sun_dir, res.hit)
        shadow_hit = _shadow_trace(trace_fn, res.hit,
                                   (res.px, res.py, res.pz),
                                   (res.nx, res.ny, res.nz), sun,
                                   offset=1e-1)
        shadow = torch.where(res.hit & shadow_hit, lcfg.shadow_factor, 1.0)
    return dist - rcfg.dist_bias, shadow


def _expand_even(a: torch.Tensor, s: int, out_shape) -> torch.Tensor:
    """Linear upsample by ``s`` with sources anchored at the even grid
    sites (out[s*k] == a[k]); edge-clamped, sliced to ``out_shape``."""
    def axis_up(v, axis):
        nxt = _clamped_shift(v, 1, axis)
        ws = [(1.0 - j / s) for j in range(s)]
        planes = [v * w + nxt * (1.0 - w) for w in ws]
        out = torch.stack(planes, dim=axis + 1)
        shape = list(v.shape)
        shape[axis] *= s
        return out.reshape(shape)

    up = axis_up(axis_up(a, 0), 1)
    return up[:out_shape[0], :out_shape[1]]


def min_dist_upsample(half_dist: torch.Tensor) -> torch.Tensor:
    """Conservative 2x upsample: min over the 2x2 quad at (ix//2, iy//2),
    neighbours clamped at edges (``minDist``, StateRender.cu:182-198)."""
    pad = torch.cat([half_dist, half_dist[-1:]], dim=0)
    pad = torch.cat([pad, pad[:, -1:]], dim=1)
    m = torch.minimum(torch.minimum(pad[:-1, :-1], pad[:-1, 1:]),
                      torch.minimum(pad[1:, :-1], pad[1:, 1:]))
    return torch.repeat_interleave(torch.repeat_interleave(m, 2, dim=0), 2,
                                   dim=1)


def _min_dist_upsample_slab(half_halo: torch.Tensor, slab_h: int,
                            d: int = 2):
    """minDist over a prepass slab with a 1-row halo on each side.  d == 2
    is the reference's exact 2x2 quad min (StateRender.cu:182-198); d > 2
    takes the min over the {-1, 0, 1, 2} coarse offsets."""
    if d == 2:
        pad = torch.cat([half_halo, half_halo[:, -1:]], dim=1)
        m = torch.minimum(torch.minimum(pad[:-1, :-1], pad[:-1, 1:]),
                          torch.minimum(pad[1:, :-1], pad[1:, 1:]))
        m = m[1:1 + slab_h // 2]
    else:
        m = half_halo
        for ax in (0, 1):
            acc = m
            for dlt in (-1, 1, 2):
                acc = torch.minimum(acc, _clamped_shift(m, dlt, ax))
            m = acc
        m = m[1:1 + slab_h // d]
    return torch.repeat_interleave(torch.repeat_interleave(m, d, dim=0),
                                   d, dim=1)


def _bilinear_upsample_slab(half_halo: torch.Tensor, slab_h: int,
                            d: int = 2):
    """Shadow upsample of a prepass slab with halo rows: d == 2 keeps the
    reference's CUDA-texture bilinear (StateRender.cu:230); d > 2 the
    even-anchored linear expand."""
    a = half_halo
    if d == 2:
        prevx = torch.cat([a[:, :1], a[:, :-1]], dim=1)
        evenx = 0.5 * (prevx + a)
        ax = torch.stack([evenx, a], dim=2).reshape(a.shape[0],
                                                    a.shape[1] * 2)
        h = slab_h // 2
        avg = 0.5 * (ax[0:h] + ax[1:h + 1])
        cpy = ax[1:h + 1]
        return torch.stack([avg, cpy], dim=1).reshape(slab_h, ax.shape[1])
    return _expand_even(a[1:], d, (slab_h, a.shape[1] * d))


def _phase_frac(n_coarse: int, d: int, off: int, device):
    """Per-output bilinear fraction toward the +1 coarse neighbor.  The
    table goes to the card in a blocking copy from pageable memory, which
    waits for the stream's queued work: a sync."""
    with profiling.span("sync.gi_upsample"):
        fr = torch.tensor([((r - off) % d) / d for r in range(d)],
                          dtype=_F32, device=device)
    return fr.repeat(n_coarse)


def _normal_code(nx, ny, nz):
    """Axis-aligned face normal as a small int (0..5 = +-x/+-y/+-z,
    6 = degenerate) for equality tests in the GI upsample."""
    return torch.where(nx != 0, (nx > 0).to(_I32),
                       torch.where(ny != 0, 2 + (ny > 0).to(_I32),
                                   torch.where(nz != 0,
                                               4 + (nz > 0).to(_I32), 6)))


def _gi_joint_upsample(cir, cig, cib, c_t, c_code, c_valid,
                       t_full, code_full, d: int, rel_thresh: float):
    """Geometry-aware (Hc,Wc) -> (H,W) upsample of the strided GI gather:
    bilinear weights x validity x similarity (same face normal, hit
    distance within a relative threshold), falling back to
    validity-weighted bilinear where no similar coarse sample exists."""
    off = d // 2
    hc, wc = cir.shape
    fy = _phase_frac(hc, d, off, cir.device)[:, None]
    fx = _phase_frac(wc, d, off, cir.device)[None, :]
    chans = (cir, cig, cib)
    num1 = [None, None, None]
    num2 = [None, None, None]
    den1 = den2 = None

    def acc(a, b):
        return b if a is None else a + b

    for dy in (0, 1):
        wy = fy if dy else 1.0 - fy
        for dx in (0, 1):
            wx_ = fx if dx else 1.0 - fx

            def ex(c, dy=dy, dx=dx):
                e = _phase_expand(c, d, off, dy, 0)
                return _phase_expand(e, d, off, dx, 1)

            wb = wy * wx_ * ex(c_valid).to(_F32)
            et = ex(c_t)
            sim = (ex(c_code) == code_full) \
                & (torch.abs(et - t_full) <= rel_thresh * t_full + 2.0)
            w1 = wb * sim.to(_F32)
            den1 = acc(den1, w1)
            den2 = acc(den2, wb)
            for k in range(3):
                e = ex(chans[k])
                num1[k] = acc(num1[k], w1 * e)
                num2[k] = acc(num2[k], wb * e)
    use1 = den1 > 1e-4
    use2 = den2 > 1e-4
    out = []
    for k in range(3):
        v1 = num1[k] / torch.clamp_min(den1, 1e-6)
        v2 = num2[k] / torch.clamp_min(den2, 1e-6)
        out.append(torch.where(use1, v1, torch.where(use2, v2, 0.0)))
    return out[0], out[1], out[2]


def gi_divisor(h: int, w: int, d: int) -> int:
    """The GI gather's divisor on an (h, w) grid: ``d`` halved while it
    does not divide both, and 1 at the least."""
    while d > 1 and (h % d or w % d):
        d //= 2
    return max(d, 1)


def _cone_table(gi, sdf, cfg, rcfg, gi_occ):
    """With ``rcfg.gi_fused_cone`` the fused cone table (radiance | the
    occlusion mip ``gi_occ``, built from ``sdf`` when None), else None."""
    if not rcfg.gi_fused_cone:
        return None
    occ = gi_occ if gi_occ is not None \
        else gi_grid.build_occlusion(sdf, cfg)
    return gi_grid.make_cone_table(gi, occ)


def gather_gi_image(res, gi, sdf, cfg, rcfg, lcfg, gi_occ=None):
    """Per-pixel indirect light for a traced frame: cones march every
    ``gi_res_divisor``-th pixel and the result is geometry-aware
    upsampled.  With ``rcfg.gi_fused_cone`` each cone step reads one word
    of the fused cone table (radiance | the occlusion mip ``gi_occ``, built
    from ``sdf`` when None).  CUDA tensors go through the two kernels of
    ``ops/gi_kernels.py``, CPU tensors through
    ``gather_gi_image_plain``."""
    if res.hit.device.type == "cpu":
        return gather_gi_image_plain(res, gi, sdf, cfg, rcfg, lcfg,
                                     gi_occ=gi_occ)
    tbl = _cone_table(gi, sdf, cfg, rcfg, gi_occ)
    h, w = res.hit.shape
    return gi_kernels.gather_gi_image_cuda(
        res, gi if tbl is None else tbl, sdf, cfg, rcfg, lcfg,
        gi_divisor(h, w, rcfg.gi_res_divisor), tbl is not None)


def gather_gi_image_plain(res, gi, sdf, cfg, rcfg, lcfg, gi_occ=None):
    """``gather_gi_image`` in plain PyTorch, on any device."""
    cone_tbl = _cone_table(gi, sdf, cfg, rcfg, gi_occ)
    h, w = res.hit.shape
    d = gi_divisor(h, w, rcfg.gi_res_divisor)
    hpos = (res.px, res.py, res.pz)
    normal = (res.nx, res.ny, res.nz)
    if d == 1:
        return shading.gather_gi(hpos, normal, gi, sdf, cfg, lcfg,
                                 cone_table=cone_tbl)
    off = d // 2

    def sub(a):
        return a[off::d, off::d]

    cir, cig, cib = shading.gather_gi(
        tuple(sub(a) for a in hpos), tuple(sub(a) for a in normal),
        gi, sdf, cfg, lcfg, cone_table=cone_tbl)
    code = _normal_code(res.nx, res.ny, res.nz)
    return _gi_joint_upsample(cir, cig, cib, sub(res.t), sub(code),
                              sub(res.hit), res.t, code, d,
                              rcfg.gi_depth_threshold)


def checker_select(a: torch.Tensor, parity: int, y0: int = 0):
    """(H, W[, C]) -> (H, W/2[, C]): keep each row's checkerboard-active
    columns, ``x = 2j + off`` with ``off = (y0 + row + parity) & 1``.
    ``parity`` is a host int (the schedule is host-side: no device
    read)."""
    h = a.shape[0]
    off = (torch.arange(h, dtype=_I32, device=a.device) + y0 + parity) & 1
    off = off.reshape((h,) + (1,) * (a.ndim - 1))
    return torch.where(off == 0, a[:, 0::2], a[:, 1::2])


#: dispatch order of the 4-phase quarter interleave: the 2x2 quad is
#: visited diagonally ((0,0), (1,1), (0,1), (1,0)), so any two consecutive
#: frames form a checkerboard and any four the full grid
QUARTER_PHASE_ORDER = (0, 3, 1, 2)


def quarter_select(a: torch.Tensor, phase: int) -> torch.Tensor:
    """(H, W[, C]) -> (H/2, W/2[, C]): keep the pixels with ``y & 1 ==
    phase >> 1`` and ``x & 1 == phase & 1``, the quarter a 4-phase frame
    traces."""
    h, w = a.shape[0], a.shape[1]
    a4 = a.reshape((h // 2, 2, w // 2, 2) + tuple(a.shape[2:]))
    return a4[:, (phase >> 1) & 1, :, phase & 1]


def quarter_expand(q: torch.Tensor) -> torch.Tensor:
    """(H/2, W/2[, C]) -> (H, W[, C]) nearest fill: ``q[i, j]`` lands on
    all four pixels of its 2x2 quad, whatever the phase (the validity mask
    is what down-weights the three copies)."""
    return torch.repeat_interleave(torch.repeat_interleave(q, 2, dim=0), 2,
                                   dim=1)


def quarter_valid_mask(height: int, width: int, phase: int,
                       device=None) -> torch.Tensor:
    """(H, W) bool: True where this 4-phase frame traced a pixel."""
    ys = torch.arange(height, dtype=_I32, device=device)[:, None]
    xs = torch.arange(width, dtype=_I32, device=device)[None, :]
    return ((ys & 1) == ((phase >> 1) & 1)) & ((xs & 1) == (phase & 1))


def checker_expand(half: torch.Tensor, parity: int, y0: int = 0):
    """(H, W/2[, C]) checkerboard buffer -> (H, W[, C]) full frame.

    Traced pixels keep their exact values; each untraced pixel is the
    average of its 4 traced neighbours (left/right in its row, up/down in
    the adjacent rows), edge-clamped, summed first and then scaled by 0.25
    as in the JAX package.  The fill is a placeholder that
    ``temporal_upscale(valid=...)`` down-weights wherever history exists."""
    h, w2 = half.shape[0], half.shape[1]
    off = (torch.arange(h, dtype=_I32, device=half.device) + y0
           + parity) & 1
    off = off.reshape((h,) + (1,) * (half.ndim - 1))
    # the JAX package's _shift_rows / _shift_cols: edge-clamped shifts
    vert = _clamped_shift(half, -1, 0) + _clamped_shift(half, 1, 0)
    # off == 0 (traced at even x): untraced odd x' = 2j+1 between half
    # cols j and j+1; off == 1: untraced even x' = 2j between j-1 and j
    fill0 = (half + _clamped_shift(half, 1, 1) + vert) * 0.25
    fill1 = (_clamped_shift(half, -1, 1) + half + vert) * 0.25
    fill = torch.where(off == 0, fill0, fill1)
    evens = torch.where(off == 0, half, fill)
    odds = torch.where(off == 0, fill, half)
    out = torch.stack([evens, odds], dim=2)
    return out.reshape((h, 2 * w2) + tuple(half.shape[2:]))


def checker_valid_mask(height: int, width: int, parity: int,
                       device=None) -> torch.Tensor:
    """(H, W) bool: True where this checkerboard frame traced a pixel
    (``(x + y + parity) & 1 == 0``)."""
    ys = torch.arange(height, dtype=_I32, device=device)[:, None]
    xs = torch.arange(width, dtype=_I32, device=device)[None, :]
    return ((xs + ys + parity) & 1) == 0


def render_slab(bits, sdf, gi, atlas, cam: CameraArrays,
                ecfg: EngineConfig, y0: int, slab_h: int,
                include_gi: bool = True, gi_occ=None, sky_y=None,
                table=None, return_gbuffer: bool = False, trace_fn=None,
                checker_parity: int | None = None,
                quarter_phase: int | None = None, hint_half=None,
                hint_full=None, start_override=None,
                shadow_override=None):
    """Render rows [y0, y0 + slab_h) of the frame.

    ``hint_half`` / ``hint_full``: optional full-frame conservative start
    maps from the previous frame (``temporal_hints_from_prepass``, at the
    prepass and the primary grid), maximum-combined with the same-frame
    starts.  ``start_override`` / ``shadow_override``: precomputed
    full-resolution starts / shadow factors for this slab; the prepass is
    skipped and the returned ``half_dist`` / ``half_shadow`` are
    placeholders.  A start override without a shadow override needs
    decoupled shadow sites (else every pixel would be lit by the
    placeholder): ``ValueError``.  ``gi_occ``: the world's cone-occlusion
    mip for ``gi_fused_cone`` (built from ``sdf`` when None).

    ``checker_parity`` (0/1): trace only the pixels with ``(x + y +
    parity) & 1 == 0``; ``quarter_phase`` (0-3): only one pixel of each 2x2
    quad (``quarter_select``).  The outputs and G-buffer then come back on
    the rate-cut grid, (H, W/2) or (H/2, W/2); the caller expands them
    after the GI composite (``checker_expand`` / ``quarter_expand``) and
    hands the upscaler the matching valid mask.  Both are host ints."""
    cfg, rcfg, lcfg = ecfg.world, ecfg.render, ecfg.lighting
    w, h = rcfg.width, slab_h
    if trace_fn is None:
        trace_fn = make_trace_fn(bits, sdf, cfg, rcfg, table=table,
                                 sky_y=sky_y)

    # ---- 1+2: prepass (with halo) and conservative upsamples ----
    with profiling.span("prepass"):
        pd = rcfg.prepass_divisor
        assert slab_h % pd == 0, \
            f"slab height {slab_h} not divisible by prepass_divisor {pd}"
        hy0 = y0 // pd - 1
        # the halo'd row count is padded to a multiple of trace_tile_rows as
        # in the JAX package (the cascade samples depend on it); the extra rows
        # duplicate the clamped bottom edge and are sliced off below
        hneed = slab_h // pd + 2
        t = max(rcfg.trace_tile_rows, 1)
        hrows = -(-hneed // t) * t
        shadow_decoupled = (lcfg.soft_shadows and rcfg.shadow_site_divisor > 0
                            and shadow_override is None)
        if start_override is not None and shadow_override is None \
                and not shadow_decoupled:
            raise ValueError(
                "start_override without shadow_override requires decoupled "
                "shadow sites (lighting.soft_shadows and "
                "render.shadow_site_divisor > 0); pass shadow_override or "
                "decouple the shadows")
        if start_override is not None:
            # precomputed starts: no prepass, placeholder half buffers
            half_dist = torch.zeros(hneed, rcfg.half_width, dtype=_F32,
                                    device=cam.pos.device)
            half_shadow = torch.ones_like(half_dist)
        else:
            half_dist, half_shadow = half_res_prepass(
                bits, sdf, cfg, rcfg, lcfg, cam, hy0=hy0, hrows=hrows,
                trace_fn=trace_fn, sky_y=sky_y, start_hint=hint_half,
                want_shadow=not shadow_decoupled)
        half_dist = half_dist[:hneed]
        half_shadow = half_shadow[:hneed]
        if start_override is not None:
            start_dist = start_override
        else:
            start_dist = _min_dist_upsample_slab(half_dist, slab_h, d=pd)
        # the conservative start is clamped at the camera (see the JAX
        # render_slab for why)
        start_dist = torch.clamp_min(start_dist, 0.0)
        if hint_full is not None:
            start_dist = torch.maximum(
                start_dist, _take_rows(hint_full, y0, slab_h, rcfg.height))
        if shadow_override is not None:
            shadow_full = shadow_override
        else:
            shadow_full = (None if shadow_decoupled else
                           _bilinear_upsample_slab(half_shadow, slab_h, d=pd))

    # ---- 3: full-res primary ----
    with profiling.span("primary"):
        dx, dy, dz = _ray_dirs(cam, w, rcfg.height, pixel_center=False,
                               y0=y0, rows=slab_h)
        sel = None
        if checker_parity is not None:
            def sel(a):
                return checker_select(a, checker_parity, y0=y0)
        elif quarter_phase is not None:
            def sel(a):
                return quarter_select(a, quarter_phase)
        if sel is not None:
            # the rate cut: directions, starts and a coupled shadow are taken
            # on the traced pixels before the primary trace
            dx, dy, dz = sel(dx), sel(dy), sel(dz)
            start_dist = sel(start_dist)
            if shadow_full is not None:
                shadow_full = sel(shadow_full)
        res = trace_fn(cam.pos[0] + torch.zeros_like(dx), cam.pos[1],
                       cam.pos[2], dx, dy, dz, start_dist)
        hit = res.hit
        hpos = (res.px, res.py, res.pz)
        normal = (res.nx, res.ny, res.nz)
        d = (dx, dy, dz)
        sun = vm.splat(lcfg.sun_dir, hit)

    if shadow_decoupled:
        with profiling.span("shadow"):
            # SDF penumbra march from every ssd-th true primary hit
            ssd = rcfg.shadow_site_divisor
            assert hit.shape[0] % ssd == 0, (hit.shape, ssd)

            def sub(a):
                return a[::ssd, ::ssd]
            q = shading.soft_shadow_march(
                sub(res.px), sub(res.py), sub(res.pz),
                sub(res.nx), sub(res.ny), sub(res.nz), sub(res.hit),
                sdf, cfg, lcfg, sky_y=sky_y)
            shadow_full = _expand_even(q, ssd, hit.shape)

    # ---- 4a: water path (StateRender.cu:53-87); the two secondary
    # traces run only when a water pixel is visible ----
    with profiling.span("water"):
        is_water = hit & (res.py < lcfg.water_level)
        with profiling.span("sync.water"):
            any_water = bool(is_water.any())
        if any_water:
            wnormal = shading.water_normal(hpos, normal, cam.time, lcfg)
            refl_dir = vm.reflect(d, wnormal)
            rox = torch.where(is_water, res.px, -10.0)
            roy = torch.where(is_water, res.py, -10.0)
            roz = torch.where(is_water, res.pz, -10.0)
            refl = trace_fn(rox, roy, roz, refl_dir[0], refl_dir[1],
                            refl_dir[2], torch.full_like(rox, 0.001))
            refl_albedo = atlas_mod.sample_texture(
                atlas, refl.uv_u, refl.uv_v, refl.px, refl.py, refl.pz)
            refl_shadow_hit = _shadow_trace(
                trace_fn, is_water & refl.hit,
                (refl.px, refl.py, refl.pz), (refl.nx, refl.ny, refl.nz), sun,
                offset=1e-3)
            refl_solid_col = vm.where(refl_shadow_hit,
                                      vm.scale(refl_albedo, 0.1), refl_albedo)
            refl_col = vm.where(refl.hit, refl_solid_col,
                                shading.sample_sky(refl_dir, lcfg))
            n_dot_v = torch.clamp_min(vm.dot(normal, vm.scale(d, -1.0)), 0.0)
            fresnel = shading.fresnel_schlick(n_dot_v, lcfg.water_reflectivity)
            water_col = vm.lerp(vm.splat(lcfg.water_color, hit), refl_col,
                                fresnel)
        else:
            z = torch.zeros_like(res.px)
            water_col = (z, z, z)

    # ---- 4b: solid path (StateRender.cu:88-131) ----
    with profiling.span("shade"):
        albedo = atlas_mod.sample_texture(atlas, res.uv_u, res.uv_v,
                                          res.px, res.py, res.pz)
        diffuse = torch.clamp_min(vm.dot(normal, sun), 0.0)
        direct = vm.scale(albedo, diffuse * shadow_full)
        solid_col = direct
        if include_gi:
            ir, ig, ib = gather_gi_image(res, gi, sdf, cfg, rcfg, lcfg,
                                         gi_occ=gi_occ)
            indirect = vm.mul((ir, ig, ib),
                              vm.scale(albedo, vm.f32(lcfg.gi_strength)))
            ambient = vm.mul(shading.sample_sky(normal, lcfg),
                             vm.scale(albedo, vm.f32(lcfg.ambient_strength)))
            solid_col = vm.add(vm.add(direct, indirect), ambient)

        # ---- 4c: miss path + composition ----
        sky_col = shading.sample_sky(d, lcfg)
        color = vm.where(is_water, water_col,
                         vm.where(hit, solid_col, sky_col))

        # ---- fog (StateRender.cu:140-145) ----
        dist = vm.length(vm.sub(hpos, (cam.pos[0], cam.pos[1], cam.pos[2])))
        fog_t = torch.where(hit, torch.exp(-dist * lcfg.fog_density), 1.0)
        fog_col = vm.splat(lcfg.fog_color, fog_t)
        color = vm.add(vm.scale(color, fog_t), vm.scale(fog_col, 1.0 - fog_t))

        # ---- 5: motion vectors + depth (StateRender.cu:234-252) ----
        ones = torch.ones_like(res.px)
        hpos1 = (res.px, res.py, res.pz, ones)
        prev_clip = vm.mat_mul_vec4(cam.prev_vp, hpos1)
        cur_clip = vm.mat_mul_vec4(cam.vp, hpos1)
        both_front = (prev_clip[3] > 0.0) & (cur_clip[3] > 0.0)
        # miss pixels get the motion of the point at infinity along the ray
        zeros = torch.zeros_like(res.px)
        prev_inf = vm.mat_mul_vec4(cam.prev_vp, (dx, dy, dz, zeros))
        cur_inf = vm.mat_mul_vec4(cam.vp, (dx, dy, dz, zeros))
        inf_front = (prev_inf[3] > 0.0) & (cur_inf[3] > 0.0)
        mv_inf_x = torch.where(
            inf_front, cur_inf[0] / cur_inf[3] - prev_inf[0] / prev_inf[3],
            0.0)
        mv_inf_y = torch.where(
            inf_front, cur_inf[1] / cur_inf[3] - prev_inf[1] / prev_inf[3],
            0.0)
        mv_x = torch.where(
            hit & both_front,
            cur_clip[0] / cur_clip[3] - prev_clip[0] / prev_clip[3],
            torch.where(hit, 0.0, mv_inf_x))
        mv_y = torch.where(
            hit & both_front,
            cur_clip[1] / cur_clip[3] - prev_clip[1] / prev_clip[3],
            torch.where(hit, 0.0, mv_inf_y))
        depth = torch.where(hit & (cur_clip[3] > 0.0),
                            cur_clip[2] / cur_clip[3], 1.0)
        color_img = torch.clamp(torch.stack(color, dim=-1), 0.0, 1.0)
        motion = torch.stack([mv_x, -mv_y], dim=-1)

    out = FrameOutputs(color=color_img, motion=motion, depth=depth,
                       half_dist=half_dist[1:-1],
                       half_shadow=half_shadow[1:-1])
    if return_gbuffer:
        gb = GBuffer(hit=hit, px=res.px, py=res.py, pz=res.pz,
                     nx=res.nx, ny=res.ny, nz=res.nz, t=res.t,
                     albedo_r=albedo[0], albedo_g=albedo[1],
                     albedo_b=albedo[2], fog=fog_t)
        return out, gb
    return out


def render_frame(bits, sdf, gi, atlas, cam: CameraArrays,
                 ecfg: EngineConfig, include_gi: bool = True, gi_occ=None,
                 sky_y=None, table=None, return_gbuffer: bool = False,
                 trace_fn=None, checker_parity: int | None = None,
                 quarter_phase: int | None = None, hint_half=None,
                 hint_full=None, start_override=None,
                 shadow_override=None):
    """Full frame = one slab covering every row."""
    return render_slab(bits, sdf, gi, atlas, cam, ecfg, y0=0,
                       slab_h=ecfg.render.height, include_gi=include_gi,
                       gi_occ=gi_occ, sky_y=sky_y, table=table,
                       return_gbuffer=return_gbuffer, trace_fn=trace_fn,
                       checker_parity=checker_parity,
                       quarter_phase=quarter_phase, hint_half=hint_half,
                       hint_full=hint_full, start_override=start_override,
                       shadow_override=shadow_override)


def gi_composite(color, gb: GBuffer, gi, sdf, ecfg: EngineConfig,
                 gi_occ=None, return_addend: bool = False):
    """Add cone-traced indirect + sky ambient onto a GI-less base color
    (the split-dispatch half of the GI frame): the added light is scaled by
    the fog transmittance the base was composited with.  With
    ``return_addend``: ``(out, add)``, the added-light image too, for
    re-adding to a later frame's base (``bench.py``'s composite cadence:
    indirect light is low-frequency and geometry-attached).  CUDA tensors
    go through the two kernels of ``ops/gi_kernels.py``, CPU tensors
    through ``gi_composite_plain``."""
    if gb.hit.device.type == "cpu":
        return gi_composite_plain(color, gb, gi, sdf, ecfg, gi_occ=gi_occ,
                                  return_addend=return_addend)
    tbl = _cone_table(gi, sdf, ecfg.world, ecfg.render, gi_occ)
    h, w = gb.hit.shape
    return gi_kernels.gi_composite_cuda(
        color, gb, gi if tbl is None else tbl, sdf, ecfg,
        gi_divisor(h, w, ecfg.render.gi_res_divisor), tbl is not None,
        return_addend=return_addend)


def gi_composite_plain(color, gb: GBuffer, gi, sdf, ecfg: EngineConfig,
                       gi_occ=None, return_addend: bool = False):
    """``gi_composite`` in plain PyTorch, on any device."""
    cfg, rcfg, lcfg = ecfg.world, ecfg.render, ecfg.lighting
    ir, ig, ib = gather_gi_image_plain(gb, gi, sdf, cfg, rcfg, lcfg,
                                       gi_occ=gi_occ)
    albedo = (gb.albedo_r, gb.albedo_g, gb.albedo_b)
    normal = (gb.nx, gb.ny, gb.nz)
    indirect = vm.mul((ir, ig, ib),
                      vm.scale(albedo, vm.f32(lcfg.gi_strength)))
    ambient = vm.mul(shading.sample_sky(normal, lcfg),
                     vm.scale(albedo, vm.f32(lcfg.ambient_strength)))
    solid = gb.hit & ~(gb.py < lcfg.water_level)
    scale = torch.where(solid, gb.fog, 0.0)
    add = torch.stack(vm.scale(vm.add(indirect, ambient), scale), dim=-1)
    out = torch.clamp(color + add, 0.0, 1.0)
    if return_addend:
        return out, add
    return out
