"""Temporal super-resolution accumulator: the analytic DLSS mechanism.

The port of ``rvgrt_tpu/upscale/temporal.py``: jittered temporal
supersampling (the reference's DLSS call, ``main.cpp:178-191``).  Each frame
samples the scene at a known sub-pixel offset; the accumulator integrates
those samples into a 3x display-resolution history, rejecting stale history
with motion-vector reprojection + neighborhood variance clipping.

* jitter-aware upsampling is a per-phase separable linear resample (the
  low-res pixel ``i`` lands at display coordinate ``SCALE*(i + j_px)``);
* history + per-pixel confidence are packed RGBN into one u32 word per
  display pixel, so reprojection is one gather (``_warp_state``); taps
  ``"pallas"`` run the hand-written CUDA warp kernel (K2,
  ``ops/warp_kernels.py``; the name is kept so one config string means the
  same in both packages), ``"bilinear"`` its plain version and
  ``"bilinear_shift"`` (the JAX default) one gather + output-space shifts;
* rectification clamps to mean +- gamma*std over the 3x3 low-res
  neighborhood, nearest-upsampled;
* blending is a running average with a confidence count;
* rate-cut frames (checkerboard, quarter) pass ``valid``: untraced pixels
  keep their history and enter at a small weight.

The same accumulator runs at scale 1 as native-resolution reconstruction
(``bench.py``'s config-4).  Not ported yet: ``temporal_upscale_slab``,
depth rejection, the ``nearest`` and ``catmull_shift`` taps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rvgrt_tpu_torch.core import u32
from rvgrt_tpu_torch.core.vecmath import f32
from rvgrt_tpu_torch.utils.device import resolve_device

_F32 = torch.float32
_I32 = torch.int32
SCALE = 3  # 1280x800 -> 3840x2400


class TemporalState(NamedTuple):
    """Carried across frames; reset to zeros on camera cuts."""
    history: torch.Tensor  # (SCALE*h, SCALE*w, 3) f32 in [0, 1]
    conf: torch.Tensor     # (SCALE*h, SCALE*w) f32 effective sample count
    depth: torch.Tensor    # (1, 1) sentinel (depth rejection not ported)


def init_state(height: int, width: int, scale: int = SCALE,
               device=None) -> TemporalState:
    """Zero state for a ``height x width`` LOW-res stream."""
    dev = resolve_device(device)
    return TemporalState(
        history=torch.zeros(height * scale, width * scale, 3, dtype=_F32,
                            device=dev),
        conf=torch.zeros(height * scale, width * scale, dtype=_F32,
                         device=dev),
        depth=torch.zeros(1, 1, dtype=_F32, device=dev))


def state_from_numpy(d: dict, device=None) -> TemporalState:
    """A TemporalState from {history, conf, depth} float32 arrays."""
    dev = resolve_device(device)
    return TemporalState(**{k: torch.from_numpy(
        np.ascontiguousarray(d[k], np.float32)).to(dev)
        for k in TemporalState._fields})


def state_to_numpy(state: TemporalState) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in TemporalState._fields}


def _shift_cf(img_cf: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """Edge-clamped integer shift: out[..i..] = img[..i+m..]."""
    if m == 0:
        return img_cf
    n = img_cf.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img_cf.device) + m, 0, n - 1)
    return img_cf.index_select(axis, idx)


def _phase_filter_axis(img_cf: torch.Tensor, j_px: torch.Tensor, axis: int,
                       scale: int = SCALE):
    """Per-phase jitter-compensating linear resample along one axis:
    display position ``scale*i + p`` reads the low-res signal at
    ``i + p/scale - j_px`` through the static shifts m in {-1, 0, 1, 2}.
    Returns ``scale`` tensors shaped like ``img_cf``."""
    shifted = [_shift_cf(img_cf, m, axis) for m in (-1, 0, 1, 2)]
    outs = []
    for p in range(scale):
        o = f32(p) / f32(scale) - j_px
        acc = None
        for m, sh in zip((-1, 0, 1, 2), shifted):
            w = torch.clamp(1.0 - torch.abs(o - float(m)), 0.0, 1.0)
            term = w * sh
            acc = term if acc is None else acc + term
        outs.append(acc)
    return outs


def _interleave(parts, axis: int):
    """[p_0..p_{s-1}] -> out with out[.., s*i + k, ..] = p_k[.., i, ..]."""
    st = torch.stack(parts, dim=axis + 1)
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return st.reshape(shape)


def jitter_upsample(color: torch.Tensor, jitter_ndc: torch.Tensor,
                    scale: int = SCALE):
    """(h, w, 3) low-res + its NDC jitter -> (3, scale*h, scale*w)
    channel-first display-res image, resampled so the known sub-pixel
    sample positions line up with the unjittered display grid."""
    h, w = color.shape[0], color.shape[1]
    jx = jitter_ndc[0] * (0.5 * w)   # low-res px
    jy = jitter_ndc[1] * (0.5 * h)
    cf = color.permute(2, 0, 1)  # (3, h, w)
    row = _interleave(_phase_filter_axis(cf, jx, axis=2, scale=scale), 2)
    return _interleave(_phase_filter_axis(row, jy, axis=1, scale=scale), 1)


def _neighborhood_box(color: torch.Tensor, gamma, scale: int = SCALE):
    """Variance-clipping box: mean +- gamma*std over the 3x3 low-res
    neighborhood, nearest-upsampled to display res, channel-first.
    ``gamma``: scalar or per-low-res-pixel (h, w) map."""
    cf = color.permute(2, 0, 1)
    s = None
    s2 = None
    for dy in (-1, 0, 1):
        sy = _shift_cf(cf, dy, axis=1)
        for dx in (-1, 0, 1):
            v = _shift_cf(sy, dx, axis=2) if dx else sy
            s = v if s is None else s + v
            s2 = v * v if s2 is None else s2 + v * v
    mu = s * (1.0 / 9.0)
    sd = torch.sqrt(torch.clamp_min(s2 * (1.0 / 9.0) - mu * mu, 0.0))
    g = gamma if isinstance(gamma, torch.Tensor) else f32(gamma)
    if g.ndim == 2:
        g = g[None]  # broadcast over channels
    mn = mu - g * sd
    mx = mu + g * sd
    if scale == 1:
        return mn, mx

    def up(a):
        a = torch.repeat_interleave(a, scale, dim=2)
        return torch.repeat_interleave(a, scale, dim=1)
    return up(mn), up(mx)


_CONF_MAX = 12.0


def _pack_rgbn(history: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) rgb + (H, W) count -> (H, W) u32 r|g<<8|b<<16|n<<24."""
    q = torch.clamp(torch.round(history * 255.0), 0.0, 255.0).to(_I32)
    nq = torch.clamp(torch.round(conf * (255.0 / _CONF_MAX)), 0.0,
                     255.0).to(_I32)
    return (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            | u32.shl(nq, 24))


def _unpack_rgbn_cf(word: torch.Tensor):
    """(H, W) u32 -> ((3, H, W) rgb f32, (H, W) count f32)."""
    f = 1.0 / 255.0
    rgb = torch.stack([(word & 0xFF).to(_F32) * f,
                       (u32.lsr(word, 8) & 0xFF).to(_F32) * f,
                       (u32.lsr(word, 16) & 0xFF).to(_F32) * f], dim=0)
    n = (u32.lsr(word, 24) & 0xFF).to(_F32) * (_CONF_MAX / 255.0)
    return rgb, n


def _nearest_up(a: torch.Tensor, s: int) -> torch.Tensor:
    """(h, w) -> (s*h, s*w), out[i, j] = a[i // s, j // s] (an explicit
    integer index; a float-scale resize can pick other rows)."""
    return torch.repeat_interleave(torch.repeat_interleave(a, s, dim=0),
                                   s, dim=1)


def warp_inputs(state: TemporalState, motion_lowres: torch.Tensor,
                motion_decay: float = 0.35):
    """What the history warp gathers from: ``(packed, x, y, inside)`` =
    the (H, W) RGBN words, the clipped f32 source coordinates and the
    motion-decayed on-screen weight (motion = NDC delta current-previous,
    y negated, ``StateRender.cu:241,251``)."""
    hh, hw = state.history.shape[0], state.history.shape[1]
    s = hh // motion_lowres.shape[0]
    mvx = _nearest_up(motion_lowres[..., 0], s)
    mvy = _nearest_up(motion_lowres[..., 1], s)
    dev = mvx.device
    xs = torch.arange(hw, dtype=_F32, device=dev)[None, :] \
        - mvx * (0.5 * hw)
    ys = torch.arange(hh, dtype=_F32, device=dev)[:, None] \
        - mvy * (0.5 * hh)
    inside = ((xs >= 0.0) & (xs <= hw - 1.0)
              & (ys >= 0.0) & (ys <= hh - 1.0)).to(_F32)
    # motion-adaptive decay of the history confidence
    mx_ = mvx * (0.5 * hw)
    my_ = mvy * (0.5 * hh)
    mpx = torch.sqrt(mx_ * mx_ + my_ * my_)
    inside = inside * torch.exp(-mpx * motion_decay)
    packed = _pack_rgbn(state.history, state.conf)
    x = torch.clamp(xs, 0.0, hw - 1.0)
    y = torch.clamp(ys, 0.0, hh - 1.0)
    return packed, x, y, inside


def _warp_state(state: TemporalState, motion_lowres: torch.Tensor,
                taps: str = "bilinear", motion_decay: float = 0.35):
    """Reproject history + confidence with ONE packed 4-tap gather;
    off-screen source coordinates zero the confidence."""
    from rvgrt_tpu_torch.ops import warp_kernels

    packed, x, y, inside = warp_inputs(state, motion_lowres, motion_decay)

    if taps == "pallas":
        # the hand-written CUDA warp kernel (K2) on a GPU
        planes, _ = warp_kernels.warp_packed_bilinear(packed, x, y)
        return planes[:3], planes[3] * _CONF_MAX * inside
    if taps == "bilinear_shift":
        # bilinear quality at 1-gather cost: the +1 taps are output-space
        # shifts of the gathered floor tap (exact where motion is locally
        # constant)
        x0 = torch.floor(x).to(_I32)
        y0 = torch.floor(y).to(_I32)
        fx = (x - x0.to(_F32))[None]
        fy = (y - y0.to(_F32))[None]
        rgb00, n00 = _unpack_rgbn_cf(packed[y0.long(), x0.long()])
        v00 = torch.cat([rgb00, n00[None]], dim=0)  # (4, H, W)
        v01 = _shift_cf(v00, 1, axis=2)
        v10 = _shift_cf(v00, 1, axis=1)
        v11 = _shift_cf(v01, 1, axis=1)
        v = ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
             + (1 - fx) * fy * v10 + fx * fy * v11)
        return v[:3], v[3] * inside
    if taps == "bilinear":
        # exact 4-tap gather: the warp kernel's plain version
        planes, _ = warp_kernels.warp_packed_bilinear_plain(packed, x, y)
        return planes[:3], planes[3] * _CONF_MAX * inside
    raise ValueError(f"warp taps {taps!r} are not ported")


def _current_weight(jitter_ndc: torch.Tensor, height: int, width: int,
                    sigma: float, w_min: float, scale: int = SCALE):
    """Per-display-pixel weight of the CURRENT frame's sample: peaked at
    the display pixels the jittered low-res sample landed on; a
    (scale, scale) pattern tiled over the image."""
    def axis_d(j_px):
        s = f32(scale) * j_px
        p = torch.arange(scale, dtype=_F32, device=j_px.device)
        cands = torch.stack([torch.abs(s - p + f32(scale) * m)
                             for m in (-1, 0, 1)])
        return cands.amin(dim=0)  # (scale,)

    dx = axis_d(jitter_ndc[0] * (0.5 * width))
    dy = axis_d(jitter_ndc[1] * (0.5 * height))
    d2 = dy[:, None] * dy[:, None] + dx[None, :] * dx[None, :]
    w = torch.exp(-d2 / (2.0 * sigma * sigma))
    w = w_min + (1.0 - w_min) * w
    return w.repeat(height, width)  # (scale*h, scale*w)


def temporal_upscale(color: torch.Tensor, motion: torch.Tensor,
                     depth: torch.Tensor, jitter_ndc: torch.Tensor,
                     state: TemporalState, *,
                     sigma: float = 0.9, w_min: float = 0.08,
                     gamma: float | None = None,
                     clamp_beta: float | None = None,
                     clamp_eps: float = 0.01,
                     warp_taps: str = "bilinear_shift",
                     motion_decay: float = 0.35,
                     gamma_static: float = 1.5, gamma_moving: float = 0.6,
                     beta_static: float = 8.0, beta_moving: float = 40.0,
                     adapt_rate: float = 8.0, valid=None,
                     invalid_weight: float = 0.05):
    """One frame of temporal super-resolution.  Returns ``(out,
    new_state)`` with ``out`` (scale*h, scale*w, 3); the scale (3 for the
    display upscale, 1 for native-res reconstruction) is the state's.

    ``valid``: optional (h, w) bool, True where this frame traced the
    low-res pixel (``pipeline.checker_valid_mask`` /
    ``quarter_valid_mask``).  An untraced pixel keeps its history
    unclamped (its neighbourhood box is built from filled copies) and its
    current sample enters at ``invalid_weight`` x the normal weight."""
    del depth  # depth rejection is not ported
    h, w = color.shape[0], color.shape[1]
    scale = state.history.shape[0] // h
    assert state.history.shape[0] == scale * h, (state.history.shape, h)

    cur = jitter_upsample(color, jitter_ndc, scale=scale)  # (3, H, W)
    hist, n_prev = _warp_state(state, motion, taps=warp_taps,
                               motion_decay=motion_decay)

    # motion-adaptive rectification: wide box + soft beta where still,
    # tight box + harsh beta where moving; explicit scalars override
    if gamma is None or clamp_beta is None:
        m0 = motion[..., 0] * (0.5 * w * scale)
        m1 = motion[..., 1] * (0.5 * h * scale)
        m = torch.sqrt(m0 * m0 + m1 * m1)[None]
        # dilate by a 3x3 max: sky pixels carry zero motion but the
        # silhouette sweeping across them moves
        for ax in (1, 2):
            m = torch.maximum(m, torch.maximum(_shift_cf(m, 1, axis=ax),
                                               _shift_cf(m, -1, axis=ax)))
        a = 1.0 - torch.exp(-m[0] * adapt_rate)
    if gamma is None:
        gamma = gamma_static + (gamma_moving - gamma_static) * a
    if clamp_beta is None:
        clamp_beta = _nearest_up(
            beta_static + (beta_moving - beta_static) * a, scale)

    v3 = None
    if valid is not None:
        v3 = valid.to(_F32)
        if scale > 1:
            v3 = _nearest_up(v3, scale)

    mn, mx = _neighborhood_box(color, gamma, scale=scale)
    clamped = torch.clamp(hist, mn - clamp_eps, mx + clamp_eps)
    if v3 is not None:
        # an untraced pixel keeps its history as it is
        clamped = v3[None] * clamped + (1.0 - v3[None]) * hist
    # history that needed clamping is stale: scale its sample count down
    d = torch.abs(hist - clamped)
    clamp_dist = (d[0] + d[1] + d[2]) / 3.0
    beta = clamp_beta if isinstance(clamp_beta, torch.Tensor) \
        else f32(clamp_beta)
    n_w = n_prev * torch.exp(-clamp_dist * beta)

    w_cur = _current_weight(jitter_ndc, h, w, sigma, w_min, scale=scale)
    if v3 is not None:
        w_cur = w_cur * (v3 + (1.0 - v3) * invalid_weight)
    den = n_w + w_cur
    out_cf = (n_w[None] * clamped + w_cur[None] * cur) / den[None]
    out_cf = torch.clamp(out_cf, 0.0, 1.0)
    n_new = torch.clamp_max(den, _CONF_MAX)
    out = out_cf.permute(1, 2, 0).contiguous()
    return out, TemporalState(history=out, conf=n_new, depth=state.depth)
