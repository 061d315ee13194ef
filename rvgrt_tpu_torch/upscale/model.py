"""Learned upscaler: the DLSS replacement.

The port of ``rvgrt_tpu/upscale/model.py``.  The reference hands its
low-res colour + motion vectors + depth + jitter to Streamline DLSS for a 3x
upscale (1280x800 -> 3840x2400, ``main.cpp:134-191``); this is the same
contract as a small conv net:

  inputs:  low-res color (H, W, 3), motion (H, W, 2, NDC delta, y negated),
           depth (H, W), jitter (2,), and the previous *high-res* output
           (temporal history, reprojected with the motion vectors);
  output:  (3H, 3W, 3) color + a per-pixel history blend weight.

The JAX package computes the convs through flax and XLA, outside any Pallas
kernel; here they are ``F.conv2d`` (cuDNN on a GPU), channels-last.  What
the port keeps of the JAX package, so that one checkpoint means the same in
both:

* the parameters in flax's tree, names and channel orders; only the conv
  kernels turn from HWIO to OIHW (``params_from_flax`` /
  ``params_to_flax``).  The shuffle conv's outputs stay in JAX's ``(si, sj,
  c)`` order, which ``depth_to_space_cf`` reads: no permutation is folded
  into the weights, and ``F.pixel_shuffle`` (order ``(c, si, sj)``) is not
  used;
* the net's input channels in JAX's order: colour 3, motion 2, depth 1, the
  jitter map 2, then the warped history's space-to-depth 27 in ``(si, sj,
  rgb)`` order (``pixel_unshuffle``'s order is ``(rgb, si, sj)``);
* flax's bf16 rounding: inputs and weights cast to bf16, the conv without a
  bias, then the bias added in bf16 (flax rounds the conv's output before
  it adds the bias; a fused ``F.conv2d(x, w, b)`` does not);
* ``jax.image.resize``: "nearest" at the integer scale is an explicit
  repeat (``temporal._nearest_up``); "bilinear" takes resize's own weights,
  two taps an output, the x axis first, each output a product and a fused
  multiply-add, as XLA's dot accumulates them (``_resize_bilinear_cf``):
  on the CPU the bilinear anchor is JAX's to the bit at the tests' sizes;
  at 800x1280, where XLA's blocked dot splits some columns' sums, a small
  share of its values is 1 ulp off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rvgrt_tpu_torch.upscale.temporal import _nearest_up
from rvgrt_tpu_torch.utils.device import resolve_device

_F32 = torch.float32
_I32 = torch.int32

SCALE = 3  # 1280x800 -> 3840x2400
#: the net's input channels: colour 3, motion 2, depth 1, jitter 2, history
#: space-to-depth 27
IN_CHANNELS = 3 + 2 + 1 + 2 + 3 * SCALE * SCALE
#: the shuffle conv's channels a display pixel: rgb + history blend logit
C_OUT = 4


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sample (H, W, C) at float pixel coords (clamped); x/y shaped (h, w).
    Returns (h, w, C)."""
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0 = torch.floor(x).to(_I32)
    y0 = torch.floor(y).to(_I32)
    x1 = torch.clamp_max(x0 + 1, w - 1).long()
    y1 = torch.clamp_max(y0 + 1, h - 1).long()
    fx = (x - x0.to(_F32))[None]
    fy = (y - y0.to(_F32))[None]
    x0, y0 = x0.long(), y0.long()
    cf = img.permute(2, 0, 1)  # (C, H, W)
    a = cf[:, y0, x0]
    b = cf[:, y0, x1]
    c = cf[:, y1, x0]
    d = cf[:, y1, x1]
    out = (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
           + c * (1 - fx) * fy + d * fx * fy)
    return out.permute(1, 2, 0)


def depth_to_space_cf(x_hwc: torch.Tensor, s: int, c_out: int):
    """(h, w, s*s*c_out) conv output -> (c_out, s*h, s*w) channel-first,
    in JAX's order: ``out[c, y*s + si, x*s + sj] = x[y, x, (si*s + sj)*c_out
    + c]``."""
    h, w = x_hwc.shape[0], x_hwc.shape[1]
    t = x_hwc.permute(2, 0, 1).reshape(s, s, c_out, h, w)
    return t.permute(2, 3, 0, 4, 1).reshape(c_out, s * h, s * w)


def space_to_depth_cf(cf: torch.Tensor, s: int = SCALE) -> torch.Tensor:
    """(c, s*h, s*w) -> (s*s*c, h, w): the inverse order of
    ``depth_to_space_cf``, channel ``(si*s + sj)*c + k`` = ``cf[k, y*s + si,
    x*s + sj]`` (the JAX package's strided slices ``cf[:, si::s, sj::s]``,
    concatenated in (si, sj) order)."""
    c, hh, ww = cf.shape
    t = cf.reshape(c, hh // s, s, ww // s, s)
    return t.permute(2, 4, 0, 1, 3).reshape(s * s * c, hh // s, ww // s)


def _pack_rgb8(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) f32 [0,1] -> (H, W) int32 (r | g<<8 | b<<16)."""
    q = torch.clamp(torch.round(img * 255.0), 0.0, 255.0).to(_I32)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)


def _unpack_rgb8_cf(w: torch.Tensor) -> torch.Tensor:
    """(H, W) packed words -> (3, H, W) f32 [0,1], channel-first."""
    f = 1.0 / 255.0
    return torch.stack([(w & 0xFF).to(_F32) * f,
                        ((w >> 8) & 0xFF).to(_F32) * f,
                        ((w >> 16) & 0xFF).to(_F32) * f], dim=0)


def warp_history(history: torch.Tensor, motion_lowres: torch.Tensor,
                 mode: str = "bilinear_packed"):
    """Reproject the previous high-res frame with the low-res motion
    vectors (NDC delta current-previous, y negated, ``StateRender.cu:241,
    251``): the previous position of out-pixel p is p - motion_px.

    ``mode``: ``bilinear`` (4 taps x 3 channels, exact),
    ``bilinear_packed`` (RGB packed into one word a pixel, 4 taps; the
    history quantised to 8 bits) or ``nearest_packed`` (1 tap, <= 0.5 px
    resample shift).  A plain gather, as in the JAX package: the CUDA warp
    kernel K2 warps RGBN words of the accumulator and blends its weights
    first, a different function."""
    hh, hw = history.shape[0], history.shape[1]
    s = hh // motion_lowres.shape[0]
    mvx = _nearest_up(motion_lowres[..., 0], s)
    mvy = _nearest_up(motion_lowres[..., 1], s)
    dev = mvx.device
    xs = torch.arange(hw, dtype=_F32, device=dev)[None, :] \
        - mvx * (0.5 * hw)
    ys = torch.arange(hh, dtype=_F32, device=dev)[:, None] \
        - mvy * (0.5 * hh)
    xs = xs.expand(hh, hw)
    ys = ys.expand(hh, hw)
    if mode == "bilinear":
        return bilinear_sample(history, xs, ys)
    packed = _pack_rgb8(history)
    x = torch.clamp(xs, 0.0, hw - 1.0)
    y = torch.clamp(ys, 0.0, hh - 1.0)
    if mode == "nearest_packed":
        xi = torch.round(x).long()
        yi = torch.round(y).long()
        return _unpack_rgb8_cf(packed[yi, xi]).permute(1, 2, 0)
    if mode != "bilinear_packed":
        raise ValueError(f"unknown warp mode {mode!r}")
    x0 = torch.floor(x).to(_I32)
    y0 = torch.floor(y).to(_I32)
    x1 = torch.clamp_max(x0 + 1, hw - 1).long()
    y1 = torch.clamp_max(y0 + 1, hh - 1).long()
    fx = (x - x0.to(_F32))[None]
    fy = (y - y0.to(_F32))[None]
    x0, y0 = x0.long(), y0.long()
    a = _unpack_rgb8_cf(packed[y0, x0])
    b = _unpack_rgb8_cf(packed[y0, x1])
    c = _unpack_rgb8_cf(packed[y1, x0])
    d = _unpack_rgb8_cf(packed[y1, x1])
    out = (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
           + c * (1 - fx) * fy + d * fx * fy)
    return out.permute(1, 2, 0)


def _linear_taps(m: int, n: int, device):
    """``jax.image.resize``'s linear weights for m -> n samples
    (``compute_weight_mat``: a triangle kernel, each output's weights
    normalised by their sum, zero outside the input), as its two taps an
    output: (tap 0, tap 1, weight 0, weight 1), each tap clamped into the
    input and weighted 0 where it lies outside."""
    inv = 1.0 / (n / m)
    sf = (torch.arange(n, dtype=_F32, device=device) + 0.5) * inv - 0.5
    i0 = torch.floor(sf)
    taps, ws = [], []
    for k in (0.0, 1.0):
        j = i0 + k
        t = torch.clamp_min(1.0 - torch.abs(sf - j), 0.0)
        ws.append(torch.where((j >= 0.0) & (j <= m - 1.0), t, 0.0))
        taps.append(torch.clamp(j, 0, m - 1).long())
    total = ws[0] + ws[1]
    big = torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    inside = (sf >= -0.5) & (sf <= m - 0.5)
    ws = [torch.where(big & inside,
                      w / torch.where(total != 0, total, 1.0), 0.0)
          for w in ws]
    return taps[0], taps[1], ws[0], ws[1]


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: ``min(max(x, 0), 1)``,
    whose gradient at exactly 0 or 1 is 0.5 (``torch.clamp`` gives 1
    there).  The values are ``torch.clamp``'s."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _resize_bilinear_cf(cf: torch.Tensor, s: int) -> torch.Tensor:
    """(c, h, w) -> (c, s*h, s*w): ``jax.image.resize(.., "bilinear")`` of
    each channel.  Resize contracts its weight matrices with the image in
    one einsum, the x axis first (the smaller product for h <= w); a
    column has two non-zero weights, which XLA's dot accumulates as a
    product and then a fused multiply-add (``torch.addcmul``, one
    rounding), so the result is JAX's to the bit wherever XLA sums a column
    in one block (module docstring)."""
    _, h, w = cf.shape
    a, b, wa, wb = _linear_taps(w, s * w, cf.device)
    row = torch.addcmul(cf[..., a] * wa, cf[..., b], wb)  # (c, h, s*w)
    a, b, wa, wb = _linear_taps(h, s * h, cf.device)
    return torch.addcmul(row[:, a] * wa[:, None], row[:, b], wb[:, None])


class _Conv(nn.Module):
    """flax's ``nn.Conv(cout, (3, 3), dtype=...)``, padding SAME: the
    weight (OIHW) and bias kept in float32 as flax keeps its params, and
    applied in ``dtype`` - the conv without a bias, then the bias added in
    ``dtype``.  Trainable (``upscale/train.py``); the serving entry points
    run under ``torch.no_grad()``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(dtype), None, padding=1)
        return y + self.bias.to(dtype)[:, None, None]


def _net_input(color, motion, depth, jitter, extra_cf, dtype):
    """The nets' channels-last (1, C, h, w) input in ``dtype``: colour 3,
    motion 2, depth 1, the jitter map 2, then ``extra_cf`` (C', h, w)."""
    h, w = color.shape[0], color.shape[1]
    x = torch.cat([color.permute(2, 0, 1).to(dtype),
                   motion.permute(2, 0, 1).to(dtype),
                   depth[None].to(dtype),
                   jitter.to(dtype).reshape(2, 1, 1).expand(2, h, w),
                   extra_cf.to(dtype)], dim=0)
    return x[None].contiguous(memory_format=torch.channels_last)


class _ConvStack(nn.Module):
    """``depth_layers`` 3x3 convs with ReLU (``feat0`` ..) and the shuffle
    conv to ``SCALE*SCALE*c_out`` channels (``shuffle``), the flax names."""

    def __init__(self, cin: int, features: int, depth_layers: int,
                 c_out: int, dtype):
        super().__init__()
        self.features = features
        self.depth_layers = depth_layers
        self.c_out = c_out
        self.dtype = dtype
        for i in range(depth_layers):
            setattr(self, f"feat{i}", _Conv(cin if i == 0 else features,
                                             features))
        self.shuffle = _Conv(features, SCALE * SCALE * c_out)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """(1, C, h, w) input -> (c_out, SCALE*h, SCALE*w) in ``dtype``."""
        for i in range(self.depth_layers):
            x = torch.relu(getattr(self, f"feat{i}")(x, self.dtype))
        x = self.shuffle(x, self.dtype)
        return depth_to_space_cf(x[0].permute(1, 2, 0), SCALE, self.c_out)


class UpscalerNet(_ConvStack):
    """Small conv net: features at low res, pixel-shuffle 3x, history
    blend.  ``stack(...)`` is the conv stack (its output the shuffled
    logits), ``blend(...)`` the display-resolution tail."""

    def __init__(self, features: int = 32, depth_layers: int = 3,
                 dtype=torch.bfloat16):
        super().__init__(IN_CHANNELS, features, depth_layers, C_OUT, dtype)

    def stack(self, color, motion, depth, jitter, warped_history):
        """(4, 3h, 3w) logits: the rgb residual and the blend logit."""
        wh_cf = warped_history.permute(2, 0, 1)
        return self.logits(_net_input(color, motion, depth, jitter,
                                      space_to_depth_cf(wh_cf), self.dtype))

    @staticmethod
    def blend(up, color, warped_history):
        """The tail: sigmoid alpha, the bilinear anchor, the clip and the
        blend.  Returns ((3h, 3w, 3) image, (3h, 3w) alpha)."""
        rgb_cf = up[:3].to(_F32)
        alpha = torch.sigmoid(up[3].to(_F32))[None]  # (1, 3h, 3w)
        base_cf = _resize_bilinear_cf(color.permute(2, 0, 1), SCALE)
        current_cf = clip01(base_cf + rgb_cf)
        wh_cf = warped_history.permute(2, 0, 1)
        out_cf = alpha * wh_cf.to(_F32) + (1.0 - alpha) * current_cf
        return clip01(out_cf).permute(1, 2, 0).contiguous(), alpha[0]

    def forward(self, color, motion, depth, jitter, warped_history):
        up = self.stack(color, motion, depth, jitter, warped_history)
        return self.blend(up, color, warped_history)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's ``lecun_normal`` on an OIHW kernel: a normal truncated at 2
    standard deviations, scaled to a standard deviation of sqrt(1 /
    fan_in) after truncation (fan_in = I*H*W)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)


@torch.no_grad()
def init_stack(net: _ConvStack, generator: torch.Generator | None):
    """flax's initialisation of a conv stack, on the CPU from
    ``generator`` (seed 0 when None): lecun-normal feature kernels, zero
    biases and a zero shuffle kernel."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    for i in range(net.depth_layers):
        conv = getattr(net, f"feat{i}")
        lecun_normal_(conv.weight, g)
        conv.bias.zero_()
    net.shuffle.weight.zero_()
    net.shuffle.bias.zero_()


def init_params(height: int, width: int, features: int = 32,
                generator: torch.Generator | None = None, device=None,
                depth_layers: int = 3) -> UpscalerNet:
    """A fresh ``UpscalerNet``: lecun-normal feature kernels drawn from
    ``generator`` (seed 0 when None), zero biases, a zero shuffle kernel
    and the blend logit's bias at -3 (alpha ~= 0.05), so that its first
    output is exactly the bilinear anchor blended with the history.  The
    low-res size is JAX's signature; a torch module needs no shape to
    initialise."""
    del height, width
    net = UpscalerNet(features=features, depth_layers=depth_layers)
    init_stack(net, generator)
    with torch.no_grad():
        net.shuffle.bias[3::C_OUT] = -3.0
    return net.to(resolve_device(device))


@torch.no_grad()
def upscale(net: UpscalerNet, color, motion, depth, jitter, history,
            warp_mode: str = "bilinear_packed"):
    """One DLSS-evaluate equivalent: warp history, run the net.  Returns
    ((3h, 3w, 3) image, (3h, 3w) alpha)."""
    warped = warp_history(history, motion, mode=warp_mode)
    return net(color, motion, depth, jitter, warped)


def params_from_flax(tree) -> dict:
    """A flax param tree (``{"params": {layer: {"kernel", "bias"}}}``, or
    its inner dict; numpy or anything ``np.asarray`` reads) -> a
    ``state_dict`` of float32 tensors: each HWIO kernel as OIHW
    (``<layer>.weight``), each bias as it is (``<layer>.bias``).  The
    channel orders are JAX's."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for name, p in tree.items():
        k = np.asarray(p["kernel"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())
    return out


def params_to_flax(net: nn.Module) -> dict:
    """The inverse of ``params_from_flax``: ``{"params": {layer: {"kernel":
    HWIO, "bias": ...}}}`` of float32 numpy arrays, as flax's ``init``
    returns it (a pickle of it needs only numpy)."""
    layers: dict = {}
    for key, v in net.state_dict().items():
        name, kind = key.rsplit(".", 1)
        a = v.detach().cpu().to(_F32).numpy()
        layers.setdefault(name, {})[
            "kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(a.transpose(2, 3, 1, 0))
            if kind == "weight" else a.copy())
    return {"params": layers}


def load_checkpoint(path: str, device=None) -> UpscalerNet:
    """The net of a checkpoint file, on ``device``: a raw param tree (the
    default up-m architecture, ``UpscalerNet()``) or a variant-tagged dict
    ``{"variant": name, "params": ...}`` as the trainer writes it."""
    from rvgrt_tpu_torch.driver import checkpoint as ck

    blob = ck.load_params(path)
    if isinstance(blob, dict) and "variant" in blob:
        from rvgrt_tpu_torch.models import upscaler as up_family

        net = up_family.build(blob["variant"])
        params = blob["params"]
    else:
        net = UpscalerNet()
        params = blob
    net.load_state_dict(params_from_flax(params))
    return net.to(resolve_device(device))
