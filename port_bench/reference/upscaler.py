"""The learned upscaler's plain reference: the net of a parameter
checkpoint, one frame at a time, in float32.

Written from the JAX package's ``rvgrt_tpu/upscale/model.py`` (flax's
``UpscalerNet`` and ``upscale`` with the ``"bilinear_packed"`` history warp)
and the DLSS contract it documents: low-res colour (h, w, 3), motion (h, w,
2; NDC delta current - previous, y negated), depth (h, w) and jitter (2,),
and the previous 3x output as the history, give the (3h, 3w, 3) image.  Not
a copy of the port's net, and it imports nothing of the port: a later
change that fuses the port's warp, convs and blend is held against this.

Per frame:

1. the history warp: the motion nearest-upsampled by repetition (JAX's
   ``"nearest"`` resize at an integer scale), each display pixel's source
   ``p - motion * 0.5 * size``, clipped into the image; the history packed
   into one 8-bit-a-channel word a pixel (round half to even, as
   ``jnp.round``), four taps gathered, unpacked and blended bilinearly in
   the JAX expression's order;
2. the net's input, in flax's channel order: colour 3, motion 2, depth 1,
   the jitter map 2, then the warped history's space-to-depth 27 in ``(si,
   sj, rgb)`` order; the layers ``feat0 .. featN-1`` (3x3, SAME, ReLU) and
   ``shuffle`` (3x3 to 9 x 4 channels);
3. each conv as flax's ``nn.Conv(dtype=bfloat16)`` computes it: the input
   and the kernel rounded to bfloat16, the convolution in float32 (TF32 off,
   ``check.compare`` sets both flags), the sum rounded to bfloat16, then the
   bias added in bfloat16 (rounded again);
4. depth-to-space in JAX's ``(si, sj, c)`` order: display pixel ``(3y +
   si, 3x + sj)`` takes channel ``(3 si + sj) * 4 + c``; the rgb residual and
   the blend logit in float32, alpha its sigmoid;
5. the anchor, ``jax.image.resize(.., "bilinear")`` of each colour channel
   to 3x: its dense weight matrices (a triangle kernel at sample ``(i + 0.5)
   / 3 - 0.5``, each output's weights normalised by their sum, taps outside
   the input weighted 0), contracted with the image, x first;
6. ``clip(anchor + rgb, 0, 1)``, the blend ``alpha * warped + (1 - alpha) *
   current``, clipped: the image, which is also the next frame's history.

``lowp_dtype``: the control's step below the configuration's bfloat16,
``torch.float8_e4m3fn``: each conv's input and kernel rounded to it
(saturating at its largest finite value, 448) instead of to bfloat16.

Departures from the JAX package, all of float32 rounding order and none
of the function: the convolution's float32 sums are cuDNN's or oneDNN's
order here and XLA's there, so a bf16 rounding of a conv's output can fall
the other way (1 bf16 ulp, which the later layers carry on); the anchor's
dense contraction is a float32 matrix product, whose two non-zero terms an
output may add in the other order (1 float32 ulp).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

SCALE = 3
#: the shuffle conv's channels a display pixel: rgb and the blend logit
C_OUT = 4
_F32 = torch.float32
_BF16 = torch.bfloat16
#: the control's conv precision, and its largest finite value
FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


@dataclass
class Net:
    """The layers of a checkpoint: (OIHW float32 kernel, bias) each, the
    feature convs in order, then the shuffle conv."""
    feats: list
    shuffle: tuple

    def to(self, device) -> "Net":
        return Net([(k.to(device), b.to(device)) for k, b in self.feats],
                   tuple(t.to(device) for t in self.shuffle))


def load(path) -> Net:
    """The net of a parameter checkpoint: a pickle (read by numpy) of
    flax's tree ``{"params": {layer: {"kernel": HWIO, "bias"}}}``, of its
    inner dict, or of ``{"variant": name, "params": tree}``; the layers
    ``feat0 ..`` and ``shuffle``, each kernel turned from HWIO to OIHW."""
    tree = np.load(path, allow_pickle=True)  # a pickle: its object
    if "variant" in tree:
        tree = tree["params"]
    if "params" in tree:
        tree = tree["params"]

    def layer(name):
        p = tree[name]
        k = np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)
        return (torch.from_numpy(np.ascontiguousarray(k)),
                torch.from_numpy(np.asarray(p["bias"], np.float32).copy()))
    n = 0
    while f"feat{n}" in tree:
        n += 1
    if n == 0 or "shuffle" not in tree or len(tree) != n + 1:
        raise ValueError(f"{path}: layers {sorted(tree)}, not feat0.. and "
                         "shuffle")
    return Net([layer(f"feat{i}") for i in range(n)], layer("shuffle"))


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (to nearest even) and back to float32;
    to float8 after saturating at its largest finite value."""
    if dtype == FP8:
        x = torch.clamp(x, -_FP8_MAX, _FP8_MAX)
    return x.to(dtype).to(_F32)


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         in_dtype=_BF16) -> torch.Tensor:
    """flax's bfloat16 3x3 SAME conv of (1, C, h, w) float32 values (module
    docstring, step 3); the result holds bfloat16 values in float32."""
    y = F.conv2d(_round(x, in_dtype), _round(kernel, in_dtype), None,
                 padding=1)
    return _round(_round(y, _BF16) + _round(bias, _BF16)[:, None, None],
                  _BF16)


def _unpack(word: torch.Tensor) -> torch.Tensor:
    """(H, W) packed words -> (3, H, W) float32 in [0, 1]."""
    return torch.stack([((word >> (8 * c)) & 0xFF).to(_F32) * (1.0 / 255.0)
                        for c in range(3)])


def warp_history(history: torch.Tensor, motion: torch.Tensor):
    """The history (3h, 3w, 3) reprojected by the low-res motion (h, w, 2)
    with the ``"bilinear_packed"`` warp (module docstring, step 1);
    returns (3, 3h, 3w)."""
    hh, hw = history.shape[0], history.shape[1]
    s = hh // motion.shape[0]
    mv = motion.repeat_interleave(s, 0).repeat_interleave(s, 1)
    dev = history.device
    xs = torch.arange(hw, dtype=_F32, device=dev)[None, :] \
        - mv[..., 0] * (0.5 * hw)
    ys = torch.arange(hh, dtype=_F32, device=dev)[:, None] \
        - mv[..., 1] * (0.5 * hh)
    q = torch.clamp(torch.round(history * 255.0), 0.0, 255.0).to(torch.int64)
    packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
    x = torch.clamp(xs, 0.0, hw - 1.0)
    y = torch.clamp(ys, 0.0, hh - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[None], (y - y0)[None]
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=hw - 1)
    y1 = torch.clamp(y0 + 1, max=hh - 1)
    a, b = _unpack(packed[y0, x0]), _unpack(packed[y0, x1])
    c, d = _unpack(packed[y1, x0]), _unpack(packed[y1, x1])
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def resize_weights(m: int, n: int, device) -> torch.Tensor:
    """``jax.image.resize``'s (m, n) weight matrix for a linear resize of m
    samples to n (module docstring, step 5)."""
    sample = (torch.arange(n, dtype=_F32, device=device) + 0.5) * (m / n) \
        - 0.5
    x = torch.abs(sample[None, :]
                  - torch.arange(m, dtype=_F32, device=device)[:, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def space_to_depth(cf: torch.Tensor) -> torch.Tensor:
    """(3, 3h, 3w) -> (27, h, w): the strided slices ``cf[:, si::3,
    sj::3]`` in (si, sj) order."""
    return torch.cat([cf[:, si::SCALE, sj::SCALE] for si in range(SCALE)
                      for sj in range(SCALE)])


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(9 * C_OUT, h, w) -> (C_OUT, 3h, 3w) in JAX's order (step 4)."""
    _, h, w = x.shape
    out = x.new_empty(C_OUT, SCALE * h, SCALE * w)
    for si in range(SCALE):
        for sj in range(SCALE):
            k = (si * SCALE + sj) * C_OUT
            out[:, si::SCALE, sj::SCALE] = x[k:k + C_OUT]
    return out


def upscale(net: Net, color, motion, depth, jitter, history,
            lowp_dtype=None) -> torch.Tensor:
    """One frame of the learned upscaler (module docstring): the (3h, 3w,
    3) image from the frame's low-res colour, motion, depth and jitter and
    the previous image ``history``.  ``lowp_dtype``: the control's
    rounding of each conv's input and kernel."""
    h, w = color.shape[0], color.shape[1]
    warped = warp_history(history, motion)
    x = torch.cat([color.permute(2, 0, 1), motion.permute(2, 0, 1),
                   depth[None], jitter.to(_F32).reshape(2, 1, 1)
                   .expand(2, h, w), space_to_depth(warped)])[None]
    in_dtype = _BF16 if lowp_dtype is None else lowp_dtype
    for kernel, bias in net.feats:
        x = torch.relu(conv(x, kernel, bias, in_dtype))
    up = depth_to_space(conv(x, *net.shuffle, in_dtype)[0])
    alpha = torch.sigmoid(up[3:4])
    dev = color.device
    cf = color.permute(2, 0, 1)
    anchor = torch.matmul(cf, resize_weights(w, SCALE * w, dev))
    anchor = torch.matmul(resize_weights(h, SCALE * h, dev).T, anchor)
    current = torch.clamp(anchor + up[:3], 0.0, 1.0)
    out = alpha * warped + (1.0 - alpha) * current
    return torch.clamp(out, 0.0, 1.0).permute(1, 2, 0).contiguous()
