"""Learned residual head on top of the temporal accumulator.

The port of ``rvgrt_tpu/upscale/residual.py``.  Standalone conv nets top
out at bilinear level while the analytic temporal accumulator
(``upscale/temporal.py``) does better, so the learned component is a
residual head: a small zero-initialised conv net that sees the
accumulator's output and confidence and the current frame's inputs, and
predicts a per-pixel correction.  Its starting output is exactly the
accumulator, and it does not feed back into the accumulator's state: the
recurrence stays analytic and the head is a pure post-pass
(``bench.py``'s ``BENCH_UPSCALE=residual``), so training is plain
supervised regression (no closed-loop rollout).

The convs, the bf16 rounding and the channel orders are ``model.py``'s;
the loss, the step and the optimizer are ``train.py``'s.  The trainer is
``tools/train_residual.py``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from rvgrt_tpu_torch.core.vecmath import f32
from rvgrt_tpu_torch.upscale import model as up_model
from rvgrt_tpu_torch.upscale import temporal as up_temporal
from rvgrt_tpu_torch.upscale import train as up_train
from rvgrt_tpu_torch.utils.device import resolve_device

_F32 = torch.float32
SCALE = up_model.SCALE
#: the head's input channels: the net's 8 low-res ones, the accumulator's
#: output (27) and confidence (9) in space-to-depth
IN_CHANNELS = 3 + 2 + 1 + 2 + 3 * SCALE * SCALE + SCALE * SCALE


class ResSample(NamedTuple):
    color: torch.Tensor     # (h, w, 3) low-res input
    motion: torch.Tensor    # (h, w, 2)
    depth: torch.Tensor     # (h, w)
    jitter: torch.Tensor    # (2,)
    acc_out: torch.Tensor   # (3h, 3w, 3) temporal accumulator output
    acc_conf: torch.Tensor  # (3h, 3w) accumulator confidence
    target: torch.Tensor    # (3h, 3w, 3) SSAA ground truth


def _s2d(cf_or_img: torch.Tensor) -> torch.Tensor:
    """(3h, 3w[, c]) display-res -> (h, w, 9[*c]) space-to-depth, channel
    ``(si*3 + sj)*c + k``."""
    a = cf_or_img if cf_or_img.ndim == 3 else cf_or_img[..., None]
    return up_model.space_to_depth_cf(a.permute(2, 0, 1)).permute(1, 2, 0)


class ResidualHead(up_model._ConvStack):
    """Zero-initialised residual over the accumulator's output."""

    def __init__(self, features: int = 32, depth_layers: int = 3,
                 dtype=torch.bfloat16):
        super().__init__(IN_CHANNELS, features, depth_layers, 3, dtype)

    def forward(self, color, motion, depth, jitter, acc_out, acc_conf):
        acc_cf = acc_out.permute(2, 0, 1)
        conf = acc_conf * f32(1.0 / up_temporal._CONF_MAX)
        extra = torch.cat([up_model.space_to_depth_cf(acc_cf),
                           up_model.space_to_depth_cf(conf[None])], dim=0)
        res_cf = self.logits(up_model._net_input(
            color, motion, depth, jitter, extra, self.dtype)).to(_F32)
        out_cf = acc_cf + res_cf
        return up_model.clip01(out_cf).permute(1, 2, 0).contiguous()


def init_params(height: int, width: int, features: int = 32,
                depth_layers: int = 3,
                generator: torch.Generator | None = None,
                device=None, dtype=torch.bfloat16) -> ResidualHead:
    """A fresh head (``model.init_stack``: lecun-normal feature kernels
    from ``generator``, zero biases, a zero shuffle conv): its output is
    exactly the accumulator's.  The low-res size is JAX's signature."""
    del height, width
    net = ResidualHead(features=features, depth_layers=depth_layers,
                       dtype=dtype)
    up_model.init_stack(net, generator)
    return net.to(resolve_device(device))


@torch.no_grad()
def apply(net: ResidualHead, color, motion, depth, jitter, acc_out,
          acc_conf) -> torch.Tensor:
    return net(color, motion, depth, jitter, acc_out, acc_conf)


def load_checkpoint(path: str, device=None) -> ResidualHead:
    """The head of a checkpoint as the trainer writes it and ``bench.py``
    reads it (``{"kind": "residual_head", "features", "layers",
    "params"}``), on ``device``."""
    from rvgrt_tpu_torch.driver import checkpoint as ck

    blob = ck.load_params(path)
    if blob.get("kind") != "residual_head":
        raise ValueError(f"{path}: not a residual head checkpoint")
    net = ResidualHead(features=blob["features"],
                       depth_layers=blob["layers"])
    net.load_state_dict(up_model.params_from_flax(blob["params"]))
    return net.to(resolve_device(device))


def accumulate_samples(samples, valid=None) -> Iterator[ResSample]:
    """Run the analytic accumulator (``temporal_upscale`` with its
    defaults) over an ordered segment of ``train.Sample``s, from a zero
    state (the segment's start), and yield the head's training samples."""
    state = None
    for s in samples:
        if state is None:
            state = up_temporal.init_state(s.color.shape[0], s.color.shape[1],
                                           device=s.color.device)
        out, state = up_temporal.temporal_upscale(
            s.color, s.motion, s.depth, s.jitter, state, valid=valid)
        yield ResSample(color=s.color, motion=s.motion, depth=s.depth,
                        jitter=s.jitter, acc_out=out, acc_conf=state.conf,
                        target=s.target)


def loss_fn(net: ResidualHead, s: ResSample):
    """L1 + 0.5 x gradient L1 of the head's output against the target,
    with JAX's gradients at ties (``train.abs_jax``); returns (loss,
    output)."""
    out = net(s.color, s.motion, s.depth, s.jitter, s.acc_out, s.acc_conf)
    return up_train.l1_grad_loss(out, s.target), out


def train_step(net: ResidualHead, opt, opt_state, s: ResSample):
    """One update of ``net``'s parameters in place; returns (opt_state,
    loss, output), the output detached."""
    return up_train.step(net, opt, opt_state, lambda: loss_fn(net, s))


psnr = up_train.psnr


@torch.no_grad()
def evaluate(net: ResidualHead, res_samples) -> dict:
    """Held-out PSNR of the head's output against the accumulator it
    rides on."""
    head_p, acc_p = [], []
    for s in res_samples:
        out = net(s.color, s.motion, s.depth, s.jitter, s.acc_out,
                  s.acc_conf)
        head_p.append(psnr(out, s.target))
        acc_p.append(psnr(s.acc_out, s.target))
    return {"psnr_head": sum(head_p) / len(head_p),
            "psnr_accumulator": sum(acc_p) / len(acc_p)}
