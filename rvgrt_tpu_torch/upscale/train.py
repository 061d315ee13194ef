"""Self-supervised upscaler training.

The port of ``rvgrt_tpu/upscale/train.py``.  Training data is free: render
the same deterministic camera path at low and at 3x resolution with the
same engine (SURVEY.md §7.8); the high-res render is the ground truth.
Loss = L1 + 0.5 x gradient L1 (edge preservation), optimised with Adam.

What the port keeps of the JAX package, so that the two trainers take the
same steps from the same weights and data:

* the gradients at ties.  ``jnp.abs`` has gradient +1 at 0 (``abs_jax``;
  ``torch.abs`` gives 0) and ``jnp.clip`` 0.5 at its bounds
  (``model.clip01``; ``torch.clamp`` gives 1).  Both ties are common here:
  the gradient-L1 differences are exactly 0 over flat sky and over pixels
  clipped on both sides, and a zero-initialised residual head starts on
  ``clip(acc_out)``;
* optax's ``adam`` and ``cosine_decay_schedule(lr, decay_steps,
  alpha=0.03)`` in optax's order of operations (``Adam``), not
  ``torch.optim.Adam`` (which divides ``sqrt(v)`` by
  ``sqrt(bias_correction2)``) nor ``CosineAnnealingLR`` (recursive): the
  moments, the bias correction with the count after its increment, the
  step scaled by the schedule at the count before it, each rounded in
  float32 as XLA rounds it;
* the convs' gradients are ``F.conv2d``'s under ``torch.autograd`` (cuDNN
  on a GPU), as the JAX package leaves them to XLA: no TPU kernel has a
  backward.

The trainer's own initialisation (``train(seed)``, ``main``) draws from a
``torch.Generator``, not JAX's PRNG; ``model.params_from_flax`` carries a
flax tree across.  ``python -m rvgrt_tpu_torch.upscale.train`` trains a
model family member on engine-rendered pairs and writes ``{"variant",
"params"}`` as the JAX trainer does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
import time
from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from rvgrt_tpu_torch.upscale import model as up_model

_F32 = torch.float32
_f32 = np.float32


class Sample(NamedTuple):
    color: torch.Tensor    # (h, w, 3) low-res
    motion: torch.Tensor   # (h, w, 2)
    depth: torch.Tensor    # (h, w)
    jitter: torch.Tensor   # (2,)
    history: torch.Tensor  # (3h, 3w, 3) previous high-res output (or zeros)
    target: torch.Tensor   # (3h, 3w, 3) high-res ground truth


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient: +1 at +-0, where ``torch.abs``'s is
    0.  The values are ``torch.abs``'s."""
    return torch.where(x >= 0, x, -x)


def _grad_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dxa = a[:, 1:] - a[:, :-1]
    dxb = b[:, 1:] - b[:, :-1]
    dya = a[1:] - a[:-1]
    dyb = b[1:] - b[:-1]
    return torch.mean(abs_jax(dxa - dxb)) + torch.mean(abs_jax(dya - dyb))


def l1_grad_loss(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Both trainers' loss: mean |out - target| + 0.5 x gradient L1."""
    return torch.mean(abs_jax(out - target)) + 0.5 * _grad_l1(out, target)


def loss_fn(net: up_model.UpscalerNet, s: Sample):
    """(loss, output) of ``net`` on ``s``, its history warped first."""
    warped = up_model.warp_history(s.history, s.motion)
    out, _ = net(s.color, s.motion, s.depth, s.jitter, warped)
    return l1_grad_loss(out, s.target), out


# --- Adam in optax's order of operations ---------------------------------

#: optax.adam's defaults, and make_optimizer's cosine floor (3 % of lr)
B1, B2, EPS, ALPHA = 0.9, 0.999, 1e-8, 0.03


@functools.lru_cache(maxsize=None)
def _libm():
    """The C library's ``cosf`` and ``powf``, which XLA:CPU calls for
    float32 ``cos`` and ``pow`` (numpy's and torch's ``cos`` differ from
    it by an ulp at some counts of the schedule)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn, n in ((lib.cosf, 1), (lib.powf, 2)):
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * n
    return lib


class AdamState(NamedTuple):
    count: int                  # updates taken (optax's count), on the host
    mu: list[torch.Tensor]      # first moments, one a parameter
    nu: list[torch.Tensor]      # second moments


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)``, or with ``decay_steps`` ``optax.adam(optax.
    cosine_decay_schedule(lr, decay_steps, alpha=0.03))``, over a list of
    parameter tensors.  ``init(params)`` -> state; ``update(grads, state)``
    -> (updates, state); ``apply_updates(params, updates)`` adds them in
    place.  The host-side scalars (the schedule, the bias corrections) are
    float32 values computed as XLA computes them (``_libm``)."""

    lr: float = 1e-3
    decay_steps: int | None = None

    def learning_rate(self, count: int) -> float:
        """The step size's magnitude at ``count`` (before the increment)."""
        if not self.decay_steps:
            return float(_f32(self.lr))
        ds = _f32(self.decay_steps)
        x = _f32(_f32(math.pi) * _f32(min(count, self.decay_steps))) / ds
        cosine = _f32(0.5) * (_f32(1.0) + _f32(_libm().cosf(float(x))))
        decayed = _f32(1.0 - ALPHA) * cosine + _f32(ALPHA)
        return float(_f32(self.lr) * decayed)

    def init(self, params) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads, state: AdamState):
        t = state.count + 1
        c1, d1 = float(_f32(1.0 - B1)), float(_f32(B1))
        c2, d2 = float(_f32(1.0 - B2)), float(_f32(B2))
        # optax: 1 - decay**count in float32, the count after the increment;
        # divided by as device tensors (a CUDA division by a host scalar
        # multiplies by its reciprocal)
        dev = grads[0].device
        bc1, bc2 = (torch.full((), float(_f32(1.0) - _f32(_libm().powf(
            d, float(t)))), device=dev) for d in (d1, d2))
        step = -self.learning_rate(state.count)
        eps = float(_f32(EPS))
        mu, nu, updates = [], [], []
        for g, m, v in zip(grads, state.mu, state.nu):
            m = g * c1 + m * d1
            v = (g * g) * c2 + v * d2
            mu_hat = torch.div(m, bc1)
            nu_hat = torch.div(v, bc2)
            updates.append(mu_hat / (torch.sqrt(nu_hat) + eps) * step)
            mu.append(m)
            nu.append(v)
        return updates, AdamState(count=t, mu=mu, nu=nu)

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates) -> None:
        for p, u in zip(params, updates):
            p.add_(u)


def make_optimizer(lr: float = 1e-3, decay_steps: int | None = None) -> Adam:
    """Adam; with ``decay_steps``, cosine-decay the lr to 3% over the run."""
    return Adam(lr=lr, decay_steps=decay_steps or None)


def step(net: torch.nn.Module, opt: Adam, opt_state: AdamState,
         loss_and_out: Callable):
    """Value and gradient of ``loss_and_out()`` (-> (loss, output)) over
    ``net``'s parameters, then one Adam update in place.  Returns
    (opt_state, loss, output), the loss a 0-d tensor and the output
    detached (``jax.lax.stop_gradient``)."""
    params = list(net.parameters())
    loss, out = loss_and_out()
    grads = torch.autograd.grad(loss, params)
    updates, opt_state = opt.update(grads, opt_state)
    opt.apply_updates(params, updates)
    return opt_state, loss.detach(), out.detach()


def train_step(net: up_model.UpscalerNet, opt: Adam, opt_state: AdamState,
               s: Sample):
    """One update; also returns the net output, for closed-loop history.

    Training must feed the net its own previous output as history, not the
    ground-truth previous frame: with teacher-forced history the blend
    weight degenerates to a constant, which then blends black at history
    resets and compounds drift at inference."""
    return step(net, opt, opt_state, lambda: loss_fn(net, s))


# --- data -----------------------------------------------------------------

def render_pair_dataset(ecfg, n_frames: int, low_w: int, low_h: int,
                        include_gi: bool = False,
                        segment_len: int = 12,
                        path_seed: int = 0,
                        static: bool = False,
                        ssaa: int = 0,
                        jitter_seq=None, device=None) -> Iterator[Sample]:
    """Render (low-res inputs, 3x high-res target) pairs along a
    deterministic flythrough of the configured world.

    The path is cut into segments with varied motion (fly / strafe / turn
    left / turn right / climb) from re-randomised headings; each segment
    restarts the temporal history.  The two engines share one world object
    (``hi.world = lo.world``), so each frame runs two GI updates on the
    same grid, as in the JAX package; the high-res engine is given the
    low-res engine's world instead of building its own copy.  The water
    clock is ``time.time()``'s, as in the JAX package."""
    from rvgrt_tpu_torch.driver.cli import spawn_above_terrain
    from rvgrt_tpu_torch.driver.engine import Engine
    from rvgrt_tpu_torch.scene.camera import JITTER_SEQUENCE, InputState

    lo_cfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, width=low_w, height=low_h))
    hi_cfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, width=low_w * up_model.SCALE,
        height=low_h * up_model.SCALE))

    lo = Engine(lo_cfg, include_gi=include_gi, verbose=False, device=device)
    hi = Engine(hi_cfg, include_gi=include_gi, verbose=False, device=device,
                world=lo.world)
    dev = lo.device
    # the target is the unjittered high-res signal; the low-res input keeps
    # its jitter (the DLSS input contract)
    hi.character.use_jitter = False
    if jitter_seq is not None:
        lo.character.jitter_sequence = jitter_seq
    spawn = spawn_above_terrain(lo)
    hi.character.position = spawn.copy()
    hi.character.pitch = lo.character.pitch
    hi.character.yaw = lo.character.yaw

    moves = [
        InputState(move_z=1.0, mouse_dx=1.0),
        InputState(move_z=1.0, mouse_dx=-3.0),
        InputState(move_x=1.0, mouse_dx=0.5),
        InputState(move_z=1.0, mouse_dy=1.0),
        InputState(move_z=-1.0, mouse_dx=2.0),
    ]
    if static:
        moves = [InputState()]
    rng = np.random.default_rng(path_seed)
    if path_seed:
        # held-out paths start on their own heading: one draw, assigned to
        # both cameras
        yaw0 = float(rng.uniform(-3.14, 3.14))
        pitch0 = float(rng.uniform(-3.9, -3.3))
        for ch in (lo.character, hi.character):
            ch.yaw = yaw0
            ch.pitch = pitch0
    zero_hist = torch.zeros(low_h * up_model.SCALE, low_w * up_model.SCALE,
                            3, dtype=_F32, device=dev)
    history = zero_hist
    for i in range(n_frames):
        if segment_len and i % segment_len == 0 and i:
            # new heading + fresh history each segment; the pitch resets
            # into a downward-looking band
            lo.character.yaw = float(rng.uniform(-3.14, 3.14))
            lo.character.pitch = float(rng.uniform(-3.9, -3.3))
            hi.character.yaw = lo.character.yaw
            hi.character.pitch = lo.character.pitch
            hi.character.position = lo.character.position.copy()
            history = zero_hist
        inputs = moves[(i // max(segment_len, 1)) % len(moves)]
        out_lo = lo.step(inputs, 1 / 60)
        out_hi = hi.step(inputs, 1 / 60)
        target = out_hi.color
        if ssaa > 0:
            # supersampled reference: the mean of `ssaa` jittered renders
            # of the same pose
            hw_, hh_ = hi.ecfg.render.width, hi.ecfg.render.height
            t_s = (time.time() - hi.start_time) % 1e6
            acc = None
            for k in range(ssaa):
                jx, jy = JITTER_SEQUENCE[k % 8] * 0.5
                j = (float(jx) * 2.0 / hw_, float(jy) * 2.0 / hh_)
                c = hi.render_at(jitter_ndc=j, time_s=t_s).color
                acc = c if acc is None else acc + c
            target = acc / _f32(ssaa)
        jit = torch.tensor(lo.character.ray_jitter_ndc(), dtype=_F32,
                           device=dev)
        yield Sample(color=out_lo.color, motion=out_lo.motion,
                     depth=out_lo.depth, jitter=jit, history=history,
                     target=target)
        history = target


def segments_of(data: list, segment_len: int) -> list:
    """``data`` cut into consecutive segments of ``segment_len``."""
    return [data[i:i + segment_len] for i in range(0, len(data), segment_len)]


def train_closed_loop(net, opt: Adam, opt_state: AdamState, segments,
                      steps: int, rng=None, verbose: bool = True):
    """Closed-loop training: walk segments frame by frame, feeding the
    net's own (detached) output back as the next frame's history - the
    inference regime, including the zero-history segment start.  Returns
    (opt_state, losses); ``net`` is trained in place.  The losses are read
    to the host once, at the end."""
    if not segments:
        raise ValueError("no training segment")
    rng = rng or np.random.default_rng(0)
    zero_hist = torch.zeros_like(segments[0][0].history)
    losses = []
    i = 0
    while i < steps:
        seg = segments[rng.integers(len(segments))]
        hist = zero_hist
        for s in seg:
            if i >= steps:
                break
            s = s._replace(history=hist)
            opt_state, loss, out = train_step(net, opt, opt_state, s)
            hist = out
            losses.append(loss)
            if verbose and i % 100 == 0:
                print(f"step {i}: loss {float(loss):.4f}", flush=True)
            i += 1
    return opt_state, [float(v) for v in losses]


def train(ecfg, steps: int = 200, low_w: int = 128, low_h: int = 96,
          lr: float = 1e-3, seed: int = 0, verbose: bool = True,
          segment_len: int = 12, device=None):
    """Train on freshly rendered pairs; returns (net, losses)."""
    net = up_model.init_params(low_h, low_w,
                               generator=torch.Generator().manual_seed(seed),
                               device=device)
    opt = make_optimizer(lr, decay_steps=steps)
    opt_state = opt.init(list(net.parameters()))
    n_frames = min(max(steps, segment_len), 48)
    data = list(render_pair_dataset(ecfg, n_frames, low_w, low_h,
                                    segment_len=segment_len, device=device))
    _, losses = train_closed_loop(net, opt, opt_state,
                                  segments_of(data, segment_len), steps,
                                  rng=np.random.default_rng(seed),
                                  verbose=verbose)
    return net, losses


def save_params(params, path: str) -> None:
    from rvgrt_tpu_torch.driver import checkpoint

    checkpoint.save_params(path, params)


def load_params(path: str):
    from rvgrt_tpu_torch.driver import checkpoint

    return checkpoint.load_params(path)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR (dB) of ``a`` against ``b`` in [0, 1], in float32 as the JAX
    package computes it; 99 for equal images."""
    mse = torch.mean((a - b) ** 2)
    if float(mse) == 0:
        return 99.0
    return float(10.0 * torch.log10(1.0 / mse))


@torch.no_grad()
def evaluate(net, samples, closed_loop: bool = True) -> dict:
    """PSNR + temporal stability of the net against plain bilinear
    upsampling.

    ``closed_loop`` treats ``samples`` as one ordered segment and rolls the
    net's own output as history from zeros (the inference regime);
    otherwise each sample's stored history is used as it is.  Temporal
    stability: mean |out_t - warp(out_{t-1}, motion_t)| over the segment,
    as a ratio to the same residual of the ground truth (1.0 = the output
    changes as much as the true signal; > 1 shimmer, < 1 ghosting)."""
    net_psnrs, bil_psnrs = [], []
    net_flick, gt_flick = [], []
    hist = torch.zeros_like(samples[0].history)
    prev_out = prev_gt = None
    for s in samples:
        if closed_loop:
            s = s._replace(history=hist)
        warped = up_model.warp_history(s.history, s.motion)
        out, _ = net(s.color, s.motion, s.depth, s.jitter, warped)
        hist = out
        bil = up_model._resize_bilinear_cf(
            s.color.permute(2, 0, 1), up_model.SCALE).permute(1, 2, 0)
        net_psnrs.append(psnr(out, s.target))
        bil_psnrs.append(psnr(bil, s.target))
        if prev_out is not None:
            w_out = up_model.warp_history(prev_out, s.motion)
            w_gt = up_model.warp_history(prev_gt, s.motion)
            net_flick.append(float(torch.mean(torch.abs(out - w_out))))
            gt_flick.append(float(torch.mean(torch.abs(s.target - w_gt))))
        prev_out, prev_gt = out, s.target
    res = {"psnr_net": sum(net_psnrs) / len(net_psnrs),
           "psnr_bilinear": sum(bil_psnrs) / len(bil_psnrs)}
    if net_flick:
        gt = max(sum(gt_flick) / len(gt_flick), 1e-6)
        res["temporal_ratio"] = (sum(net_flick) / len(net_flick)) / gt
    return res


def main(argv=None) -> dict:
    """Train the upscaler on engine-rendered pairs and save its params;
    returns a report (seconds, losses, evaluation, and the trained
    ``net``)."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    p.add_argument("--cube", type=int, default=8)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--low-w", type=int, default=128)
    p.add_argument("--low-h", type=int, default=96)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--gi", action="store_true",
                   help="render training pairs with cone-traced GI on")
    p.add_argument("--eval-w", type=int, default=0,
                   help="held-out eval at a different low-res width (the "
                        "net is fully convolutional)")
    p.add_argument("--eval-h", type=int, default=0)
    p.add_argument("--eval-frames", type=int, default=24)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--variant", default="up-m",
                   help="model family member (models/upscaler.py)")
    p.add_argument("--out", default="checkpoints/upscaler.pkl")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
    from rvgrt_tpu_torch.models import upscaler as up_family
    from rvgrt_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    ecfg = EngineConfig(world=WorldConfig().with_cube(args.cube),
                        render=RenderConfig())
    report = {"variant": args.variant, "device": str(dev)}
    t0 = time.perf_counter()
    data = list(render_pair_dataset(ecfg, args.frames, args.low_w,
                                    args.low_h, include_gi=args.gi,
                                    device=dev))
    _sync(dev)
    report["render_s"] = time.perf_counter() - t0
    print(f"rendered {len(data)} pairs in {report['render_s']:.0f}s",
          flush=True)

    net = up_family.init(args.variant, torch.Generator().manual_seed(0),
                         args.low_h, args.low_w, device=dev)
    opt = make_optimizer(args.lr, decay_steps=args.steps)
    opt_state = opt.init(list(net.parameters()))
    seg = 12
    segments = segments_of(data, seg)
    if args.eval_w:
        # held-out frames at the operating point, on another camera path
        train_segs = segments
        eval_segs = segments_of(list(render_pair_dataset(
            ecfg, args.eval_frames, args.eval_w, args.eval_h,
            include_gi=args.gi, segment_len=seg, path_seed=101,
            device=dev)), seg)
    else:
        train_segs, eval_segs = segments[:-2], segments[-2:]
        if not train_segs:
            p.error(f"--frames {args.frames} leaves no training segment: "
                    f"the last two segments of {seg} frames are held out "
                    "(give more frames, or --eval-w)")
    t0 = time.perf_counter()
    _, losses = train_closed_loop(net, opt, opt_state, train_segs,
                                  args.steps, rng=np.random.default_rng(0))
    _sync(dev)
    report.update(train_s=time.perf_counter() - t0, losses=losses)
    report["step_ms_mean"] = report["train_s"] * 1e3 / max(args.steps, 1)
    print(f"trained {args.steps} steps in {report['train_s']:.0f}s",
          flush=True)
    report["eval"] = []
    for k, es in enumerate(eval_segs):
        report["eval"].append(evaluate(net, es))
        print(f"eval segment {k}:", report["eval"][-1], flush=True)
    save_params({"variant": args.variant,
                 "params": up_model.params_to_flax(net)}, args.out)
    print(f"saved {args.out} ({args.variant})", flush=True)
    report.update(out=args.out, net=net)
    return report


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
