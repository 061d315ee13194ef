"""Train the learned residual head on top of the temporal accumulator
(``upscale/residual.py``) and evaluate it held out.

The port of ``scripts/train_residual.py``, with the same flags.  The head
is a pure post-pass (the accumulator's recurrence stays analytic), so
training is plain supervised regression on (accumulator output,
current-frame inputs) -> SSAA reference.  The targets are supersampled:
the head must beat the accumulator on anti-aliased truth, not learn to
re-alias.

Usage (``--cpu`` runs on the CPU; the default device is the GPU):

  python -m rvgrt_tpu_torch.tools.train_residual --cube 8 --low-w 128 \\
      --low-h 96 --frames 72 --steps 800 --ssaa 4 --gi

It writes ``{"kind": "residual_head", "features", "layers", "params"}``
(flax's tree of numpy arrays), which ``bench.py`` and both packages'
``residual`` loaders read.  ``main`` returns a report: the seconds of the
pairs' renders and of the accumulation, each step's milliseconds (CUDA
events on a GPU), the losses, the evaluations and the peak device memory.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cube", type=int, default=8)
    p.add_argument("--low-w", type=int, default=128)
    p.add_argument("--low-h", type=int, default=96)
    p.add_argument("--frames", type=int, default=72)
    p.add_argument("--eval-frames", type=int, default=24)
    p.add_argument("--seg", type=int, default=12)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ssaa", type=int, default=4)
    p.add_argument("--gi", action="store_true", default=True)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--loss", choices=["l1g", "mse"], default="l1g",
                   help="l1g = L1 + 0.5*gradient-L1 (default); mse = "
                        "plain MSE (PSNR-aligned - capacity probes)")
    p.add_argument("--f32", action="store_true",
                   help="run the head in float32 instead of bfloat16")
    p.add_argument("--eval-seed", type=int, default=202,
                   help="held-out path seed (202 faces terrain; 101 faces "
                        "pure sky at cube 8)")
    p.add_argument("--out", default="checkpoints/residual_head.pkl")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
    from rvgrt_tpu_torch.driver import checkpoint as ck
    from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
    from rvgrt_tpu_torch.upscale import model as up_model
    from rvgrt_tpu_torch.upscale import residual as res_mod
    from rvgrt_tpu_torch.upscale import train as up_train
    from rvgrt_tpu_torch.utils.device import resolve_device
    from rvgrt_tpu_torch.utils.timer import Timer

    dev = resolve_device("cpu" if args.cpu else None)
    cuda = dev.type == "cuda"
    print(f"device={dev}", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    report = {"device": str(dev), "render_s": [], "accumulate_s": []}
    ecfg = EngineConfig(world=WorldConfig().with_cube(args.cube),
                        render=RenderConfig())
    jseq = phase_jitter_sequence(3)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def segments_of(n_frames, path_seed):
        t0 = time.perf_counter()
        data = list(up_train.render_pair_dataset(
            ecfg, n_frames, args.low_w, args.low_h, include_gi=args.gi,
            segment_len=args.seg, path_seed=path_seed, ssaa=args.ssaa,
            jitter_seq=jseq, device=dev))
        sync()
        report["render_s"].append(time.perf_counter() - t0)
        print(f"rendered {len(data)} pairs (seed {path_seed}) in "
              f"{report['render_s'][-1]:.0f}s", flush=True)
        segs = up_train.segments_of(data, args.seg)
        t0 = time.perf_counter()
        rsegs = [list(res_mod.accumulate_samples(s)) for s in segs]
        sync()
        report["accumulate_s"].append(time.perf_counter() - t0)
        print(f"accumulated in {report['accumulate_s'][-1]:.0f}s",
              flush=True)
        return rsegs

    train_segs = segments_of(args.frames, path_seed=0)
    eval_segs = segments_of(args.eval_frames, path_seed=args.eval_seed)

    net = res_mod.init_params(
        args.low_h, args.low_w, features=args.features,
        depth_layers=args.layers, generator=torch.Generator().manual_seed(0),
        device=dev, dtype=torch.float32 if args.f32 else torch.bfloat16)
    opt = up_train.make_optimizer(args.lr, decay_steps=args.steps)
    opt_state = opt.init(list(net.parameters()))

    if args.loss == "mse":
        def step_fn(net, opt, opt_state, s):
            def loss_and_out():
                out = net(s.color, s.motion, s.depth, s.jitter, s.acc_out,
                          s.acc_conf)
                return torch.mean((out - s.target) ** 2), out
            return up_train.step(net, opt, opt_state, loss_and_out)
    else:
        step_fn = res_mod.train_step

    flat = [s for seg in train_segs for s in seg]
    rng = np.random.default_rng(0)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        s = flat[rng.integers(len(flat))]
        with Timer("step", verbose=False, device=dev) as t:
            opt_state, loss, _ = step_fn(net, opt, opt_state, s)
        step_ms.append(t.elapsed_ms)
        losses.append(loss)
        if i % 100 == 0:
            print(f"step {i}: loss {float(loss):.4f}", flush=True)
    sync()
    report["train_s"] = time.perf_counter() - t0
    report["losses"] = [float(v) for v in losses]
    report["step_ms"] = step_ms
    timed = step_ms[2:] or step_ms
    report["step_ms_median"] = statistics.median(timed)
    report["steps_per_s"] = 1e3 / report["step_ms_median"]
    print(f"trained {args.steps} steps in {report['train_s']:.0f}s",
          flush=True)

    report["eval"] = []
    for k, seg in enumerate(eval_segs):
        report["eval"].append(res_mod.evaluate(net, seg))
        print(f"eval segment {k}: {report['eval'][-1]}", flush=True)
    report["train_split"] = res_mod.evaluate(
        net, [s for seg in train_segs[:2] for s in seg])
    print(f"train-split sanity: {report['train_split']}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ck.save_params(args.out, {
        "kind": "residual_head", "features": args.features,
        "layers": args.layers, "params": up_model.params_to_flax(net)})
    print(f"saved {args.out}", flush=True)
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    report.update(out=args.out, net=net)
    return report


if __name__ == "__main__":
    main()
