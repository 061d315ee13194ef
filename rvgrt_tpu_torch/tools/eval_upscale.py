"""Compare upscalers on rendered flythrough segments.

The port of ``scripts/eval_upscale.py``, with the same flags.  Renders
held-out (low-res, 3x target) pairs with the renderer
(``upscale/train.render_pair_dataset``) and evaluates, closed loop per
segment:

  * bilinear resize (the floor),
  * the temporal super-resolution accumulator (``upscale/temporal.py``)
    over ``--taps`` / ``--decay`` / ``--depth-reject``,
  * learned checkpoints: ``--net`` (the upscaler) and ``--residual`` (the
    residual head riding the accumulator).

Reports the mean PSNR against the unjittered high-res target and the
temporal stability ratio (the reprojected frame-to-frame residual against
the ground truth's: 1.0 = moves like the true signal, > 1 shimmer, < 1
ghosting).

Usage (``--cpu`` runs on the CPU; the default device is the GPU):

  python -m rvgrt_tpu_torch.tools.eval_upscale --cube 8 --low-w 128 \\
      --low-h 80 --frames 24 --gi --net checkpoints/upscaler.pkl

``main`` returns {name: (psnr, temporal_ratio)}.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cube", type=int, default=8)
    p.add_argument("--low-w", type=int, default=128)
    p.add_argument("--low-h", type=int, default=80)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--seg", type=int, default=12)
    p.add_argument("--gi", action="store_true")
    p.add_argument("--static", action="store_true",
                   help="hold the camera still (isolates sub-pixel jitter "
                        "accumulation from reprojection quality)")
    p.add_argument("--ssaa", type=int, default=0,
                   help="supersample the reference target with N jittered "
                        "renders per pose (0 = single point-sampled render)")
    p.add_argument("--path-seed", type=int, default=101)
    p.add_argument("--net", nargs="*", default=[],
                   help="learned checkpoints to include")
    p.add_argument("--residual", nargs="*", default=[],
                   help="residual-head checkpoints (ride the temporal "
                        "accumulator as a post-pass, upscale/residual.py)")
    p.add_argument("--taps", nargs="*", default=["bilinear_shift"],
                   help="temporal-accumulator history-warp variants to "
                        "evaluate (bilinear / bilinear_shift / "
                        "catmull_shift / nearest / pallas)")
    p.add_argument("--decay", nargs="*", type=float, default=[0.35],
                   help="motion-decay values to evaluate (crossed with "
                        "the first --taps entry)")
    p.add_argument("--depth-reject", action="store_true",
                   help="also evaluate the accumulator with depth-based "
                        "disocclusion rejection (temporal.py depth_reject)")
    p.add_argument("--jitter9", action="store_true",
                   help="drive the renderer with the 9-phase full-"
                        "coverage jitter (camera.phase_jitter_sequence(3)) "
                        "instead of the reference's 8-phase table")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (small-scale checks)")
    args = p.parse_args(argv)

    from rvgrt_tpu_torch.config import EngineConfig, RenderConfig, WorldConfig
    from rvgrt_tpu_torch.upscale import model as up_model
    from rvgrt_tpu_torch.upscale import residual as res_mod
    from rvgrt_tpu_torch.upscale import temporal
    from rvgrt_tpu_torch.upscale.train import (psnr, render_pair_dataset,
                                               segments_of)
    from rvgrt_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    ecfg = EngineConfig(world=WorldConfig().with_cube(args.cube),
                        render=RenderConfig())
    t0 = time.perf_counter()
    jseq = None
    if args.jitter9:
        from rvgrt_tpu_torch.scene.camera import phase_jitter_sequence
        jseq = phase_jitter_sequence(up_model.SCALE)
    data = list(render_pair_dataset(ecfg, args.frames, args.low_w,
                                    args.low_h, include_gi=args.gi,
                                    segment_len=args.seg,
                                    path_seed=args.path_seed,
                                    static=args.static, ssaa=args.ssaa,
                                    jitter_seq=jseq, device=dev))
    print(f"rendered {len(data)} pairs in {time.perf_counter() - t0:.0f}s",
          flush=True)
    segs = segments_of(data, args.seg)
    results = {}

    def flicker(prev_out, prev_gt, out, gt, motion):
        w_out = up_model.warp_history(prev_out, motion)
        w_gt = up_model.warp_history(prev_gt, motion)
        return (float(torch.mean(torch.abs(out - w_out))),
                float(torch.mean(torch.abs(gt - w_gt))))

    def report(name, run_segment):
        """run_segment(seg) -> list of outputs (closed loop inside)."""
        ps, fl_o, fl_g = [], [], []
        for seg in segs:
            outs = run_segment(seg)
            prev = None
            for s, out in zip(seg, outs):
                ps.append(psnr(out, s.target))
                if prev is not None:
                    o, g = flicker(prev[0], prev[1], out, s.target, s.motion)
                    fl_o.append(o)
                    fl_g.append(g)
                prev = (out, s.target)
        ratio = (sum(fl_o) / len(fl_o)) / max(sum(fl_g) / len(fl_g), 1e-6)
        print(f"{name:28s} psnr {sum(ps)/len(ps):6.2f} dB   "
              f"temporal_ratio {ratio:5.2f}", flush=True)
        results[name] = (sum(ps) / len(ps), ratio)
        return sum(ps) / len(ps)

    def run_bilinear(seg):
        return [up_model._resize_bilinear_cf(
            s.color.permute(2, 0, 1), up_model.SCALE).permute(1, 2, 0)
            for s in seg]

    with torch.no_grad():
        base = report("bilinear", run_bilinear)

        tp = base
        variants = [(t, args.decay[0], False) for t in args.taps]
        variants += [(args.taps[0], d, False) for d in args.decay[1:]]
        if args.depth_reject:
            variants += [(args.taps[0], args.decay[0], True)]
        for taps, decay, dr in variants:
            def run_temporal(seg, taps=taps, decay=decay, dr=dr):
                state = temporal.init_state(args.low_h, args.low_w,
                                            depth_reject=dr, device=dev)
                outs = []
                for s in seg:
                    out, state = temporal.temporal_upscale(
                        s.color, s.motion, s.depth, s.jitter, state,
                        warp_taps=taps, motion_decay=decay, depth_reject=dr)
                    outs.append(out)
                return outs

            tag = f"temporal[{taps} d={decay}{' +depth' if dr else ''}]"
            got = report(tag, run_temporal)
            if (taps, decay, dr) == variants[0]:
                tp = got

        for path in args.residual:
            rnet = res_mod.load_checkpoint(path, device=dev)

            def run_residual(seg, rnet=rnet):
                state = temporal.init_state(args.low_h, args.low_w,
                                            device=dev)
                outs = []
                for s in seg:
                    acc_out, state = temporal.temporal_upscale(
                        s.color, s.motion, s.depth, s.jitter, state)
                    outs.append(res_mod.apply(rnet, s.color, s.motion,
                                              s.depth, s.jitter, acc_out,
                                              state.conf))
                return outs

            report(f"residual[{os.path.basename(path)}]", run_residual)

        for path in args.net:
            net = up_model.load_checkpoint(path, device=dev)

            def run_net(seg, net=net):
                hist = torch.zeros_like(seg[0].history)
                outs = []
                for s in seg:
                    hist, _ = up_model.upscale(net, s.color, s.motion,
                                               s.depth, s.jitter, hist)
                    outs.append(hist)
                return outs

            report(os.path.basename(path), run_net)

    print(f"temporal vs bilinear: {tp - base:+.2f} dB", flush=True)
    return results


if __name__ == "__main__":
    main()
