"""What decides ``correct``: the port's outputs held against the plain
reference (``port_bench/reference/``), which works the world, the tiers
and the frames out again from the configuration and the poses the run
handed to the port.

The numbers compared, each against its limit in ``limits/<workload>.json``:

* ``world_mismatch``: the elements of the world build (fine bits, coarse
  SDF, the tracer's gather table, the sky limit and the GI words after
  their init) that differ from the reference's;
* ``gi_mismatch``: the GI words after a checked frame's GI update that
  differ;
* ``color_err``, ``motion_err``, ``depth_err``: the largest absolute gap of
  the frame's colour, motion and depth at render size, after the GI
  composite and the expand to the full grid;
* ``image_err``: the largest absolute gap of the displayed image (the
  accumulator's or the learned upscaler's output, or the colour where there
  is no post stage).

The checked frames are the chain, the run's first ``CHAIN_FRAMES`` frames
(warm-up frames at the start pose, then window frames, which move, where
there are fewer), and one window frame drawn from the seed.  The reference
renders each at the tier its own copy of the scheduler picks over the run's
poses.  Along the chain it starts from the world and an empty accumulator
and carries its own GI words, post-stage state (the accumulator's, or the
learned upscaler's last image) and composite addend from frame to frame, so
a fault that builds up in that state over the chain shows.  For the window
frame it starts from the port's GI words, post-stage state and carried
addend before the frame: following the whole window would cost a plain
frame (5-9 s on the card) for each of its frames.  A window frame that lies
in the chain is checked there alone.  Where the post stage is ``"net"``,
the reference's net (``reference/upscaler.py``, float32 with flax's
bfloat16 roundings) is loaded from the configuration's checkpoint, the file
the port loads its net from.
"""

from __future__ import annotations

import torch

from port_bench import spec
from port_bench.drive import CHAIN
from port_bench.reference import config as rcfg
from port_bench.reference import frame as rframe
from port_bench.reference import pipeline as rpipe
from port_bench.reference import upscaler as rup
from port_bench.reference.scheduler import AdaptiveRateScheduler

NUMBERS = ("world_mismatch", "gi_mismatch", "color_err", "motion_err",
           "depth_err", "image_err")


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    if a is None or b is None or a.shape != b.shape:
        return -1 if a is None and b is None else max(
            (x.numel() for x in (a, b) if x is not None), default=0)
    return int((a.to(b.device) != b).sum())


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    d = (a.to(b.device).float() - b.float()).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def ref_tiers(poses, warm_rates, ecfg, rates: str) -> list[str]:
    """Each frame's tier as the reference picks it: the warm-up frames'
    tiers as set, then its scheduler's pick over consecutive poses."""
    out = list(warm_rates)
    if rates != "adaptive":
        return out + [rates] * (len(poses) - len(out))
    r = ecfg.render
    sched = AdaptiveRateScheduler(r.width, r.height, r.fov_degrees)
    for k in range(len(out), len(poses)):
        out.append(sched.step(poses[k - 1], poses[k]))
    return out


def _cam(pose, dev) -> rpipe.CameraArrays:
    return rpipe.CameraArrays(*(torch.as_tensor(a).to(dev)
                                for a in pose.arrays()))


def world_numbers(port_world, ref_world) -> int:
    return sum(_mismatch(getattr(port_world, k), getattr(ref_world, k))
               for k in ("bits", "sdf", "trace_table", "sky_y", "gi"))


def compare(cell: spec.Cell, port_world, kept: dict, poses, warm_rates,
            device, lowp: bool = False, log=print, ref=None) -> dict:
    """The numbers of ``NUMBERS`` for a run's kept world and frames.
    ``lowp``: the control, the reference in bfloat16 in the port's place
    (its world's density and GI radiance and its frames' images rounded to
    bfloat16, the learned upscaler's convs in float8), held against the
    reference; ``port_world`` is then that world,
    ``reference.frame.build_world(lowp=True)``, or None to build it.
    ``ref``: the reference's world, or None to build it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ecfg = spec.engine_config(cell.config, rcfg)
    lc = cell.config["loop"]
    dev = torch.device(device)
    net_path = cell.net_path()
    args = dict(upscaler=lc["post"], gi_cadence=lc["gi_cadence"],
                include_gi=lc["include_gi"], warp_taps=lc["warp_taps"],
                comp_cadence=lc.get("comp_cadence", 1),
                net=None if net_path is None else rup.load(net_path).to(dev))
    chain = sorted((kp for k, kp in kept.items() if k.startswith(CHAIN)),
                   key=lambda kp: kp.index)
    if [kp.index for kp in chain] != list(range(len(chain))):
        raise ValueError("the chain's frames are not frames 0, 1, ...")
    window = kept.get("window")
    with torch.no_grad():
        if ref is None:
            ref = rframe.build_world(ecfg, dev)
        if lowp and port_world is None:
            port_world = rframe.build_world(ecfg, dev, lowp=True)
        nums = {"world_mismatch": world_numbers(port_world, ref)}
        tiers = ref_tiers(poses, warm_rates, ecfg, lc["rates"])
        offsets = rframe.gi_offsets(len(poses), ecfg, lc["gi_cadence"],
                                    lc["include_gi"])
        for k in NUMBERS[1:]:
            nums[k] = 0 if k == "gi_mismatch" else 0.0

        def one(kp, ref_in, low_in, what):
            """Frame ``kp`` from the reference's (GI words, state, addend)
            ``ref_in``, held against the port's outputs, or with ``lowp``
            against the control's from ``low_in``; returns both sides'
            (GI words, state, addend) after it."""
            i = kp.index
            gi, state, addend = ref_in
            want = rframe.frame(ref, ecfg, i, _cam(kp.pose, dev), tiers[i],
                                gi, state, offsets[i], addend=addend, **args)
            if lowp:
                gi, state, addend = low_in
                got = rframe.frame(port_world, ecfg, i, _cam(kp.pose, dev),
                                   tiers[i], gi, state, offsets[i],
                                   addend=addend, lowp=True, **args)
                got["gi_out"] = got["gi"]
                low_out = (got["gi"], got["state"], got["addend"])
            else:
                got = {"gi_out": kp.gi_out, "color": kp.color,
                       "motion": kp.motion, "depth": kp.depth,
                       "image": kp.image}
                low_out = None
            nums["gi_mismatch"] += _mismatch(got["gi_out"], want["gi"])
            for k in ("color", "motion", "depth", "image"):
                nums[f"{k}_err"] = max(nums[f"{k}_err"],
                                       _err(got[k], want[k]))
            log(f"checked frame {i} ({what}; {tiers[i]}; the port's "
                f"{kp.rate})")
            return (want["gi"], want["state"], want["addend"]), low_out

        def start():
            # frame 0 composites, so no addend is read before one is made
            return rframe.init_state(ecfg, lc["scale"], lc["post"], dev)
        ref_in = (ref.gi, start(), None)
        low_in = (port_world.gi, start(), None) if lowp else None
        for kp in chain:
            ref_in, low_in = one(kp, ref_in, low_in, "chain")
        if window is not None and window.index >= len(chain):
            port_in = (window.gi_in, window.state_in, window.addend_in)
            one(window, port_in, port_in, "from the port's state")
    return nums


def verdict(nums: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(nums[k] <= limits[k] for k in NUMBERS)
