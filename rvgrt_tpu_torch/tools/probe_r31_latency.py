"""Interactive input->photon latency through the live viewer (VERDICT r4
#3/#8).

The port of ``scripts/probe_r31_latency.py``, with the same flags.  It runs
the real ``ViewerServer`` (``driver/viewer.py``, ``max_fps=1000``) over a
real ``Engine`` and measures, from the HTTP client's side, the wall time
from POSTing an input event to the frame count showing a frame that
includes it:

* POST ``/input`` with ``mouse_dx=3``; the frame count s0 is read from
  ``/stats`` just before;
* ``first-after`` = time until the count passes s0 (optimistic: that frame
  was already in flight when the input landed, so it may not include it);
* ``guaranteed`` = time until the count reaches s0 + 2 (the render loop
  took the input at the start of that frame or earlier).

``/stats`` is polled every 2 ms, as the script does: each poll is an HTTP
request that takes the interpreter lock from the render thread, so the
POST's own round trip is reported beside the two spans.  The span covers
the input's parse, ``Engine.step`` (the GI window, the base frame and the
composite on the card), the colour's quantisation and copy to the host,
the JPEG encode and the publish.  A browser adds its own network, decode
and vsync; the reference's loop is vsync-paced (``main.cpp:217``).

Usage (the default device is the GPU; ``--device cpu`` runs the plain
PyTorch path):

    python -m rvgrt_tpu_torch.tools.probe_r31_latency [--config stage2] \\
        [--trials 10] [--no-gi]

``--config`` is any name of ``driver/cli.py``'s ``CONFIGS`` or ``tiny``.
``main`` prints the script's lines, then one JSON line (median and p90 of
both spans and of the POST round trip, the last ``frame_ms``, the card's
name and power limit) and returns it.  A failed frame fails the tool:
``ViewerServer.stop()`` raises the render loop's error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import urllib.request

import numpy as np
import torch

#: seconds between two polls of /stats
POLL_S = 0.002
#: the warm-up: frames the server must report before the trials
WARM_FRAMES = 3


def parse_args(argv=None) -> argparse.Namespace:
    from rvgrt_tpu_torch.driver import cli as cli_mod

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="stage2",
                   choices=list(cli_mod.CONFIGS) + ["tiny"])
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--no-gi", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p.parse_args(argv)


def _stats(base: str) -> dict:
    with urllib.request.urlopen(base + "/stats", timeout=120) as r:
        return json.loads(r.read())


def _alive(srv) -> None:
    """Raise once the server stopped (its ``stop()``, which the caller
    runs in a ``finally``, then raises the render loop's error)."""
    if not srv.running:
        raise RuntimeError("the viewer stopped while the probe waited for "
                           "frames")


def warm_up(srv, timeout_s: float = 1200.0) -> float:
    """Wait until the server reports ``WARM_FRAMES`` frames; returns the
    seconds it took."""
    base = f"http://127.0.0.1:{srv.port}"
    t0 = time.time()
    while _stats(base).get("frames", 0) < WARM_FRAMES:
        _alive(srv)
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"no {WARM_FRAMES} frames in {timeout_s} s")
        time.sleep(0.5)
    return time.time() - t0


def run_trials(srv, trials: int, log=None) -> dict:
    """The script's trials against a started server: {"post_ms",
    "first_after_ms", "guaranteed_ms"}, a value a trial."""
    base = f"http://127.0.0.1:{srv.port}"
    post, first_after, guaranteed = [], [], []
    data = json.dumps({"mouse_dx": 3.0}).encode()
    for i in range(trials):
        s0 = _stats(base)["frames"]
        t0 = time.time()
        req = urllib.request.Request(base + "/input", data=data,
                                     method="POST")
        urllib.request.urlopen(req, timeout=60).read()
        t_post = time.time()
        fa = None
        while True:
            s = _stats(base)["frames"]
            if fa is None and s > s0:
                fa = time.time() - t0
            if s >= s0 + 2:
                guaranteed.append(1e3 * (time.time() - t0))
                first_after.append(1e3 * fa)
                break
            _alive(srv)
            time.sleep(POLL_S)
        post.append(1e3 * (t_post - t0))
        if log is not None:
            log(f"trial {i}: post {post[-1]:.1f} ms, first-after "
                f"{first_after[-1]:.0f} ms, guaranteed "
                f"{guaranteed[-1]:.0f} ms")
    return dict(post_ms=post, first_after_ms=first_after,
                guaranteed_ms=guaranteed)


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card, or None
    where it is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def main(argv=None) -> dict:
    from rvgrt_tpu_torch.driver import cli as cli_mod
    from rvgrt_tpu_torch.driver.engine import Engine
    from rvgrt_tpu_torch.driver.viewer import ViewerServer
    from rvgrt_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"device={dev} ({name})", flush=True)
    ecfg = (cli_mod.tiny_config() if args.config == "tiny"
            else cli_mod.CONFIGS[args.config]())
    t0 = time.time()
    eng = Engine(ecfg, include_gi=not args.no_gi, verbose=False,
                 device=dev)
    cli_mod.spawn_above_terrain(eng)
    build_s = time.time() - t0
    print(f"engine ready {build_s:.1f}s", flush=True)

    srv = ViewerServer(eng, port=0, max_fps=1000).start()
    try:
        warm_s = warm_up(srv)
        frame_ms = _stats(f"http://127.0.0.1:{srv.port}")["frame_ms"]
        print(f"warm after {warm_s:.1f}s; frame_ms={frame_ms}", flush=True)
        res = run_trials(srv, args.trials,
                         log=lambda s: print(s, flush=True))
        frame_ms = srv.last_frame_ms
        frames = srv.frame_count
    finally:
        srv.stop()
    fa = np.array(res["first_after_ms"])
    ga = np.array(res["guaranteed_ms"])
    print(f"\nconfig={args.config} gi={not args.no_gi} trials={args.trials}")
    print(f"first-after : median {np.median(fa):.0f} ms  p90 "
          f"{np.percentile(fa, 90):.0f} ms")
    print(f"guaranteed  : median {np.median(ga):.0f} ms  p90 "
          f"{np.percentile(ga, 90):.0f} ms")
    r = ecfg.render
    report = dict(
        tool="probe_r31_latency", device=name,
        card=card_line() if cuda else None, config=args.config,
        gi=not args.no_gi, trials=args.trials,
        world=f"{ecfg.world.size_x}x{ecfg.world.size_y}x"
              f"{ecfg.world.size_z}", render=f"{r.width}x{r.height}",
        poll_ms=1e3 * POLL_S, build_s=build_s, warm_s=warm_s,
        first_after_ms=dict(median=float(np.median(fa)),
                            p90=float(np.percentile(fa, 90))),
        guaranteed_ms=dict(median=float(np.median(ga)),
                           p90=float(np.percentile(ga, 90))),
        post_ms=dict(median=float(np.median(res["post_ms"])),
                     p90=float(np.percentile(res["post_ms"], 90))),
        frame_ms=frame_ms, frames=frames, trials_ms=res)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
