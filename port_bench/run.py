"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It measures ``rvgrt_tpu_torch`` on one NVIDIA card (``drive.py``: set-up,
the window of ``--seconds``, with ``--trace 1`` the profiled sub-window),
holds what the window produced against the plain reference (``check.py``),
and prints as its last stdout line one JSON object: ``correct``,
``attempted`` (the window's frames), ``failed`` (1 where the check
failed, else 0), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones, each from its reader in ``metrics/``), ``device``,
with ``--trace 1`` ``breakdown``, then ``card`` (the card's name and power
limit) and last ``checked``, each number compared beside its limit.  A run
that built the kernels prints its set-up on a line of its own before it.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), and where JAX or the JAX
package has been loaded.  Every cache it or the port writes is at a fixed
place inside the checkout: the kernels in ``rvgrt_tpu_torch/_build/``, the
compilers' caches in ``.pb_cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".pb_cache"
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = str(CACHE / _dir)

#: top-level module names that may not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "rvgrt_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``rvgrt_tpu_torch`` is neither)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def card_info() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def metric_values(cell, rec, trace: bool) -> dict:
    """The cell's metrics for this kind of run, each from its reader; a
    reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell.metrics(trace):
        v = cell.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def stage_line(trace: dict) -> str:
    """The sub-window's top-level spans (``rec.trace["stages"]``), a frame:
    launches, device ms and idle ms of each."""
    from port_bench import stages

    st = trace.get("stages") or {}
    n = trace["frames"]
    parts = [f"{k} {r['launches'] / n:.1f} / {r['device_ms'] / n:.3f} / "
             f"{r['idle_ms'] / n:.3f}"
             for k in ("frame", *stages.TOP)
             if (r := st.get("stages", {}).get(k))]
    return ("sub-window stages, a frame (launches / device ms / idle ms): "
            + ("; ".join(parts) or "none"))


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            max_frames=None, t_start: float = T_START):
    """Set-up, window, sub-window and check of ``cell`` on ``device``.
    Returns (the run, its numbers compared, the peak device memory)."""
    import torch

    from port_bench import check, drive

    run = drive.PortRun(cell, seed, device, log=log)
    run.setup(t_start)
    log(f"set-up {run.rec.setup_s:.2f} s (world build {run.rec.build_s:.2f}"
        f" s); window of {seconds} s")
    run.window(seconds, max_frames=max_frames)
    if trace:
        run.traced()
    cuda = run.dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.dev) if cuda else 0
    # the port's state goes, but for what the check compares
    world, kept, poses = run.world, run.kept, run.poses
    run.loop = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums = check.compare(cell, world, kept, poses, run.rates[:run.n_warm],
                         run.dev, log=log)
    log(f"check {time.perf_counter() - t0:.2f} s")
    return run, nums, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import rvgrt_tpu_torch  # noqa: F401  (the system under test)
    import torch

    from port_bench import check, spec

    cell = spec.Cell(spec.load_benchmark(), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload}: needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count()} available. No result.")
        return 2
    trace = bool(args.trace)
    run, nums, peak = measure(cell, args.seed, args.seconds, trace)
    rec = run.rec
    metrics = metric_values(cell, rec, trace)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in the measured process: {', '.join(bad)}. No result.")
        return 3
    limits = cell.limits
    correct = check.verdict(nums, limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(rec.intervals_ms),
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device}
    if trace and rec.trace and rec.trace.get("span_s"):
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["span_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
        log(f"sub-window: frames {rec.trace['variants']}, "
            f"K1 {rec.trace['k1_records']}/{rec.trace['k1_launched']}")
        log(stage_line(rec.trace))
    out["card"] = card_info()
    out["checked"] = {k: {"value": nums[k], "limit": limits[k]}
                      for k in check.NUMBERS}
    if rec.kernel_build_s is not None:
        print(json.dumps({"first_run_of_checkout": True,
                          "setup_s": rec.setup_s,
                          "kernel_build_s": rec.kernel_build_s}), flush=True)
    log(f"card: {out['card']}")
    for k in check.NUMBERS:
        log(f"{k} {nums[k]!r} limit {limits[k]!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
