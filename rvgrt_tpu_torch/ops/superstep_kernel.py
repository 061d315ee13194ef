"""K1: the tracer's whole superstep loop in one launch
(``csrc/superstep_kernel.cu``).

Replaces ``rvgrt_tpu/ops/superstep_kernel.py::fused_superstep`` (:82), the
Pallas kernel that applied ``wavefront._superstep_update`` after an XLA
gather, once per superstep of the JAX tracer's device-side while loop.
The CUDA kernel runs that loop itself: persistent threads take rays from a
device-side queue (one atomic counter), each lane runs its ray's supersteps
(pregather index, clamped table gather, update) in registers until the ray
retires or reaches its superstep budget, writes back the state words that
changed, and takes the next ray.  One launch per trace, and no host read:
the supersteps the trace ran come back as a 0-d device tensor.

What bounds it on the H100 is bytes: the state and direction words each
lane's path reads, read once, and its changed state words written once (the
distinct table words it gathers are few and stay in L2).  The design keeps
the ray state in registers for the whole trace instead of reloading and
storing it every superstep, skips the cell and tMax words of a ray fetched
in SPHERE (dead until its turn to DDA sets them), and leaves the host out of
the loop.

``trace_supersteps`` is the main path's entry: it launches the kernel when
the table lies on a CUDA device and runs ``trace_plain`` (the host loop of
``superstep_plain``, the plain version of the whole trace) when it lies on
the CPU.  ``fused_superstep`` is the same kernel with a budget of one
superstep (the per-superstep check).  ``rcfg.slim_carry`` picks the
kernel's slim variant, which recomputes tMax from the DDA-entry position
and the cell at every superstep and neither loads nor stores the tMax
words (``wavefront.recompute_tmax``); ``z_edges`` (the volume-sharded
mode's (is_first, is_last) host bools) picks its ZEDGES variant, which
retires a ray leaving the slab through an interior z face as
``PHASE_EXIT_LO`` / ``HI``.  The four instantiations (carried or slim,
with or without ``z_edges``) share every other line.  There is no
fallback: a CUDA tensor the kernel does not take raises.  ``launches``
counts kernel launches, and ``slim_launches``, ``zedges_launches`` and
``zedges_slim_launches`` those of three of the instantiations among them
(the carried one without ``z_edges`` has the rest).
"""

from __future__ import annotations

import functools

import torch

launches = 0
slim_launches = 0
zedges_launches = 0
zedges_slim_launches = 0


def superstep_plain(cfg, rcfg, table, dirs, s, sky_y=None, z_edges=None):
    """One whole superstep in plain PyTorch: pregather, the clamped gather,
    update (under ``rcfg.slim_carry`` with tMax recomputed from the state
    and not stored).  Returns the next state dict (``s`` is not
    modified)."""
    from rvgrt_tpu_torch.trace import wavefront as wf

    pre = wf._superstep_pregather(cfg, rcfg, dirs, s, sky_y=sky_y,
                                  z_edges=z_edges)
    word = table[pre["widx"].long()]
    if rcfg.slim_carry:
        return wf._superstep_update(cfg, rcfg, dirs, s, pre, word,
                                    tm=wf.slim_tmax(s, dirs),
                                    carry_tm=False, z_edges=z_edges)
    return wf._superstep_update(cfg, rcfg, dirs, s, pre, word,
                                z_edges=z_edges)


def trace_plain(cfg, rcfg, table, dirs, s, sky_y=None,
                z_edges=None) -> torch.Tensor:
    """The whole trace in plain PyTorch, in place on ``s``: batches of
    ``steps_per_check`` supersteps while a lane is live and fewer than
    ``max_supersteps`` ran (the JAX tracer's while loop).  Returns the
    supersteps run, a 0-d int32 tensor on ``s``'s device."""
    from rvgrt_tpu_torch.trace import wavefront as wf

    k = max(rcfg.steps_per_check, 1)
    step = 0
    while step < rcfg.max_supersteps and wf.any_live(s["flags"]):
        for _ in range(k):
            s.update(superstep_plain(cfg, rcfg, table, dirs, s, sky_y=sky_y,
                                     z_edges=z_edges))
        step += k
    return torch.tensor(step, dtype=torch.int32, device=s["flags"].device)


def step_cap(rcfg) -> int:
    """A lane's superstep budget in ``trace_plain``'s loop:
    ``max_supersteps`` rounded up to whole batches of ``steps_per_check``."""
    k = max(rcfg.steps_per_check, 1)
    return max(-(-rcfg.max_supersteps // k) * k, 0)


def trace_supersteps(cfg, rcfg, table, dirs, s, sky_y=None,
                     z_edges=None) -> torch.Tensor:
    """Run the whole trace on the state dict ``s``, in place; return the
    supersteps it ran (0-d int32 tensor on the table's device, the same
    value as ``trace_plain``'s).

    ``dirs`` = (dx, dy, dz, ddx, ddy, ddz, stx, sty, stz) per-lane
    invariants; ``s`` holds ``wavefront.STATE_KEYS``; ``sky_y`` an optional
    0-d float32 tensor; ``z_edges`` None or the (is_first, is_last) host
    bools of the volume-sharded mode.  On a CUDA table: one kernel launch,
    no host read."""
    if table.device.type == "cpu":
        return trace_plain(cfg, rcfg, table, dirs, s, sky_y=sky_y,
                           z_edges=z_edges)
    return _launch(cfg, rcfg, table, dirs, s, sky_y, z_edges, step_cap(rcfg),
                   max(rcfg.steps_per_check, 1), "trace_supersteps")


def fused_superstep(cfg, rcfg, table, dirs, s, sky_y=None,
                    z_edges=None) -> None:
    """Advance the state dict ``s`` by one superstep, in place: the kernel
    with a budget of one superstep per lane on a CUDA table,
    ``superstep_plain`` on a CPU one."""
    if table.device.type == "cpu":
        s.update(superstep_plain(cfg, rcfg, table, dirs, s, sky_y=sky_y,
                                 z_edges=z_edges))
        return
    _launch(cfg, rcfg, table, dirs, s, sky_y, z_edges, 1, 1,
            "fused_superstep")


@functools.lru_cache(maxsize=16)
def _params(cfg, rcfg):
    from rvgrt_tpu_torch.ops import _lib

    cfg.validate()
    c = cfg.sdf_coarseness
    assert c & (c - 1) == 0, c
    quarter = cfg.sdf_num_cells // 4
    probe = rcfg.sdf_probe_interval
    assert probe & (probe - 1) == 0, probe
    vals = dict(
        size_x=cfg.size_x, size_y=cfg.size_y, size_z=cfg.size_z,
        shift_x=cfg.shift_x, shift_y=cfg.shift_y,
        sdf_shift=c.bit_length() - 1, sdf_coarseness=c,
        sdf_size_x=cfg.sdf_size_x, sdf_size_y=cfg.sdf_size_y,
        sdf_size_z=cfg.sdf_size_z, bits_len=cfg.num_words,
        sdf_quarter=quarter, qshift=quarter.bit_length() - 1,
        table_len=cfg.num_words + quarter, probe_mask=probe - 1,
        max_sphere_steps=rcfg.max_sphere_steps,
        max_major_iterations=rcfg.max_major_iterations,
        max_dda_steps=rcfg.max_dda_steps, jump_min_dist=rcfg.jump_min_dist,
        dda_substeps=rcfg.dda_substeps)
    return _lib.trace_params_type()(**vals)


def _launch(cfg, rcfg, table, dirs, s, sky_y, z_edges, cap: int,
            check_every: int, what: str) -> torch.Tensor:
    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.trace.wavefront import STATE_KEYS

    global launches, slim_launches, zedges_launches, zedges_slim_launches
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: table on {dev}")
    _lib.require(table, "table", torch.int32, dev,
                 (cfg.num_words + cfg.sdf_num_cells // 4,))
    n = s["flags"].numel()
    f32, i32 = torch.float32, torch.int32
    kinds = dict(px=f32, py=f32, pz=f32, ix=i32, iy=i32, iz=i32, flags=i32,
                 its=i32, tmx=f32, tmy=f32, tmz=f32)
    for k in STATE_KEYS:
        _lib.require(s[k], k, kinds[k], dev, (n,))
    for name, a, dt in zip(("dx", "dy", "dz", "ddx", "ddy", "ddz", "stx",
                            "sty", "stz"), dirs, (f32,) * 6 + (i32,) * 3):
        _lib.require(a, name, dt, dev, (n,))
    sky_ptr = None
    if sky_y is not None:
        _lib.require(sky_y, "sky_y", f32, dev, ())
        sky_ptr = sky_y.data_ptr()
    # [ray counter, steps], zeroed on the stream by the C entry point
    scratch = torch.empty(2, dtype=i32, device=dev)
    fn = _lib.library().rvgrt_trace
    slim, zedges = bool(rcfg.slim_carry), z_edges is not None
    first, last = (bool(z_edges[0]), bool(z_edges[1])) if zedges \
        else (False, False)
    if n > 0 and cap > 0:
        launches += 1
        if slim and zedges:
            zedges_slim_launches += 1
        elif zedges:
            zedges_launches += 1
        elif slim:
            slim_launches += 1
    _lib.check(fn(_params(cfg, rcfg), table.data_ptr(), sky_ptr,
                  *(s[k].data_ptr() for k in STATE_KEYS),
                  *(a.data_ptr() for a in dirs), n, cap, check_every,
                  int(slim), int(zedges), int(first), int(last),
                  scratch.data_ptr(), _lib.stream_ptr(dev)), what)
    return scratch[1]
