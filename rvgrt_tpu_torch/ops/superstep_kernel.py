"""K1: one tracer superstep, gather included (``csrc/superstep_kernel.cu``).

Replaces ``rvgrt_tpu/ops/superstep_kernel.py::fused_superstep``, the Pallas
kernel that applied ``wavefront._superstep_update`` after an XLA gather.
The CUDA kernel runs one thread per lane and does the pregather index, the
clamped gather of the combined table and the update in one launch, updating
the 11 state arrays in place.

``fused_superstep`` launches the kernel when the table lies on a CUDA
device and runs ``superstep_plain`` (the port's ``_superstep_pregather`` +
clamped gather + ``_superstep_update``) when it lies on the CPU.  There is
no fallback: a CUDA tensor the kernel does not take raises.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

launches = 0


def superstep_plain(cfg, rcfg, table, dirs, s, sky_y=None):
    """One whole superstep in plain PyTorch: pregather, the clamped gather,
    update.  Returns the next state dict (``s`` is not modified)."""
    from rvgrt_tpu_torch.trace import wavefront as wf

    pre = wf._superstep_pregather(cfg, rcfg, dirs, s, sky_y=sky_y)
    word = table[pre["widx"].long()]
    return wf._superstep_update(cfg, rcfg, dirs, s, pre, word)


def fused_superstep(cfg, rcfg, table, dirs, s, sky_y=None, live=None):
    """Advance the state dict ``s`` by one superstep, in place.

    ``dirs`` = (dx, dy, dz, ddx, ddy, ddz, stx, sty, stz) per-lane
    invariants; ``s`` holds ``wavefront.STATE_KEYS``; ``sky_y`` an optional
    0-d float32 tensor.  ``live``: optional (1,) int32 tensor, set to 1 when
    a lane is still marching after this step (left alone otherwise)."""
    if table.device.type == "cpu":
        from rvgrt_tpu_torch.trace import wavefront as wf

        s.update(superstep_plain(cfg, rcfg, table, dirs, s, sky_y=sky_y))
        if live is not None and wf.any_live(s["flags"]):
            live.fill_(1)
        return
    _launch(cfg, rcfg, table, dirs, s, sky_y, live)


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


def _launch(cfg, rcfg, table, dirs, s, sky_y, live):
    from rvgrt_tpu_torch.ops import _lib
    from rvgrt_tpu_torch.trace.wavefront import STATE_KEYS

    global launches
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"fused_superstep: table on {dev}")
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
    live_ptr = None
    if live is not None:
        _lib.require(live, "live", i32, dev, (1,))
        live_ptr = live.data_ptr()
    fn = _lib.library().rvgrt_superstep
    launches += 1
    _lib.check(fn(_params(cfg, rcfg), table.data_ptr(), sky_ptr,
                  *(s[k].data_ptr() for k in STATE_KEYS),
                  *(a.data_ptr() for a in dirs), live_ptr, n,
                  _lib.stream_ptr(dev)), "fused_superstep")
