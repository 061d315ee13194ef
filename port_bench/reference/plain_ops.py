"""The plain versions of the port's three CUDA kernels that a frame and a
world build run: the tracer's superstep loop (K1), the history warp (K2)
and the SDF min-plus pass (K3).

Frozen copies of ``superstep_plain`` / ``trace_plain``,
``warp_packed_bilinear_plain`` and ``min_squares_plain`` / ``isqrt`` /
``minconv_pass_plain``; the module-level names the copied call sites use
(``trace_supersteps``, ``warp_packed_bilinear``, ``minconv_pass``) are the
plain functions themselves, on every device.

One departure, which changes no result: ``trace_plain`` reads the live flag
back every ``CHECK_EVERY`` batches instead of every batch, since a retired
lane is left as it is by every later superstep.  The supersteps it returns
are counted on the device, batch by batch, while a lane is live, as the
per-batch loop counts them.
"""

from __future__ import annotations

import torch

from . import u32

#: batches of ``steps_per_check`` supersteps between two reads of the live
#: flag (each read waits for the device)
CHECK_EVERY = 16


def superstep_plain(cfg, rcfg, table, dirs, s, sky_y=None, z_edges=None):
    """One whole superstep: pregather, the clamped gather, update (under
    ``rcfg.slim_carry`` with tMax recomputed and not stored).  Returns the
    next state dict (``s`` is not modified)."""
    from . import wavefront as wf

    pre = wf._superstep_pregather(cfg, rcfg, dirs, s, sky_y=sky_y,
                                  z_edges=z_edges)
    word = table[pre["widx"].long()]
    if rcfg.slim_carry:
        return wf._superstep_update(cfg, rcfg, dirs, s, pre, word,
                                    tm=wf.slim_tmax(s, dirs),
                                    carry_tm=False, z_edges=z_edges)
    return wf._superstep_update(cfg, rcfg, dirs, s, pre, word,
                                z_edges=z_edges)


def step_cap(rcfg) -> int:
    """A lane's superstep budget: ``max_supersteps`` rounded up to whole
    batches of ``steps_per_check``."""
    k = max(rcfg.steps_per_check, 1)
    return max(-(-rcfg.max_supersteps // k) * k, 0)


def trace_plain(cfg, rcfg, table, dirs, s, sky_y=None,
                z_edges=None) -> torch.Tensor:
    """The whole trace, in place on ``s``: batches of ``steps_per_check``
    supersteps while a lane is live and fewer than ``max_supersteps`` ran.
    Returns the supersteps run, a 0-d int32 tensor on ``s``'s device."""
    from . import wavefront as wf

    k = max(rcfg.steps_per_check, 1)
    cap = step_cap(rcfg)
    dev = s["flags"].device
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = 0
    while done < cap:
        for _ in range(CHECK_EVERY):
            if done >= cap:
                break
            live = (wf._get(s["flags"], wf._PH_SH, wf._PH_W)
                    < wf.PHASE_MISS).any()
            steps = steps + live.to(torch.int32) * k
            for _ in range(k):
                s.update(superstep_plain(cfg, rcfg, table, dirs, s,
                                         sky_y=sky_y, z_edges=z_edges))
            done += k
        if not wf.any_live(s["flags"]):
            break
    return steps


trace_supersteps = trace_plain


def _unpack4(word):
    """u32 RGBN -> 4 f32 planes (r, g, b in [0,1], n in [0,1]-of-max)."""
    f = 1.0 / 255.0
    return ((word & 0xFF).to(torch.float32) * f,
            (u32.lsr(word, 8) & 0xFF).to(torch.float32) * f,
            (u32.lsr(word, 16) & 0xFF).to(torch.float32) * f,
            (u32.lsr(word, 24) & 0xFF).to(torch.float32) * f)


def warp_packed_bilinear_plain(packed: torch.Tensor, xs: torch.Tensor,
                               ys: torch.Tensor):
    """Exact 4-tap bilinear gather of the packed u32 RGBN history at f32
    source coordinates, the +1 taps clamped to the edge.  Returns ``(planes,
    overflow)``: (4, OH, W) f32 and a 0 int32 count."""
    hh, hw = packed.shape
    x0 = torch.floor(xs).to(torch.int32)
    y0 = torch.floor(ys).to(torch.int32)
    x1 = torch.clamp_max(x0 + 1, hw - 1)
    y1 = torch.clamp_max(y0 + 1, hh - 1)
    fx = (xs - x0.to(torch.float32))[None]
    fy = (ys - y0.to(torch.float32))[None]

    def tap(yi, xi):
        return torch.stack(_unpack4(packed[yi.long(), xi.long()]))

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x1) * fx * (1 - fy)
           + tap(y1, x0) * (1 - fx) * fy + tap(y1, x1) * fx * fy)
    return out, torch.zeros((), dtype=torch.int32, device=packed.device)


warp_packed_bilinear = warp_packed_bilinear_plain


def min_squares_plain(prev_dist: torch.Tensor, axis: int,
                      cap: int) -> torch.Tensor:
    """min over off in [-cap, cap] of prev[i+off]^2 + off^2, int32;
    out-of-bounds neighbours lose through +inf padding."""
    sq = prev_dist.to(torch.int32)
    sq = sq * sq
    n = sq.shape[axis]
    shape = list(sq.shape)
    shape[axis] = n + 2 * cap
    inf = 2 * cap * cap + 1  # larger than any reachable candidate
    padded = torch.full(shape, inf, dtype=torch.int32, device=sq.device)
    padded.narrow(axis, cap, n).copy_(sq)
    best = sq
    for off in range(1, cap + 1):
        lo = padded.narrow(axis, cap - off, n)
        hi = padded.narrow(axis, cap + off, n)
        best = torch.minimum(best, torch.minimum(lo, hi) + off * off)
    return best


def isqrt(a: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(a)) of int32 ``a`` >= 0, with integer correction."""
    d = torch.sqrt(a.to(torch.float32)).to(torch.int32)
    d = torch.where(d * d > a, d - 1, d)
    return torch.where((d + 1) * (d + 1) <= a, d + 1, d)


def minconv_pass_plain(prev_dist: torch.Tensor, axis: int,
                       cap: int) -> torch.Tensor:
    """One min-plus pass along ``axis`` (0 or 1) of a (Z, Y, X) uint8
    volume: ``min_squares_plain`` -> floor(sqrt), capped, uint8."""
    best = min_squares_plain(prev_dist, axis, cap)
    return torch.clamp_max(isqrt(best), cap).to(torch.uint8)


minconv_pass = minconv_pass_plain
