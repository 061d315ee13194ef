"""K3: the SDF min-plus distance pass (``csrc/sdf_kernels.cu``).

Replaces ``rvgrt_tpu/ops/sdf_kernels.py::minconv_pass_pallas``.  One pass
along ``axis`` of a uint8 (Z, Y, X) distance volume:

    out = min(cap, isqrt(min over off in [0, cap] of
                         min(d[i - off], d[i + off])^2 + off^2))

``minconv_pass`` launches the CUDA kernel for a CUDA tensor and runs the
plain PyTorch version (``minconv_pass_plain``, the counterpart of
``rvgrt_tpu/world/sdf.py::_minconv_pass``) for a CPU tensor.  The two pad
differently (255 in the kernel, 2 cap^2 + 1 on the squares here) and give
the same bytes.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

launches = 0


def minconv_pass_plain(prev_dist: torch.Tensor, axis: int,
                       cap: int) -> torch.Tensor:
    """min over off in [-cap, cap] of prev[i+off]^2 + off^2 -> floor(sqrt),
    capped (``computeDistY``/``computeDistZ``, ``CoarseArray.cu:79-152``);
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
    # floor(sqrt(n)) with integer correction (approximate-sqrt-safe)
    dist = torch.sqrt(best.to(torch.float32)).to(torch.int32)
    dist = torch.where(dist * dist > best, dist - 1, dist)
    dist = torch.where((dist + 1) * (dist + 1) <= best, dist + 1, dist)
    return torch.clamp_max(dist, cap).to(torch.uint8)


def minconv_pass(prev_dist: torch.Tensor, axis: int, cap: int) -> torch.Tensor:
    """One min-plus pass along ``axis`` (0 or 1) of a (Z, Y, X) volume;
    uint8 in, uint8 out."""
    if prev_dist.device.type == "cpu":
        return minconv_pass_plain(prev_dist, axis, cap)
    return minconv_pass_cuda(prev_dist, axis, cap)


def minconv_pass_cuda(prev_dist: torch.Tensor, axis: int,
                      cap: int) -> torch.Tensor:
    """The CUDA kernel; raises for anything it does not take."""
    from rvgrt_tpu_torch.ops import _lib

    global launches
    if prev_dist.device.type != "cuda":
        raise ValueError(f"minconv_pass_cuda: tensor on {prev_dist.device}")
    if prev_dist.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"minconv_pass_cuda: shape {tuple(prev_dist.shape)}"
                         f", axis {axis}")
    if not 0 < cap < 256:
        raise ValueError(f"minconv_pass_cuda: cap {cap}")
    d = prev_dist
    _lib.require(d, "prev_dist", torch.uint8, d.device)
    z, y, x = d.shape
    outer, n, inner = (z, y, x) if axis == 1 else (1, z, y * x)
    out = torch.empty_like(d)
    fn = _lib.library().rvgrt_minconv_mid
    launches += 1
    _lib.check(fn(d.data_ptr(), out.data_ptr(), outer, n, inner, cap,
                  _lib.stream_ptr(d.device)), "minconv_pass_cuda")
    return out
