"""Small vector-math helpers over "struct of arrays" float3s.

A float3 here is a tuple ``(x, y, z)`` of same-shaped float32 tensors, the
layout ``rvgrt_tpu/core/vecmath.py`` uses.  Constant vectors made by ``v3``
are 0-d float32 CPU tensors: they combine with tensors on any device, and
arithmetic between two constants stays in float32 as it does in JAX (a
Python float would compute in double).  Matrices are (4, 4) float32 tensors
in glm column-major convention, ``m[col][row]`` (``cumath.cuh:47-54``).
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def f32(x) -> torch.Tensor:
    """A float32 scalar constant (0-d CPU tensor) or a tensor cast to f32."""
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.tensor(x, dtype=_F32)


def v3(x, y, z):
    return (f32(x), f32(y), f32(z))


def splat(v, like: torch.Tensor):
    """Constant float3 broadcast to ``like``'s shape and device."""
    return tuple(torch.full(like.shape, float(c), dtype=_F32,
                            device=like.device) for c in v)


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    inv = 1.0 / length(a)
    return scale(a, inv)


def lerp(a, b, t):
    """a + (b - a) * t, written out: ``torch.lerp`` may fuse into an FMA."""
    return (a[0] + (b[0] - a[0]) * t,
            a[1] + (b[1] - a[1]) * t,
            a[2] + (b[2] - a[2]) * t)


def reflect(d, n):
    """r = d - 2*dot(d,n)*n (cumath.cuh reflect)."""
    k = 2.0 * dot(d, n)
    return sub(d, scale(n, k))


def where(mask, a, b):
    return (torch.where(mask, a[0], b[0]),
            torch.where(mask, a[1], b[1]),
            torch.where(mask, a[2], b[2]))


def mat_mul_vec4(m, v4):
    """glm column-major m @ v: res_r = sum_c m[c][r] * v[c] (cumath.cuh:47-54).

    ``m`` is (4,4) with m[col, row]; ``v4`` a tuple of 4 tensors.
    Returns a tuple of 4 tensors.
    """
    return tuple(
        m[0, r] * v4[0] + m[1, r] * v4[1] + m[2, r] * v4[2] + m[3, r] * v4[3]
        for r in range(4)
    )
