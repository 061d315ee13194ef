"""The GI composite's two CUDA kernels (``csrc/gi_kernels.cu``).

``render/pipeline.py::gather_gi_image`` and ``gi_composite`` take them for
CUDA tensors: ``gi_cone_march`` marches the 6 cones of every ``d``-th
G-buffer pixel in one launch, and ``gi_upsample_composite`` upsamples the
coarse radiance to every pixel in one more, writing the three planes
(``gather_gi_image_cuda``) or, given the base colour, the finished
composite (``gi_composite_cuda``).  For CPU tensors the pipeline runs its
plain path (``gather_gi_image_plain``, ``gi_composite_plain``), which the
kernels equal bit for bit on the card.  Nothing here reads back to the
host.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from rvgrt_tpu_torch.render import shading

_F32 = torch.float32

launches = 0

#: the upsample kernel's modes (``GiParams.mode``)
PLANES, COMPOSITE, COMPOSITE_ADDEND = 0, 1, 2


def _params(h: int, w: int, d: int, cfg, rcfg, lcfg, mode: int):
    """The kernels' ``GiParams``: every Python float enters as the f32
    torch rounds it to (ctypes' float conversion is the same rounding)."""
    from rvgrt_tpu_torch.ops import _lib

    return _lib.gi_params_type()(
        h=h, w=w, d=d, off=d // 2, hc=h // d, wc=w // d,
        steps=shading.max_cone_steps(lcfg),
        sdf_coarseness=cfg.sdf_coarseness, sdf_size_x=cfg.sdf_size_x,
        sdf_size_y=cfg.sdf_size_y, sdf_size_z=cfg.sdf_size_z,
        sdf_num_cells=cfg.sdf_num_cells, gi_coarseness=cfg.gi_coarseness,
        gi_size_x=cfg.gi_size_x, gi_size_y=cfg.gi_size_y,
        gi_size_z=cfg.gi_size_z, gi_num_cells=cfg.gi_num_cells, mode=mode,
        cur0=lcfg.gi_step_size * 2.0, step_size=lcfg.gi_step_size,
        max_distance=lcfg.gi_max_distance,
        tan_angle=math.tan(lcfg.cone_angle),
        inv_cones=1.0 / lcfg.num_cones, rel_thresh=rcfg.gi_depth_threshold,
        gi_strength=lcfg.gi_strength,
        ambient_strength=lcfg.ambient_strength,
        water_level=lcfg.water_level,
        **dict(zip(("sun_x", "sun_y", "sun_z"), lcfg.sun_dir)),
        sun_disc_cos=lcfg.sun_disc_cos,
        **dict(zip(("sun_r", "sun_g", "sun_b"), lcfg.sun_color)),
        **dict(zip(("hor_r", "hor_g", "hor_b"), lcfg.sky_horizon)),
        **dict(zip(("zen_r", "zen_g", "zen_b"), lcfg.sky_zenith)))


def _checked(items, dev):
    """The kernels' inputs, contiguous, each ``(tensor, name, dtype,
    shape)`` checked: every dtype first, then device and shape."""
    out = [t.contiguous() for t, _, _, _ in items]
    for t, (_, name, dtype, _) in zip(out, items):
        if t.dtype != dtype:
            raise ValueError(f"gi_kernels: {name} dtype {t.dtype}, "
                             f"expected {dtype}")
    for t, (_, name, _, shape) in zip(out, items):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"gi_kernels: {name} on {t.device}, expected "
                             f"CUDA ({dev})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"gi_kernels: {name} shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    return out


def _planes(g, names, shape):
    """The G-buffer planes a kernel reads, as ``_checked`` items."""
    return [(getattr(g, n), n, torch.bool if n == "hit" else _F32, shape)
            for n in names]


def _cone_march(g, words, sdf, cfg, d: int, fused: bool, p):
    """One launch of ``gi_cone_march``: (3, h / d, w / d) f32 radiance."""
    from rvgrt_tpu_torch.ops import _lib

    global launches
    h, w = g.hit.shape
    if d < 1 or h % d or w % d:
        raise ValueError(f"gi_kernels: divisor {d} for a ({h}, {w}) grid")
    if h * w >= 2 ** 31:
        raise ValueError(f"gi_kernels: ({h}, {w}) is past int32 indexing")
    dev = g.hit.device
    *planes, words, sdf = _checked(
        _planes(g, ("px", "py", "pz", "nx", "ny", "nz"), (h, w))
        + [(words, "words", torch.int32, (cfg.gi_num_cells,)),
           (sdf, "sdf", torch.uint8, (cfg.sdf_num_cells,))], dev)
    coarse = torch.empty((3, h // d, w // d), dtype=_F32, device=dev)
    launches += 1
    _lib.check(_lib.library().rvgrt_gi_cone_march(
        p, int(fused), *(t.data_ptr() for t in planes), sdf.data_ptr(),
        words.data_ptr(), coarse.data_ptr(), _lib.stream_ptr(dev)),
        "gi_cone_march")
    return coarse


def _upsample(coarse, g, p, color=None):
    """One launch of ``gi_upsample_composite``; ``p.mode`` says what it
    writes: (3, h, w) planes, or the (h, w, 3) composite (and addend)."""
    from rvgrt_tpu_torch.ops import _lib

    global launches
    dev = coarse.device
    h, w = g.hit.shape
    names = ["hit", "t", "nx", "ny", "nz"]
    items = _planes(g, names, (h, w))
    if p.mode != PLANES:
        items += _planes(g, ("py", "albedo_r", "albedo_g", "albedo_b",
                             "fog"), (h, w))
        items.append((color, "color", _F32, (h, w, 3)))
    ptrs = [t.data_ptr() for t in _checked(items, dev)]
    ptrs += [None] * (11 - len(ptrs))
    add = None
    if p.mode == PLANES:
        out = torch.empty((3, h, w), dtype=_F32, device=dev)
    else:
        out = torch.empty((h, w, 3), dtype=_F32, device=dev)
        if p.mode == COMPOSITE_ADDEND:
            add = torch.empty_like(out)
    launches += 1
    _lib.check(_lib.library().rvgrt_gi_upsample_composite(
        p, coarse.data_ptr(), *ptrs, out.data_ptr(),
        None if add is None else add.data_ptr(), _lib.stream_ptr(dev)),
        "gi_upsample_composite")
    return out, add


def gather_gi_image_cuda(res, words, sdf, cfg, rcfg, lcfg, d: int,
                         fused: bool):
    """``gather_gi_image`` on the card: (r, g, b) (h, w) f32 planes of the
    G-buffer ``res`` (its ``hit``, position, normal and ``t``), from the
    GI words or, ``fused``, the fused cone table ``words``; ``d`` the
    divisor ``pipeline.gi_divisor`` gives.  One launch at ``d == 1``, two
    otherwise.  Raises ``ValueError`` for anything the kernels do not
    take."""
    h, w = res.hit.shape
    p = _params(h, w, d, cfg, rcfg, lcfg, PLANES)
    coarse = _cone_march(res, words, sdf, cfg, d, fused, p)
    if d > 1:
        coarse, _ = _upsample(coarse, res, p)
    return coarse[0], coarse[1], coarse[2]


def gi_composite_cuda(color, gb, words, sdf, ecfg, d: int, fused: bool,
                      return_addend: bool = False):
    """``gi_composite`` on the card, in two launches: the (h, w, 3) colour
    with the indirect and ambient light added, and with ``return_addend``
    the added light too.  Arguments as ``gather_gi_image_cuda``'s."""
    cfg, rcfg, lcfg = ecfg.world, ecfg.render, ecfg.lighting
    h, w = gb.hit.shape
    p = _params(h, w, d, cfg, rcfg, lcfg,
                COMPOSITE_ADDEND if return_addend else COMPOSITE)
    coarse = _cone_march(gb, words, sdf, cfg, d, fused, p)
    out, add = _upsample(coarse, gb, p, color=color)
    return (out, add) if return_addend else out
