"""The GI composite's CUDA kernels (``ops/gi_kernels.py``,
``csrc/gi_kernels.cu``) and their routing in ``render/pipeline.py``.

On the CPU: the divisor rule both paths share; the kernel source is in
the build and its parameter struct and C entry points agree with the
wrapper's ctypes declarations, parsed from the sources; the ``_cuda``
entries refuse CPU tensors and wrong dtypes; and ``gather_gi_image`` /
``gi_composite`` on CPU tensors launch nothing and give the plain path's
outputs, bit for bit against the benchmark's frozen copy of it
(``port_bench/reference``) on a 64^3 world.

On a card (``cuda`` marker; skipped without one): both kernels against the
plain path on the card, bit for bit, at the checker, quarter and full
grids of a 256x160 frame, at divisors 16, 8 and 1, with the fused cone
table on and off, the composite with and without its addend and the
upsample alone through ``gather_gi_image``; two launches a composite, and
none of them a host read.  The file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gi_kernels.py -m cuda -q
"""

from __future__ import annotations

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from port_bench.reference import pipeline as frozen
from rvgrt_tpu_torch import config as tcfg
from rvgrt_tpu_torch.driver import engine
from rvgrt_tpu_torch.ops import _lib, gi_kernels
from rvgrt_tpu_torch.render import pipeline
from rvgrt_tpu_torch.scene.camera import Camera

BENCH = dict(dda_substeps=6, sdf_probe_interval=16, dist_bias=4.0,
             steps_per_check=1, prepass_divisor=8, shadow_site_divisor=4)


def _ecfg(width, height, **render):
    return dataclasses.replace(
        tcfg.EngineConfig(
            world=tcfg.WorldConfig().with_cube(6),
            render=dataclasses.replace(tcfg.RenderConfig(), width=width,
                                       height=height, **BENCH, **render),
            gi_init_mode="heightfield"),
        lighting=dataclasses.replace(tcfg.LightingConfig(),
                                     soft_shadows=True, soft_shadow_stride=2))


def _camera(dev):
    fwd = np.array([0.25, -0.18, -1.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right).astype(np.float32)
    vp = np.eye(4, dtype=np.float32)
    vp[0, 0], vp[1, 1], vp[2, 3], vp[3, 2] = 1.1, 1.7, -1.0, -0.2
    cam = Camera(pos=np.array([30.0, 44.0, 60.0], np.float32), forward=fwd,
                 right=right, up=up)
    return engine.camera_arrays(cam, vp, vp, (0.0021, -0.0034), 0.25,
                                device=dev)


#: the rate cuts of a frame: render_frame's keywords
RATES = {"checker": dict(checker_parity=1), "quarter": dict(quarter_phase=3),
         "full": {}}


def _base(w, ecfg, rate, dev):
    """A GI-less base frame and its G-buffer on the rate's grid."""
    return pipeline.render_frame(
        w.bits, w.sdf, w.gi, w.atlas, _camera(dev), ecfg, include_gi=False,
        sky_y=w.sky_y, table=w.trace_table, return_gbuffer=True,
        **RATES[rate])


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32).cpu()


# ---------------------------------------------------------------- CPU ----

@pytest.mark.parametrize("h, w, d, want", [
    (800, 640, 16, 16), (400, 640, 16, 16), (1080, 1920, 16, 8),
    (1080, 1920, 8, 8), (15, 40, 16, 1), (64, 48, 1, 1)])
def test_gi_divisor_halves_until_it_divides(h, w, d, want):
    assert pipeline.gi_divisor(h, w, d) == want


def _struct_fields(src: str, name: str):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (s.strip() for s in body.split(";"))):
        typ, names = decl.split(None, 1)
        fields += [(typ, n.strip()) for n in names.split(",")]
    return fields


@pytest.mark.parametrize("struct, source, want", [
    ("TraceParams", "superstep_kernel.cu",
     [("int", k) for k in _lib.TRACE_PARAMS]),
    ("GiParams", "gi_kernels.cu",
     [("int", k) for k in _lib.GI_INT_PARAMS]
     + [("float", k) for k in _lib.GI_FLOAT_PARAMS])])
def test_param_structs_match_the_sources(struct, source, want):
    """The ctypes structs the wrappers pass by value are the sources'
    structs, field for field and type for type."""
    assert source in _lib.SOURCES
    assert _struct_fields((_lib.CSRC / source).read_text(), struct) == want
    ctype = {"TraceParams": _lib.trace_params_type,
             "GiParams": _lib.gi_params_type}[struct]()
    py = {ctypes.c_int: "int", ctypes.c_float: "float"}
    assert [(py[t], k) for k, t in ctype._fields_] == want


class _Fn:
    """Stands in for a loaded C function: takes argtypes and restype."""


def _c_entry_points():
    """Every ``extern "C"`` function of the sources: name -> its parameter
    types as ctypes types."""
    kinds = {"TraceParams": _lib.trace_params_type(),
             "GiParams": _lib.gi_params_type(), "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}
    out = {}
    for src in _lib.SOURCES:
        text = (_lib.CSRC / src).read_text()
        for m in re.finditer(r'extern "C" [\w\s\*]+?\b(rvgrt_\w+)\(([^)]*)\)',
                             text):
            types = []
            for param in filter(None, (s.strip() for s in m.group(2)
                                       .split(","))):
                typ = param.rsplit(None, 1)[0].replace("const ", "")
                types.append(ctypes.c_void_p if "*" in param
                             else kinds[typ])
            out[m.group(1)] = types
    return out


def test_entry_points_match_their_declarations():
    """``_lib._declare`` gives each C entry point of every source its
    parameters in number and type (a wrong count would read past the
    arguments on the card)."""
    entries = _c_entry_points()
    assert {"rvgrt_gi_cone_march", "rvgrt_gi_upsample_composite"} <= set(
        entries)
    lib = type("Lib", (), {k: _Fn() for k in entries})()
    _lib._declare(lib)
    for name, types in entries.items():
        assert getattr(lib, name).argtypes == types, name


def _gb_cpu(h=16, w=16, dtype=torch.float32):
    z = torch.zeros(h, w, dtype=dtype)
    return pipeline.GBuffer(hit=torch.zeros(h, w, dtype=torch.bool), px=z,
                            py=z, pz=z, nx=z, ny=z, nz=z, t=z, albedo_r=z,
                            albedo_g=z, albedo_b=z, fog=z)


@pytest.mark.parametrize("case, match", [
    ("cpu", "expected CUDA"), ("f64_planes", "dtype torch.float64"),
    ("words_dtype", "words dtype")])
def test_cuda_entries_refuse(case, match):
    """The ``_cuda`` entries raise ``ValueError`` for CPU tensors and for
    dtypes the kernels do not take, before any launch."""
    ecfg = _ecfg(16, 16)
    cfg = ecfg.world
    gb = _gb_cpu(dtype=torch.float64 if case == "f64_planes"
                 else torch.float32)
    words = torch.zeros(cfg.gi_num_cells,
                        dtype=torch.int64 if case == "words_dtype"
                        else torch.int32)
    sdf = torch.zeros(cfg.sdf_num_cells, dtype=torch.uint8)
    n0 = gi_kernels.launches
    with pytest.raises(ValueError, match=match):
        gi_kernels.gather_gi_image_cuda(gb, words, sdf, cfg, ecfg.render,
                                        ecfg.lighting, 4, False)
    with pytest.raises(ValueError, match=match):
        gi_kernels.gi_composite_cuda(torch.zeros(16, 16, 3), gb, words, sdf,
                                     ecfg, 4, False)
    assert gi_kernels.launches == n0


@pytest.fixture(scope="module")
def cpu_case():
    ecfg = _ecfg(128, 80, gi_res_divisor=16)
    w = engine.build_world(ecfg, verbose=False, device="cpu")
    out, gb = _base(w, ecfg, "checker", "cpu")
    return ecfg, w, out, gb


@pytest.mark.parametrize("fused", [False, True], ids=["two_gathers",
                                                       "fused_cone"])
def test_cpu_path_is_the_plain_path(cpu_case, fused):
    """On CPU tensors the composite (with its addend) and the gather
    launch nothing and equal the frozen plain copy bit for bit: the GI
    at d = 16 on the 80x64 checker grid of a 64^3 world."""
    ecfg, w, out, gb = cpu_case
    ecfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, gi_fused_cone=fused))
    cfg, rcfg, lcfg = ecfg.world, ecfg.render, ecfg.lighting
    n0 = gi_kernels.launches
    got, add = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg,
                                     gi_occ=w.gi_occ, return_addend=True)
    planes = pipeline.gather_gi_image(gb, w.gi, w.sdf, cfg, rcfg, lcfg,
                                      gi_occ=w.gi_occ)
    assert gi_kernels.launches == n0
    want, want_add = frozen.gi_composite(out.color, gb, w.gi, w.sdf, ecfg,
                                         gi_occ=w.gi_occ, return_addend=True)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(add), _bits(want_add))
    assert float(add.abs().max()) > 0.0
    for g, f in zip(planes, frozen.gather_gi_image(gb, w.gi, w.sdf, cfg,
                                                   rcfg, lcfg,
                                                   gi_occ=w.gi_occ)):
        assert torch.equal(_bits(g), _bits(f))


# --------------------------------------------------------------- card ----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are CUDA C++")
    dev = torch.device("cuda")
    ecfg = _ecfg(256, 160)
    w = engine.build_world(ecfg, verbose=False, device=dev)
    return dev, ecfg, w, {rate: _base(w, ecfg, rate, dev) for rate in RATES}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["two_gathers",
                                                       "fused_cone"])
@pytest.mark.parametrize("d", [16, 8, 1])
@pytest.mark.parametrize("rate", list(RATES))
def test_kernels_match_the_plain_path(card, rate, d, fused):
    """The composite with and without its addend, and the upsample alone
    through ``gather_gi_image``, equal the plain path on the card bit for
    bit; a composite is two launches (the gather one at d = 1)."""
    dev, ecfg, w, bases = card
    ecfg = dataclasses.replace(ecfg, render=dataclasses.replace(
        ecfg.render, gi_res_divisor=d, gi_fused_cone=fused))
    cfg, rcfg, lcfg = ecfg.world, ecfg.render, ecfg.lighting
    out, gb = bases[rate]
    assert pipeline.gi_divisor(*gb.hit.shape, d) == d
    for addend in (False, True):
        n0 = gi_kernels.launches
        got = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg,
                                    return_addend=addend)
        assert gi_kernels.launches == n0 + 2
        want = pipeline.gi_composite_plain(out.color, gb, w.gi, w.sdf, ecfg,
                                           return_addend=addend)
        if addend:
            assert torch.equal(_bits(got[1]), _bits(want[1]))
            got, want = got[0], want[0]
        assert torch.equal(_bits(got), _bits(want)), \
            float((got - want).abs().max())
    n0 = gi_kernels.launches
    planes = pipeline.gather_gi_image(gb, w.gi, w.sdf, cfg, rcfg, lcfg)
    assert gi_kernels.launches == n0 + (2 if d > 1 else 1)
    want = pipeline.gather_gi_image_plain(gb, w.gi, w.sdf, cfg, rcfg, lcfg)
    for g, f in zip(planes, want):
        assert torch.equal(_bits(g), _bits(f)), float((g - f).abs().max())
    assert float(planes[0].max()) > 0.0


@pytest.mark.cuda
def test_composite_makes_no_host_read(card):
    """The composite on the card runs under
    ``set_sync_debug_mode("error")``: no host read (the plain path's phase
    tables were two blocking uploads)."""
    dev, ecfg, w, bases = card
    out, gb = bases["checker"]
    pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pipeline.gi_composite(out.color, gb, w.gi, w.sdf, ecfg,
                                    return_addend=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert got[0].shape == out.color.shape
