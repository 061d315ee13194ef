"""Build and load the port's CUDA kernels.

All kernels live in ``rvgrt_tpu_torch/csrc/*.cu`` and export a plain C
interface.  On first use this module compiles each source with ``nvcc`` for
``sm_90a`` (all sources at once, one process each), links them into one
shared library under ``rvgrt_tpu_torch/_build/`` named by a hash of the
sources and flags, and loads it with ``ctypes``.  No PyTorch header is
compiled and no ``ninja`` is needed.

Flags: ``-fmad=false`` keeps every float multiply and add separately
rounded, as the reference's elementwise graphs are - FMA contraction moves
results between graphs - and fast math is never used.

Nothing here runs at import time: the CPU tests import every module on a
host without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gather_kernels.cu", "lib.cu", "sdf_kernels.cu",
           "superstep_kernel.cu", "warp_kernels.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC")

#: K1's parameter struct, field for field as ``TraceParams`` in
#: ``csrc/superstep_kernel.cu``.
TRACE_PARAMS = ("size_x", "size_y", "size_z", "shift_x", "shift_y",
                "sdf_shift", "sdf_coarseness", "sdf_size_x", "sdf_size_y",
                "sdf_size_z", "bits_len", "sdf_quarter", "qshift",
                "table_len", "probe_mask", "max_sphere_steps",
                "max_major_iterations", "max_dda_steps", "jump_min_dist",
                "dda_substeps")

_lock = threading.Lock()
_lib = None
_trace_params_type = None
build_seconds = None  # wall time of this process's build, if it built


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path("/usr/local/cuda/bin/nvcc")
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the GPU machine")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, verbose: bool) -> None:
    import time

    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(f"[nvcc {src}]\n{out}", file=sys.stderr, flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        objs.append(str(obj))
    so_tmp = tmp / target.name
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                          str(so_tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(so_tmp, target)
    shutil.rmtree(tmp, ignore_errors=True)
    global build_seconds
    build_seconds = time.perf_counter() - t0


def trace_params_type():
    """The ctypes struct of K1's parameters (made on first use)."""
    global _trace_params_type
    if _trace_params_type is None:
        import ctypes

        class TraceParams(ctypes.Structure):
            _fields_ = [(k, ctypes.c_int) for k in TRACE_PARAMS]
        _trace_params_type = TraceParams
    return _trace_params_type


def _declare(lib) -> None:
    """Set every C entry point's signature, once, when the library loads."""
    import ctypes

    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "rvgrt_error_string": ([ci], ctypes.c_char_p),
        "rvgrt_trace": ([trace_params_type()] + [vp] * 22 + [ci] * 7
                        + [vp, vp], ci),
        "rvgrt_warp_bilinear": ([vp] * 4 + [ci, ci, cll, vp], ci),
        "rvgrt_minconv_mid": ([vp, vp, ci, ci, cll, ci, vp], ci),
        "rvgrt_gather": ([ci, vp, cll, ci, vp, vp, cll, cll, ci, ci, cll,
                          ctypes.c_float, vp], ci),
        "rvgrt_gather_cluster": ([ci, vp, cll, ci, vp, vp, cll, cll, ci, ci,
                                  vp], ci),
        "rvgrt_gather_limits": ([ci, vp], ci),
        "rvgrt_set_persisting_l2": ([cll], ci),
        "rvgrt_device_limits": ([ci, vp], ci),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            import ctypes

            target = BUILD_DIR / f"librvgrt_kernels_{_digest()}.so"
            if not target.exists():
                _build(target, os.environ.get("RVGRT_PTXAS_VERBOSE") == "1")
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().rvgrt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, device, shape=None) -> None:
    """Check what a kernel takes: device, dtype, contiguity and shape."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
