"""Build and load the native sinks (``native/*.cpp``) with ``g++``.

The shared libraries are not in the repository: on first use each source
is compiled with the commands of ``native/build.sh`` into
``rvgrt_tpu_torch/_build/native/``, under a name that carries a hash of the
source, and loaded with ``ctypes``.  ``native/`` itself is only read.  A
library that cannot be built or loaded raises: the port has no
pure-Python writer to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "native"
#: g++ flags and link libraries of each source, as in native/build.sh
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = {"framesink": ("-lz", "-lpthread"), "videosink": ("-lpthread",)}

#: the sinks' frame argument, (H, W, 3) uint8
U8P = ctypes.POINTER(ctypes.c_uint8)

_lock = threading.Lock()
_loaded: dict = {}


def _build(src: Path, target: Path, libs) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"cannot build {src.name}: no g++ on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(src), *libs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, target)


def load(name: str, sigs: dict) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built on first use, with the
    signatures ``sigs`` ({function: (argtypes, restype)}) set once."""
    with _lock:
        if name not in _loaded:
            src = NATIVE_DIR / f"{name}.cpp"
            digest = hashlib.sha256(src.read_bytes() + " ".join(
                FLAGS + LIBS[name]).encode()).hexdigest()[:16]
            target = BUILD_DIR / f"lib{name}_{digest}.so"
            if not target.exists():
                _build(src, target, LIBS[name])
            lib = ctypes.CDLL(str(target))
            for fn, (args, res) in sigs.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _loaded[name] = lib
        return _loaded[name]


def rgb_frame(frame) -> np.ndarray:
    """An (H, W, 3) uint8 tensor (on any device) or array, as the contiguous
    host array a sink takes."""
    if isinstance(frame, torch.Tensor):
        frame = frame.detach().cpu().numpy()
    a = np.ascontiguousarray(frame, np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) frame, got {a.shape}")
    return a
