"""The port's host libraries in C++, built at first use and bound with
ctypes (counterpart of ``splatfields_tpu/native``).

Each source beside this file (``hullcarve.cpp``, ``jpeg.cpp``,
``gif.cpp``) builds with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into ``build/native/`` at the repository root, the library named by the
source and a hash of the source and the flags, as ``ops/cuda_build.py``
names the CUDA kernels. A failed build raises: nothing here falls back to
NumPy.

``carve_points`` is the multithreaded visual-hull carver
(``hullcarve.cpp``, the JAX package's source and arithmetic):
``data/point_init.mask_filter_points`` takes it by default.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}   # {name: g++ seconds} of the libraries built here


def lib_path(name: str) -> Path:
    """The library of ``<name>.cpp``, named by a hash of the source and
    the flags."""
    src = SRC_DIR / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """``<name>.cpp`` built (once) and loaded, each function of
    ``signatures`` (``{name: (argtypes, restype)}``) typed. Raises
    RuntimeError when ``g++`` fails or is missing."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _build_and_load(name)
        lib = _LIBS[name]
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        return lib


def _build_and_load(name: str) -> ctypes.CDLL:
    path = lib_path(name)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o",
                 str(tmp)], capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"g++ could not build {name}.cpp: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {name}.cpp:\n" + proc.stderr)
        os.replace(tmp, path)  # atomic: another process sees all or none
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(path))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_CARVE = {"carve_points": ([
    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32], None)}


def carve_points(points: np.ndarray, mats: np.ndarray, masks: list,
                 mode: int, n_threads: int = 0) -> np.ndarray:
    """[N] bool: the points that land inside every camera's mask.

    points: [N, 3] float32. mats: mode 0, [C, 4, 4] transposed full
    projections (NDC -> pixel ``((v + 1) S - 1) / 2``, integer bounds);
    mode 1, [C, 3, 4] KRT pixel projections (float bounds, clipped
    lookup). masks: C arrays [H, W], nonzero inside. ``n_threads`` 0: one
    thread a core."""
    lib = library("hullcarve", _CARVE)
    pts = np.ascontiguousarray(points, np.float32)
    m = np.ascontiguousarray(mats, np.float32)
    widths = np.array([mk.shape[1] for mk in masks], np.int32)
    heights = np.array([mk.shape[0] for mk in masks], np.int32)
    flat = np.concatenate([(np.asarray(mk) != 0).astype(np.uint8).reshape(-1)
                           for mk in masks])
    offsets = np.concatenate([[0], np.cumsum([mk.size for mk in masks])[:-1]
                              ]).astype(np.int64)
    keep = np.zeros(pts.shape[0], np.uint8)
    lib.carve_points(_ptr(pts, ctypes.c_float), pts.shape[0],
                     _ptr(m, ctypes.c_float), _ptr(flat, ctypes.c_uint8),
                     _ptr(widths, ctypes.c_int32),
                     _ptr(heights, ctypes.c_int32),
                     _ptr(offsets, ctypes.c_int64), len(masks), mode,
                     _ptr(keep, ctypes.c_uint8), n_threads)
    return keep.astype(bool)
