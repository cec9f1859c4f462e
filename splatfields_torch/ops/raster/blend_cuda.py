"""The tile-blend forward kernel, CUDA C++ for Hopper, bound with ctypes.

``blend_fwd`` takes the contract of
``splatfields_tpu/ops/raster/blend_pallas.py::blend_sorted_pallas``:
``(sorted_pack [D,10], tile_start [T+1], counts [T], tiles_x, tiles_y,
tile_size, tile_cap, k_chunk, tile_ids=None)`` ->
``(color [T,3,P], depth [T,P], final_t [T,P])``.

On CUDA tensors it launches ``csrc/blend_fwd.cu`` (built with ``nvcc`` on
first use into ``build/kernels/`` at the repository root, named by a hash
of the source and flags) on PyTorch's current stream, or raises. On CPU
tensors it runs the plain version, ``blend_torch.blend_sorted_plain``.
``blend_fwd.launches`` counts kernel launches, and nothing else.

Forward only: the backward kernel comes with the training slice.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from splatfields_torch.ops.raster.blend_torch import (
    PACK_WIDTH,
    blend_sorted_plain,
)

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "blend_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the blend kernel is built with "
                           "the CUDA toolkit on the GPU machine")
    return path


def build() -> tuple[Path, float]:
    """Compile the kernel unless a library for this source and these flags
    exists. Returns (library path, seconds spent compiling). The compiler's
    report (registers, shared memory, spills) goes to ``<library>.log``."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libblend_fwd-{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    return lib_path, seconds


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.blend_fwd_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                         ptr, i32, i32, i32, i32, ptr]
        lib.blend_fwd_launch.restype = i32
        lib.blend_fwd_error_string.argtypes = [i32]
        lib.blend_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launch(sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
            tile_cap):
    dev = sorted_pack.device
    num_tiles = counts.shape[0]
    p = tile_size * tile_size
    if not 0 < p <= 1024:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel needs "
                         "1 <= tile_size**2 <= 1024")
    d_rows = sorted_pack.shape[0]
    _check("sorted_pack", sorted_pack, torch.float32, (d_rows, PACK_WIDTH), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles + 1,), dev)
    _check("counts", counts, torch.int32, (num_tiles,), dev)
    _check("tile_ids", tile_ids, torch.int32, (num_tiles,), dev)
    color = torch.empty(num_tiles, 3, p, device=dev)
    depth = torch.empty(num_tiles, p, device=dev)
    final_t = torch.empty(num_tiles, p, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_fwd_launch(
            sorted_pack.data_ptr(), d_rows, tile_start.data_ptr(),
            counts.data_ptr(), tile_ids.data_ptr(), color.data_ptr(),
            depth.data_ptr(), final_t.data_ptr(), num_tiles, tiles_x,
            tile_size, tile_cap, stream)
    if err != 0:
        raise RuntimeError("blend_fwd launch failed: "
                           + lib.blend_fwd_error_string(err).decode())
    blend_fwd.launches += 1
    return color, depth, final_t


class _BlendFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sorted_pack, tile_start, counts, tile_ids, tiles_x,
                tile_size, tile_cap):
        return _launch(sorted_pack, tile_start, counts, tile_ids, tiles_x,
                       tile_size, tile_cap)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("blend backward kernel: training slice")


def blend_fwd(sorted_pack, tile_start, counts, tiles_x: int, tiles_y: int,
              tile_size: int, tile_cap: int, k_chunk: int, tile_ids=None):
    """Tile blend: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. ``k_chunk`` only shapes the plain version's chunks."""
    if not sorted_pack.is_cuda:
        return blend_sorted_plain(sorted_pack, tile_start, counts, tiles_x,
                                  tiles_y, tile_size, tile_cap, k_chunk,
                                  tile_ids)
    if tile_ids is None:
        tile_ids = torch.arange(counts.shape[0], device=counts.device,
                                dtype=torch.int32)
    return _BlendFwd.apply(sorted_pack.contiguous(), tile_start.contiguous(),
                           counts.contiguous(), tile_ids.contiguous(),
                           tiles_x, tile_size, tile_cap)


blend_fwd.launches = 0
