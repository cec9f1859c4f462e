"""The tile-blend kernels, forward and backward, CUDA C++ for Hopper, bound
with ctypes.

``blend_fwd`` takes the contract of
``splatfields_tpu/ops/raster/blend_pallas.py::blend_sorted_pallas``:
``(sorted_pack [D,10], tile_start [T+1], counts [T], tiles_x, tiles_y,
tile_size, tile_cap, k_chunk, tile_ids=None)`` ->
``(color [T,3,P], depth [T,P], final_t [T,P])``, differentiable in
``sorted_pack``. ``blend_bwd`` is its VJP, the contract of
``_blend_bwd_pallas``.

On CUDA tensors the forward launches ``csrc/blend_fwd.cu`` and the
backward ``csrc/blend_bwd.cu`` on PyTorch's current stream, or raise; they
never fall back to the plain versions. The kernels are built with ``nvcc``
on first use into ``build/kernels/`` at the repository root, one library
per source, named by a hash of that source and the flags, all sources
compiled at once. On CPU tensors the same ``autograd.Function`` runs the
plain versions, ``blend_torch.blend_sorted_plain`` and
``blend_torch.blend_bwd_plain``, so both devices share one gradient
contract. ``blend_fwd.launches`` and ``blend_bwd.launches`` count kernel
launches, and nothing else.
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
    blend_bwd_plain,
    blend_sorted_plain,
)

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = {name: CSRC / f"{name}.cu" for name in ("blend_fwd", "blend_bwd")}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# C signature of each <name>_launch: pointers, then ints, then the stream
_ARGTYPES = {
    "blend_fwd": [_ptr, _i32, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32,
                  _i32, _i32, _ptr],
    "blend_bwd": [_ptr, _i32, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                  _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr],
}
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the blend kernels are built with "
                           "the CUDA toolkit on the GPU machine")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build() -> dict[str, tuple[Path, float]]:
    """Compile every kernel whose library for this source and these flags
    does not exist, all at once (one nvcc each). Returns ``{name: (library
    path, seconds spent compiling)}``. The compiler's report (registers,
    shared memory, spills) goes to ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        lib_path = _lib_path(name)
        if lib_path.exists():
            out[name] = (lib_path, 0.0)
            continue
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        running[name] = (lib_path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib_path, tmp, proc) in running.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{report}")
        lib_path.with_suffix(".log").write_text(report)
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
        out[name] = (lib_path, time.perf_counter() - t0)
    return out


def _load(name: str):
    if name not in _libs:
        built = build()
        for n, (path, _) in built.items():
            if n in _libs:
                continue
            lib = ctypes.CDLL(str(path))
            launch = getattr(lib, f"{n}_launch")
            launch.argtypes = _ARGTYPES[n]
            launch.restype = _i32
            err = getattr(lib, f"{n}_error_string")
            err.argtypes = [_i32]
            err.restype = ctypes.c_char_p
            _libs[n] = lib
    return _libs[name]


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_tiles(sorted_pack, tile_start, counts, tile_ids, tile_size):
    dev = sorted_pack.device
    num_tiles = counts.shape[0]
    _check("sorted_pack", sorted_pack, torch.float32,
           (sorted_pack.shape[0], PACK_WIDTH), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles + 1,), dev)
    _check("counts", counts, torch.int32, (num_tiles,), dev)
    _check("tile_ids", tile_ids, torch.int32, (num_tiles,), dev)
    return dev, num_tiles, tile_size * tile_size


def _run(name, *args):
    """Launch ``name`` on the current stream and raise on a launch error."""
    lib = _load(name)
    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())


def _launch_fwd(sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
                tile_cap):
    dev, num_tiles, p = _check_tiles(sorted_pack, tile_start, counts,
                                     tile_ids, tile_size)
    if not 0 < p <= 1024:
        raise ValueError(f"tile_size {tile_size}: one thread per pixel needs "
                         "1 <= tile_size**2 <= 1024")
    color = torch.empty(num_tiles, 3, p, device=dev)
    depth = torch.empty(num_tiles, p, device=dev)
    final_t = torch.empty(num_tiles, p, device=dev)
    _run("blend_fwd", sorted_pack, sorted_pack.shape[0], tile_start, counts,
         tile_ids, color, depth, final_t, num_tiles, tiles_x, tile_size,
         tile_cap)
    blend_fwd.launches += 1
    return color, depth, final_t


def blend_bwd(sorted_pack, tile_start, counts, tile_ids, g_color, g_depth,
              g_tfinal, color, depth, final_t, tiles_x: int, tile_size: int,
              tile_cap: int) -> torch.Tensor:
    """The backward kernel: dL/d(sorted_pack) [D, 10] (zero for rows no
    pixel reaches) from the upstream gradients ``g_color`` [T,3,P],
    ``g_depth``, ``g_tfinal`` [T,P] and the saved forward outputs. CUDA
    tensors only; ``blend_torch.blend_bwd_plain`` is its plain version."""
    dev, num_tiles, p = _check_tiles(sorted_pack, tile_start, counts,
                                     tile_ids, tile_size)
    if p % 32 or not 0 < p <= 1024:
        raise ValueError(f"tile_size {tile_size}: the backward needs "
                         "tile_size**2 a multiple of 32, at most 1024")
    for name, x, ch in (("g_color", g_color, 3), ("g_depth", g_depth, 0),
                        ("g_tfinal", g_tfinal, 0), ("color", color, 3),
                        ("depth", depth, 0), ("final_t", final_t, 0)):
        shape = (num_tiles, ch, p) if ch else (num_tiles, p)
        _check(name, x, torch.float32, shape, dev)
    # zeros, not empty: rows no pixel reaches are not written, and the
    # gather's backward folds every row onto a Gaussian
    grad = torch.zeros(sorted_pack.shape[0], PACK_WIDTH, device=dev)
    _run("blend_bwd", sorted_pack, sorted_pack.shape[0], tile_start, counts,
         tile_ids, g_color, g_depth, g_tfinal, color, depth, final_t, grad,
         num_tiles, tiles_x, tile_size, tile_cap)
    blend_bwd.launches += 1
    return grad


class _Blend(torch.autograd.Function):
    """The blend with its closed-form VJP: the kernels for CUDA tensors,
    the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, sorted_pack, tile_start, counts, tile_ids, tiles_x,
                tiles_y, tile_size, tile_cap, k_chunk):
        if sorted_pack.is_cuda:
            out = _launch_fwd(sorted_pack, tile_start, counts, tile_ids,
                              tiles_x, tile_size, tile_cap)
        else:
            out = blend_sorted_plain(sorted_pack, tile_start, counts,
                                     tiles_x, tiles_y, tile_size, tile_cap,
                                     k_chunk, tile_ids)
        ctx.save_for_backward(sorted_pack, tile_start, counts, tile_ids, *out)
        ctx.args = (tiles_x, tile_size, tile_cap, k_chunk)
        return out

    @staticmethod
    def backward(ctx, g_color, g_depth, g_tfinal):
        sorted_pack, tile_start, counts, tile_ids, *out = ctx.saved_tensors
        tiles_x, tile_size, tile_cap, k_chunk = ctx.args
        # an output the loss ignores arrives as None; a transposed image
        # gradient arrives strided
        g = [torch.zeros_like(o) if g is None else g.contiguous()
             for g, o in zip((g_color, g_depth, g_tfinal), out)]
        if sorted_pack.is_cuda:
            grad = blend_bwd(sorted_pack, tile_start, counts, tile_ids, *g,
                             *out, tiles_x, tile_size, tile_cap)
        else:
            grad = blend_bwd_plain(sorted_pack, tile_start, counts, tile_ids,
                                   *g, *out, tiles_x, tile_size, tile_cap,
                                   k_chunk)
        return (grad,) + (None,) * 8


def blend_fwd(sorted_pack, tile_start, counts, tiles_x: int, tiles_y: int,
              tile_size: int, tile_cap: int, k_chunk: int, tile_ids=None):
    """Tile blend: the CUDA kernels for CUDA tensors, the plain versions
    for CPU tensors. ``k_chunk`` only shapes the plain versions' chunks."""
    if tile_ids is None:
        tile_ids = torch.arange(counts.shape[0], device=counts.device,
                                dtype=torch.int32)
    return _Blend.apply(sorted_pack.contiguous(), tile_start.contiguous(),
                        counts.contiguous(), tile_ids.contiguous(), tiles_x,
                        tiles_y, tile_size, tile_cap, k_chunk)


blend_fwd.launches = 0
blend_bwd.launches = 0
