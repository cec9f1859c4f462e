"""Build, load and launch the port's hand-written CUDA kernels.

Every kernel has a plain C interface in a source under
``splatfields_torch/csrc/``: ``int <name>_launch(..., void* stream)``
returns the ``cudaError_t`` of its launch, ``const char*
<name>_error_string(int)`` names it. ``KERNELS`` is the registry of
``{name: (source, argtypes)}``; one source may hold several kernels.

``build()`` compiles every registered source whose library for this
source and these flags does not exist yet, all at once (one ``nvcc`` each,
started together), for sm_90a into ``build/kernels/`` at the repository
root, each library named by its source and a hash of the source, the
headers of ``csrc/`` and the flags. The first launch of any kernel builds them all. ``run(name, ...)``
launches on PyTorch's current stream and raises on a launch error;
nothing here falls back to a plain version.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# C signature of each <name>_launch: pointers and ints, then the stream
KERNELS = {
    "blend_fwd": (CSRC / "blend_fwd.cu",
                  [_ptr, _i32, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _i32, _i32,
                   _i32, _i32, _ptr]),
    "blend_bwd": (CSRC / "blend_bwd.cu",
                  [_ptr, _i32, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                   _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr]),
    "segsum": (CSRC / "segsum.cu",
               [_ptr, _ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr]),
    "fused_mlp_fwd": (CSRC / "fused_mlp_fwd.cu",
                      [_ptr] * 6 + [_i32] * 8 + [_ptr]),
    "fused_mlp_bwd": (CSRC / "fused_mlp_bwd.cu",
                      [_ptr] * 11 + [_i32] * 10 + [_ptr]),
    "fused_mlp_dw": (CSRC / "fused_mlp_bwd.cu",
                     [_ptr] * 5 + [_i32] * 5 + [_ptr]),
    "fused_mlp_reduce": (CSRC / "fused_mlp_bwd.cu",
                         [_ptr, _ptr, _i32, _i32, _ptr, _ptr, _i32, _i32,
                          _i32, _ptr]),
}
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the GPU machine")
    return path


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, of every
    header beside it (``*.cuh``, by name: a source may include any) and of
    the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, tuple[Path, float]]:
    """Compile every source whose library does not exist, all at once.
    Returns ``{source stem: (library path, seconds spent compiling)}``.
    The compiler's report (registers, shared memory, spills) goes to
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for src in dict.fromkeys(src for src, _ in KERNELS.values()):
        lib_path = _lib_path(src)
        if lib_path.exists():
            out[src.stem] = (lib_path, 0.0)
            continue
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        running[src] = (lib_path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for src, (lib_path, tmp, proc) in running.items():
        report, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{report}")
        lib_path.with_suffix(".log").write_text(report)
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
        out[src.stem] = (lib_path, time.perf_counter() - t0)
    return out


def _load(name: str):
    if name not in _libs:
        paths = build()
        for n, (src, argtypes) in KERNELS.items():
            if n in _libs:
                continue
            lib = ctypes.CDLL(str(paths[src.stem][0]))
            launch = getattr(lib, f"{n}_launch")
            launch.argtypes = argtypes
            launch.restype = _i32
            err = getattr(lib, f"{n}_error_string")
            err.argtypes = [_i32]
            err.restype = ctypes.c_char_p
            _libs[n] = lib
    return _libs[name]


def check(name, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every kernel takes."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def run(name, *args):
    """Launch ``name`` on the current stream of the first argument's
    device and raise on a launch error. Tensors pass as their data
    pointers, ints as ints."""
    lib = _load(name)
    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
