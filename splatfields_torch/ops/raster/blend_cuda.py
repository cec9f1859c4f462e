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
never fall back to the plain versions. ``ops/cuda_build.py`` builds them,
with the port's other kernels, on first use (``build`` is its ``build``,
re-exported). On CPU tensors the same ``autograd.Function`` runs the
plain versions, ``blend_torch.blend_sorted_plain`` and
``blend_torch.blend_bwd_plain``, so both devices share one gradient
contract. ``blend_fwd.launches`` and ``blend_bwd.launches`` count kernel
launches, and nothing else.
"""
from __future__ import annotations

import torch

from splatfields_torch.ops.cuda_build import build, check, run
from splatfields_torch.ops.raster.blend_torch import (
    PACK_WIDTH,
    blend_bwd_plain,
    blend_sorted_plain,
)

__all__ = ["blend_fwd", "blend_bwd", "build"]


def _check_tiles(sorted_pack, tile_start, counts, tile_ids, tile_size):
    dev = sorted_pack.device
    num_tiles = counts.shape[0]
    check("sorted_pack", sorted_pack, torch.float32,
          (sorted_pack.shape[0], PACK_WIDTH), dev)
    if sorted_pack.data_ptr() % 8:
        raise ValueError("sorted_pack must be 8-byte aligned: the kernels "
                         "read its rows as float2")
    check("tile_start", tile_start, torch.int32, (num_tiles + 1,), dev)
    check("counts", counts, torch.int32, (num_tiles,), dev)
    check("tile_ids", tile_ids, torch.int32, (num_tiles,), dev)
    return dev, num_tiles, tile_size * tile_size


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
    run("blend_fwd", sorted_pack, sorted_pack.shape[0], tile_start, counts,
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
        check(name, x, torch.float32, shape, dev)
    # zeros, not empty: rows no pixel reaches are not written, and the
    # gather's backward folds every row onto a Gaussian
    grad = torch.zeros(sorted_pack.shape[0], PACK_WIDTH, device=dev)
    run("blend_bwd", sorted_pack, sorted_pack.shape[0], tile_start, counts,
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
