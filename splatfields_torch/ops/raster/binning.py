"""Tile binning: duplicate each visible Gaussian into one instance per
overlapped tile and sort the instances by (tile, depth, Gaussian id)
(counterpart of ``splatfields_tpu/ops/raster/binning.py``).

The order is the one the CUDA rasterizer's per-tile radix sort produces:
instances are enumerated in Gaussian-id order and sorted stably, so equal
depths tie by id. A static budget ``dup_cap`` bounds the instance array;
overflow drops the spillover of the highest-id Gaussians and is reported in
``n_dropped``. ``counts`` is not capped at ``tile_cap``: the blend applies
that cap itself.

The JAX version builds the duplication scatter-free for the TPU (prefix-max
trick) and can also emit a dense [tiles, tile_cap] id table for its XLA
blend; here a ``searchsorted`` does the duplication and the blends read the
sorted instance array directly, so ``BinningOut`` has no table.

Indices only: nothing here is differentiable.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BinningOut(NamedTuple):
    counts: torch.Tensor      # [num_tiles] int32 instances per tile
    depth: torch.Tensor       # [dup_cap] per-slot view depth (+inf pad)
    n_dropped: torch.Tensor   # scalar: instances beyond dup_cap
    sorted_id: torch.Tensor   # [dup_cap] Gaussian id per sorted instance (-1 pad)
    tile_start: torch.Tensor  # [num_tiles + 1] int32 instance ranges


def tile_rects(means2d: torch.Tensor, radii: torch.Tensor, tiles_x: int,
               tiles_y: int, tile_size: int):
    """CUDA getRect: inclusive-exclusive tile ranges clamped to the grid.

    Clamped in float before the int cast (the cast truncates toward zero,
    so the result equals XLA's saturating cast followed by the clip)."""
    r = radii.to(torch.float32)
    x, y = means2d[:, 0], means2d[:, 1]

    def cell(v, hi):
        return torch.clamp(v / tile_size, 0, hi).to(torch.int32)

    xmin = cell(x - r, tiles_x)
    ymin = cell(y - r, tiles_y)
    xmax = cell(x + r + tile_size - 1, tiles_x)
    ymax = cell(y + r + tile_size - 1, tiles_y)
    return xmin, ymin, xmax, ymax


def duplicate_instances(means2d, depths, radii, tiles_x: int, tiles_y: int,
                        tile_size: int, dup_cap: int):
    """One slot per (visible Gaussian, overlapped tile), enumerated in
    Gaussian-id order. Returns ``(tile, gauss_id, total, depth)`` per slot:
    tile id (``num_tiles`` for unused slots), Gaussian id (-1 pad), the
    true instance count (may exceed ``dup_cap``) and the slot's depth
    (+inf pad)."""
    n = means2d.shape[0]
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    xmin, ymin, xmax, ymax = tile_rects(means2d, radii, tiles_x, tiles_y,
                                        tile_size)
    span_x = torch.clamp_min(xmax - xmin, 0).to(torch.int64)
    span_y = torch.clamp_min(ymax - ymin, 0).to(torch.int64)
    per_g = torch.where(radii > 0, span_x * span_y, 0)
    ends = torch.cumsum(per_g, 0)
    total = ends[-1] if n else ends.new_zeros(())
    starts = ends - per_g

    d = torch.arange(dup_cap, device=dev, dtype=torch.int64)
    # owner of slot d: the first Gaussian whose inclusive end exceeds d
    g = torch.clamp(torch.searchsorted(ends, d, right=True), max=max(n - 1, 0))
    rank = d - starts[g]
    sx = torch.clamp_min(span_x[g], 1)
    tx = xmin[g].to(torch.int64) + rank % sx
    ty = ymin[g].to(torch.int64) + rank // sx
    valid = d < total
    tile = torch.where(valid, ty * tiles_x + tx, num_tiles)
    gauss_id = torch.where(valid, g, -1)
    depth = torch.where(valid, depths.detach().to(torch.float32)[g],
                        float("inf"))
    return tile, gauss_id, total, depth


def _orderable(depth: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) with the same order as the floats."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits + 2 ** 31


def bin_gaussians(means2d: torch.Tensor, depths: torch.Tensor,
                  radii: torch.Tensor, tiles_x: int, tiles_y: int,
                  tile_size: int, dup_cap: int | None = None) -> BinningOut:
    """Sort the instances; the blend applies ``tile_cap`` (the JAX version
    takes it only to size its dense table)."""
    means2d, depths = means2d.detach(), depths.detach()
    n = means2d.shape[0]
    num_tiles = tiles_x * tiles_y
    if dup_cap is None:
        dup_cap = 8 * n
    tile, gauss_id, total, depth = duplicate_instances(
        means2d, depths, radii, tiles_x, tiles_y, tile_size, dup_cap)

    # slots are already in id order, so ONE stable sort on (tile, depth)
    # gives the lexicographic (tile, depth, id) order of the JAX sort
    key = tile * 2 ** 32 + _orderable(depth)
    order = torch.sort(key, stable=True).indices
    sorted_tile = tile[order]
    sorted_id = gauss_id[order].to(torch.int32)

    tile_start = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=tile.device),
        right=False).to(torch.int32)
    counts = tile_start[1:] - tile_start[:-1]
    n_dropped = torch.clamp_min(total - dup_cap, 0).to(torch.int32)
    return BinningOut(counts=counts, depth=depth, n_dropped=n_dropped,
                      sorted_id=sorted_id, tile_start=tile_start)
