"""Bilinear and trilinear sampling with ``torch.nn.functional.grid_sample``
semantics (counterpart of ``splatfields_tpu/ops/grid_sample.py``).

The JAX package re-implements grid_sample for the TPU (its quad-packed
sampler is plain XLA, no Pallas); here PyTorch's own op is the function
itself: bilinear (trilinear on a 5-D input), zeros padding,
align_corners=False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_planes(planes: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Sample P same-size planes [P, C, H, W] at per-plane normalized (x, y)
    coords [P, N, 2] (x indexes W) -> [N, P, C]."""
    out = F.grid_sample(planes, coords[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0].permute(2, 0, 1)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Sample a [C, D, H, W] grid at [N, 3] normalized (x, y, z) coords
    (x indexes W, y H, z D) -> [N, C]. ``padding_mode``: "zeros" or
    "border"."""
    out = F.grid_sample(grid[None], coords[None, :, None, None, :],
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out[0, :, :, 0, 0].t()
