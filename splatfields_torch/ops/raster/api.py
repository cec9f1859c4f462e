"""Gaussian-splat rendering: the port's public rasterizer API (counterpart
of ``splatfields_tpu/ops/raster/api.py``).

One call gives the colour image, the alpha-blended depth, the accumulated
opacity (``alpha = 1 - T_final``, the blend's own final transmittance, so
no second mask pass), the screen radii and the instances dropped by the
``dup_cap`` budget.

Pipeline: preprocess -> bin_gaussians -> pack_attributes + one row gather
into instance order -> blend (the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors; ``blend_cuda.blend_fwd`` chooses) ->
tiles_to_image -> background compositing.

Gradients: one autograd graph from the inputs to the images. The blend's
backward is its closed-form VJP (``blend_cuda._Blend``); the backward of
the row gather folds each instance row back onto its Gaussian (an
``index_add``). For the densification statistics the caller passes a
zero ``screenspace_offset`` [N, 2] that requires grad: its gradient is
the CUDA rasterizer's ``means2D`` gradient, in half-resolution NDC units.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatfields_torch.ops.raster.binning import bin_gaussians
from splatfields_torch.ops.raster.blend_cuda import blend_fwd
from splatfields_torch.ops.raster.blend_torch import (
    pack_attributes,
    tiles_to_image,
)
from splatfields_torch.ops.raster.preprocess import preprocess


class RenderOut(NamedTuple):
    color: torch.Tensor      # [3, H, W]
    depth: torch.Tensor      # [1, H, W] alpha-weighted view depth
    alpha: torch.Tensor      # [1, H, W] accumulated opacity
    radii: torch.Tensor      # [N] int32 screen radii (0 = invisible)
    n_dropped: torch.Tensor  # scalar: instances beyond dup_cap


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    bg: torch.Tensor,
    tanfovx: float,
    tanfovy: float,
    image_width: int,
    image_height: int,
    colors_precomp: torch.Tensor | None = None,
    shs: torch.Tensor | None = None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    valid_mask: torch.Tensor | None = None,
    screenspace_offset: torch.Tensor | None = None,
    tile_size: int = 16,
    tile_cap: int = 1024,
    k_chunk: int = 128,
    dup_cap: int | None = None,
) -> RenderOut:
    """Render one view; N is the (padded) splat capacity."""
    pre = preprocess(
        means3d, scales, rotations, opacities, viewmatrix, projmatrix,
        image_width, image_height, tanfovx, tanfovy,
        colors_precomp=colors_precomp, shs=shs, sh_degree=sh_degree,
        campos=campos, scale_modifier=scale_modifier, valid_mask=valid_mask)

    means2d = pre.means2d
    if screenspace_offset is not None:
        # CUDA's dL/dmean2D is in half-resolution NDC units; adding
        # offset * (W/2, H/2) in pixel space makes the gradient w.r.t. the
        # zero offset come out in exactly those units
        scale_vec = means2d.new_tensor([0.5 * image_width, 0.5 * image_height])
        means2d = means2d + screenspace_offset * scale_vec[None, :]

    tiles_x = -(-image_width // tile_size)
    tiles_y = -(-image_height // tile_size)
    binning = bin_gaussians(means2d.detach(), pre.depths.detach(), pre.radii,
                            tiles_x, tiles_y, tile_size, dup_cap=dup_cap)
    pack = pack_attributes(means2d, pre.conics, pre.rgb, pre.opacity,
                           pre.depths)
    sorted_pack = pack[torch.clamp_min(binning.sorted_id, 0).to(torch.int64)]
    color_t, depth_t, tfinal_t = blend_fwd(
        sorted_pack, binning.tile_start, binning.counts, tiles_x, tiles_y,
        tile_size, tile_cap, k_chunk)

    color = tiles_to_image(color_t.transpose(1, 2), tiles_x, tiles_y,
                           tile_size, image_height, image_width)   # [H, W, 3]
    depth = tiles_to_image(depth_t, tiles_x, tiles_y, tile_size,
                           image_height, image_width)
    final_t = tiles_to_image(tfinal_t, tiles_x, tiles_y, tile_size,
                             image_height, image_width)
    color = color + final_t[..., None] * bg[None, None, :]
    return RenderOut(color=color.permute(2, 0, 1), depth=depth[None],
                     alpha=(1.0 - final_t)[None], radii=pre.radii,
                     n_dropped=binning.n_dropped)
