"""Per-Gaussian preprocess of the tile rasterizer: EWA projection
(counterpart of ``splatfields_tpu/ops/raster/preprocess.py``).

World -> view -> clip with the row-vector convention (matrices stored
transposed), frustum cull at view z <= 0.2, 3-D covariance from
(scale, quaternion), EWA projection with the 1.3*tanfov clamp and the
0.3-pixel dilation, conic from the inverse 2-D covariance (``det != 0``),
radius ceil(3 sqrt(lambda1)) as int32, and colour either precomputed or
from SH. Elementwise N-parallel math, differentiable by autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatfields_torch.ops.sh import sh_to_rgb_clamped
from splatfields_torch.utils.transforms import build_covariance


class PreprocessOut(NamedTuple):
    means2d: torch.Tensor   # [N, 2] pixel-space centers
    depths: torch.Tensor    # [N] view-space z
    conics: torch.Tensor    # [N, 3] inverse 2-D covariance (a, b, c)
    radii: torch.Tensor     # [N] int32 screen radius (0 = culled)
    rgb: torch.Tensor       # [N, 3]
    opacity: torch.Tensor   # [N]
    visible: torch.Tensor   # [N] bool


def _ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(
    means3d: torch.Tensor,          # [N, 3]
    scales: torch.Tensor,           # [N, 3] activated scales
    rotations: torch.Tensor,        # [N, 4] (w, x, y, z)
    opacities: torch.Tensor,        # [N] or [N, 1]
    viewmatrix: torch.Tensor,       # [4, 4] transposed W2V
    projmatrix: torch.Tensor,       # [4, 4] transposed view*proj
    image_width: int,
    image_height: int,
    tanfovx: float,
    tanfovy: float,
    colors_precomp: torch.Tensor | None = None,   # [N, 3]
    shs: torch.Tensor | None = None,              # [N, K, 3]
    sh_degree: int = 0,
    campos: torch.Tensor | None = None,           # [3]
    scale_modifier: float = 1.0,
    valid_mask: torch.Tensor | None = None,       # [N] bool
) -> PreprocessOut:
    f32 = torch.float32
    means3d = means3d.to(f32)
    opacities = opacities.reshape(-1).to(f32)
    viewmatrix = viewmatrix.to(f32)
    n = means3d.shape[0]

    focal_x = image_width / (2.0 * tanfovx)
    focal_y = image_height / (2.0 * tanfovy)

    p_hom = torch.cat([means3d, means3d.new_ones(n, 1)], dim=-1)
    p_view = (p_hom @ viewmatrix)[:, :3]
    p_clip = p_hom @ projmatrix.to(f32)
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    p_ndc = p_clip[:, :3] * p_w[:, None]

    in_frustum = p_view[:, 2] > 0.2

    cov3d = build_covariance(scales.to(f32) * scale_modifier, rotations.to(f32))

    # EWA projection (CUDA computeCov2D)
    tz = p_view[:, 2]
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z * inv_z

    # A = J @ R_w2v; the stored viewmatrix is transposed, so the rows of
    # R_w2v are the columns of Wm
    Wm = viewmatrix[:3, :3]
    A0 = j00[:, None] * Wm[None, :, 0] + j02[:, None] * Wm[None, :, 2]
    A1 = j11[:, None] * Wm[None, :, 1] + j12[:, None] * Wm[None, :, 2]

    def quad(a, b):
        return (a[:, 0] * (cov3d[:, 0, 0] * b[:, 0] + cov3d[:, 0, 1] * b[:, 1]
                           + cov3d[:, 0, 2] * b[:, 2])
                + a[:, 1] * (cov3d[:, 1, 0] * b[:, 0] + cov3d[:, 1, 1] * b[:, 1]
                             + cov3d[:, 1, 2] * b[:, 2])
                + a[:, 2] * (cov3d[:, 2, 0] * b[:, 0] + cov3d[:, 2, 1] * b[:, 1]
                             + cov3d[:, 2, 2] * b[:, 2]))

    cxx = quad(A0, A0) + 0.3
    cyy = quad(A1, A1) + 0.3
    cxy = quad(A0, A1)

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    means2d = torch.stack([_ndc2pix(p_ndc[:, 0], image_width),
                           _ndc2pix(p_ndc[:, 1], image_height)], dim=-1)

    visible = in_frustum & det_ok
    if valid_mask is not None:
        visible = visible & valid_mask
    radii = torch.where(visible, radius, 0.0).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp.to(f32)
    else:
        if shs is None or campos is None:
            raise ValueError("preprocess needs colors_precomp or shs + campos")
        dirs = means3d - campos[None, :].to(f32)
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
                       + 1e-12)
        rgb = sh_to_rgb_clamped(sh_degree, shs.to(f32).transpose(-1, -2), dirs)

    return PreprocessOut(means2d=means2d, depths=p_view[:, 2], conics=conic,
                         radii=radii, rgb=rgb, opacity=opacities,
                         visible=visible)
