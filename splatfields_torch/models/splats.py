"""Explicit splat parameters and their activations (counterpart of
``splatfields_tpu/models/splats.py``; Adam, densification and PLY IO come
with the training slice).

Parameters live in fixed-capacity tensors with a validity mask, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatfields_torch.device import resolve_device
from splatfields_torch.ops.knn import mean_sq_dist_knn3
from splatfields_torch.ops.sh import rgb_to_sh
from splatfields_torch.utils.transforms import inverse_sigmoid


@dataclasses.dataclass
class SplatParams:
    """Raw (pre-activation) splat parameters at fixed capacity C."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] or [C, 1] (isotropic), log space
    rotation: torch.Tensor       # [C, 4]
    opacity: torch.Tensor        # [C, 1], logit space

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


@dataclasses.dataclass
class SplatStats:
    """Densification bookkeeping."""
    valid: torch.Tensor              # [C] bool
    max_radii2d: torch.Tensor        # [C]
    xyz_gradient_accum: torch.Tensor  # [C]
    denom: torch.Tensor              # [C]


def get_scaling(p: SplatParams) -> torch.Tensor:
    s = torch.exp(p.scaling)
    return s.expand(-1, 3) if s.shape[-1] == 1 else s


def get_opacity(p: SplatParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_rotation(p: SplatParams) -> torch.Tensor:
    return p.rotation / (torch.linalg.vector_norm(p.rotation, dim=-1,
                                                  keepdim=True) + 1e-12)


def get_features(p: SplatParams) -> torch.Tensor:
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: int | None = None, isotropic: bool = False,
                    device=None) -> tuple[SplatParams, SplatStats]:
    """Splats from a point cloud: SH DC from RGB, log scale from the mean
    squared distance to the 3 nearest neighbours, identity rotation,
    opacity 0.1; padded to ``capacity``. ``device=None`` means the GPU."""
    dev = resolve_device(device)
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)

    dist2 = mean_sq_dist_knn3(pts)
    scale_init = torch.log(torch.sqrt(dist2))[:, None]
    scaling = scale_init if isotropic else scale_init.repeat(1, 3)
    features_dc = rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32),
                                            device=dev))[:, None, :]
    rotation = torch.zeros(n, 4, device=dev)
    rotation[:, 0] = 1.0
    opacity = torch.full((n, 1), float(inverse_sigmoid(torch.tensor(0.1))),
                         device=dev)

    def pad(a):
        out = torch.zeros((capacity,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        out[:n] = a
        return out

    params = SplatParams(
        xyz=pad(pts), features_dc=pad(features_dc),
        features_rest=torch.zeros(capacity, k - 1, 3, device=dev),
        scaling=pad(scaling), rotation=pad(rotation), opacity=pad(opacity))
    valid = torch.zeros(capacity, dtype=torch.bool, device=dev)
    valid[:n] = True
    zeros = torch.zeros(capacity, device=dev)
    stats = SplatStats(valid=valid, max_radii2d=zeros.clone(),
                       xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    return params, stats
