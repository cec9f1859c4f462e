"""Rotation and covariance math for splats (counterpart of
``splatfields_tpu/utils/transforms.py``; the SE(3) maps come with the 4-D
slice)."""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternions, normalized first -> [..., 3, 3]."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = L L^T with L = R diag(s), unrolled elementwise in f32 like
    the JAX version so both round the same way."""
    L = quat_to_rotmat(quats) * scales[..., None, :]

    def sig(i, j):
        return (L[..., i, 0] * L[..., j, 0] + L[..., i, 1] * L[..., j, 1]
                + L[..., i, 2] * L[..., j, 2])

    row0 = torch.stack([sig(0, 0), sig(0, 1), sig(0, 2)], -1)
    row1 = torch.stack([sig(0, 1), sig(1, 1), sig(1, 2)], -1)
    row2 = torch.stack([sig(0, 2), sig(1, 2), sig(2, 2)], -1)
    return torch.stack([row0, row1, row2], -2)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
