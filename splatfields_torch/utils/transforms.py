"""Rotation and covariance math for splats, and the SO(3) / SE(3)
exponential maps of the flow head (counterpart of
``splatfields_tpu/utils/transforms.py``; reference
``utils/rigid_utils.py``)."""
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


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis vector -> [..., 3, 3] cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis [..., 3], angle [..., 1] -> [..., 3, 3]."""
    W = skew(w)
    th = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + torch.sin(th) * W + (1.0 - torch.cos(th)) * (W @ W)


def _rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    bottom = torch.cat([torch.zeros_like(R[..., :1, :]),
                        torch.ones_like(p[..., :1, :])], -1)
    return torch.cat([torch.cat([R, p], -1), bottom], -2)


def _screw_translation(w, v, theta):
    W = skew(w)
    th = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    G = th * eye + (1.0 - torch.cos(th)) * W + (th - torch.sin(th)) * (W @ W)
    return G @ v[..., None]


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw-axis exponential (Modern Robotics Eqn 3.88): S [..., 6] =
    (w, v), theta [..., 1] -> [..., 4, 4] homogeneous transforms."""
    w, v = S[..., :3], S[..., 3:]
    return _rp_to_se3(exp_so3(w, theta), _screw_translation(w, v, theta))


def scaled_exp_se3(S: torch.Tensor, theta: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``exp_se3`` with the rotation block scaled by ``scale`` [..., 1]
    (reference ``utils/rigid_utils.py:85-110``)."""
    w, v = S[..., :3], S[..., 3:]
    return _rp_to_se3(scale[..., None] * exp_so3(w, theta),
                      _screw_translation(w, v, theta))


def to_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, torch.ones_like(v[..., :1])], -1)


def from_homogeneous(v: torch.Tensor) -> torch.Tensor:
    return v[..., :3] / v[..., -1:]
