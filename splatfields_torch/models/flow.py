"""Per-splat motion heads for 4-D scenes (counterpart of
``splatfields_tpu/models/flow.py``; reference ``utils/time_utils.py:
194-304``, ``FlowHead``).

``flow_model`` selects the head; each returns ``(flow, means3D)``:

- ``offset``: a Linear to a displacement (the Owlii protocol,
  ``scripts/run_owlii.sh``);
- ``se3``: a screw-axis exponential map; ``se3Affine`` adds an offset
  branch; ``se3Scaled`` scales the rotation and adds an offset;
- ``affine``: a full 3x3 map and a translation;
- ``dct``: per-splat trajectory coefficients (zero init) over a learned
  DCT basis of ``2 n_frames`` rows, indexed by the frame;
- ``dct_siren``: the basis from a SIREN of the time step.

The reference's quirk stays: the screw axis is normalised by its angle
and then 1e-5 is added. Parameter names are the flax names, so
``interop`` carries the weights across.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import torch_linear_
from splatfields_torch.models.resfields import SirenMLP
from splatfields_torch.utils.transforms import (
    exp_se3,
    from_homogeneous,
    scaled_exp_se3,
    to_homogeneous,
)

FLOW_MODELS = ("offset", "se3", "se3Affine", "se3Scaled", "affine", "dct",
               "dct_siren")


def init_dct_basis(num_basis: int, num_frames: int) -> np.ndarray:
    """DCT motion basis [num_frames, num_basis] (reference
    ``utils/time_utils.py:60-69``)."""
    T, K = num_frames, num_basis
    basis = np.zeros((T, K), np.float32)
    for t in range(T):
        for k in range(1, K + 1):
            basis[t, k - 1] = np.sqrt(2.0 / T) * np.cos(
                np.pi / (2.0 * T) * (2 * t + 1) * k)
    return basis


class FlowHead(nn.Module):
    def __init__(self, width: int = 256, flow_model: str = "offset",
                 num_basis: int = 4, n_frames: int = 100, *,
                 generator: torch.Generator):
        super().__init__()
        if flow_model not in FLOW_MODELS:
            raise NotImplementedError(flow_model)
        self.flow_model = flow_model
        self.num_basis = num_basis

        def dense(name, features, zero=False):
            lin = nn.Linear(width, features)
            if zero:
                with torch.no_grad():
                    lin.weight.zero_()
                    lin.bias.zero_()
            else:
                torch_linear_(lin.weight, lin.bias, width, generator)
            self.add_module(name, lin)

        fm = flow_model
        if fm == "offset":
            dense("gaussian_warp", 3)
        elif fm.startswith("se3"):
            dense("branch_w", 3)
            dense("branch_v", 3)
            if fm == "se3Scaled":
                dense("branch_scale", 1)
            if fm != "se3":
                dense("branch_offset", 3)
        elif fm == "affine":
            dense("branch_v", 3)
            dense("branch_w", 9)
        else:
            dense("branch_coeff", 3 * num_basis, zero=True)
            if fm == "dct":
                self.trajectory_basis = nn.Parameter(torch.from_numpy(
                    init_dct_basis(num_basis, n_frames * 2)))
            else:
                self.basis_net = SirenMLP(1, num_basis, 128, 2,
                                          generator=generator)

    def forward(self, hidden: torch.Tensor, pts: torch.Tensor,
                time_step: torch.Tensor | None = None,
                frame_id: int | None = None):
        """hidden [N, width], pts [N, 3]; ``time_step`` a one-element
        tensor (``dct_siren``), ``frame_id`` a host int (``dct``) ->
        (flow [N, 3], means3D [N, 3])."""
        fm = self.flow_model
        if fm == "offset":
            flow = self.gaussian_warp(hidden)
            return flow, pts + flow
        if fm.startswith("se3"):
            w = self.branch_w(hidden)
            v = self.branch_v(hidden)
            theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
            # the reference's quirk: normalise, then add eps
            w = w / theta + 1e-5
            v = v / theta + 1e-5
            screw = torch.cat([w, v], -1)
            if fm == "se3Scaled":
                tfm = scaled_exp_se3(screw, theta,
                                     F.softplus(self.branch_scale(hidden)))
            else:
                tfm = exp_se3(screw, theta)
            moved = from_homogeneous(
                (tfm @ to_homogeneous(pts)[..., None])[..., 0])
            if fm != "se3":
                moved = moved + self.branch_offset(hidden)
            return moved - pts, moved
        if fm == "affine":
            v = self.branch_v(hidden)
            aff = self.branch_w(hidden).reshape(-1, 3, 3)
            moved = (aff @ pts[..., None])[..., 0] + v
            return moved - pts, moved
        coeff = self.branch_coeff(hidden).reshape(-1, 3, self.num_basis)
        if fm == "dct":
            b = self.trajectory_basis[frame_id]
        else:
            b = self.basis_net(time_step.reshape(1, 1))[0]
        flow = (coeff * b[None, None, :]).sum(-1)
        return flow, pts + flow
