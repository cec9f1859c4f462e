"""Splat attributes for rendering (counterpart of the attribute functions in
``splatfields_tpu/train_lib.py``; the train step, losses and optimizer
come with the training slice)."""
from __future__ import annotations

import torch

from splatfields_torch.models import splats as splats_lib


def field_attributes(net, xyz: torch.Tensor, scaling: torch.Tensor,
                     valid: torch.Tensor, fid, n_frames: int, planes=None):
    """Field forward -> renderable attributes (reference ``train.py:51-85``):
    the net predicts attributes at the detached splat xyz; its scale is
    added to the splats' activated scale."""
    if n_frames > 0:
        raise NotImplementedError(
            "4-D field attributes: ROADMAP Queue 1 item 6")
    del fid
    ret = net(xyz.detach(), planes=planes)
    return {
        "means3d": ret["means3D"],
        "opacity": ret["opacity"][:, 0],
        "scales": ret["scales"] + scaling.detach(),
        "rotations": ret["rotations"],
        "rgb": ret["rgb"],
        "valid": valid,
    }


def static_attributes(params: splats_lib.SplatParams, valid: torch.Tensor):
    """Classic-3DGS attributes: SH colours straight from the splats."""
    return {
        "means3d": params.xyz,
        "opacity": splats_lib.get_opacity(params)[:, 0],
        "scales": splats_lib.get_scaling(params),
        "rotations": splats_lib.get_rotation(params),
        "shs": splats_lib.get_features(params),
        "valid": valid,
    }
