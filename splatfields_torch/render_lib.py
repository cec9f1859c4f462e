"""Inference-side rendering (counterpart of ``splatfields_tpu/render_lib.py``).

``render_camera`` is the serving path: field forward -> rasterize, with no
autograd graph. A camera is any object with the attributes of the JAX
package's ``Camera``/``MiniCam``: ``world_view_transform``,
``full_proj_transform``, ``camera_center``, ``tanfovx``, ``tanfovy``,
``image_width``, ``image_height`` and ``fid``.
"""
from __future__ import annotations

import numpy as np
import torch

from splatfields_torch import train_lib
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.ops.raster.api import rasterize


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@torch.no_grad()
def render_camera(cam, params, stats, deform, pipe_cfg, bg, field_mode=True,
                  n_frames=0, sh_degree=0):
    """Render one camera -> dict of tensors on the splats' device:
    render [3,H,W], depth [1,H,W], opacity [1,H,W], radii [N], n_dropped."""
    dev = params.xyz.device
    net = deform.net if field_mode and deform is not None else None
    if net is not None:
        attrs = train_lib.field_attributes(
            net, params.xyz, splats_lib.get_scaling(params), stats.valid,
            cam.fid, n_frames)
    else:
        attrs = train_lib.static_attributes(params, stats.valid)
    campos = _f32(cam.camera_center, dev)
    out = rasterize(
        attrs["means3d"], attrs["scales"], attrs["rotations"],
        attrs["opacity"], _f32(cam.world_view_transform, dev),
        _f32(cam.full_proj_transform, dev), campos,
        _f32(bg, dev), float(np.float32(cam.tanfovx)),
        float(np.float32(cam.tanfovy)), cam.image_width, cam.image_height,
        colors_precomp=train_lib.view_colors(attrs, campos, net),
        shs=attrs.get("shs"),
        sh_degree=sh_degree, valid_mask=attrs["valid"],
        tile_size=pipe_cfg.tile_size, tile_cap=pipe_cfg.tile_cap,
        k_chunk=pipe_cfg.k_chunk,
        # the training instance budget, so a model trained with a grown
        # dup_factor renders with it too
        dup_cap=pipe_cfg.dup_factor * attrs["means3d"].shape[0])
    return {"render": out.color, "depth": out.depth, "opacity": out.alpha,
            "radii": out.radii, "n_dropped": out.n_dropped}


def render_cameras_batched(cams, params, stats, deform, pipe_cfg, bg,
                           field_mode=True, n_frames=0, sh_degree=0):
    """Render a list of cameras one after another; yields per-frame dicts
    like ``render_camera``. (The JAX package batches frames into one
    ``lax.scan`` dispatch; PyTorch runs eagerly, so a loop is the twin.)"""
    for cam in cams:
        yield render_camera(cam, params, stats, deform, pipe_cfg, bg,
                            field_mode=field_mode, n_frames=n_frames,
                            sh_degree=sh_degree)
