"""Field-model holder (counterpart of
``splatfields_tpu/models/deform_model.py``). The optimizer and checkpoint IO
come with the training slice; ``interop.load_flax_variables`` carries JAX
weights across."""
from __future__ import annotations

import torch

from splatfields_torch.device import resolve_device
from splatfields_torch.models.splatfields import SplatFields


def build_splatfields(hidden_cfg, *,
                      generator: torch.Generator) -> SplatFields:
    """The net from a HiddenConfig (flag surface -> module arguments)."""
    h = hidden_cfg
    return SplatFields(
        n_frames=h.n_frames, encoder_type=h.encoder_type,
        encoder_args=dict(h.encoder_args or {}),
        layer_strategy=h.layer_strategy,
        composition_rank=h.composition_rank, deform_weight=h.deform_weight,
        use_view_dep_rgb=h.use_view_dep_rgb,
        geo_model_disable_pts=h.geo_model_disable_pts, rgb_w=h.rgb_w,
        generator=generator)


class DeformModel:
    """The SplatFields net on a device, initialised from ``seed``.

    The weights are drawn on the CPU from a ``torch.Generator`` and then
    moved, so one seed gives the same net on every device. ``device=None``
    means the GPU. ``radius`` (the scene radius) is read only by the NGP
    encoder of the JAX package, which is not ported yet."""

    def __init__(self, hidden_cfg, radius=None, seed: int = 0, device=None):
        del radius
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.net = build_splatfields(hidden_cfg, generator=gen)
        self.net = self.net.to(self.device).eval()
        self.n_frames = hidden_cfg.n_frames
