"""Feature encoders (counterpart of ``splatfields_tpu/models/encoders.py``).

Ported: ``VarTriPlaneEncoder``, the released-config encoder: one
``Tensorial2D`` noise -> CNN generator per plane, planes regenerated on
every call, sampled bilinearly (torch grid_sample semantics) at the
xy / yz / zx coordinates and fused by concatenation (out_dim 3 * 16 = 48).
The other encoders come with later slices (ROADMAP Queue 1, items 6-7).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from splatfields_torch.models.decoder import Tensorial2D
from splatfields_torch.ops.grid_sample import grid_sample_planes

_SPACE_AXES = ((0, 1), (1, 2), (2, 0))   # xy, yz, zx


def _fuse(feat: torch.Tensor) -> torch.Tensor:
    """[N, n_planes, C] -> [N, n_planes * C]: the "cat" fuse, the only mode
    ported."""
    return feat.reshape(feat.shape[0], -1)


class VarTriPlaneEncoder(nn.Module):
    """Generated tri-planes: 3x Tensorial2D (noise 8x20x20 -> 16x160x160)."""

    def __init__(self, in_ch: int = 8, out_ch: int = 16, noise_res: int = 20,
                 fuse_mode: str = "cat", n_frames: int = 0,
                 strategy: str = "none", n_planes: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        if n_frames > 0 or n_planes != 3:
            raise NotImplementedError(
                "VarTriPlaneEncoder with frames or time planes: ROADMAP "
                "Queue 1 item 6")
        if fuse_mode != "cat":
            raise NotImplementedError(
                f"fuse mode {fuse_mode!r}: only 'cat' is ported")
        del strategy  # only the per-frame 4-D decoders read it
        self.out_dim = n_planes * out_ch
        self.n_planes = n_planes
        for i in range(n_planes):
            self.add_module(f"subs_{i}", Tensorial2D(
                in_ch, out_ch, noise_res, generator=generator))

    def planes(self) -> torch.Tensor:
        """All planes, [n_planes, C, H, W]. Independent of the points: run
        once and reuse across point batches."""
        return torch.cat([getattr(self, f"subs_{i}")()
                          for i in range(self.n_planes)], dim=0)

    def forward(self, pts: torch.Tensor,
                planes: torch.Tensor | None = None) -> torch.Tensor:
        if planes is None:
            planes = self.planes()
        # sample positions carry no gradient (the field conditions on
        # detached splat xyz), as in the JAX encoder
        pts = pts.detach()
        coords = torch.stack([pts[:, list(ax)] for ax in _SPACE_AXES])
        return _fuse(grid_sample_planes(planes, coords))
