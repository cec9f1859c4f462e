"""Feature encoders (counterpart of ``splatfields_tpu/models/encoders.py``).

Ported:

- ``VarTriPlaneEncoder``, the released-config encoder: one ``Tensorial2D``
  noise -> CNN generator per plane, planes regenerated on every call (for
  4-D scenes too: with ``strategy='none'`` they do not depend on the
  frame),
  sampled bilinearly (torch grid_sample semantics) at the xy / yz / zx
  coordinates and fused by concatenation (out_dim 3 * 16 = 48);
- ``HashGridEncoder`` and ``NGPMLP``, the NGP variant: a multi-resolution
  hash grid (dense levels indexed directly, the others by the instant-ngp
  xor-prime hash) gathered from the level-flattened f32 table, then a
  small ReLU MLP. The table's gradient is ``_SortedGather``'s VJP: one
  stable sort of the gathered row ids with the gradient rows as payload,
  then one ``ops/segsum.sorted_segment_sum`` over the whole table (the
  CUDA kernel on the card), never autograd's scatter.

The JAX package's bf16 gather source (``SPLATFIELDS_NGP_BF16_TABLE``) is
not ported: the port gathers from f32, the JAX package's CPU default. The
other encoders come with later slices (ROADMAP Queue 1 item 6, the
Hex/Tri/Grid encoders).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.decoder import Tensorial2D
from splatfields_torch.models.initializers import torch_linear_
from splatfields_torch.ops.grid_sample import grid_sample_planes
from splatfields_torch.ops.segsum import sorted_segment_sum

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
        if n_planes != 3:
            raise NotImplementedError(
                "VarTriPlaneEncoder with time planes: ROADMAP Queue 1 item "
                "6 (the Hex/Tri/Grid encoders)")
        if strategy == "per_frame" and n_frames > 1:
            raise NotImplementedError(
                "per-frame conv deltas (layer_strategy 'per_frame'): "
                "ROADMAP Queue 1 item 6 (per_frame TimeConv)")
        if fuse_mode != "cat":
            raise NotImplementedError(
                f"fuse mode {fuse_mode!r}: only 'cat' is ported")
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


# ---------------------------------------------------------------------------
# NGP hash-grid encoder
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def contract_mipnerf360(x: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Unbounded-scene contraction: points beyond ``radius`` go to the 1..2
    shell, then everything to the [0, 1] box."""
    x = x / radius
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    contracted = torch.where(norm <= 1.0, x, (2.0 - 1.0 / norm) * x / norm)
    return contracted * 0.25 + 0.5


def _sort_rows(ids: torch.Tensor, rows: torch.Tensor):
    """One stable sort of the row ids, the rows following as payload."""
    sidx, perm = torch.sort(ids, stable=True)
    return sidx, rows.index_select(0, perm)


class _SortedGather(torch.autograd.Function):
    """``table[ids]`` for a [R, F] table and [K] int32 row ids; the VJP
    sorts the ids with the gradient rows and sums them per row with
    ``sorted_segment_sum``: one launch for the whole table. (The JAX
    package scans the levels one at a time because the TPU kernel's packed
    operand ran out of device memory; the flat call computes the same
    sums.)"""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        sidx, rows = _sort_rows(ids, g)
        return sorted_segment_sum(sidx, rows, ctx.n_rows), None


class HashGridEncoder(nn.Module):
    """Multi-resolution hash grid, instant-ngp style: ``n_levels`` levels
    of ``n_features`` features, base resolution 16, per-level scale 1.5, a
    table of 2^log2_hashmap_size rows per level. Levels whose
    (res + 1)^3 grid fits the table index it directly."""

    def __init__(self, n_levels: int = 16, n_features: int = 2,
                 base_resolution: int = 16, per_level_scale: float = 1.5,
                 log2_hashmap_size: int = 19, *, generator: torch.Generator):
        super().__init__()
        self.n_levels, self.n_features = n_levels, n_features
        self.table_size = 2 ** log2_hashmap_size
        self.out_dim = n_levels * n_features
        self.table = nn.Parameter(torch.empty(
            n_levels, self.table_size, n_features).uniform_(
                -1e-4, 1e-4, generator=generator))
        res = np.floor(base_resolution * per_level_scale
                       ** np.arange(n_levels)).astype(np.int32)
        dense = (res.astype(np.int64) + 1) ** 3 <= self.table_size
        corners = [[(c >> k) & 1 for k in range(3)] for c in range(8)]
        # derived constants, not state: kept out of the state_dict
        for name, value in (
                ("res", torch.tensor(res, dtype=torch.float32)),
                ("rp1", torch.tensor(res.astype(np.int64) + 1)),
                ("dense", torch.tensor(dense)),
                ("level_offset", torch.arange(n_levels, dtype=torch.int32)
                 * self.table_size),
                ("corners", torch.tensor(corners, dtype=torch.int64))):
            self.register_buffer(name, value, persistent=False)

    def corner_ids(self, pts01: torch.Tensor):
        """-> (ids [L, N, 8] int32 into each level's table, the fractional
        position f [L, N, 3]). The hash runs in int64 with every product
        masked to 32 bits: the JAX package's uint32 arithmetic."""
        x = pts01[None, :, :] * self.res[:, None, None]       # [L, N, 3]
        x0 = torch.floor(x)
        f = x - x0
        c = x0.to(torch.int64)[:, :, None, :] + self.corners  # [L, N, 8, 3]
        cx, cy, cz = c.unbind(-1)
        rp1 = self.rp1[:, None, None]
        idx_dense = (cx + cy * rp1 + cz * rp1 * rp1) & _U32
        idx_hash = (((cx * _PRIMES[0]) & _U32) ^ ((cy * _PRIMES[1]) & _U32)
                    ^ ((cz * _PRIMES[2]) & _U32))
        idx = torch.where(self.dense[:, None, None], idx_dense, idx_hash)
        return (idx % self.table_size).to(torch.int32), f

    def forward(self, pts01: torch.Tensor) -> torch.Tensor:
        """pts01 [N, 3] in [0, 1] -> [N, n_levels * n_features]."""
        n = pts01.shape[0]
        ids, f = self.corner_ids(pts01)
        flat_ids = (ids + self.level_offset[:, None, None]).reshape(-1)
        gathered = _SortedGather.apply(
            self.table.reshape(-1, self.n_features), flat_ids).reshape(
                self.n_levels, n, 8, self.n_features)
        w = torch.where(self.corners.bool(), f[:, :, None, :],
                        1.0 - f[:, :, None, :]).prod(dim=-1)   # [L, N, 8]
        feats = (gathered * w[..., None]).sum(dim=2)           # [L, N, F]
        return feats.transpose(0, 1).reshape(n, self.out_dim)


class NGPMLP(nn.Module):
    """Hash grid + small ReLU MLP. Inputs are clipped into the [-radius,
    radius] box (or contracted, ``contract``) and mapped to [0, 1]."""

    def __init__(self, out_features: int = 16, hidden: int = 64,
                 n_hidden_layers: int = 1, n_levels: int = 16,
                 log2_hashmap_size: int = 19, radius: float = 1.0,
                 contract: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.radius, self.contract = radius, contract
        self.n_hidden_layers = n_hidden_layers
        self.out_dim = out_features
        self.encoding = HashGridEncoder(
            n_levels=n_levels, log2_hashmap_size=log2_hashmap_size,
            generator=generator)
        fin = self.encoding.out_dim
        for i in range(n_hidden_layers):
            self.add_module(f"hidden_{i}", nn.Linear(fin, hidden))
            layer = getattr(self, f"hidden_{i}")
            torch_linear_(layer.weight, layer.bias, fin, generator)
            fin = hidden
        self.out = nn.Linear(fin, out_features)
        torch_linear_(self.out.weight, self.out.bias, fin, generator)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        if self.contract:
            x01 = contract_mipnerf360(pts, self.radius)
        else:
            x01 = torch.clamp(pts / (2.0 * self.radius) + 0.5, 0.0, 1.0)
        h = self.encoding(x01)
        for i in range(self.n_hidden_layers):
            h = F.relu(getattr(self, f"hidden_{i}")(h))
        return self.out(h)
