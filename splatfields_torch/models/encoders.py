"""Feature encoders (counterpart of ``splatfields_tpu/models/encoders.py``).

- ``TriPlaneEncoder``: learned [3, C, R, R] planes, N(0, 1), sampled at the
  xy / yz / zx coordinates;
- ``HexPlaneEncoder``: those planes plus xt / yt / zt time planes
  initialised to ones, sampled at space-time points (a 4th coordinate
  ``input_time[:1] * 0.8`` is appended to 3-D points; 3-D points with no
  time raise, as the JAX assert does);
- ``GridEncoder``: a learned [C, R, R, R] grid, N(0, 1), sampled
  trilinearly; ``VarGridEncoder``: the grid generated by ``Tensorial3D``;
- ``VarTriPlaneEncoder``, the released-config encoder: one ``Tensorial2D``
  noise -> CNN generator per plane (3 space planes, then time planes for
  ``n_planes > 3``), planes regenerated on every call unless the caller
  passes them (``planes(frame_id)`` once a step); ``VarHexPlaneEncoder``:
  six generated planes for 4-D points. With ``strategy='per_frame'`` the
  generated planes depend on the frame;
- ``HashGridEncoder`` and ``NGPMLP``, the NGP variant: a multi-resolution
  hash grid (dense levels indexed directly, the others by the instant-ngp
  xor-prime hash) gathered from the level-flattened f32 table, then a
  small ReLU MLP. On the card the table's gradient is
  ``_SortedGather``'s VJP: one stable sort of the gathered row ids with
  the gradient rows as payload, then one ``ops/segsum.sorted_segment_sum``
  over the whole table (the CUDA kernel), not autograd's scatter.

Sampling is torch's grid_sample (bilinear, zeros padding,
align_corners=False) unless a plane option below says otherwise. The
plane features [N, P, C] are fused by ``_fuse``'s modes with the JAX
package's quirks: ``add`` and ``mean`` both sum, ``space_cat`` is space
planes times time planes. ``out_dim`` is the
JAX property, which for VarTriPlane's ``space_cat`` says C although the
fuse returns 3C; ``width`` is what ``forward`` returns, and the field's
first refine layer reads that. The generated encoders sample at detached
points (the JAX ``stop_gradient``). A time axis of a VarTriPlane with
``n_planes > 3`` reads coordinate 3; on 3-D points that index is past the
last column, which JAX clamps to z, and so does the port.

The hash grid gathers from a bf16 copy of the f32 table by the JAX
package's ``SPLATFIELDS_NGP_BF16_TABLE`` rule (``ngp_bf16_table``: on for
CUDA tensors under ``auto``); the gradient stays f32 through the sorted
segment sum. ``SPLATFIELDS_NGP_SORTED_GRAD`` picks the table's VJP as the
JAX package does: ``on`` is ``_SortedGather``, ``off`` the plain gather
(f32, autograd's scatter), and ``auto`` (the default and any other value)
``_SortedGather`` for CUDA tables and the scatter for CPU ones. The bf16
source applies to ``_SortedGather`` only, as in JAX.

The generated encoders (VarTriPlane, VarHexPlane; not TriPlane or
HexPlane, as in JAX) take the JAX package's plane options, each read once
when the encoder is built (``PlaneOptions``), with JAX's names and values:

- ``SPLATFIELDS_QUAD_SAMPLE``: ``off`` samples with ``F.grid_sample`` and
  ignores the options below; any other value samples through the quad
  table (``ops/grid_sample.grid_sample_2d_quad``). One difference from
  JAX is kept on purpose: unset, with none of the options below on, the
  port keeps ``F.grid_sample``, the same function as JAX's default quad
  route, so that the port's default path stays as it was. Unset with any
  option below on, or set to anything but ``off``, takes the quad route.
- ``SPLATFIELDS_PLANE_BF16=on``: the quad table is rounded to bf16 inside
  the forward; the plane gradient stays f32.
- ``SPLATFIELDS_QUAD_MULTI=on`` (with ``SPLATFIELDS_QUAD_SAMPLE`` unset or
  ``on``): every plane's table in one, one gather and one VJP for all.
- ``SPLATFIELDS_PLANE_GRAD_PALLAS=on``: the table's VJP through the
  sorted segment sum (``csrc/segsum.cu`` on the card);
  ``SPLATFIELDS_SORTED_PLANE_GRAD=on``: through the scatter-free f32
  prefix sums. Both on raises ``ValueError`` when the encoder is built.
- ``SPLATFIELDS_PACKED_CNN=on`` (VarTriPlane only, as in JAX): the
  ``n_planes`` decoders run as one channel-packed ``Tensorial2D``
  (``subs_packed``, ``n_packs=n_planes``: grouped convs, ``gn * P``
  GroupNorm groups, block-diagonal attention); ``planes()`` un-packs its
  pack-major channels. Its parameters are those of the JAX package's
  packed tree, so a ``deform.msgpack`` written under the option loads
  under the option.
- ``SPLATFIELDS_CNN_BF16=on``: bf16 convs in the decoders
  (``models/decoder.py``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.decoder import Tensorial2D, Tensorial3D
from splatfields_torch.models.initializers import torch_linear_
from splatfields_torch.ops.grid_sample import (
    grid_sample_2d_quad,
    grid_sample_2d_quad_multi,
    grid_sample_3d,
    grid_sample_planes,
    plane_grad_route,
)
from splatfields_torch.ops.segsum import sorted_segment_sum

_SPACE_AXES = ((0, 1), (1, 2), (2, 0))   # xy, yz, zx
_TIME_AXES = ((0, 3), (1, 3), (2, 3))    # xt, yt, zt
FUSE_MODES = ("cat", "add", "mean", "space_cat")


def _fuse(feat: torch.Tensor, mode: str) -> torch.Tensor:
    """[N, n_planes, C] -> [N, F]: "cat" concatenates, "add" and "mean"
    both sum, "space_cat" multiplies the space planes 0:3 by the planes
    3: (broadcast) and concatenates."""
    if mode == "cat":
        return feat.reshape(feat.shape[0], -1)
    if mode in ("add", "mean"):
        return feat.sum(dim=1)
    if mode == "space_cat":
        return (feat[:, 0:3] * feat[:, 3:]).reshape(feat.shape[0], -1)
    raise NotImplementedError(mode)


def fuse_width(mode: str, n_planes: int, channels: int) -> int:
    """The width ``_fuse`` returns for ``n_planes`` planes of ``channels``."""
    if mode == "cat":
        return n_planes * channels
    if mode in ("add", "mean"):
        return channels
    if mode == "space_cat" and n_planes - 3 in (1, 3):
        return 3 * channels
    raise NotImplementedError(f"fuse mode {mode!r} over {n_planes} planes")


def _coords(pts: torch.Tensor, axes) -> torch.Tensor:
    """The per-plane columns ``axes`` of ``pts`` (an index past the last
    column reads the last, as JAX clamps it) -> [P, N, 2]."""
    last = pts.shape[1] - 1
    return torch.stack([pts[:, [min(a, last) for a in ax]] for ax in axes])


def _sample(planes: torch.Tensor, pts: torch.Tensor, axes) -> torch.Tensor:
    """Planes [P, C, H, W] at the per-plane columns ``axes`` of ``pts`` ->
    [N, P, C]."""
    return grid_sample_planes(planes, _coords(pts, axes))


def _on(name: str) -> bool:
    return os.environ.get(name, "off") == "on"


@dataclasses.dataclass(frozen=True)
class PlaneOptions:
    """The generated encoders' plane options, read from the environment
    once (``read``): ``quad`` samples through the quad table, with
    ``gather_dtype`` (bf16 or None), ``multi`` (one table for every plane)
    and ``grad`` (the table VJP's route, ``ops/grid_sample.GRAD_ROUTES``);
    ``packed`` runs VarTriPlane's decoders as one channel-packed net."""
    quad: bool = False
    gather_dtype: torch.dtype | None = None
    multi: bool = False
    grad: str = "scatter"
    packed: bool = False

    @classmethod
    def read(cls) -> "PlaneOptions":
        env = os.environ.get("SPLATFIELDS_QUAD_SAMPLE")
        subs = ("SPLATFIELDS_PLANE_BF16", "SPLATFIELDS_QUAD_MULTI",
                "SPLATFIELDS_PLANE_GRAD_PALLAS",
                "SPLATFIELDS_SORTED_PLANE_GRAD")
        packed = _on("SPLATFIELDS_PACKED_CNN")
        if env == "off" or (env is None and not any(map(_on, subs))):
            return cls(packed=packed)
        return cls(quad=True,
                   gather_dtype=(torch.bfloat16
                                 if _on("SPLATFIELDS_PLANE_BF16") else None),
                   multi=(_on("SPLATFIELDS_QUAD_MULTI")
                          and env in (None, "on")),
                   grad=plane_grad_route(), packed=packed)

    def sample(self, planes: torch.Tensor, pts: torch.Tensor,
               axes) -> torch.Tensor:
        """Planes [P, C, H, W] at the per-plane columns ``axes`` of the
        (detached) points ``pts`` -> [N, P, C]."""
        if not self.quad:
            return _sample(planes, pts, axes)
        coords = _coords(pts, axes)
        if self.multi:
            return grid_sample_2d_quad_multi(planes, coords,
                                             self.gather_dtype, self.grad)
        return torch.stack([grid_sample_2d_quad(planes[i], coords[i],
                                                self.gather_dtype, self.grad)
                            for i in range(planes.shape[0])], dim=1)


def _with_time(pts: torch.Tensor, input_time) -> torch.Tensor:
    """Space-time points: 3-D points gain ``input_time[:1] * 0.8`` as a
    4th coordinate; anything but 4-D points then raises."""
    if pts.shape[-1] == 3 and input_time is not None:
        t = (input_time.reshape(-1)[:1] * 0.8).expand(pts.shape[0], 1)
        pts = torch.cat([pts, t], dim=-1)
    if pts.shape[-1] != 4:
        raise ValueError("HexPlane encoders take space-time points (4-D, "
                         "or 3-D with input_time)")
    return pts


def _normal_param(shape, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(*shape, generator=generator))


class TriPlaneEncoder(nn.Module):
    """Learned tri-planes [3, C, R, R], N(0, 1)."""

    def __init__(self, resolution: int = 200, channels: int = 16,
                 fuse_mode: str = "cat", *, generator: torch.Generator):
        super().__init__()
        self.fuse_mode = fuse_mode
        self.out_dim = 3 * channels if fuse_mode == "cat" else channels
        self.width = fuse_width(fuse_mode, 3, channels)
        self.planes = _normal_param((3, channels, resolution, resolution),
                                    generator)

    def forward(self, pts, input_time=None, frame_id=None):
        return _fuse(_sample(self.planes, pts, _SPACE_AXES), self.fuse_mode)


class HexPlaneEncoder(nn.Module):
    """Learned space planes [3, C, R, R], N(0, 1), and time planes, ones."""

    def __init__(self, resolution: int = 200, channels: int = 16,
                 fuse_mode: str = "cat", *, generator: torch.Generator):
        super().__init__()
        self.fuse_mode = fuse_mode
        self.out_dim = self.width = fuse_width(fuse_mode, 6, channels)
        self.planes = _normal_param((3, channels, resolution, resolution),
                                    generator)
        self.time_planes = nn.Parameter(
            torch.ones(3, channels, resolution, resolution))

    def forward(self, pts, input_time=None, frame_id=None):
        pts = _with_time(pts, input_time)
        planes = torch.cat([self.planes, self.time_planes], dim=0)
        return _fuse(_sample(planes, pts, _SPACE_AXES + _TIME_AXES),
                     self.fuse_mode)


class GridEncoder(nn.Module):
    """A learned grid [C, R, R, R], N(0, 1), sampled trilinearly."""

    def __init__(self, resolution: int = 128, channels: int = 24, *,
                 generator: torch.Generator):
        super().__init__()
        self.out_dim = self.width = channels
        self.grid = _normal_param((channels, resolution, resolution,
                                   resolution), generator)

    def forward(self, pts, input_time=None, frame_id=None):
        return grid_sample_3d(self.grid, pts)


class VarGridEncoder(nn.Module):
    """A grid generated by ``Tensorial3D`` from frozen noise (8r cells a
    side), sampled trilinearly."""

    def __init__(self, in_ch: int = 8, out_ch: int = 16, noise_res: int = 4,
                 *, generator: torch.Generator):
        super().__init__()
        self.out_dim = self.width = out_ch
        self.net = Tensorial3D(in_ch, out_ch, noise_res, generator=generator)

    def forward(self, pts, input_time=None, frame_id=None):
        return grid_sample_3d(self.net()[0], pts)


class _GeneratedPlanes(nn.Module):
    """``n_planes`` Tensorial2D generators ``subs_<i>`` (or, ``packed``,
    one ``subs_packed`` of ``n_planes`` packs) sampled at ``axes`` by the
    plane options read when the encoder is built."""

    def __init__(self, n_planes, axes, in_ch, out_ch, noise_res, fuse_mode,
                 n_frames, strategy, generator, packable=False):
        super().__init__()
        self.n_planes, self.axes, self.fuse_mode = n_planes, axes, fuse_mode
        self.out_ch = out_ch
        self.width = fuse_width(fuse_mode, n_planes, out_ch)
        self.options = PlaneOptions.read()
        self.packed = packable and self.options.packed
        tc = dict(n_frames=n_frames, strategy=strategy, generator=generator)
        if self.packed:
            self.subs_packed = Tensorial2D(in_ch, out_ch, noise_res,
                                           n_packs=n_planes, **tc)
            return
        for i in range(n_planes):
            self.add_module(f"subs_{i}", Tensorial2D(in_ch, out_ch, noise_res,
                                                     **tc))

    def planes(self, frame_id: int | None = None) -> torch.Tensor:
        """All planes, [n_planes, C, H, W]. Independent of the points: run
        once a step and reuse across point batches."""
        if self.packed:   # [1, P*C, H, W], pack-major
            out = self.subs_packed(frame_id)
            return out.reshape(self.n_planes, self.out_ch, *out.shape[2:])
        return torch.cat([getattr(self, f"subs_{i}")(frame_id)
                          for i in range(self.n_planes)], dim=0)

    def _features(self, pts, frame_id, planes):
        if planes is None:
            planes = self.planes(frame_id)
        # sample positions carry no gradient (the field conditions on
        # detached splat xyz), as in the JAX encoder
        return _fuse(self.options.sample(planes, pts.detach(), self.axes),
                     self.fuse_mode)


class VarTriPlaneEncoder(_GeneratedPlanes):
    """Generated planes: n_planes x Tensorial2D (noise 8x20x20 ->
    16x160x160), the space planes, then time planes past 3; one packed
    Tensorial2D under ``SPLATFIELDS_PACKED_CNN=on``."""

    def __init__(self, in_ch: int = 8, out_ch: int = 16, noise_res: int = 20,
                 fuse_mode: str = "cat", n_frames: int = 0,
                 strategy: str = "none", n_planes: int = 3, *,
                 generator: torch.Generator):
        super().__init__(n_planes,
                         _SPACE_AXES[:n_planes] + _TIME_AXES[:n_planes - 3],
                         in_ch, out_ch, noise_res, fuse_mode, n_frames,
                         strategy, generator, packable=True)
        self.out_dim = n_planes * out_ch if fuse_mode == "cat" else out_ch

    def forward(self, pts, input_time=None, frame_id=None, planes=None):
        return self._features(pts, frame_id, planes)


class VarHexPlaneEncoder(_GeneratedPlanes):
    """Six generated planes (xy / yz / zx, xt / yt / zt) for 4-D points
    (no packed form, as in JAX)."""

    def __init__(self, in_ch: int = 8, out_ch: int = 16, noise_res: int = 20,
                 fuse_mode: str = "cat", n_frames: int = 0,
                 strategy: str = "none", *, generator: torch.Generator):
        super().__init__(6, _SPACE_AXES + _TIME_AXES, in_ch, out_ch,
                         noise_res, fuse_mode, n_frames, strategy, generator)
        self.out_dim = self.width

    def forward(self, pts, input_time=None, frame_id=None, planes=None):
        return self._features(_with_time(pts, input_time), frame_id, planes)


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


def ngp_sorted_grad(env: str, table: torch.Tensor) -> bool:
    """``SPLATFIELDS_NGP_SORTED_GRAD``'s rule (JAX ``models/encoders.py:
    455-459``) for the value ``env`` read when the encoder was built:
    ``on``, ``off``, or ``auto`` (the default and any other value), which
    takes the sorted VJP off the CPU: for CUDA tables."""
    return env == "on" or (env != "off" and table.is_cuda)


def ngp_bf16_table(table: torch.Tensor) -> bool:
    """``SPLATFIELDS_NGP_BF16_TABLE``'s rule (JAX ``models/encoders.py:
    67-70``): ``on``, ``off``, or ``auto`` (the default and any other
    value), which gathers from bf16 off the CPU: for CUDA tensors."""
    env = os.environ.get("SPLATFIELDS_NGP_BF16_TABLE", "auto")
    return env == "on" or (env == "auto" and table.is_cuda)


class _SortedGather(torch.autograd.Function):
    """``table[ids]`` for a [R, F] table and [K] int32 row ids; the VJP
    sorts the ids with the gradient rows and sums them per row with
    ``sorted_segment_sum``: one launch for the whole table. (The JAX
    package scans the levels one at a time because the TPU kernel's packed
    operand ran out of device memory; the flat call computes the same
    sums.)"""

    @staticmethod
    def forward(ctx, table, ids, bf16_source=False):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        if bf16_source:
            return table.to(torch.bfloat16).index_select(0, ids).float()
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        sidx, rows = _sort_rows(ids, g)
        return sorted_segment_sum(sidx, rows, ctx.n_rows), None, None


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
        self.sorted_grad = os.environ.get("SPLATFIELDS_NGP_SORTED_GRAD",
                                          "auto")
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
        flat = self.table.reshape(-1, self.n_features)
        if ngp_sorted_grad(self.sorted_grad, self.table):
            gathered = _SortedGather.apply(flat, flat_ids,
                                           ngp_bf16_table(self.table))
        else:   # JAX's plain gather: f32, autograd's scatter
            gathered = flat.index_select(0, flat_ids)
        gathered = gathered.reshape(self.n_levels, n, 8, self.n_features)
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
        self.out_dim = self.width = out_features
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

    def forward(self, pts: torch.Tensor, input_time=None,
                frame_id=None) -> torch.Tensor:
        if self.contract:
            x01 = contract_mipnerf360(pts, self.radius)
        else:
            x01 = torch.clamp(pts / (2.0 * self.radius) + 0.5, 0.0, 1.0)
        h = self.encoding(x01)
        for i in range(self.n_hidden_layers):
            h = F.relu(getattr(self, f"hidden_{i}")(h))
        return self.out(h)
