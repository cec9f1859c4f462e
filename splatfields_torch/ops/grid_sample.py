"""Bilinear and trilinear sampling with ``torch.nn.functional.grid_sample``
semantics (counterpart of ``splatfields_tpu/ops/grid_sample.py``).

The JAX package re-implements grid_sample for the TPU; here PyTorch's own
op is the default: bilinear (trilinear on a 5-D input), zeros padding,
align_corners=False.

The JAX package's quad sampler is here too, for the generated encoders'
plane options (``models/encoders.py``): ``pack_quad_rows`` lays a [C, H, W]
plane out as an [H*W, 4C] table whose row (y, x) holds the four bilinear
corners, so a point's sample is one row gather (``_quad_weights`` routes
the edge cells). Its VJP treats the coordinates as constants (their
cotangent is zero, as in JAX) and sums the per-point rows into the table
by one of three routes, each the JAX package's:

- ``"scatter"`` (the default): one ``index_add_`` of the expanded rows;
- ``"segsum"`` (``SPLATFIELDS_PLANE_GRAD_PALLAS=on``): a stable sort of
  the slots by table row, one gather of the narrow (g | w4) pack, the
  expansion, then ``ops/segsum.sorted_segment_sum``, which launches
  ``csrc/segsum.cu`` on CUDA tensors: a deterministic sum, where
  ``index_add_`` adds with atomics;
- ``"cumsum"`` (``SPLATFIELDS_SORTED_PLANE_GRAD=on``): scatter-free, by a
  stable sort, one gather, an f32 running sum and prefix differences at
  the rows' edges (``segment_rows_sum``; its error is absolute, on the
  order of the running sum, and grows with the number of points).

Both sorts are stable (``torch.sort(..., stable=True)``, as ``lax.sort``
is), so each row's terms are added in slot order.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from splatfields_torch.ops.segsum import sorted_segment_sum

GRAD_ROUTES = ("scatter", "segsum", "cumsum")


def grid_sample_planes(planes: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Sample P same-size planes [P, C, H, W] at per-plane normalized (x, y)
    coords [P, N, 2] (x indexes W) -> [N, P, C]."""
    out = F.grid_sample(planes, coords[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0].permute(2, 0, 1)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Sample a [C, D, H, W] grid at [N, 3] normalized (x, y, z) coords
    (x indexes W, y H, z D) -> [N, C]. ``padding_mode``: "zeros" or
    "border"."""
    out = F.grid_sample(grid[None], coords[None, :, None, None, :],
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out[0, :, :, 0, 0].t()


def plane_grad_route() -> str:
    """The quad table's VJP route from ``SPLATFIELDS_SORTED_PLANE_GRAD``
    and ``SPLATFIELDS_PLANE_GRAD_PALLAS`` (each ``on`` or, by default,
    off). Both on raises the JAX package's ``ValueError``."""
    cumsum = os.environ.get("SPLATFIELDS_SORTED_PLANE_GRAD", "off") == "on"
    segsum = os.environ.get("SPLATFIELDS_PLANE_GRAD_PALLAS", "off") == "on"
    if cumsum and segsum:
        raise ValueError(
            "SPLATFIELDS_SORTED_PLANE_GRAD and SPLATFIELDS_PLANE_GRAD_PALLAS"
            " are both 'on'; they select alternative plane-grad VJPs —"
            " enable at most one (both are read when the encoder is built).")
    return "cumsum" if cumsum else "segsum" if segsum else "scatter"


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel index space, align_corners=False."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _quad_weights(c: torch.Tensor, size: int):
    """Per-axis (low, high) sub-row weights and the clipped floor cell.

    A point whose floor cell is i0 weights the row's halves (w0, w1);
    i0 == -1 reads cell 0's first half, its i1 corner, with w1; i0 ==
    size - 1 reads no second half (the table's zero pad); floors outside
    [-1, size - 1] get (0, 0): zeros padding."""
    i = torch.floor(c)
    w1 = c - i
    w0 = 1.0 - w1
    zero = torch.zeros_like(c)
    a0 = (torch.where((i >= 0) & (i <= size - 1), w0, zero)
          + torch.where(i == -1, w1, zero))
    a1 = torch.where((i >= 0) & (i <= size - 2), w1, zero)
    ic = torch.clamp(i, 0, size - 1).to(torch.int32)
    return a0, a1, ic


def pack_quad_rows(plane: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> the [H*W, 4C] quad table: row (y, x) holds [P(y, x),
    P(y, x+1), P(y+1, x), P(y+1, x+1)], zero past the bottom and right
    edges. Differentiable: the table's gradient flows back to the plane."""
    c, h, w = plane.shape
    p = plane.permute(1, 2, 0)                       # [H, W, C]
    zx = p.new_zeros(h, 1, c)
    zy = p.new_zeros(1, w, c)
    pr = torch.cat([p[:, 1:], zx], dim=1)
    pd = torch.cat([p[1:], zy], dim=0)
    pdr = torch.cat([pd[:, 1:], zx], dim=1)
    return torch.cat([p, pr, pd, pdr], dim=-1).reshape(h * w, 4 * c)


def quad_idx_w(coords: torch.Tensor, h: int, w: int):
    """[N, 2] normalized (x, y) -> (table rows [N] int32, corner weights
    [N, 4] in the table's corner order)."""
    a0, a1, ixc = _quad_weights(_unnormalize(coords[:, 0], w), w)
    b0, b1, iyc = _quad_weights(_unnormalize(coords[:, 1], h), h)
    w4 = torch.stack([a0 * b0, a1 * b0, a0 * b1, a1 * b1], dim=1)
    return iyc * w + ixc, w4


def _expand(g: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """Per-point table rows of the VJP: [N, C] x [N, 4] -> [N, 4C]."""
    return (g[:, None, :] * w4[:, :, None]).reshape(g.shape[0], -1)


def segment_rows_sum(idx: torch.Tensor, packed: torch.Tensor, n_rows: int,
                     c: int) -> torch.Tensor:
    """Scatter-free sum of the per-point (g | w4) rows ``packed`` [N, C+4]
    into ``n_rows`` table rows (JAX ``_segment_rows_sum``): a stable sort
    of the slots, one gather of the narrow pack, the expansion, an f32
    running sum, and per row the difference of the running sum at its
    edges (``searchsorted``). The error of a row is absolute, on the order
    of the running sum where the row lies, which grows with N."""
    sidx, order = torch.sort(idx, stable=True)
    sp = packed.index_select(0, order)
    rows = _expand(sp[:, :c], sp[:, c:])
    csum = torch.cumsum(rows, dim=0, dtype=torch.float32)
    csum0 = torch.cat([csum.new_zeros(1, 4 * c), csum], dim=0)
    bounds = torch.searchsorted(
        sidx, torch.arange(n_rows + 1, dtype=sidx.dtype, device=idx.device),
        side="left")
    seg = csum0.index_select(0, bounds)
    return seg[1:] - seg[:-1]


def quad_table_grad(route: str, idx: torch.Tensor, w4: torch.Tensor,
                    g: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The quad table's gradient [n_rows, 4C] from the sample's cotangent
    ``g`` [N, C] by ``route`` (``GRAD_ROUTES``)."""
    c = g.shape[1]
    if route == "cumsum":
        return segment_rows_sum(idx, torch.cat([g, w4], dim=1), n_rows,
                                c).to(g.dtype)
    if route == "segsum":
        sidx, order = torch.sort(idx, stable=True)
        sp = torch.cat([g, w4], dim=1).index_select(0, order)
        return sorted_segment_sum(sidx, _expand(sp[:, :c], sp[:, c:]),
                                  n_rows).to(g.dtype)
    if route != "scatter":
        raise ValueError(route)
    out = g.new_zeros(n_rows, 4 * c)
    return out.index_add_(0, idx.to(torch.int64), _expand(g, w4))


class _QuadSample(torch.autograd.Function):
    """One row gather of the quad table at precomputed (idx, w4) -> [N, C];
    ``gather_dtype`` (bf16) rounds the table inside the forward only, so
    the table's gradient stays f32. The VJP goes to the table alone."""

    @staticmethod
    def forward(ctx, quad_rows, idx, w4, gather_dtype, route):
        ctx.save_for_backward(idx, w4)
        ctx.n_rows, ctx.route = quad_rows.shape[0], route
        src = quad_rows if gather_dtype is None else quad_rows.to(
            gather_dtype)
        rows = src.index_select(0, idx).float()
        n, c = idx.shape[0], quad_rows.shape[1] // 4
        return (rows.reshape(n, 4, c) * w4[:, :, None]).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        idx, w4 = ctx.saved_tensors
        grad = quad_table_grad(ctx.route, idx, w4, g.contiguous(),
                               ctx.n_rows)
        return grad, None, None, None, None


def quad_sample(quad_rows: torch.Tensor, coords: torch.Tensor, h: int,
                w: int, gather_dtype=None, route: str = "scatter"):
    """Sample the quad table of an h x w plane at [N, 2] coords -> [N, C]."""
    idx, w4 = quad_idx_w(coords, h, w)
    return _QuadSample.apply(quad_rows, idx, w4, gather_dtype, route)


def grid_sample_2d_quad(plane: torch.Tensor, coords: torch.Tensor,
                        gather_dtype=None,
                        route: str = "scatter") -> torch.Tensor:
    """``grid_sample`` of a [C, H, W] plane at [N, 2] coords (zeros
    padding, align_corners=False) through its quad table -> [N, C]; the
    coordinates carry no gradient."""
    _, h, w = plane.shape
    return quad_sample(pack_quad_rows(plane), coords, h, w, gather_dtype,
                       route)


def grid_sample_2d_quad_multi(planes: torch.Tensor, coords_list,
                              gather_dtype=None,
                              route: str = "scatter") -> torch.Tensor:
    """P same-size planes [P, C, H, W] at per-plane [N, 2] coords through
    one table of all P quad tables stacked: one gather and one VJP for the
    set -> [N, P, C]."""
    p, c, h, w = planes.shape
    tables = torch.cat([pack_quad_rows(planes[i]) for i in range(p)], dim=0)
    idxs, ws = [], []
    for i, coords in enumerate(coords_list):
        idx, w4 = quad_idx_w(coords, h, w)
        idxs.append(idx + i * h * w)
        ws.append(w4)
    out = _QuadSample.apply(tables, torch.cat(idxs), torch.cat(ws),
                            gather_dtype, route)
    return out.reshape(p, -1, c).transpose(0, 1)


def quad_rows_grad_to_plane(grad_quad: torch.Tensor, h: int,
                            w: int) -> torch.Tensor:
    """Fold an [H*W, 4C] quad-table cotangent back to the [C, H, W] plane:
    cell (y, x) appears in the rows (y, x), (y, x-1), (y-1, x) and (y-1,
    x-1)."""
    c = grad_quad.shape[1] // 4
    gq = grad_quad.reshape(h, w, 4, c)
    out = gq[..., 0, :].clone()
    out[:, 1:] += gq[:, :-1, 1]
    out[1:] += gq[:-1, :, 2]
    out[1:, 1:] += gq[:-1, :-1, 3]
    return out.permute(2, 0, 1)
