"""Ring exchange of Gaussian blocks against fixed tile slices
(counterpart of ``splatfields_tpu/parallel/ring.py``).

The default sharded step gathers every attribute, so every rank holds
all N splats for a moment. Here each rank keeps its fixed slice of the
tile grid and its own 1 / n_model block of the attributes, and the blocks
travel the ``model`` ring (``n_model - 1`` hops, ``dist.batch_isend_irecv``
to the next rank, from the previous). At each hop a rank preprocesses the
block it holds, duplicates it into per-tile instances, keeps those in its
own tiles and appends their packed rows. After the ring one local sort by
(tile, depth, global Gaussian id) gives exactly ``bin_gaussians``'s order
(equal depths tie by id in both), and the blend reads the rows directly.

Everything is differentiable: the block moves through ``_RingShift``,
whose backward is the reverse exchange, so each block's gradient returns
to its owner, the screen-offset carrier's too; the instance selection and
the order are index gathers of detached permutations; the blend keeps its
VJP. The eager port keeps every instance of the slice (the JAX version's
static buffer drops instances past ``ring_keep``); each block's
duplication budget is ``dup_factor`` times its rows, as in JAX.

Losses over all splats (the norms, Moran) still need a gather: the step
gathers only what the active terms read.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from splatfields_torch import train_lib
from splatfields_torch.ops.raster.api import RenderOut
from splatfields_torch.ops.raster.binning import (
    _orderable,
    duplicate_instances,
)
from splatfields_torch.ops.raster.blend_cuda import blend_fwd
from splatfields_torch.ops.raster.blend_torch import PACK_WIDTH, pack_attributes
from splatfields_torch.ops.raster.preprocess import preprocess
from splatfields_torch.parallel.step import gather_image, tile_slice

_BLOCK_KEYS = ("means3d", "scales", "rotations", "opacity", "rgb", "shs",
               "rgb_feat")


def _exchange(x: torch.Tensor, mesh, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` places along the model ring (+1: to the next
    rank) and receive the block from the other side."""
    n, me = mesh.n_model, mesh.model_index
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, mesh.model_rank((me + step) % n)),
           dist.P2POp(dist.irecv, out, mesh.model_rank((me - step) % n))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One hop forward; the cotangent goes one hop back to the sender."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _exchange(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, -1), None


def _pack_block(attrs, offset):
    """The attributes a render reads, the offset carrier and the valid
    mask as one [c, F] float tensor, with the layout to unpack it."""
    c = attrs["means3d"].shape[0]
    keys = [k for k in _BLOCK_KEYS if k in attrs]
    parts = [attrs[k].reshape(c, -1) for k in keys]
    parts += [offset, attrs["valid"].to(torch.float32)[:, None]]
    layout = [(k, attrs[k].shape[1:]) for k in keys]
    layout += [("_offset", offset.shape[1:]), ("valid", (1,))]
    return torch.cat(parts, dim=1), layout


def _unpack_block(block, layout):
    c, out, at = block.shape[0], {}, 0
    for k, shape in layout:
        width = int(torch.tensor(shape).prod()) if len(shape) else 1
        out[k] = block[:, at:at + width].reshape((c,) + tuple(shape))
        at += width
    out["valid"] = out["valid"][:, 0] > 0.5
    return out


def ring_render_view(attrs_local, cam, bg, width, height, sh_degree, pipe,
                     mesh, screenspace_offset, net=None,
                     params=None) -> RenderOut:
    """One view: Gaussian blocks ring-exchanged over ``model``, the tile
    grid statically sliced per rank. ``attrs_local``: this rank's chunk;
    ``screenspace_offset``: its [c_loc, 2] zero carrier, whose gradient
    comes home through the reverse exchange. ``radii`` cover the local
    chunk."""
    n_model, me = mesh.n_model, mesh.model_index
    ts = pipe.tile_size
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    num_tiles = tiles_x * tiles_y
    t0, t_loc = tile_slice(num_tiles, n_model, me)
    c_loc = attrs_local["means3d"].shape[0]
    pre_cap = pipe.dup_factor * c_loc
    dev = attrs_local["means3d"].device
    block, layout = _pack_block(attrs_local, screenspace_offset)
    rows_l, tile_l, depth_l, gid_l = [], [], [], []
    n_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    radii_local = None
    for s in range(n_model):
        b = _unpack_block(block, layout)
        pre = preprocess(
            b["means3d"], b["scales"], b["rotations"], b["opacity"],
            cam["viewmatrix"], cam["projmatrix"], width, height,
            float(cam["tanfovx"]), float(cam["tanfovy"]),
            colors_precomp=train_lib.view_colors(b, cam["campos"], net,
                                                 params),
            shs=b.get("shs"), sh_degree=sh_degree, campos=cam["campos"],
            valid_mask=b["valid"])
        scale_vec = pre.means2d.new_tensor([0.5 * width, 0.5 * height])
        means2d = pre.means2d + b["_offset"] * scale_vec[None, :]
        if s == 0:
            radii_local = pre.radii
        tile, gid, total, _ = duplicate_instances(
            means2d.detach(), pre.depths.detach(), pre.radii, tiles_x,
            tiles_y, ts, pre_cap)
        mine = torch.nonzero((tile >= t0) & (tile < t0 + t_loc)
                             & (gid >= 0))[:, 0]
        sel = gid[mine]
        pack = pack_attributes(means2d, pre.conics, pre.rgb, pre.opacity,
                               pre.depths)
        rows_l.append(pack[sel])
        tile_l.append(tile[mine] - t0)
        depth_l.append(pre.depths.detach()[sel].to(torch.float32))
        owner = (me - s) % n_model
        gid_l.append(owner * c_loc + sel)
        n_dropped = n_dropped + torch.clamp_min(total - pre_cap, 0)
        if s + 1 < n_model:
            block = _RingShift.apply(block, mesh)

    # a sentinel row past the last tile keeps the buffer non-empty
    rows_l.append(block.new_zeros(1, PACK_WIDTH))
    tile_l.append(torch.full((1,), t_loc, dtype=torch.int64, device=dev))
    depth_l.append(torch.zeros(1, device=dev))
    gid_l.append(torch.zeros(1, dtype=torch.int64, device=dev))
    rows, tiles = torch.cat(rows_l), torch.cat(tile_l)
    depth, gids = torch.cat(depth_l), torch.cat(gid_l)
    # (tile, depth, global id): id order first, then one stable sort
    order = torch.argsort(gids, stable=True)
    key = tiles[order] * 2 ** 32 + _orderable(depth[order])
    order = order[torch.sort(key, stable=True).indices]
    sorted_tile = tiles[order]
    tile_start = torch.searchsorted(
        sorted_tile, torch.arange(t_loc + 1, device=dev),
        right=False).to(torch.int32)
    counts = tile_start[1:] - tile_start[:-1]
    ids = torch.clamp_max(t0 + torch.arange(t_loc, dtype=torch.int32,
                                            device=dev), num_tiles - 1)
    color_t, depth_t, tfinal_t = blend_fwd(
        rows[order], tile_start, counts, tiles_x, tiles_y, ts,
        pipe.tile_cap, pipe.k_chunk, tile_ids=ids)
    color, depth_img, alpha = gather_image(color_t, depth_t, tfinal_t, bg,
                                           tiles_x, tiles_y, ts, width,
                                           height, mesh)
    return RenderOut(color=color, depth=depth_img, alpha=alpha,
                     radii=radii_local, n_dropped=n_dropped.to(torch.int32))
