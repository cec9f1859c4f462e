"""The sharded training step on a [data, model] mesh (counterpart of
``splatfields_tpu/parallel/step.py``): one process a device, eager torch,
``torch.distributed`` collectives.

The contract of ``train_lib.make_train_step``, sharded:

- splat parameters, statistics and splat Adam moments are split over
  ``model`` along the capacity axis (``shard_train_state``); each rank
  computes the attributes of its chunk, through the field
  (``train_lib.field_attributes``) or the static path
  (``static_attributes``);
- the attributes are gathered (``mesh.gather``, whose backward is the
  sum-scatter), so every rank holds all of them; preprocess and binning
  run replicated, and each rank blends its slice of the tile grid
  (``sharded_render_view``); the tile buffers are gathered into the
  image;
- the batch's views are split over ``data``: each rank renders its data
  row's share;
- every model rank computes the full loss from the gathered image and
  divides it by ``n_model``; each cross-rank path then sums exactly one
  copy through the gathers' backward, so the chunk's gradients (splat
  parameters, the field through the chunk) come out exact, the
  replicated paths (field parameters through the view-dependent head and
  the planes, the screen offsets) are summed over ``model``, and every
  gradient is averaged over ``data``;
- the densification statistics come from each data row's last view,
  averaged over ``data``; ``max_radii2d`` takes the max over ``data``
  (the JAX package's documented deviation; with one data row they are
  the single-device step's).

Field parameters and their Adam state are replicated (``replicate``).
``n_splats`` subsampling is not supported on a mesh. ``ring=True``
passes Gaussian blocks around the model ring instead of gathering them
(``parallel/ring.py``) and gathers only what the active regularizers
read.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from splatfields_torch import train_lib
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.ops.raster.api import RenderOut
from splatfields_torch.ops.raster.binning import bin_gaussians
from splatfields_torch.ops.raster.blend_cuda import blend_fwd
from splatfields_torch.ops.raster.blend_torch import (
    pack_attributes,
    tiles_to_image,
)
from splatfields_torch.ops.raster.preprocess import preprocess
from splatfields_torch.parallel import mesh as mesh_lib

_CAM_KEYS = ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy")
_VIEW_KEYS = _CAM_KEYS + ("image", "mask", "depth")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_slice(num_tiles: int, n_model: int, model_index: int):
    """This rank's slice of the tile grid: (first tile, tiles a rank). The
    grid is padded to a multiple of ``n_model``; the last rank's padding
    tiles have no instances."""
    t_loc = _cdiv(num_tiles, n_model)
    return model_index * t_loc, t_loc


def local_tiles(tile_start, counts, num_tiles: int, n_model: int,
                model_index: int):
    """The blend's arguments for this rank's slice: ``tile_start`` [t+1]
    and ``counts`` [t] of the grid padded to ``n_model`` slices (padding
    starts repeat the terminal value, padding counts are 0, so no slice
    start is clamped), and the global tile ids [t], clamped to the last
    tile (a clamped id pairs only with a zero count)."""
    start, t_loc = tile_slice(num_tiles, n_model, model_index)
    pad = n_model * t_loc - num_tiles
    starts_pad = torch.cat([tile_start, tile_start[-1:].expand(pad)])
    counts_pad = torch.cat([counts, counts.new_zeros(pad)])
    ids = torch.clamp_max(
        start + torch.arange(t_loc, dtype=torch.int32,
                             device=counts.device), num_tiles - 1)
    return (starts_pad[start:start + t_loc + 1].contiguous(),
            counts_pad[start:start + t_loc].contiguous(), ids)


def gather_image(color_t, depth_t, tfinal_t, bg, tiles_x, tiles_y,
                 tile_size, width, height, mesh) -> tuple:
    """The model row's tile buffers ([t, 3, P], [t, P], [t, P] each) ->
    the full (color [3, H, W] over ``bg``, depth [1, H, W], alpha
    [1, H, W])."""
    num_tiles = tiles_x * tiles_y

    def full(buf):
        return mesh_lib.gather(buf, mesh.model_group)[:num_tiles]

    color = tiles_to_image(full(color_t.transpose(1, 2).contiguous()),
                           tiles_x, tiles_y, tile_size, height, width)
    depth = tiles_to_image(full(depth_t), tiles_x, tiles_y, tile_size,
                           height, width)
    final_t = tiles_to_image(full(tfinal_t), tiles_x, tiles_y, tile_size,
                             height, width)
    color = color + final_t[..., None] * bg[None, None, :]
    return color.permute(2, 0, 1), depth[None], (1.0 - final_t)[None]


def sharded_render_view(attrs, cam, bg, width, height, sh_degree, pipe,
                        mesh, screenspace_offset=None, net=None,
                        params=None) -> RenderOut:
    """One view with the tile grid sliced over ``model``: ``rasterize``'s
    preprocess, binning and pack on the full attribute set, the blend on
    this rank's tiles (``local_tiles``), the tile buffers gathered."""
    pre = preprocess(
        attrs["means3d"], attrs["scales"], attrs["rotations"],
        attrs["opacity"], cam["viewmatrix"], cam["projmatrix"], width,
        height, float(cam["tanfovx"]), float(cam["tanfovy"]),
        colors_precomp=train_lib.view_colors(attrs, cam["campos"], net,
                                             params),
        shs=attrs.get("shs"), sh_degree=sh_degree, campos=cam["campos"],
        valid_mask=attrs["valid"])
    means2d = pre.means2d
    if screenspace_offset is not None:
        scale_vec = means2d.new_tensor([0.5 * width, 0.5 * height])
        means2d = means2d + screenspace_offset * scale_vec[None, :]
    ts = pipe.tile_size
    tiles_x, tiles_y = _cdiv(width, ts), _cdiv(height, ts)
    binning = bin_gaussians(means2d.detach(), pre.depths.detach(), pre.radii,
                            tiles_x, tiles_y, ts,
                            dup_cap=pipe.dup_factor * means2d.shape[0])
    starts, counts, ids = local_tiles(binning.tile_start, binning.counts,
                                      tiles_x * tiles_y, mesh.n_model,
                                      mesh.model_index)
    pack = pack_attributes(means2d, pre.conics, pre.rgb, pre.opacity,
                           pre.depths)
    sorted_pack = pack[torch.clamp_min(binning.sorted_id, 0).to(torch.int64)]
    color_t, depth_t, tfinal_t = blend_fwd(
        sorted_pack, starts, counts, tiles_x, tiles_y, ts, pipe.tile_cap,
        pipe.k_chunk, tile_ids=ids)
    color, depth, alpha = gather_image(color_t, depth_t, tfinal_t, bg,
                                       tiles_x, tiles_y, ts, width, height,
                                       mesh)
    return RenderOut(color=color, depth=depth, alpha=alpha, radii=pre.radii,
                     n_dropped=binning.n_dropped)


def reduce_flat(tensors: list, group, op=dist.ReduceOp.SUM) -> list:
    """``op`` over ``group`` of every tensor of the list, in one
    collective over their concatenation (same dtype)."""
    if not tensors or dist.get_world_size(group) == 1:
        return list(tensors)
    flat = mesh_lib.all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                               group, op)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def make_sharded_train_step(net, opt_cfg, pipe_cfg, width, height,
                            views_per_shard: int, field_mode: bool,
                            n_frames: int, mesh, sh_degree: int = 0,
                            enable_gaussian_opt: bool = True,
                            ring: bool = False):
    """The sharded step, ``train_lib.make_train_step``'s signature and
    outputs on this rank's state:

        step(splat_params, splat_stats, splat_opt, field_params, field_opt,
             batch, splat_lrs, field_lr)

    ``splat_*``: this rank's capacity chunk (``shard_train_state``);
    ``field_*``: replicated; ``batch``: the whole view batch
    (``n_data * views_per_shard`` views), of which this rank renders its
    data row's. ``StepOut.radii``, ``screen_grad`` and ``means3d`` are
    the local chunk's; ``loss`` and ``loss_dict`` the mesh's."""
    n_model, vps = mesh.n_model, views_per_shard
    model_g, data_g = mesh.model_group, mesh.data_group

    def step(splat_params, splat_stats, splat_opt, field_params, field_opt,
             batch, splat_lrs, field_lr):
        valid_local = splat_stats.valid
        c_loc = valid_local.shape[0]
        v0 = mesh.data_index * vps
        shard = {k: (v[v0:v0 + vps] if k in _VIEW_KEYS else v)
                 for k, v in batch.items()}
        sp = train_lib._leaves(splat_params)
        fp = train_lib._leaves(field_params)
        sp_tree = splats_lib.tree_like(splat_params, sp)
        if field_mode:
            attrs_local = train_lib.field_attributes(
                net, sp_tree.xyz, splats_lib.get_scaling(sp_tree),
                valid_local, batch["fid"], n_frames, params=fp)
        else:
            attrs_local = train_lib.static_attributes(sp_tree, valid_local)
        cams = [{k: shard[k][v] for k in _CAM_KEYS} for v in range(vps)]
        dev = valid_local.device

        def gather(t):
            return mesh_lib.gather(t, model_g)

        if ring:
            from splatfields_torch.parallel.ring import ring_render_view
            offsets = [torch.zeros(c_loc, 2, device=dev, requires_grad=True)
                       for _ in range(vps)]
            outs = [ring_render_view(attrs_local, cams[v], batch["bg"],
                                     width, height, sh_degree, pipe_cfg,
                                     mesh, offsets[v], net, fp)
                    for v in range(vps)]
            # only what the active regularizers read is gathered
            need_means = (opt_cfg.lambda_norm > 0
                          or opt_cfg.lambda_norm_mean > 0
                          or opt_cfg.lambda_corr > 0
                          or opt_cfg.lambda_corr_color > 0)
            need_full = (opt_cfg.lambda_corr > 0
                         or opt_cfg.lambda_corr_color > 0)
            attrs = {}
            if need_means:
                attrs["means3d"] = gather(attrs_local["means3d"])
            if need_full:
                for k in ("scales", "rotations", "opacity", "rgb", "shs",
                          "rgb_feat"):
                    if k in attrs_local:
                        attrs[k] = gather(attrs_local[k])
            reg_valid = gather(valid_local) if need_means else valid_local
            means3d_out = attrs_local["means3d"]
        else:
            attrs = {k: gather(v) for k, v in attrs_local.items()}
            offsets = [torch.zeros(c_loc * n_model, 2, device=dev,
                                   requires_grad=True) for _ in range(vps)]
            outs = [sharded_render_view(attrs, cams[v], batch["bg"], width,
                                        height, sh_degree, pipe_cfg, mesh,
                                        offsets[v], net, fp)
                    for v in range(vps)]
            reg_valid = attrs["valid"]
            means3d_out = attrs["means3d"]
        loss, aux = train_lib.compute_losses(outs, shard, attrs, opt_cfg,
                                             reg_valid)
        aux["bin_dropped"] = sum(o.n_dropped for o in outs)

        # every model rank holds the whole loss: each keeps 1 / n_model
        inputs = [*sp.values(), *fp.values(), offsets[-1]]
        grads = torch.autograd.grad(loss / n_model, inputs,
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        n_sp, n_fp = len(sp), len(fp)
        g_sp = reduce_flat(grads[:n_sp], data_g)
        g_fp = reduce_flat(reduce_flat(grads[n_sp:n_sp + n_fp], model_g),
                           data_g)
        n_data = mesh.n_data
        g_sp = dict(zip(sp, (g / n_data for g in g_sp)))
        g_fp = dict(zip(fp, (g / n_data for g in g_fp)))
        g_off = grads[-1]
        radii = outs[-1].radii
        if not ring:
            # the ring's reverse exchange already brought each offset
            # gradient home
            g_off = mesh_lib.all_reduce(g_off, model_g)
            lo = mesh.model_index * c_loc
            g_off, radii = g_off[lo:lo + c_loc], radii[lo:lo + c_loc]
            means3d_out = means3d_out[lo:lo + c_loc]

        new_sp, new_sp_opt = splat_params, splat_opt
        if enable_gaussian_opt:
            new_sp, new_sp_opt = splats_lib.adam_update(
                splat_params, splats_lib.tree_like(splat_params, g_sp),
                splat_opt, splat_lrs)
        new_fp, new_f_opt = field_params, field_opt
        if field_mode:
            new_fp, new_f_opt = splats_lib.adam_update(
                field_params, g_fp, field_opt, field_lr)

        radii_max = mesh_lib.all_reduce(radii, data_g, dist.ReduceOp.MAX)
        new_stats = splats_lib.update_max_radii(splat_stats, radii_max)
        vis = radii > 0
        norm = torch.linalg.vector_norm(g_off, dim=-1)
        add_accum, add_denom = reduce_flat(
            [torch.where(vis, norm, 0.0), vis.to(torch.float32)], data_g)
        new_stats = dataclasses.replace(
            new_stats,
            xyz_gradient_accum=new_stats.xyz_gradient_accum
            + add_accum / n_data,
            denom=new_stats.denom + add_denom / n_data)

        loss_all = mesh_lib.mean(
            mesh_lib.all_reduce(loss.detach() / n_model, model_g), data_g)
        names = list(aux)
        vals = reduce_flat([torch.as_tensor(aux[k], dtype=torch.float32,
                                            device=dev).detach().reshape(1)
                            for k in names], data_g)
        aux = {k: (v / n_data)[0] for k, v in zip(names, vals)}
        out = train_lib.StepOut(loss=loss_all, l1=aux["l1"], loss_dict=aux,
                                radii=radii, screen_grad=g_off,
                                means3d=means3d_out.detach())
        return new_sp, new_stats, new_sp_opt, new_fp, new_f_opt, out

    return step


def _slice_rows(a: torch.Tensor, mesh) -> torch.Tensor:
    c_loc = a.shape[0] // mesh.n_model
    lo = mesh.model_index * c_loc
    return a[lo:lo + c_loc].clone()


def shard_train_state(params, stats, opt_state, mesh):
    """This rank's capacity chunk of the splat parameters, statistics and
    Adam moments (the capacity must divide by ``n_model``)."""
    cap = params.xyz.shape[0]
    if cap % mesh.n_model:
        raise ValueError(f"capacity {cap} not divisible by model axis "
                         f"{mesh.n_model}")

    def cut(tree):
        return splats_lib.tree_map(lambda a: _slice_rows(a, mesh), tree)

    return (cut(params), cut(stats),
            splats_lib.AdamState(count=opt_state.count, mu=cut(opt_state.mu),
                                 nu=cut(opt_state.nu)))


def unshard_train_state(params, stats, opt_state, mesh):
    """The whole splat state from every rank's chunk (a collective over
    the model row)."""
    def full(tree):
        return splats_lib.tree_map(
            lambda a: mesh_lib.all_gather(a, mesh.model_group), tree)

    return (full(params), full(stats),
            splats_lib.AdamState(count=opt_state.count,
                                 mu=full(opt_state.mu),
                                 nu=full(opt_state.nu)))


def replicate(tree):
    """Every tensor of ``tree`` (a dict or a dataclass of tensors) set to
    global rank 0's values on every rank."""
    def bcast(a):
        a = a.detach().clone().contiguous()
        if dist.get_world_size() > 1:
            dist.broadcast(a, 0)
        return a

    return splats_lib.tree_map(bcast, tree)


def make_sharded_densify(mesh, max_screen_size: float,
                         percent_dense: float):
    """On-mesh densification: the whole state gathered on every rank,
    ``splats.densify_and_prune`` run there with the same ``noise`` (every
    rank draws it from the same seeded generator), the chunks sliced back:
    the single-device result, partitioned.

        run(params, stats, opt_state, noise, grad_threshold, min_opacity,
            extent) -> (params, stats, opt_state, n_dropped)"""
    def run(params, stats, opt_state, noise, grad_threshold, min_opacity,
            extent):
        p, s, o = unshard_train_state(params, stats, opt_state, mesh)
        p, s, o, dropped = splats_lib.densify_and_prune(
            p, s, o, noise, grad_threshold, min_opacity, extent,
            max_screen_size, percent_dense=percent_dense)
        return (*shard_train_state(p, s, o, mesh), dropped)

    return run
