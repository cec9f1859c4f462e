"""The training step (counterpart of ``splatfields_tpu/train_lib.py``).

Two modes, as in the JAX package:

- **static mode** (``--is_static``): the splat parameters render directly
  with SH colours, the classic-3DGS path;
- **field mode**: the splats' xyz and scaling are detached, the
  SplatFields net predicts the attributes, its scale is added to the
  splats' activated scale, colour comes from the field.

One step = field forward (planes generated once) -> V renders, each with a
zero screen-space offset that requires grad -> losses -> backward -> two
Adam updates (splats, field). The densification statistics use the LAST
view's offset gradient and radii, the reference's loop-variable reuse.

4-D fields (``n_frames > 0``): the net reads the batch's time step
``fid`` (a host number) broadcast to [N, 1] and its frame, computed on
the host (``models.splatfields.time_inputs``); the V views of an
``--all_training`` batch share that fid.

PyTorch runs eagerly, so there is no jit and no scanned twin. The field
runs once a step, so generated planes (VarTriPlane, VarHexPlane) are
generated once a step, at the batch's frame.

``n_splats > 0`` (field mode): each step renders a random subset of
``n_splats`` valid splats (``_subsample_idx``, keys from the
``torch.Generator`` passed to ``make_train_step``, as the densify noise
takes its own), and the densification statistics go back to the subset's
rows. A view-dependent colour head (``use_view_dep_rgb``) turns the
field's ``rgb_feat`` into colours per view, with the splats' view
directions (``render_view``).
The depth-SSIM regularizer runs over the [1, H, W] depth map, the JAX
package's documented deviation. The Moran terms (``corr_term``) run once
a step, after the view average; with ``--corr_interval k`` the loop marks
every k-th step in ``batch["corr_gate"]`` and the others skip the term,
KNN included, on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from splatfields_torch.models import splats as splats_lib
from splatfields_torch.models.splatfields import time_inputs
from splatfields_torch.ops import knn as knn_ops
from splatfields_torch.ops.raster.api import rasterize
from splatfields_torch.ops.ssim import ssim as ssim_fn


class StepOut(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    loss_dict: dict
    radii: torch.Tensor          # last view
    screen_grad: torch.Tensor    # last view [N, 2]
    means3d: torch.Tensor        # field-predicted means (for overwrite_loc)


def field_attributes(net, xyz: torch.Tensor, scaling: torch.Tensor,
                     valid: torch.Tensor, fid, n_frames: int, planes=None,
                     params=None):
    """Field forward -> renderable attributes (reference ``train.py:51-85``):
    the net predicts attributes at the detached splat xyz; its scale is
    added to the splats' activated scale. ``params`` (``{state_dict name:
    tensor}``) replaces the net's own parameters for this call. A 4-D
    field (``n_frames > 0``) reads the time step ``fid`` (a host number)
    as t [N, 1] and its frame; the flow passes through. A view-dependent
    net's colour features pass through as ``rgb_feat``."""
    args = (xyz.detach(),)
    kwargs = {"planes": planes,
              **time_inputs(xyz.shape[0], fid, n_frames, xyz.device)}
    ret = (net(*args, **kwargs) if params is None
           else functional_call(net, params, args, kwargs))
    out = {
        "means3d": ret["means3D"],
        "opacity": ret["opacity"][:, 0],
        "scales": ret["scales"] + scaling.detach(),
        "rotations": ret["rotations"],
        "valid": valid,
    }
    for key in ("rgb", "rgb_feat"):
        if key in ret:
            out[key] = ret[key]
    if ret["flow"] is not None:
        out["flow"] = ret["flow"]
    return out


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


def view_colors(attrs, campos: torch.Tensor, net=None, params=None):
    """The colours to render: ``attrs["rgb"]``, or a view-dependent
    head's (``net.rgb_from_viewdir`` with ``params``) on ``rgb_feat`` and
    the unit directions from ``campos`` to the means; None for SH
    colours."""
    if "rgb_feat" not in attrs:
        return attrs.get("rgb")
    dirs = attrs["means3d"] - campos[None]
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
                   + 1e-12)
    return net.rgb_from_viewdir(attrs["rgb_feat"], dirs, params)


def render_view(attrs, cam, bg, width, height, sh_degree, pipe,
                screenspace_offset=None, net=None, params=None):
    """One differentiable rasterization of an attribute dict; ``cam`` holds
    one view's ``viewmatrix``, ``projmatrix``, ``campos`` (tensors on the
    splats' device) and ``tanfovx``, ``tanfovy`` (numbers). ``net`` and
    ``params`` serve a view-dependent colour head (``view_colors``)."""
    return rasterize(
        attrs["means3d"], attrs["scales"], attrs["rotations"],
        attrs["opacity"], cam["viewmatrix"], cam["projmatrix"],
        cam["campos"], bg, float(cam["tanfovx"]), float(cam["tanfovy"]),
        width, height,
        colors_precomp=view_colors(attrs, cam["campos"], net, params),
        shs=attrs.get("shs"), sh_degree=sh_degree,
        valid_mask=attrs["valid"], screenspace_offset=screenspace_offset,
        tile_size=pipe.tile_size, tile_cap=pipe.tile_cap,
        k_chunk=pipe.k_chunk,
        dup_cap=pipe.dup_factor * attrs["means3d"].shape[0])


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    v = valid.to(x.dtype)
    return (x * v).sum() / torch.clamp_min(v.sum(), 1.0)


def compute_losses(render_outs, batch, attrs, opt, valid):
    """Per-view photometric loss plus the regularizers -> (loss, aux)."""
    loss_list, l1_list = [], []
    mask_l, depth_l, depthl1_l = [], [], []
    for v, out in enumerate(render_outs):
        gt = batch["image"][v]
        l1 = (out.color - gt).abs().mean()
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (
            1.0 - ssim_fn(out.color, gt))
        if opt.lambda_mask > 0.0:
            alpha = torch.clamp(out.alpha, 0.0, 1.0)
            lm = (alpha.reshape(-1) - batch["mask"][v].reshape(-1)).abs().mean()
            loss = loss + opt.lambda_mask * lm
            mask_l.append(lm)
        if opt.lambda_norm > 0.0:
            ln = _masked_mean(
                torch.linalg.vector_norm(attrs["means3d"], dim=1), valid)
            loss = loss + opt.lambda_norm * ln
        if opt.lambda_norm_mean > 0.0:
            vf = valid[:, None].to(torch.float32)
            mean_val = ((attrs["means3d"] * vf).sum(0)
                        / torch.clamp_min(valid.sum(), 1)).detach()
            ln = _masked_mean(torch.linalg.vector_norm(
                attrs["means3d"] - mean_val[None], dim=1), valid)
            loss = loss + opt.lambda_norm_mean * ln
        if opt.lambda_depth > 0.0 or opt.lambda_depthl1 > 0.0:
            gt_depth = batch["depth"][v]
            dmask = (gt_depth > 0).to(torch.float32)
        if opt.lambda_depth > 0.0:
            ld = ssim_fn((out.depth[0] * dmask)[None],
                         (gt_depth * dmask)[None])
            loss = loss + opt.lambda_depth * ld
            depth_l.append(ld)
        if opt.lambda_depthl1 > 0.0:
            ld = (out.depth[0] * dmask - gt_depth * dmask).abs().mean()
            loss = loss + opt.lambda_depthl1 * ld
            depthl1_l.append(ld)
        loss_list.append(loss)
        l1_list.append(l1)

    loss = sum(loss_list) / len(render_outs)
    aux = {"l1": sum(l1_list) / len(render_outs)}
    if opt.lambda_corr > 0.0 or opt.lambda_corr_color > 0.0:
        interval = max(opt.corr_interval, 1)
        if interval > 1 and "corr_gate" in batch:
            # the budget knob: every k-th step only, scaled by k so the
            # expected gradient matches the every-step schedule; a
            # gated-off step runs no KNN at all
            if batch["corr_gate"]:
                loss = loss + corr_term(attrs, valid, opt) * float(interval)
        else:
            loss = loss + corr_term(attrs, valid, opt)
    if mask_l:
        aux["mask"] = sum(mask_l) / len(mask_l)
    if depth_l:
        aux["depth"] = sum(depth_l) / len(depth_l)
    if depthl1_l:
        aux["depthl1"] = sum(depthl1_l) / len(depthl1_l)
    if opt.lambda_opacity > 0.0:
        lo = _masked_mean((attrs["opacity"] - 1.0) ** 2, valid)
        loss = loss + opt.lambda_opacity * lo
        aux["opacity"] = lo
    if opt.lambda_gradient > 0.0 and "gradient_error" in attrs:
        # once per step, after the view average (reference train.py:247-250)
        lg = attrs["gradient_error"]
        loss = loss + opt.lambda_gradient * lg
        aux["gradient"] = lg
    return loss, aux


def corr_term(attrs, valid, opt) -> torch.Tensor:
    """The Moran regularizers (reference ``train.py:203-215``), view
    invariant, so computed once a step. Invalid splats are parked at
    ``1e3 + index`` before the KNN of the detached positions, and a
    neighbourhood counts only if all its splats are valid (self comes
    first, so an invalid splat masks its own). The colour feature is the
    flattened SH matrix in static mode and the predicted rgb in field
    mode; ``lambda_corr_color`` is weighted by ``lambda_corr`` (the
    reference's quirk)."""
    n = valid.shape[0]
    parked = 1e3 + torch.arange(n, dtype=torch.float32,
                                device=valid.device)[:, None]
    pts = torch.where(valid[:, None], attrs["means3d"].detach(), parked)
    w, nn_ix = knn_ops.query_nn(pts)
    nb_valid = valid[nn_ix].all(dim=1).to(torch.float32)

    def moran(feat):
        per = knn_ops.neighborhood_morans(w, feat[nn_ix], w_floor=1e-12)
        return 1.0 - torch.clamp(
            (per * nb_valid).sum() / torch.clamp_min(nb_valid.sum(), 1.0),
            0.0, 1.0)

    feat_vec = (attrs["shs"].reshape(n, -1) if "shs" in attrs
                else attrs.get("rgb"))
    term = torch.zeros((), device=valid.device)
    if opt.lambda_corr > 0.0:
        lc = (moran(attrs["scales"]) + moran(attrs["rotations"])
              + moran(attrs["opacity"][:, None]))
        if feat_vec is not None:
            lc = lc + moran(feat_vec)
        term = term + opt.lambda_corr * lc
    if opt.lambda_corr_color > 0.0 and feat_vec is not None:
        term = term + opt.lambda_corr * moran(feat_vec)
    return term


def _leaves(tree) -> dict:
    """Fresh leaves that require grad, sharing the tree's storage."""
    return {k: v.detach().requires_grad_(True)
            for k, v in splats_lib.tree_items(tree).items()}


def _subsample_idx(generator: torch.Generator, valid: torch.Tensor,
                   n_splats: int) -> torch.Tensor:
    """``n_splats`` random valid indices (reference ``train.py:56-60``):
    uniform keys pushed up by 10 on invalid rows, argsorted, the first n
    kept."""
    keys = torch.rand(valid.shape, generator=generator, device=valid.device)
    keys = keys + (~valid).to(torch.float32) * 10.0
    return torch.argsort(keys, stable=True)[:n_splats]


def make_train_step(net, opt_cfg, pipe_cfg, width, height, num_views,
                    field_mode: bool, n_frames: int, sh_degree: int,
                    n_splats: int = -1, enable_gaussian_opt: bool = True,
                    generator: torch.Generator | None = None):
    """The train step for one (mode, V, sh_degree) signature:

        step(splat_params, splat_stats, splat_opt, field_params, field_opt,
             batch, splat_lrs, field_lr)
          -> (splat_params, splat_stats, splat_opt, field_params,
              field_opt, StepOut)

    ``field_params`` is the net's ``{state_dict name: tensor}`` tree
    (``DeformModel.params``, ``{}`` in static mode) and ``field_opt`` its
    ``AdamState``; the net's own parameters are not read. ``batch`` holds
    per-view ``viewmatrix`` [V,4,4], ``projmatrix``, ``campos`` [V,3],
    ``image`` [V,3,H,W] (and ``mask``, ``depth`` for their losses) on the
    splats' device, ``tanfovx``/``tanfovy`` [V] numbers, ``fid`` (a host
    number, the views' common time step) and ``bg`` [3]. The field runs
    once a step (its planes generated once) and its attributes render all
    V views. Inputs are not modified; every
    output is new. ``n_splats > 0`` in field mode renders a random subset
    of that many valid splats a step, drawn from ``generator`` (on the
    splats' device)."""
    subsample = field_mode and n_splats > 0
    if subsample and generator is None:
        raise ValueError("n_splats > 0 needs a generator for the subsample")

    def step(splat_params, splat_stats, splat_opt, field_params, field_opt,
             batch, splat_lrs, field_lr):
        valid = splat_stats.valid
        idx = _subsample_idx(generator, valid, n_splats) if subsample else None
        sp = _leaves(splat_params)
        fp = _leaves(field_params)
        sp_tree = splats_lib.tree_like(splat_params, sp)
        if field_mode:
            xyz, scaling = sp_tree.xyz, splats_lib.get_scaling(sp_tree)
            val = valid
            if idx is not None:
                xyz, scaling, val = xyz[idx], scaling[idx], valid[idx]
            attrs = field_attributes(net, xyz, scaling, val, batch["fid"],
                                     n_frames, params=fp)
        else:
            attrs = static_attributes(sp_tree, valid)
        n_render = idx.shape[0] if subsample else splat_params.capacity
        offsets = [torch.zeros(n_render, 2, device=valid.device,
                               requires_grad=True) for _ in range(num_views)]
        outs = []
        for v in range(num_views):
            cam = {k: batch[k][v] for k in ("viewmatrix", "projmatrix",
                                            "campos", "tanfovx", "tanfovy")}
            outs.append(render_view(attrs, cam, batch["bg"], width, height,
                                    sh_degree, pipe_cfg,
                                    screenspace_offset=offsets[v], net=net,
                                    params=fp))
        loss, aux = compute_losses(outs, batch, attrs, opt_cfg, attrs["valid"])
        aux["bin_dropped"] = sum(o.n_dropped for o in outs)

        inputs = [*sp.values(), *fp.values(), offsets[-1]]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        g_sp = dict(zip(sp, grads[:len(sp)]))
        g_fp = dict(zip(fp, grads[len(sp):len(sp) + len(fp)]))
        screen_grad = grads[-1]

        new_sp, new_sp_opt = splat_params, splat_opt
        if enable_gaussian_opt:
            new_sp, new_sp_opt = splats_lib.adam_update(
                splat_params, splats_lib.tree_like(splat_params, g_sp),
                splat_opt, splat_lrs)
        new_fp, new_f_opt = field_params, field_opt
        if field_mode:
            new_fp, new_f_opt = splats_lib.adam_update(
                field_params, g_fp, field_opt, field_lr)

        radii = outs[-1].radii
        new_stats = splats_lib.update_max_radii(splat_stats, radii, idx=idx)
        new_stats = splats_lib.add_densification_stats(new_stats, screen_grad,
                                                       radii, idx=idx)
        out = StepOut(loss=loss.detach(), l1=aux["l1"].detach(),
                      loss_dict={k: v.detach() for k, v in aux.items()},
                      radii=radii, screen_grad=screen_grad,
                      means3d=attrs["means3d"].detach())
        return new_sp, new_stats, new_sp_opt, new_fp, new_f_opt, out

    return step
