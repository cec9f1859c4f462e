"""Explicit splat parameters, their activations, Adam, densification
and PLY IO (counterpart of ``splatfields_tpu/models/splats.py``).

Parameters live in fixed-capacity tensors with a validity mask, as in the
JAX package, and every function here is a plain function on tensors that
returns new tensors. Adam is hand-rolled rather than ``torch.optim.Adam``
so that its state stays plain tensors: densification gathers the moments
with the parameters, and ``interop`` carries the state across from JAX.
A "tree" is a ``SplatParams`` or a ``{name: tensor}`` dict (the field
net's parameters).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from splatfields_torch.device import resolve_device
from splatfields_torch.ops.knn import mean_sq_dist_knn3
from splatfields_torch.ops.sh import rgb_to_sh
from splatfields_torch.utils.transforms import inverse_sigmoid, quat_to_rotmat


@dataclasses.dataclass
class SplatParams:
    """Raw (pre-activation) splat parameters at fixed capacity C."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] or [C, 1] (isotropic), log space
    rotation: torch.Tensor       # [C, 4]
    opacity: torch.Tensor        # [C, 1], logit space

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


@dataclasses.dataclass
class SplatStats:
    """Densification bookkeeping."""
    valid: torch.Tensor              # [C] bool
    max_radii2d: torch.Tensor        # [C]
    xyz_gradient_accum: torch.Tensor  # [C]
    denom: torch.Tensor              # [C]


@dataclasses.dataclass
class AdamState:
    """One step count for the whole tree; moments shaped like the tree."""
    count: int
    mu: Any
    nu: Any


def get_scaling(p: SplatParams) -> torch.Tensor:
    s = torch.exp(p.scaling)
    return s.expand(-1, 3) if s.shape[-1] == 1 else s


def get_opacity(p: SplatParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_rotation(p: SplatParams) -> torch.Tensor:
    return p.rotation / (torch.linalg.vector_norm(p.rotation, dim=-1,
                                                  keepdim=True) + 1e-12)


def get_features(p: SplatParams) -> torch.Tensor:
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: int | None = None, isotropic: bool = False,
                    device=None) -> tuple[SplatParams, SplatStats]:
    """Splats from a point cloud: SH DC from RGB, log scale from the mean
    squared distance to the 3 nearest neighbours, identity rotation,
    opacity 0.1; padded to ``capacity``. ``device=None`` means the GPU."""
    dev = resolve_device(device)
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)

    dist2 = mean_sq_dist_knn3(pts)
    scale_init = torch.log(torch.sqrt(dist2))[:, None]
    scaling = scale_init if isotropic else scale_init.repeat(1, 3)
    features_dc = rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32),
                                            device=dev))[:, None, :]
    rotation = torch.zeros(n, 4, device=dev)
    rotation[:, 0] = 1.0
    opacity = torch.full((n, 1), float(inverse_sigmoid(torch.tensor(0.1))),
                         device=dev)

    def pad(a):
        out = torch.zeros((capacity,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        out[:n] = a
        return out

    params = SplatParams(
        xyz=pad(pts), features_dc=pad(features_dc),
        features_rest=torch.zeros(capacity, k - 1, 3, device=dev),
        scaling=pad(scaling), rotation=pad(rotation), opacity=pad(opacity))
    valid = torch.zeros(capacity, dtype=torch.bool, device=dev)
    valid[:n] = True
    zeros = torch.zeros(capacity, device=dev)
    stats = SplatStats(valid=valid, max_radii2d=zeros.clone(),
                       xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    return params, stats


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_items(tree) -> dict:
    """A tree's leaves by name."""
    if isinstance(tree, dict):
        return dict(tree)
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}


def tree_like(tree, leaves: dict):
    """A tree of ``tree``'s kind holding ``leaves``."""
    if isinstance(tree, dict):
        return dict(leaves)
    return dataclasses.replace(tree, **leaves)


def tree_map(fn, tree, *rest):
    items = tree_items(tree)
    others = [tree_items(r) for r in rest]
    return tree_like(tree, {k: fn(v, *(o[k] for o in others))
                            for k, v in items.items()})


# ---------------------------------------------------------------------------
# Adam (torch.optim.Adam semantics, eps after the sqrt)
# ---------------------------------------------------------------------------

def adam_init(params) -> AdamState:
    return AdamState(count=0, mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step -> (new params, new state). ``lrs`` is a tree of
    floats like ``params`` or one float. Bias-corrected moments,
    denom = sqrt(v_hat) + eps, one ``count`` for the whole tree. The
    leaves go through ``torch._foreach_*`` ops, a few launches per step
    for the whole tree."""
    count = state.count + 1
    # the JAX package forms the corrections in f32
    c1 = float(1.0 - np.float32(b1) ** np.float32(count))
    c2 = float(1.0 - np.float32(b2) ** np.float32(count))
    names = list(tree_items(params))
    p, g, m, v = ([tree_items(t)[k] for k in names]
                  for t in (params, grads, state.mu, state.nu))
    lr = tree_items(lrs) if isinstance(lrs, (dict, SplatParams)) else None
    lr = [float(lrs) if lr is None else float(lr[k]) for k in names]
    m = torch._foreach_add(torch._foreach_mul(m, b1),
                           torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_add(torch._foreach_mul(v, b2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - b2))
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(v, c2)), eps)
    step = torch._foreach_mul(
        torch._foreach_div(torch._foreach_div(m, c1), denom), lr)
    new_p = torch._foreach_sub(p, step)
    return (tree_like(params, dict(zip(names, new_p))),
            AdamState(count=count, mu=tree_like(params, dict(zip(names, m))),
                      nu=tree_like(params, dict(zip(names, v)))))


def splat_lr_tree(position_lr: float, feature_lr: float, opacity_lr: float,
                  scaling_lr: float, rotation_lr: float,
                  spatial_lr_scale: float = 5.0) -> SplatParams:
    """Per-group learning rates (reference ``training_setup``: xyz scaled
    by spatial_lr_scale 5, f_rest at feature_lr / 20)."""
    return SplatParams(
        xyz=position_lr * spatial_lr_scale, features_dc=feature_lr,
        features_rest=feature_lr / 20.0, scaling=scaling_lr,
        rotation=rotation_lr, opacity=opacity_lr)


# ---------------------------------------------------------------------------
# densification
# ---------------------------------------------------------------------------

def add_densification_stats(stats: SplatStats, screen_grad: torch.Tensor,
                            radii: torch.Tensor, idx=None) -> SplatStats:
    """Accumulate ||dL/dmeans2D|| ([N, 2] screen-offset gradient) for the
    visible splats (radii > 0). ``idx`` ([N] indices into the capacity
    arrays, the ``n_splats`` path) or None for the identity."""
    norm = torch.linalg.vector_norm(screen_grad, dim=-1)
    vis = radii > 0
    add_accum = torch.where(vis, norm, 0.0)
    add_denom = vis.to(torch.float32)
    if idx is None:
        return dataclasses.replace(
            stats, xyz_gradient_accum=stats.xyz_gradient_accum + add_accum,
            denom=stats.denom + add_denom)
    idx = idx.to(torch.int64)
    return dataclasses.replace(
        stats,
        xyz_gradient_accum=stats.xyz_gradient_accum.index_add(0, idx,
                                                              add_accum),
        denom=stats.denom.index_add(0, idx, add_denom))


def update_max_radii(stats: SplatStats, radii: torch.Tensor,
                     idx=None) -> SplatStats:
    """max_radii2D tracking over the visible splats."""
    r = radii.to(torch.float32)
    if idx is None:
        new = torch.where(radii > 0, torch.maximum(stats.max_radii2d, r),
                          stats.max_radii2d)
    else:
        idx = idx.to(torch.int64)
        cur = stats.max_radii2d[idx]
        new = stats.max_radii2d.index_copy(
            0, idx, torch.where(radii > 0, torch.maximum(cur, r), cur))
    return dataclasses.replace(stats, max_radii2d=new)


def _rows(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """[C] mask broadcast over a [C, ...] tensor."""
    return mask.reshape((-1,) + (1,) * (a.ndim - 1))


@torch.no_grad()
def densify_and_prune(params: SplatParams, stats: SplatStats,
                      opt_state: AdamState, noise: torch.Tensor,
                      grad_threshold: float, min_opacity: float,
                      extent: float, max_screen_size: float,
                      percent_dense: float = 0.01, n_split: int = 2):
    """One densification round: clone + split + prune + compaction, at
    fixed capacity. ``noise`` [C, n_split, 3] is the standard-normal draw
    for the split children (the JAX package draws it with
    ``jax.random.normal`` inside; here the caller passes it, from a
    ``torch.Generator`` or from the JAX draw in a parity test).

    Returns (params, stats, opt_state, n_dropped): n_dropped counts new
    splats that did not fit (a 0-d tensor). The semantics are the JAX
    package's, including the reference's effective behaviour that the
    screen-size prune never fires (only ``max_screen_size`` gating the
    world-size prune)."""
    cap = params.capacity
    dev = params.xyz.device
    valid = stats.valid
    grads = torch.where(stats.denom > 0,
                        stats.xyz_gradient_accum / stats.denom, 0.0)
    max_scale = get_scaling(params).amax(dim=-1)
    opacity = get_opacity(params)[:, 0]

    high_grad = (grads >= grad_threshold) & valid
    small = max_scale <= percent_dense * extent
    want_clone = high_grad & small
    want_split = high_grad & ~small
    prune = opacity < min_opacity
    if max_screen_size:
        prune = prune | (max_scale > 0.1 * extent)
    prune = prune & valid
    # children are re-tested at their scale (parent / (0.8 n_split));
    # clones have the parent's values, so the parent's test
    child_prune = opacity < min_opacity
    if max_screen_size:
        child_prune = child_prune | (max_scale / (0.8 * n_split)
                                     > 0.1 * extent)

    survive = valid & ~prune & ~want_split
    make_clone = want_clone & ~prune & ~want_split
    make_child = want_split & ~child_prune
    n_surv = survive.sum()
    n_clone = make_clone.sum()
    total = n_surv + n_clone + make_child.sum() * n_split
    n_dropped = torch.clamp_min(total - cap, 0)

    # destination slot of every source: survivors, then clones, then the
    # children of each split parent side by side; slots >= cap drop
    src = torch.arange(cap, device=dev)
    surv_pos = torch.cumsum(survive, 0) - 1
    clone_pos = n_surv + torch.cumsum(make_clone, 0) - 1
    child_pos0 = n_surv + n_clone + n_split * (torch.cumsum(make_child, 0) - 1)
    gather_idx = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    is_child_slot = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    child_rank = torch.zeros(cap + 1, dtype=torch.int64, device=dev)

    def scat(buf, pos, val, mask):
        return buf.index_copy(0, torch.where(mask & (pos < cap), pos, cap),
                              val)

    # sources that do not land keep writing slot ``cap`` (dropped below);
    # each landing slot is written by exactly one source
    gather_idx = scat(gather_idx, surv_pos, src, survive)
    gather_idx = scat(gather_idx, clone_pos, src, make_clone)
    for j in range(n_split):
        posj = child_pos0 + j
        gather_idx = scat(gather_idx, posj, src, make_child)
        is_child_slot = scat(is_child_slot, posj,
                             torch.ones(cap, dtype=torch.bool, device=dev),
                             make_child)
        child_rank = scat(child_rank, posj, torch.full_like(src, j),
                          make_child)
    gather_idx = gather_idx[:cap]
    is_child_slot = is_child_slot[:cap]
    child_rank = child_rank[:cap]

    slot_ids = torch.arange(cap, device=dev)
    new_valid = slot_ids < torch.clamp_max(total, cap)
    is_new_slot = slot_ids >= n_surv  # clones and children: fresh Adam state

    new_params = tree_map(lambda a: a[gather_idx], params)
    # split child: xyz += R (noise * scale); scaling -= log(0.8 n_split)
    child_noise = noise[gather_idx, child_rank]
    offset = (quat_to_rotmat(get_rotation(new_params))
              @ (child_noise * get_scaling(new_params))[..., None])[..., 0]
    child = is_child_slot[:, None]
    new_params = dataclasses.replace(
        new_params,
        xyz=torch.where(child, new_params.xyz + offset, new_params.xyz),
        scaling=torch.where(child,
                            new_params.scaling - math.log(0.8 * n_split),
                            new_params.scaling))
    # padding slots hold zeros
    new_params = tree_map(
        lambda a: torch.where(_rows(new_valid, a), a, 0.0), new_params)

    # survivors keep their moments; new and padding slots start at zero
    keep = ~is_new_slot & new_valid

    def surgery(m):
        g = m[gather_idx]
        return torch.where(_rows(keep, g), g, 0.0)

    new_opt = AdamState(count=opt_state.count,
                        mu=tree_map(surgery, opt_state.mu),
                        nu=tree_map(surgery, opt_state.nu))
    zeros = torch.zeros(cap, device=dev)
    new_stats = SplatStats(valid=new_valid, max_radii2d=zeros,
                           xyz_gradient_accum=zeros.clone(),
                           denom=zeros.clone())
    return new_params, new_stats, new_opt, n_dropped


@torch.no_grad()
def reset_opacity(params: SplatParams, opt_state: AdamState):
    """opacity <- min(opacity, 0.01), with the opacity leaf's Adam moments
    reset (reference ``reset_opacity``; the training loop never calls
    it)."""
    new_op = inverse_sigmoid(torch.clamp_max(get_opacity(params), 0.01))
    zeros = torch.zeros_like(new_op)
    return (dataclasses.replace(params, opacity=new_op),
            AdamState(count=opt_state.count,
                      mu=dataclasses.replace(opt_state.mu, opacity=zeros),
                      nu=dataclasses.replace(opt_state.nu, opacity=zeros)))


@torch.no_grad()
def grow_capacity(params: SplatParams, stats: SplatStats, opt: AdamState,
                  new_cap: int):
    """Pad params, stats and both Adam moments to ``new_cap`` rows with
    zeros (invalid slots), keeping their device (the JAX package's
    ``train.py::_grow_capacity``)."""
    def pad(a):
        out = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        out[:a.shape[0]] = a
        return out

    return (tree_map(pad, params), tree_map(pad, stats),
            AdamState(count=opt.count, mu=tree_map(pad, opt.mu),
                      nu=tree_map(pad, opt.nu)))


# ---------------------------------------------------------------------------
# PLY IO: the reference's layout, the same file format as the JAX package
# ---------------------------------------------------------------------------

def save_ply(path: str, params: SplatParams, valid):
    """The valid splats as a binary-little-endian PLY in the reference's
    layout (``scene/gaussian_model.py:167-205``): x y z nx ny nz f_dc_*
    f_rest_* (features as [N, 3, K] flattened) opacity scale_* rot_*."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    v = _numpy(valid).astype(bool)
    xyz, f_dc, f_rest, opacity, scaling, rotation = (
        _numpy(getattr(params, k))[v] for k in (
            "xyz", "features_dc", "features_rest", "opacity", "scaling",
            "rotation"))
    n = xyz.shape[0]

    f_dc_flat = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    f_rest_flat = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    attrs = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc_flat.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest_flat.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    data = np.concatenate([xyz, np.zeros_like(xyz), f_dc_flat, f_rest_flat,
                           opacity, scaling, rotation], 1).astype(np.float32)
    rec = np.empty(n, dtype=np.dtype([(a, "<f4") for a in attrs]))
    for i, a in enumerate(attrs):
        rec[a] = data[:, i]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {a}\n" for a in attrs)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def load_ply(path: str, capacity: int | None = None, isotropic: bool = False,
             device=None) -> tuple[SplatParams, SplatStats, int]:
    """A reference-layout splat PLY -> (params, stats, SH degree from the
    f_rest count), padded to ``capacity`` on ``device`` (None means the
    GPU)."""
    from splatfields_torch.data.ply import read_ply_vertices
    dev = resolve_device(device)
    names, data = read_ply_vertices(path)
    col = {nm: data[:, i] for i, nm in enumerate(names)}
    n = data.shape[0]

    def numbered(prefix):
        return sorted((nm for nm in names if nm.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))

    xyz = np.stack([col["x"], col["y"], col["z"]], -1)
    opacity = col["opacity"][:, None]
    f_dc = np.stack([col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]],
                    -1)[:, None, :]
    rest_names = numbered("f_rest_")
    n_rest = len(rest_names)
    if n_rest:
        rest = np.stack([col[nm] for nm in rest_names], -1)
        rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)
    scaling = np.stack([col[nm] for nm in numbered("scale_")], -1)
    if isotropic and scaling.shape[1] == 3:
        scaling = scaling[:, :1]
    rotation = np.stack([col[nm] for nm in numbered("rot_")], -1)
    capacity = capacity or n
    sh_degree = int(np.sqrt(n_rest // 3 + 1)) - 1

    def pad(a):
        out = torch.zeros((capacity,) + a.shape[1:], dtype=torch.float32,
                          device=dev)
        out[:n] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return out

    params = SplatParams(
        xyz=pad(xyz), features_dc=pad(f_dc), features_rest=pad(rest),
        scaling=pad(scaling), rotation=pad(rotation), opacity=pad(opacity))
    valid = torch.zeros(capacity, dtype=torch.bool, device=dev)
    valid[:n] = True
    zeros = torch.zeros(capacity, device=dev)
    stats = SplatStats(valid=valid, max_radii2d=zeros,
                       xyz_gradient_accum=zeros.clone(), denom=zeros.clone())
    return params, stats, sh_degree


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
