"""Carry state of the JAX package across to the port, from numpy arrays.

The port's module names equal the flax module names, so a flax variable
path maps to a ``state_dict`` key by joining it with dots and renaming the
leaf; only the layouts differ:

- Dense ``kernel`` [in, out] and ResFieldLinear ``weight`` [in, out]
  -> ``weight`` [out, in];
- conv ``kernel`` HWIO -> ``weight`` OIHW; a per-frame conv's
  ``frame_weights`` [F, kh, kw, I, O] -> [F, O, I, kh, kw];
- the conv stacks' bias-free ``<name>_kernel`` leaves keep their names:
  ``Conv1DStack``'s [3, 1, I, O] -> OIW [O, I, 3], ``Conv3DStack``'s
  DHWIO -> OIDHW;
- GroupNorm ``scale`` -> ``weight``;
- the frozen noise buffers NLC, NHWC and NDHWC -> NCL, NCHW and NCDHW;
- the NGP hash ``table`` [L, T, F], the ResField ``weights_t`` [C, R]
  and ``matrix_t`` [R, out * in] (already in the port's ``(out, in)``
  order, so never transposed), the rest of the ResField zoo's leaves
  (``chunk_weights`` [K, out, in], ``attention_weight``, ``resnet_vec``,
  the cp and tucker factors, ``lora_3``'s grid), the density scalars
  ``beta``, ``lamb``, ``gamma``, the DCT flow head's
  ``trajectory_basis``, the learned ``planes`` / ``time_planes``
  [P, C, H, W] and ``grid`` [C, D, H, W], and a channel-packed
  attention's block-diagonal ``to_*_kernel`` [P, c, c] and ``to_*_bias``
  [P, c] (``SPLATFIELDS_PACKED_CNN``) keep their layouts.

Loading is strict: a key the module lacks, a module key the tree lacks,
or a shape mismatch raises. Gradients and Adam moments, which have the
params' shape, convert the same way (``flax_to_state_dict``,
``adam_state_from_numpy``), so both packages can start from one state.

``module_to_flax`` is the inverse: a module's parameters and persistent
buffers as the flax variable tree, the leaf renamed by the module's type
(``nn.Linear`` and conv ``weight`` -> ``kernel``, ``nn.GroupNorm``
``weight`` -> ``scale``, ``ResFieldLinear`` keeps ``weight``) and laid
out back. With
``utils/msgpack.py`` the field weights then read and write as the JAX
package's ``deform.msgpack`` (``models/deform_model.py``), with neither
flax nor msgpack installed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from splatfields_torch.device import resolve_device
from splatfields_torch.models.decoder import SpatialAttention
from splatfields_torch.models.resfields import ResFieldLinear
from splatfields_torch.models.splats import AdamState, SplatParams


# leaves whose layout is the same in both packages
_KEPT = ("bias", "table", "weights_t", "matrix_t", "trajectory_basis",
         "planes", "time_planes", "grid",
         # the rest of the ResField zoo and the density scalars
         "chunk_weights", "attention_weight", "resnet_vec", "lin_w",
         "lin_f1", "lin_f2", "lin_f3", "tucker_core", "tucker_f0",
         "tucker_f1", "tucker_f2", "beta", "lamb", "gamma",
         # a channel-packed SpatialAttention's block-diagonal biases
         "to_q_bias", "to_k_bias", "to_v_bias", "to_out_bias")
# its block-diagonal kernels [P, c, c], kept; the conv stacks' bias-free
# kernels of the same suffix are rank 4 and 5 in flax, rank 3 and 5 here
_PACKED_KERNELS = ("to_q_kernel", "to_k_kernel", "to_v_kernel",
                   "to_out_kernel")
# the noise buffers, channels last in flax, by rank: flax -> torch axes
_NOISE_TO_TORCH = {3: (0, 2, 1), 4: (0, 3, 1, 2), 5: (0, 4, 1, 2, 3)}
_NOISE_TO_FLAX = {3: (0, 2, 1), 4: (0, 2, 3, 1), 5: (0, 2, 3, 4, 1)}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(path: tuple, value: np.ndarray, collection: str):
    *mods, leaf = path
    if collection == "buffers":
        if leaf != "noise" or value.ndim not in _NOISE_TO_TORCH:
            raise KeyError(f"unknown buffer {'/'.join(path)}")
        return ".".join(path), value.transpose(_NOISE_TO_TORCH[value.ndim])
    if leaf in _PACKED_KERNELS and value.ndim == 3:
        return ".".join(path), value
    if leaf.endswith("_kernel"):   # the conv stacks' bias-free kernels
        if value.ndim == 4:        # [3, 1, I, O] -> OIW
            return ".".join(path), value[:, 0].transpose(2, 1, 0)
        if value.ndim == 5:        # DHWIO -> OIDHW
            return ".".join(path), value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"{'/'.join(path)}: unexpected rank {value.ndim}")
    if leaf == "frame_weights":    # [F, kh, kw, I, O] -> [F, O, I, kh, kw]
        return ".".join(path), value.transpose(0, 4, 3, 1, 2)
    if leaf in ("kernel", "weight"):
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: unexpected rank {value.ndim}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf not in _KEPT:
        raise KeyError(f"unknown parameter {'/'.join(path)}")
    return ".".join((*mods, leaf)), value


def flax_to_state_dict(tree: Mapping, collection: str = "params",
                       device="cpu") -> dict[str, torch.Tensor]:
    """One flax collection (nested dicts of numpy arrays) -> ``{state_dict
    name: f32 tensor}``. Any tree shaped like the params converts the same
    way: gradients and Adam moments too."""
    device = resolve_device(device)
    out = {}
    for path, value in _flatten(tree):
        key, value = _convert(path, value, collection)
        out[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return out


def load_flax_variables(module: torch.nn.Module, tree: Mapping) -> None:
    """Copy a flax variable tree ``{"params": ..., "buffers": ...}`` (nested
    dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, variables)``)
    into ``module`` in place."""
    unknown = set(tree) - {"params", "buffers"}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    target = module.state_dict()
    loaded = {}
    for collection in ("params", "buffers"):
        for key, value in flax_to_state_dict(tree.get(collection, {}),
                                             collection).items():
            if key not in target:
                raise KeyError(f"{collection} {key!r} has no counterpart in "
                               "the module")
            if target[key].shape != value.shape:
                raise ValueError(f"{key}: module shape "
                                 f"{tuple(target[key].shape)} != "
                                 f"{tuple(value.shape)}")
            loaded[key] = value
    missing = set(target) - set(loaded)
    if missing:
        raise KeyError(f"module keys missing from the tree: {sorted(missing)}")
    module.load_state_dict(loaded, strict=True)


def splat_params_from_numpy(p, device=None) -> SplatParams:
    """``SplatParams`` from an object or mapping with numpy fields (xyz,
    features_dc, features_rest, scaling, rotation, opacity), e.g. the JAX
    package's ``SplatParams`` after ``jax.tree.map(np.asarray, ...)``.
    ``device=None`` means the GPU."""
    device = resolve_device(device)
    get = p.get if isinstance(p, Mapping) else (lambda k: getattr(p, k))
    fields = {f: torch.tensor(np.asarray(get(f)), dtype=torch.float32,
                              device=device)
              for f in SplatParams.__dataclass_fields__}
    return SplatParams(**fields)


def adam_state_from_numpy(state, device=None) -> AdamState:
    """The JAX package's ``AdamState`` (count, mu, nu as numpy trees) ->
    the port's. Moments of the splat tree become ``SplatParams``; moments
    of the field tree (flax-shaped dicts) become ``{state_dict name:
    tensor}`` dicts, as ``DeformModel.params``. ``device=None`` means the
    GPU."""
    def tree(t):
        if isinstance(t, Mapping) and set(t) != set(
                SplatParams.__dataclass_fields__):
            return flax_to_state_dict(t, device=device)
        return splat_params_from_numpy(t, device=device)

    return AdamState(count=int(np.asarray(state.count)), mu=tree(state.mu),
                     nu=tree(state.nu))


def _flax_leaf(module: nn.Module, leaf: str, value: np.ndarray):
    if leaf in _KEPT or (leaf in _PACKED_KERNELS
                         and isinstance(module, SpatialAttention)):
        return leaf, value
    if leaf.endswith("_kernel"):
        if value.ndim == 3:   # OIW -> [3, 1, I, O]
            return leaf, value.transpose(2, 1, 0)[:, None]
        if value.ndim == 5:   # OIDHW -> DHWIO
            return leaf, value.transpose(2, 3, 4, 1, 0)
        raise ValueError(f"{leaf}: unexpected rank {value.ndim}")
    if leaf == "frame_weights":   # [F, O, I, kh, kw] -> [F, kh, kw, I, O]
        return leaf, value.transpose(0, 3, 4, 2, 1)
    if leaf != "weight":
        raise KeyError(f"no flax counterpart for parameter {leaf!r} of "
                       f"{type(module).__name__}")
    if isinstance(module, nn.GroupNorm):
        return "scale", value
    if value.ndim == 2:   # nn.Linear kernel / ResFieldLinear weight [in, out]
        name = "weight" if isinstance(module, ResFieldLinear) else "kernel"
        return name, value.T
    if value.ndim == 4:   # conv OIHW -> HWIO
        return "kernel", value.transpose(2, 3, 1, 0)
    raise ValueError(f"{type(module).__name__}.weight: unexpected rank "
                     f"{value.ndim}")


def module_to_flax(module: nn.Module) -> dict:
    """The module's parameters and persistent buffers as a flax variable
    tree ``{"params": ..., "buffers": ...}`` of contiguous numpy arrays
    (``buffers`` only when the module has some)."""
    tree: dict = {"params": {}, "buffers": {}}

    def put(collection, path, value):
        node = tree[collection]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.copy(order="C")   # 0-d stays 0-d

    for mod_name, mod in module.named_modules():
        path = tuple(mod_name.split(".")) if mod_name else ()
        for leaf, p in mod.named_parameters(recurse=False):
            name, value = _flax_leaf(mod, leaf, p.detach().cpu().numpy())
            put("params", path + (name,), value)
        for leaf, b in mod.named_buffers(recurse=False):
            if leaf in mod._non_persistent_buffers_set:
                continue
            if leaf != "noise" or b.ndim not in _NOISE_TO_FLAX:
                raise KeyError(f"unknown buffer {mod_name}.{leaf}")
            put("buffers", path + (leaf,),
                b.detach().cpu().numpy().transpose(_NOISE_TO_FLAX[b.ndim]))
    if not tree["buffers"]:
        del tree["buffers"]
    return tree
