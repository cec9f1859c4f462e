"""Carry state of the JAX package across to the port, from numpy arrays.

The port's module names equal the flax module names, so a flax variable
path maps to a ``state_dict`` key by joining it with dots and renaming the
leaf; only the layouts differ:

- Dense ``kernel`` [in, out] and ResFieldLinear ``weight`` [in, out]
  -> ``weight`` [out, in];
- conv ``kernel`` HWIO -> ``weight`` OIHW;
- GroupNorm ``scale`` -> ``weight``;
- the frozen noise buffers NHWC -> NCHW.

Loading is strict: a key the module lacks, a module key the tree lacks,
or a shape mismatch raises. No flax or msgpack is needed; reading
``deform.msgpack`` checkpoints without flax is a ROADMAP item.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from splatfields_torch.device import resolve_device
from splatfields_torch.models.splats import SplatParams


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(path: tuple, value: np.ndarray, collection: str):
    *mods, leaf = path
    if collection == "buffers":
        if leaf != "noise" or value.ndim != 4:
            raise KeyError(f"unknown buffer {'/'.join(path)}")
        return ".".join(path), value.transpose(0, 3, 1, 2)
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
    elif leaf != "bias":
        raise KeyError(f"unknown parameter {'/'.join(path)}")
    return ".".join((*mods, leaf)), value


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
        for path, value in _flatten(tree.get(collection, {})):
            key, value = _convert(path, value, collection)
            if key not in target:
                raise KeyError(f"{collection}/{'/'.join(path)} has no "
                               f"counterpart {key!r} in the module")
            if tuple(target[key].shape) != value.shape:
                raise ValueError(f"{key}: module shape "
                                 f"{tuple(target[key].shape)} != {value.shape}")
            loaded[key] = torch.tensor(value, dtype=target[key].dtype)
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
