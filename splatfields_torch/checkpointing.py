"""Training-state checkpoints for ``--resume`` (counterpart of
``splatfields_tpu/checkpointing.py``).

``model_path/train_state/iteration_N/state.pt`` holds, as plain tensors
(``torch.save``, loadable with ``weights_only=True``): the splat params
and stats, both Adam states, the field net's ``state_dict`` and the
densify noise generator's state; ``meta.json`` beside it holds the iteration, the
capacity and what the caller adds (the loop adds its ``dup_factor`` and
its view-order ``random.Random`` state). The JAX package writes a flat
leaf list in JAX tree order (``state.msgpack``), which is tied to flax's
tree layout; the two formats are not interchangeable. The field weights
that ``render.py`` reads are separate and shared: ``deform.msgpack``
(``models/deform_model.py``).
"""
from __future__ import annotations

import json
import os

import torch

from splatfields_torch.models import splats as splats_lib
from splatfields_torch.utils.system import search_for_max_iteration


def _cpu(tree) -> dict:
    return {k: v.detach().cpu() for k, v in
            splats_lib.tree_items(tree).items()}


def _adam(state: splats_lib.AdamState) -> dict:
    return {"count": int(state.count), "mu": _cpu(state.mu),
            "nu": _cpu(state.nu)}


def save_train_state(model_path: str, iteration: int, splat_params,
                     splat_stats, splat_opt, field_state: dict, field_opt,
                     densify_rng: torch.Generator,
                     extra: dict | None = None):
    out = os.path.join(model_path, "train_state", f"iteration_{iteration}")
    os.makedirs(out, exist_ok=True)
    torch.save({
        "splat_params": _cpu(splat_params),
        "splat_stats": _cpu(splat_stats),
        "splat_opt": _adam(splat_opt),
        "field_state": _cpu(field_state),
        "field_opt": _adam(field_opt),
        "densify_rng": densify_rng.get_state(),
    }, os.path.join(out, "state.pt"))
    meta = {"iteration": iteration, "capacity": splat_params.capacity}
    meta.update(extra or {})
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_train_state(model_path: str, device,
                     iteration: int = -1) -> tuple[dict, dict] | None:
    """(state, meta) of ``iteration`` (-1: the latest) with every tensor on
    ``device`` and the trees rebuilt (``SplatParams``, ``SplatStats``,
    ``AdamState``), or None when there is no checkpoint."""
    root = os.path.join(model_path, "train_state")
    if iteration == -1:
        iteration = search_for_max_iteration(root)
        if iteration is None:
            return None
    path = os.path.join(root, f"iteration_{iteration}", "state.pt")
    if not os.path.exists(path):
        return None
    raw = torch.load(path, map_location="cpu", weights_only=True)
    with open(os.path.join(os.path.dirname(path), "meta.json")) as f:
        meta = json.load(f)

    def put(tree):
        return {k: v.to(device) for k, v in tree.items()}

    def params(tree):
        return splats_lib.SplatParams(**put(tree))

    def adam(st, tree_of):
        return splats_lib.AdamState(count=st["count"], mu=tree_of(st["mu"]),
                                    nu=tree_of(st["nu"]))

    state = {
        "splat_params": params(raw["splat_params"]),
        "splat_stats": splats_lib.SplatStats(**put(raw["splat_stats"])),
        "splat_opt": adam(raw["splat_opt"], params),
        "field_state": put(raw["field_state"]),
        "field_opt": adam(raw["field_opt"], put),
        "densify_rng": raw["densify_rng"],
    }
    return state, meta
