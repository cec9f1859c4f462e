"""Field-model holder: the SplatFields net and its Adam (counterpart of
``splatfields_tpu/models/deform_model.py``). One Adam (eps 1e-15) over all
field parameters at ``position_lr_init * 5``, decaying exponentially to
``position_lr_final`` over ``deform_lr_max_steps``. The weights are saved
as ``model_path/deform/iteration_N/deform.msgpack`` in the JAX package's
own format (flax's msgpack of the variable tree, written and read by
``utils/msgpack.py`` and ``interop``; a 4-D field's ResField and flow
leaves too), so either package renders a run directory the other
trained."""
from __future__ import annotations

import os

import torch

from splatfields_torch import interop
from splatfields_torch.device import resolve_device
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.models.splatfields import SplatFields
from splatfields_torch.utils import msgpack
from splatfields_torch.utils.schedules import expon_lr_func
from splatfields_torch.utils.system import search_for_max_iteration

SPATIAL_LR_SCALE = 5.0


def build_splatfields(hidden_cfg, radius: float | None = None, *,
                      generator: torch.Generator) -> SplatFields:
    """The net from a HiddenConfig (flag surface -> module arguments);
    ``radius`` is the scene radius the NGP encoder normalises by."""
    h = hidden_cfg
    return SplatFields(
        n_frames=h.n_frames, radius=radius, encoder_type=h.encoder_type,
        encoder_args=dict(h.encoder_args or {}),
        layer_strategy=h.layer_strategy,
        composition_rank=h.composition_rank, deform_weight=h.deform_weight,
        use_view_dep_rgb=h.use_view_dep_rgb,
        geo_model_disable_pts=h.geo_model_disable_pts, rgb_w=h.rgb_w,
        flow_model=h.flow_model, dct_basis=h.dct_basis,
        contract_ngp=h.contract_ngp, log2_hashmap_size=h.log2_hashmap_size,
        n_levels=h.n_levels, generator=generator)


class DeformModel:
    """The SplatFields net on a device, initialised from ``seed``.

    The weights are drawn on the CPU from a ``torch.Generator`` and then
    moved, so one seed gives the same net on every device. ``device=None``
    means the GPU. ``radius`` (the scene radius) is read only by the NGP
    encoder."""

    def __init__(self, hidden_cfg, radius=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.net = build_splatfields(hidden_cfg, radius, generator=gen)
        self.net = self.net.to(self.device).eval()
        self.n_frames = hidden_cfg.n_frames
        self.opt_state = splats_lib.adam_init(self.params)
        self.scheduler = None

    def train_setting(self, opt_cfg):
        self.scheduler = expon_lr_func(
            lr_init=opt_cfg.position_lr_init * SPATIAL_LR_SCALE,
            lr_final=opt_cfg.position_lr_final,
            lr_delay_mult=opt_cfg.position_lr_delay_mult,
            max_steps=opt_cfg.deform_lr_max_steps)

    def learning_rate(self, iteration: int) -> float:
        return float(self.scheduler(iteration))

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The net's parameters as ``{state_dict name: tensor}``, detached
        (the tree the train step and Adam take)."""
        return {k: p.detach() for k, p in self.net.named_parameters()}

    @params.setter
    def params(self, new_params: dict[str, torch.Tensor]):
        """Write a parameter tree (a train step's output) into the net."""
        with torch.no_grad():
            for k, p in self.net.named_parameters():
                p.copy_(new_params[k])

    def save_weights(self, model_path: str, iteration: int):
        out = os.path.join(model_path, f"deform/iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "deform.msgpack"), "wb") as f:
            f.write(msgpack.flax_to_bytes(interop.module_to_flax(self.net)))

    def load_weights(self, model_path: str, iteration: int = -1) -> int:
        """Load ``deform/iteration_N/deform.msgpack`` (N = the latest for
        -1), written by either package; returns N."""
        if iteration == -1:
            iteration = search_for_max_iteration(
                os.path.join(model_path, "deform"))
        path = os.path.join(model_path, f"deform/iteration_{iteration}",
                            "deform.msgpack")
        with open(path, "rb") as f:
            tree = msgpack.flax_from_bytes(f.read())
        interop.load_flax_variables(self.net, tree)
        self.opt_state = splats_lib.adam_init(self.params)
        return iteration

    def log_variables(self):
        return {}
