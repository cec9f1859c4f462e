"""The SplatFields network (counterpart of
``splatfields_tpu/models/splatfields.py``).

Given N points: encoder features (planes, a grid or the NGP hash grid +
MLP) refined by two Linear layers with a ReLU between; ``mlp_deform``
offsets the points (``xyz_can = xyz + deform_weight * delta``);
``mlp_scale`` / ``mlp_opacity`` (sigmoid) / ``mlp_rotation`` (normalize) /
``mlp_rgb`` (sigmoid) read (xyz_can, features), sharing one positional
embedding of xyz_can at the largest multires. Every encoder of the JAX
package builds (``_ENCODERS``); any other ``encoder_type`` means no
encoder, the pure-MLP ablation.

``use_view_dep_rgb``: ``mlp_rgb`` returns ``rgb_w`` features with no
sigmoid (``rgb_feat``), and ``rgb_from_viewdir`` turns them into colours
with the per-splat view directions: sigmoid(``rgb_viewdep``([feat,
dir])). ``geo_model_disable_pts``: the scale, opacity and rotation heads
read the features alone, at multires 0.

4-D fields (``n_frames > 0``): the features gain a ``time_multires``
positional embedding of the time step t (appended after the refined
plane features); every head's hidden layers carry ResField ranks
(``composition_rank``); ``mlp_flow`` and the ``FlowHead``
(``mlp_flow_head``) move ``xyz_can`` to the frame's means. The frame is
``round(t * (n_frames - 1))`` in float32, half to even, as the JAX
package computes it; the caller passes it as a host int
(``frame_id_of``), so no device value is read back.

``fused_pallas="on"`` (or ``SPLATFIELDS_FUSED_MLP=on``, which overrides
the attribute) runs the heads through ``ops/fused_mlp.py``: one fused call
for ``mlp_deform`` on pe(xyz) and one for the other four heads on
pe(xyz_can), hand-written CUDA kernels on the card. ``"auto"`` means off,
as in the JAX package.

``fuse_heads=True`` (off by default, as in JAX) is another thing: the
heads of equal hidden width run as one batched product a depth level
(``mlp.fused_mlp_heads``, ``torch.bmm``), with the same math. It applies
when the ResField ranks are inactive (``composition_rank == 0`` or a
static field): the scale, opacity and rotation heads when their widths
are equal, and on a 4-D field ``mlp_rgb`` with ``mlp_flow`` when
``rgb_w == flow_w`` (the defaults, 128). Traps, as in JAX: the fused CUDA
path wins when both are set; and ``fused_mlp_heads`` runs in f32, so
under ``fuse_heads`` the fused heads ignore ``SPLATFIELDS_MLP_BF16``
while the others (``mlp_deform``, and on a static field ``mlp_rgb``)
follow its rule.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.encoders import (
    NGPMLP,
    GridEncoder,
    HexPlaneEncoder,
    TriPlaneEncoder,
    VarHexPlaneEncoder,
    VarTriPlaneEncoder,
)
from splatfields_torch.models.flow import FlowHead
from splatfields_torch.models.initializers import torch_linear_
from splatfields_torch.models.mlp import (
    GeneralMLP,
    embed_dim,
    fused_mlp_heads,
    positional_embed,
)
from splatfields_torch.models.resfields import _normalize
from splatfields_torch.ops.fused_mlp import (
    fused_heads,
    pack_params,
    plan_from_module,
)

# the JAX package's encoders; any other encoder_type means no encoder
_ENCODERS = {
    "VarTriPlaneEncoder": VarTriPlaneEncoder,
    "VarHexPlaneEncoder": VarHexPlaneEncoder,
    "TriPlaneEncoder": TriPlaneEncoder,
    "HexPlaneEncoder": HexPlaneEncoder,
    "GridEncoder": GridEncoder,
    "NGPMLP": NGPMLP,
}
# encoders whose planes are generated, once a step (``generate_planes``)
_GENERATED = ("VarTriPlaneEncoder", "VarHexPlaneEncoder")


def frame_id_of(fid: float, n_frames: int) -> int:
    """The frame of time step ``fid``: ``round(fid * (n_frames - 1))`` in
    float32, half to even, as the JAX ``SplatFields`` computes it."""
    return int(np.round(np.float32(fid) * np.float32(n_frames - 1)))


def time_inputs(n: int, fid: float, n_frames: int, device) -> dict:
    """The keyword arguments that put ``n`` points of a 4-D field at time
    step ``fid`` (a host number): t [n, 1] and its frame; none for a
    static field."""
    if n_frames <= 0:
        return {}
    return {"t": torch.full((n, 1), float(np.float32(fid)), device=device),
            "frame_id": frame_id_of(fid, n_frames)}


class SplatFields(nn.Module):
    """``fused_pallas``: "on", "off" or "auto" (= off), re-read with the
    ``SPLATFIELDS_FUSED_MLP`` override on every forward.
    ``fused_compute_dtype``: the fused path's matrix operand type; None
    means as the JAX package, bf16 on the card and f32 on the CPU.
    ``fused_block`` is kept for signature parity and is inert: the TPU
    kernel's grid block has no counterpart in the CUDA kernels."""

    def __init__(self, n_frames: int = 0, radius: float | None = None,
                 encoder_type: str = "", encoder_args: Any = None,
                 layer_strategy: str = "none", composition_rank: int = 0,
                 deform_weight: float = 1.0, use_view_dep_rgb: bool = False,
                 geo_model_disable_pts: bool = False, time_multires: int = 3,
                 deform_w: int = 128, deform_d: int = 6, deform_skips=(3,),
                 deform_multires: int = 6,
                 rgb_w: int = 128, rgb_d: int = 6, rgb_skips=(3,),
                 rgb_multires: int = 6,
                 scale_w: int = 64, scale_d: int = 4, scale_skips=(2,),
                 scale_multires: int = 4,
                 opacity_w: int = 64, opacity_d: int = 4, opacity_skips=(2,),
                 opacity_multires: int = 3,
                 rotation_w: int = 64, rotation_d: int = 3,
                 rotation_skips=(20,), rotation_multires: int = 3,
                 flow_w: int = 128, flow_d: int = 6, flow_skips=(3,),
                 flow_multires: int = 6, flow_model: str = "se3",
                 dct_basis: int = 4, contract_ngp: bool = False,
                 log2_hashmap_size: int = 20, n_levels: int = 16,
                 fused_pallas: str = "auto", fused_block: int = 2048,
                 fused_compute_dtype=None, fuse_heads: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        # the batched heads apply while the ResField ranks are inactive
        self.fuse_heads = fuse_heads and (composition_rank == 0
                                          or n_frames <= 0)
        self.fused_pallas = fused_pallas
        self.fused_block = fused_block
        self.fused_compute_dtype = fused_compute_dtype
        gen = generator
        self.n_frames = n_frames
        self.use_view_dep_rgb = use_view_dep_rgb
        self.geo_model_disable_pts = geo_model_disable_pts
        self.deform_weight = deform_weight
        self.time_multires = time_multires
        # the geometry heads read the features alone, unembedded
        geo_mr = ((lambda mr: 0) if geo_model_disable_pts
                  else (lambda mr: mr))
        self.max_multires = max(rgb_multires, geo_mr(scale_multires),
                                geo_mr(opacity_multires),
                                geo_mr(rotation_multires),
                                flow_multires if n_frames > 0 else 0)
        args = dict(encoder_args or {})
        self.encoder, self.feat_dim = None, 0
        if encoder_type in _GENERATED:
            args.setdefault("n_frames", n_frames)
            args.setdefault("strategy", layer_strategy)
        elif encoder_type == "NGPMLP":
            args.setdefault("radius", radius or 1.0)
            args.setdefault("contract", contract_ngp)
            args.setdefault("log2_hashmap_size", log2_hashmap_size)
            args.setdefault("n_levels", n_levels)
        if encoder_type in _ENCODERS:
            self.encoder = _ENCODERS[encoder_type](**args, generator=gen)
            self.feat_dim = self.encoder.out_dim
            # refine0 reads what the encoder returns (wider than out_dim
            # for VarTriPlane's space_cat)
            width = self.encoder.width
            self.refine0 = nn.Linear(width, self.feat_dim)
            self.refine1 = nn.Linear(self.feat_dim, self.feat_dim)
            torch_linear_(self.refine0.weight, self.refine0.bias, width, gen)
            torch_linear_(self.refine1.weight, self.refine1.bias,
                          self.feat_dim, gen)

        time_ch = 1 + 2 * time_multires if n_frames > 0 else 0
        in_feat = 3 + self.feat_dim + time_ch
        geo_in = in_feat - (3 if geo_model_disable_pts else 0)

        def head(out, w, d, skips, mr, out_act, fin=in_feat):
            return GeneralMLP(fin, out, w, d, skips, mr, out_act,
                              "leaky_relu", composition_rank, n_frames,
                              generator=gen)

        # like flax, which creates a head's params only when it runs
        self.mlp_deform = (head(3, deform_w, deform_d, deform_skips,
                                deform_multires, "none")
                           if deform_weight > 0 else None)
        if use_view_dep_rgb:
            self.mlp_rgb = head(rgb_w, rgb_w, rgb_d, rgb_skips, rgb_multires,
                                "none")
            self.rgb_viewdep = nn.Linear(rgb_w + 3, 3)
            torch_linear_(self.rgb_viewdep.weight, self.rgb_viewdep.bias,
                          rgb_w + 3, gen)
        else:
            self.mlp_rgb = head(3, rgb_w, rgb_d, rgb_skips, rgb_multires,
                                "sigmoid")
        self.mlp_scale = head(3, scale_w, scale_d, scale_skips,
                              geo_mr(scale_multires), "none", geo_in)
        self.mlp_opacity = head(1, opacity_w, opacity_d, opacity_skips,
                                geo_mr(opacity_multires), "sigmoid", geo_in)
        self.mlp_rotation = head(4, rotation_w, rotation_d, rotation_skips,
                                 geo_mr(rotation_multires), "normalize",
                                 geo_in)
        self.mlp_flow = self.mlp_flow_head = None
        if n_frames > 0:
            self.mlp_flow = head(flow_w, flow_w, flow_d, flow_skips,
                                 flow_multires, "none")
            self.mlp_flow_head = FlowHead(flow_w, flow_model, dct_basis,
                                          n_frames, generator=gen)

    def generate_planes(self, frame_id: int | None = None) -> torch.Tensor:
        """The N-independent plane CNNs only (VarTriPlane, VarHexPlane), at
        ``frame_id`` for per-frame conv deltas."""
        return self.encoder.planes(frame_id)

    def extract_features(self, x: torch.Tensor, t=None, planes=None,
                         frame_id: int | None = None):
        """Refined encoder features, then (4-D) the time embedding. The
        encoder reads t (the HexPlanes' time coordinate) and the frame."""
        feat = None
        if self.encoder is not None:
            # only the generated encoders take planes
            kw = {} if planes is None else {"planes": planes}
            feat = self.encoder(x, t, frame_id, **kw)
            feat = self.refine1(F.relu(self.refine0(feat)))
        if self.n_frames <= 0:
            return feat
        t_feat = positional_embed(t, self.time_multires)
        return t_feat if feat is None else torch.cat([feat, t_feat], -1)

    def forward(self, xyz_in: torch.Tensor, t: torch.Tensor | None = None,
                planes: torch.Tensor | None = None,
                frame_id: int | None = None) -> Dict[str, Any]:
        """xyz_in [N, 3]; for a 4-D field t [N, 1] (one value) and its
        ``frame_id`` (``frame_id_of``)."""
        if self.n_frames > 0 and (t is None or frame_id is None):
            raise ValueError("a 4-D field needs t and frame_id")
        pts_feat = self.extract_features(xyz_in, t, planes, frame_id)
        if self._fused_pallas_active():
            return self._call_fused(xyz_in, pts_feat)
        return self._call_unfused(xyz_in, pts_feat, t, frame_id)

    def _call_unfused(self, xyz_in: torch.Tensor,
                      pts_feat: torch.Tensor | None, t=None,
                      frame_id: int | None = None) -> Dict[str, Any]:
        """The heads one GeneralMLP at a time, or with ``fuse_heads``
        those of equal width batched a depth level."""
        xyz_can = xyz_in
        if self.mlp_deform is not None:
            xyz_can = xyz_in + self.deform_weight * self.mlp_deform(
                xyz_in, pts_feat, frame_id=frame_id)
        # one shared sin/cos sweep; each head slices its prefix
        can_emb = positional_embed(xyz_can, self.max_multires)
        geo = ((pts_feat, None, None) if self.geo_model_disable_pts
               else (xyz_can, pts_feat, can_emb))
        heads = (("scales", self.mlp_scale), ("opacity", self.mlp_opacity),
                 ("rotations", self.mlp_rotation))
        if self.fuse_heads and len({h.hidden for _, h in heads}) == 1:
            outs = fused_mlp_heads([h for _, h in heads],
                                   [self._head_in(h, *geo) for _, h in heads])
            out = {name: h.out_activation(o)
                   for (name, h), o in zip(heads, outs)}
        else:
            out = {name: h(*geo, frame_id=frame_id) for name, h in heads}
        if (self.fuse_heads and self.mlp_flow is not None
                and self.mlp_rgb.hidden == self.mlp_flow.hidden):
            pair = (self.mlp_rgb, self.mlp_flow)
            rgb, hidden = fused_mlp_heads(
                pair, [self._head_in(h, xyz_can, pts_feat, can_emb)
                       for h in pair])
            out[self._rgb_key()] = self.mlp_rgb.out_activation(rgb)
        else:
            out[self._rgb_key()] = self.mlp_rgb(xyz_can, pts_feat, can_emb,
                                                frame_id=frame_id)
            hidden = (None if self.mlp_flow is None else
                      self.mlp_flow(xyz_can, pts_feat, can_emb,
                                    frame_id=frame_id))
        out["flow"], out["means3D"] = None, xyz_can
        if self.mlp_flow is not None:
            out["flow"], out["means3D"] = self.mlp_flow_head(
                hidden, xyz_can, time_step=t[:1], frame_id=frame_id)
        return out

    @staticmethod
    def _head_in(head: GeneralMLP, xyz, feat, emb) -> torch.Tensor:
        """A head's embedded input, as ``GeneralMLP.forward`` builds it."""
        h_in = (xyz if head.multires <= 0 else
                emb[:, :embed_dim(head.multires, xyz.shape[-1])])
        return h_in if feat is None else torch.cat([h_in, feat], dim=-1)

    def _fused_pallas_active(self) -> bool:
        """The fused path covers the static rank-0 point-conditioned
        configuration; "auto" is off, as in the JAX package."""
        mode = os.environ.get("SPLATFIELDS_FUSED_MLP", self.fused_pallas)
        return (mode == "on" and self.n_frames <= 0
                and not self.geo_model_disable_pts)

    def _call_fused(self, xyz_in: torch.Tensor,
                    pts_feat: torch.Tensor | None) -> Dict[str, Any]:
        cdt = self.fused_compute_dtype or (
            torch.bfloat16 if xyz_in.is_cuda else torch.float32)
        feat = (pts_feat if pts_feat is not None
                else xyz_in.new_zeros(xyz_in.shape[0], 0))
        xyz_can = xyz_in
        if self.mlp_deform is not None:
            plan = plan_from_module(self, "deform")
            emb = positional_embed(xyz_in, self.mlp_deform.multires)
            (delta,) = fused_heads(plan, emb, feat,
                                   *pack_params(self, plan), cdt)
            xyz_can = xyz_in + self.deform_weight * delta
        plan = plan_from_module(self, "downstream")
        emb = positional_embed(xyz_can, self.max_multires)
        rgb, scales, opacity, rotations = fused_heads(
            plan, emb, feat, *pack_params(self, plan), cdt)
        return {
            "scales": scales,
            "opacity": torch.sigmoid(opacity),
            "rotations": _normalize(rotations),
            self._rgb_key(): rgb if self.use_view_dep_rgb
            else torch.sigmoid(rgb),
            "flow": None,
            "means3D": xyz_can,
        }

    def _rgb_key(self) -> str:
        return "rgb_feat" if self.use_view_dep_rgb else "rgb"

    def rgb_from_viewdir(self, rgb_feat: torch.Tensor, viewdirs: torch.Tensor,
                         params: dict | None = None) -> torch.Tensor:
        """The view-dependent colour head: sigmoid(rgb_viewdep([feat,
        dir])) with per-splat view directions. ``params`` (``{state_dict
        name: tensor}``) replaces the layer's own weights."""
        x = torch.cat([rgb_feat, viewdirs], dim=-1)
        if params is None:
            return torch.sigmoid(self.rgb_viewdep(x))
        return torch.sigmoid(F.linear(x, params["rgb_viewdep.weight"],
                                      params["rgb_viewdep.bias"]))
