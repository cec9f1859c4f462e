"""Positional embedding and the GeneralMLP field head (counterpart of
``splatfields_tpu/models/mlp.py``).

The reference's quirks stay: the embedding is applied to the raw ``xyz``
with extra features concatenated after; the skip concatenates the embedded
input in front (``h = cat([h_in, h])``) after layer i in ``skips``; the
activation (leaky_relu 0.01) follows EVERY layer including the last, and
``out_activation`` is applied on top of it.

ResField ranks go on the created hidden layers with index >= 1 only, with
capacity ``n_frames``; ``frame_id`` (a host int) reaches every layer.

Activations between layers are bf16 or f32 by the JAX package's
``SPLATFIELDS_MLP_BF16``: ``on``, ``off``, or ``auto`` (the default and any
other value): bf16 for a static field (``n_frames == 0``), f32 for a 4-D
one, on every device. In bf16 the rounding points are JAX's: the input is
cast once and the skip concatenates that cast; each plain layer is
``resfields.bf16_linear`` (bf16 operands summed in f32, f32 bias); the
activation runs in f32 and its result is cast to bf16; the last output
is cast back to f32 before ``out_activation``.

``fused_mlp_heads`` (JAX ``models/mlp.py:48-105``) runs several rank-0
heads as one batched product a depth level: ``SplatFields(fuse_heads=
True)``. It is not the fused CUDA kernel (``ops/fused_mlp.py``), and it
always runs in f32: it never applies ``SPLATFIELDS_MLP_BF16``.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.resfields import ResFieldLinear, _out_act


def mlp_bf16(n_frames: int) -> bool:
    """``SPLATFIELDS_MLP_BF16``'s rule (JAX ``models/mlp.py:166-170``)."""
    env = os.environ.get("SPLATFIELDS_MLP_BF16", "auto")
    if env in ("on", "off"):
        return env == "on"
    return n_frames == 0


def embed_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires)


def positional_embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., D] -> [..., D (1 + 2 multires)]: x, then (sin, cos) of x * 2^k
    for k = 0 .. multires-1; identity if multires == 0."""
    if multires <= 0:
        return x
    outs = [x]
    for k in range(multires):
        f = float(2.0 ** k)
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


class GeneralMLP(nn.Module):
    """Layers ``net_0 .. net_{H+1}``: in -> W, H hidden, W -> out."""

    def __init__(self, in_features: int = 3, out_features: int = 3,
                 hidden_features: int = 128, num_hidden_layers: int = 8,
                 skips: Sequence[int] = (4,), multires: int = 6,
                 out_activation: str = "none", act: str = "relu",
                 composition_rank: int = 0, n_frames: int = 100, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_frames = n_frames
        self.hidden = hidden_features
        self.multires = multires
        self.skips = tuple(skips)
        self.act = _out_act(act)
        self.out_activation = _out_act(out_activation)
        emb_in = in_features - 3 + embed_dim(multires, 3)
        dims = [(emb_in, hidden_features, 0)]
        for i in range(num_hidden_layers):
            fin = hidden_features + (emb_in if i in self.skips else 0)
            rank = composition_rank if i >= 1 else 0
            cap = n_frames if (rank and n_frames > 0) else 0
            dims.append((fin, hidden_features, rank if cap else 0))
        dims.append((hidden_features, out_features, 0))
        self.n_layers = len(dims)
        for i, (fin, fout, rank) in enumerate(dims):
            self.add_module(f"net_{i}", ResFieldLinear(
                fin, fout, rank, n_frames if rank else 0, generator=generator))

    def forward(self, xyz: torch.Tensor, xyz_feat: torch.Tensor | None = None,
                xyz_embedded: torch.Tensor | None = None,
                frame_id: int | None = None) -> torch.Tensor:
        """``xyz_embedded``: a shared embedding of xyz at >= this head's
        multires; its leading columns are this head's embedding.
        ``frame_id``: the frame of the ResField layers' residuals."""
        if xyz_embedded is not None and self.multires > 0:
            h_in = xyz_embedded[:, : embed_dim(self.multires, xyz.shape[-1])]
        else:
            h_in = positional_embed(xyz, self.multires)
        if xyz_feat is not None:
            h_in = torch.cat([h_in, xyz_feat], dim=-1)
        bf16 = mlp_bf16(self.n_frames)
        if bf16:
            h_in = h_in.to(torch.bfloat16)
        h = h_in
        for i in range(self.n_layers):
            h = self.act(getattr(self, f"net_{i}")(h, frame_id))
            if bf16:
                h = h.to(torch.bfloat16)
            if i in self.skips and i != self.n_layers - 1:
                h = torch.cat([h_in, h], dim=-1)
        return self.out_activation(h.float() if bf16 else h)


def fused_mlp_heads(heads: Sequence["GeneralMLP"], h_in_list):
    """Run rank-0 ``GeneralMLP`` heads of equal hidden width on their
    embedded inputs ``h_in_list`` [N, in_j] as one ``torch.bmm`` a depth
    level: each level's weights [in, out] and inputs are zero-padded to
    the level's widest and stacked, so the heads' math is unchanged
    (padded columns meet zero weights). Every layer, the last included,
    is followed by the head's activation; the skips concatenate the
    embedded input in front. Returns each head's output before its
    ``out_activation``, in f32."""
    n_layers = [h.n_layers for h in heads]
    hs = list(h_in_list)
    outs = [None] * len(heads)
    for lvl in range(max(n_layers)):
        active = [j for j in range(len(heads)) if lvl < n_layers[j]]
        layers = [getattr(heads[j], f"net_{lvl}") for j in active]
        if len(active) == 1:
            j, = active
            new = {j: heads[j].act(hs[j] @ layers[0].weight.t()
                                   + layers[0].bias)}
        else:
            wi = max(layer.weight.shape[1] for layer in layers)
            wo = max(layer.weight.shape[0] for layer in layers)
            h_st = torch.stack([F.pad(hs[j], (0, wi - hs[j].shape[1]))
                                for j in active])
            w_st = torch.stack([F.pad(layer.weight.t(),
                                      (0, wo - layer.weight.shape[0], 0,
                                       wi - layer.weight.shape[1]))
                                for layer in layers])
            b_st = torch.stack([F.pad(layer.bias,
                                      (0, wo - layer.bias.shape[0]))
                                for layer in layers])
            out = torch.bmm(h_st, w_st) + b_st[:, None, :]
            new = {j: heads[j].act(out[k][:, :layers[k].weight.shape[0]])
                   for k, j in enumerate(active)}
        for j, h in new.items():
            if lvl == n_layers[j] - 1:
                outs[j] = h
            elif lvl in heads[j].skips:
                hs[j] = torch.cat([h_in_list[j], h], dim=-1)
            else:
                hs[j] = h
    return outs
