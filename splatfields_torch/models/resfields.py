"""ResField Linear, the SIREN MLP and the head output activations
(counterpart of ``splatfields_tpu/models/resfields.py``).

``ResFieldLinear`` computes ``y = x (W + dW_f)^T + b`` for frame ``f``.
At rank 0 (every static-scene head) it is a plain Linear. With a rank and
a capacity it holds the low-rank temporal residual the reference trains
with, ``compression='vm'``, ``mode='lookup'``, ``fuse_mode='add'``:
``dW_f = (weights_t[f] @ matrix_t).view(out, in)``, with ``weights_t``
[capacity, rank] and ``matrix_t`` [rank, out * in] flattened in
``(out, in)`` order, the order of the port's own weight. Only the
requested frame's coefficient row is contracted, as in the JAX package.
The other members of the reference's zoo (other compressions,
interpolation modes, other fuse modes) are not ported (ROADMAP Queue 1
item 6, the rest of the ResField zoo).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import torch_linear_


class ResFieldLinear(nn.Module):
    """y = x W^T + b; weight [out, in] (the JAX layout is [in, out])."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 capacity: int = 0, mode: str = "lookup",
                 compression: str = "vm", fuse_mode: str = "add", *,
                 generator: torch.Generator):
        super().__init__()
        self.active = bool(rank and rank > 0 and capacity and capacity > 0)
        if self.active and (compression, mode, fuse_mode) != (
                "vm", "lookup", "add"):
            raise NotImplementedError(
                f"ResField compression={compression!r}, mode={mode!r}, "
                f"fuse_mode={fuse_mode!r}: ROADMAP Queue 1 item 6 (the rest "
                "of the ResField zoo)")
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        torch_linear_(self.weight, self.bias, in_features, generator)
        if self.active:
            self.weights_t = nn.Parameter(0.01 * torch.randn(
                capacity, rank, generator=generator))
            self.matrix_t = nn.Parameter(0.01 * torch.randn(
                rank, out_features * in_features, generator=generator))

    def forward(self, x: torch.Tensor, frame_id: int | None = None
                ) -> torch.Tensor:
        """``frame_id``: the frame whose residual applies (a host int);
        None, or an inactive layer, is the plain Linear."""
        if not self.active or frame_id is None:
            return F.linear(x, self.weight, self.bias)
        delta = self.weights_t[frame_id] @ self.matrix_t
        weight = self.weight + delta.view(self.out_features, self.in_features)
        return F.linear(x, weight, self.bias)


class SirenMLP(nn.Module):
    """sin(30 x) MLP (reference ``utils/time_utils.py:76-121``): layers
    ``Dense_0 .. Dense_H``, the flax names; first layer U(-1/fan_in,
    1/fan_in), the others U(-sqrt(6/fan_in)/30, +), biases torch's
    default."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: int = 128, num_hidden_layers: int = 2,
                 out_activation: str = "none", *,
                 generator: torch.Generator):
        super().__init__()
        dims = [hidden_features] * num_hidden_layers + [out_features]
        self.n_layers = len(dims)
        self.out_activation = _out_act(out_activation)
        fan_in = in_features
        for i, d in enumerate(dims):
            lin = nn.Linear(fan_in, d)
            k = 1.0 / fan_in if i == 0 else math.sqrt(6.0 / fan_in) / 30.0
            with torch.no_grad():
                lin.weight.uniform_(-k, k, generator=generator)
                kb = 1.0 / math.sqrt(fan_in)
                lin.bias.uniform_(-kb, kb, generator=generator)
            self.add_module(f"Dense_{i}", lin)
            fan_in = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = torch.sin(30.0 * x)
        return self.out_activation(x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


_ACTS = {
    "none": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    "normalize": _normalize,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}


def _out_act(name: str):
    return _ACTS[name]
