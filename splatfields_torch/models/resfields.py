"""ResField Linear at rank 0 and the head output activations
(counterpart of ``splatfields_tpu/models/resfields.py``).

At rank 0 (every static-scene head) ResFieldLinear is a plain Linear. The
low-rank temporal residuals come with the 4-D slice (ROADMAP Queue 1,
item 6).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import torch_linear_


class ResFieldLinear(nn.Module):
    """y = x W^T + b; weight [out, in] (the JAX layout is [in, out])."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 capacity: int = 0, *, generator: torch.Generator):
        super().__init__()
        if rank and capacity:
            raise NotImplementedError(
                "ResField temporal residuals (rank > 0): ROADMAP Queue 1 "
                "item 6, 4D variant")
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        torch_linear_(self.weight, self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


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
