"""Weight initializers matching the reference's torch defaults
(counterpart of ``splatfields_tpu/models/initializers.py``). Every draw
takes an explicit ``torch.Generator`` so a seed fixes the weights."""
from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_linear_(weight: torch.Tensor, bias: torch.Tensor | None,
                  fan_in: int, gen: torch.Generator) -> None:
    """torch's default Linear init: U(-k, k), k = 1/sqrt(fan_in), for
    weight and bias."""
    k = 1.0 / math.sqrt(fan_in)
    weight.uniform_(-k, k, generator=gen)
    if bias is not None:
        bias.uniform_(-k, k, generator=gen)


@torch.no_grad()
def kaiming_normal_fan_out_(weight: torch.Tensor, gen: torch.Generator,
                            groups: int = 1) -> None:
    """mmcv kaiming_init defaults (normal, fan_out, relu gain) on an OIHW
    conv weight: std = sqrt(2 / (kh * kw * out)); a grouped conv's fan_out
    is a group's, out / groups."""
    out, _, kh, kw = weight.shape
    weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * (out // groups))),
                   generator=gen)
