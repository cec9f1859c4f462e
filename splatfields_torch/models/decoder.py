"""The VAE-style CNN plane decoder, static path (counterpart of
``splatfields_tpu/models/decoder.py``; NCHW here, NHWC there).

conv_in 3x3 -> mid block (resnet, single-head spatial attention, resnet)
-> one up block per ``block_out_channels`` entry of (layers_per_block + 1)
resnets, with nearest-2x + conv3x3 on all but the last -> GroupNorm, SiLU,
conv_out. GroupNorm uses 32 groups and eps 1e-6; attention softmax is f32.
Convs init kaiming-normal fan_out; every resnet conv2 and the attention
output projection start at zero.

The per-frame conv deltas (``strategy='per_frame'``) are not ported
(ROADMAP Queue 1 item 6, per_frame TimeConv); ``VarTriPlaneEncoder``
refuses that strategy before it reaches the decoder. With the default
``strategy='none'`` a 4-D field's convs do not depend on the frame, as in
the JAX ``TimeConv``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import (
    kaiming_normal_fan_out_,
    torch_linear_,
)


class TimeConv(nn.Conv2d):
    """k x k conv, 'same' padding; kaiming fan_out or zero init."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 zero_init: bool = False, *, generator: torch.Generator):
        super().__init__(in_ch, features, kernel, padding=kernel // 2)
        with torch.no_grad():
            if zero_init:
                self.weight.zero_()
            else:
                kaiming_normal_fan_out_(self.weight, generator)
            self.bias.zero_()


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv1 -> GN -> SiLU -> conv2 (zero init), plus a 1x1
    shortcut when the channel count changes."""

    def __init__(self, in_ch: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6, *, generator: torch.Generator):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = TimeConv(in_ch, out_channels, 3, generator=generator)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = TimeConv(out_channels, out_channels, 3, zero_init=True,
                              generator=generator)
        self.conv_shortcut = (TimeConv(in_ch, out_channels, 1,
                                       generator=generator)
                              if in_ch != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head self-attention over the H*W tokens: GN -> q, k, v ->
    softmax (f32) -> zero-init out projection -> + residual."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6, *,
                 generator: torch.Generator):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            lin = nn.Linear(channels, channels)
            if name == "to_out":
                with torch.no_grad():
                    lin.weight.zero_()
                    lin.bias.zero_()
            else:
                torch_linear_(lin.weight, lin.bias, channels, generator)
            self.add_module(name, lin)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.group_norm(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        attn = torch.softmax((q @ k.transpose(1, 2)) * (1.0 / c ** 0.5), dim=-1)
        out = self.to_out(attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Upsample2x(nn.Module):
    """Nearest-neighbour 2x, then conv3x3."""

    def __init__(self, channels: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = TimeConv(channels, features, 3, generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimeVAEDecoder(nn.Module):
    """Noise [B, in_ch, h, w] -> planes [B, out_ch, 8h, 8w] (4 blocks)."""

    def __init__(self, in_channels: int = 8, out_channels: int = 16,
                 block_out_channels: Sequence[int] = (32, 32, 32, 32),
                 layers_per_block: int = 1, norm_num_groups: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        gen, gn = generator, norm_num_groups
        ch = block_out_channels[-1]
        self.conv_in = TimeConv(in_channels, ch, 3, generator=gen)
        self.mid_res0 = ResnetBlock(ch, ch, gn, generator=gen)
        self.mid_attn = SpatialAttention(ch, gn, generator=gen)
        self.mid_res1 = ResnetBlock(ch, ch, gn, generator=gen)
        self.up_names = []
        rev = list(reversed(block_out_channels))
        for i, out_ch in enumerate(rev):
            for j in range(layers_per_block + 1):
                self.add_module(f"up{i}_res{j}",
                                ResnetBlock(ch, out_ch, gn, generator=gen))
                self.up_names.append(f"up{i}_res{j}")
                ch = out_ch
            if i != len(rev) - 1:
                self.add_module(f"up{i}_upsample",
                                Upsample2x(ch, out_ch, generator=gen))
                self.up_names.append(f"up{i}_upsample")
        self.conv_norm_out = nn.GroupNorm(gn, ch, eps=1e-6)
        self.conv_out = TimeConv(ch, out_channels, 3, generator=gen)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_res1(self.mid_attn(self.mid_res0(x)))
        for name in self.up_names:
            x = getattr(self, name)(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Tensorial2D(nn.Module):
    """A frozen N(0, 1) noise buffer [1, noise_ch, r, r] decoded into a
    feature plane [1, out_ch, 8r, 8r] on every call."""

    def __init__(self, noise_ch: int = 8, out_ch: int = 16, noise_res: int = 20,
                 *, generator: torch.Generator):
        super().__init__()
        self.register_buffer("noise", torch.randn(
            1, noise_ch, noise_res, noise_res, generator=generator))
        self.net = TimeVAEDecoder(noise_ch, out_ch, generator=generator)

    def forward(self):
        return self.net(self.noise)
