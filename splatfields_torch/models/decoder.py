"""The VAE-style CNN plane decoder and the other noise -> CNN generators
(counterpart of ``splatfields_tpu/models/decoder.py``; NCHW, NCL and NCDHW
here, NHWC, NLC and NDHWC there).

conv_in 3x3 -> mid block (resnet, single-head spatial attention, resnet)
-> one up block per ``block_out_channels`` entry of (layers_per_block + 1)
resnets, with nearest-2x + conv3x3 on all but the last -> GroupNorm, SiLU,
conv_out. GroupNorm uses 32 groups and eps 1e-6; attention softmax is f32.
Convs init kaiming-normal fan_out; every resnet conv2 and the attention
output projection start at zero.

Temporal conditioning: with ``strategy='per_frame'`` and ``n_frames >
1`` every conv of the decoder (conv_in, the resnets' convs and shortcuts,
the upsamplers, conv_out) keeps per-frame deltas ``frame_weights`` [F, O,
I, kh, kw] and convolves with ``weight + frame_weights[frame_id]``. They
start as the JAX package draws them: normal with 0.01 x the kaiming std
(zeros where the shared kernel is zero-initialised). With the default
``strategy='none'``, or no ``frame_id``, the convs do not depend on the
frame.

The other generators: ``VAEDecoder`` (the decoder without frames),
``Conv1DStack`` / ``Tensorial1D`` (1-D lines, linear resizes) and
``Conv3DStack`` / ``Tensorial3D`` (3-D grids, nearest upsampling). Their
conv kernels are bias-free parameters named as the flax ones
(``conv_in_kernel``, ``conv_<i>_kernel``, ``conv_out_kernel``), in
torch's OIW and OIDHW layouts; GroupNorm uses 16 groups and eps 1e-6.

Channel packing (the JAX package's ``n_packs``, used by
``SPLATFIELDS_PACKED_CNN``): ``TimeVAEDecoder(n_packs=P)`` is P
independent decoders in one, channels pack-major: every conv is grouped
(``groups=P``; kaiming std from a group's fan_out), each GroupNorm has
``gn * P`` groups, and the attention's projections are block-diagonal,
parameters ``to_q_kernel`` [P, c, c] and ``to_q_bias`` [P, c] (likewise
``to_k``, ``to_v``, ``to_out``) in the flax layout, with one attention a
pack. ``Tensorial2D(n_packs=P)`` draws its noise [1, P * noise_ch, r, r].

``SPLATFIELDS_CNN_BF16=on``, read when a ``TimeConv`` is built: its input
and kernel are rounded to bf16 and the conv returns bf16 (f32 sums
inside); the output is cast to f32 and the f32 bias added after, as in
JAX. GroupNorm, the attention and everything else stay f32.
"""
from __future__ import annotations

from typing import Sequence

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import (
    kaiming_normal_fan_out_,
    torch_linear_,
)


class TimeConv(nn.Conv2d):
    """k x k conv, 'same' padding, ``groups`` channel groups; kaiming
    fan_out or zero init; with ``strategy='per_frame'`` and ``n_frames >
    1``, per-frame deltas added to the kernel at the call's ``frame_id``;
    bf16 under ``SPLATFIELDS_CNN_BF16=on``."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 zero_init: bool = False, n_frames: int = 0,
                 strategy: str = "none", groups: int = 1, *,
                 generator: torch.Generator):
        super().__init__(in_ch, features, kernel, padding=kernel // 2,
                         groups=groups)
        with torch.no_grad():
            if zero_init:
                self.weight.zero_()
            else:
                kaiming_normal_fan_out_(self.weight, generator, groups)
            self.bias.zero_()
        self.frame_weights = None
        if strategy == "per_frame" and n_frames > 1:
            fw = torch.zeros(n_frames, *self.weight.shape)
            if not zero_init:
                std = 0.01 * math.sqrt(2.0 / (kernel * kernel
                                              * (features // groups)))
                fw.normal_(0.0, std, generator=generator)
            self.frame_weights = nn.Parameter(fw)
        self.bf16 = os.environ.get("SPLATFIELDS_CNN_BF16", "off") == "on"

    def forward(self, x, frame_id: int | None = None):
        w = self.weight
        if self.frame_weights is not None and frame_id is not None:
            w = w + self.frame_weights[frame_id]
        if self.bf16:
            out = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                           self.stride, self.padding, self.dilation,
                           self.groups)
            return out.float() + self.bias[:, None, None]
        return self._conv_forward(x, w, self.bias)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv1 -> GN -> SiLU -> conv2 (zero init), plus a 1x1
    shortcut when the channel count changes; every conv in
    ``conv_groups`` groups."""

    def __init__(self, in_ch: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6, n_frames: int = 0, strategy: str = "none",
                 conv_groups: int = 1, *, generator: torch.Generator):
        super().__init__()
        tc = dict(n_frames=n_frames, strategy=strategy, groups=conv_groups,
                  generator=generator)
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = TimeConv(in_ch, out_channels, 3, **tc)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = TimeConv(out_channels, out_channels, 3, zero_init=True,
                              **tc)
        self.conv_shortcut = (TimeConv(in_ch, out_channels, 1, **tc)
                              if in_ch != out_channels else None)

    def forward(self, x, frame_id: int | None = None):
        h = self.conv1(F.silu(self.norm1(x)), frame_id)
        h = self.conv2(F.silu(self.norm2(h)), frame_id)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, frame_id)
        return x + h


class SpatialAttention(nn.Module):
    """Single-head self-attention over the H*W tokens: GN -> q, k, v ->
    softmax (f32) -> zero-init out projection -> + residual. With
    ``n_packs`` P > 1, one attention per pack of C / P channels, with
    block-diagonal projections ``to_*_kernel`` [P, C/P, C/P] (x @ kernel)
    and ``to_*_bias`` [P, C/P]."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 n_packs: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.n_packs = n_packs
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        names = ("to_q", "to_k", "to_v", "to_out")
        if n_packs > 1:
            g, c = n_packs, channels // n_packs
            k = 1.0 / math.sqrt(c)
            for name in names:
                kernel, bias = torch.zeros(g, c, c), torch.zeros(g, c)
                if name != "to_out":
                    kernel.uniform_(-k, k, generator=generator)
                    bias.uniform_(-k, k, generator=generator)
                setattr(self, f"{name}_kernel", nn.Parameter(kernel))
                setattr(self, f"{name}_bias", nn.Parameter(bias))
            return
        for name in names:
            lin = nn.Linear(channels, channels)
            if name == "to_out":
                with torch.no_grad():
                    lin.weight.zero_()
                    lin.bias.zero_()
            else:
                torch_linear_(lin.weight, lin.bias, channels, generator)
            self.add_module(name, lin)

    def _packed(self, x):
        b, c, h, w = x.shape
        g, cg = self.n_packs, c // self.n_packs
        tokens = self.group_norm(x).flatten(2).transpose(1, 2).reshape(
            b, h * w, g, cg)

        def proj(t, name):
            return (torch.einsum("bqgc,gcd->bqgd", t,
                                 getattr(self, f"{name}_kernel"))
                    + getattr(self, f"{name}_bias"))

        q, k, v = (proj(tokens, n) for n in ("to_q", "to_k", "to_v"))
        attn = torch.softmax(torch.einsum("bqgc,bkgc->bgqk", q, k)
                             * (1.0 / cg ** 0.5), dim=-1)
        out = proj(torch.einsum("bgqk,bkgc->bqgc", attn, v), "to_out")
        return x + out.reshape(b, h * w, c).transpose(1, 2).reshape(
            b, c, h, w)

    def forward(self, x):
        if self.n_packs > 1:
            return self._packed(x)
        b, c, h, w = x.shape
        tokens = self.group_norm(x).flatten(2).transpose(1, 2)   # [B, HW, C]
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        attn = torch.softmax((q @ k.transpose(1, 2)) * (1.0 / c ** 0.5), dim=-1)
        out = self.to_out(attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Upsample2x(nn.Module):
    """Nearest-neighbour 2x, then conv3x3."""

    def __init__(self, channels: int, features: int, n_frames: int = 0,
                 strategy: str = "none", conv_groups: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = TimeConv(channels, features, 3, n_frames=n_frames,
                             strategy=strategy, groups=conv_groups,
                             generator=generator)

    def forward(self, x, frame_id: int | None = None):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                         frame_id)


class TimeVAEDecoder(nn.Module):
    """Noise [B, P * in_ch, h, w] -> planes [B, P * out_ch, 8h, 8w] (4
    blocks), P = ``n_packs`` decoders packed channel-wise (pack-major);
    channel counts are per pack."""

    def __init__(self, in_channels: int = 8, out_channels: int = 16,
                 block_out_channels: Sequence[int] = (32, 32, 32, 32),
                 layers_per_block: int = 1, norm_num_groups: int = 32,
                 n_frames: int = 0, strategy: str = "none", n_packs: int = 1,
                 *, generator: torch.Generator):
        super().__init__()
        p = n_packs
        gn = norm_num_groups * p
        tc = dict(n_frames=n_frames, strategy=strategy, generator=generator)
        rc = dict(tc, conv_groups=p)
        ch = block_out_channels[-1] * p
        self.conv_in = TimeConv(in_channels * p, ch, 3, groups=p, **tc)
        self.mid_res0 = ResnetBlock(ch, ch, gn, **rc)
        self.mid_attn = SpatialAttention(ch, gn, n_packs=p,
                                         generator=generator)
        self.mid_res1 = ResnetBlock(ch, ch, gn, **rc)
        self.up_names = []
        rev = [c * p for c in reversed(block_out_channels)]
        for i, out_ch in enumerate(rev):
            for j in range(layers_per_block + 1):
                self.add_module(f"up{i}_res{j}",
                                ResnetBlock(ch, out_ch, gn, **rc))
                self.up_names.append(f"up{i}_res{j}")
                ch = out_ch
            if i != len(rev) - 1:
                self.add_module(f"up{i}_upsample",
                                Upsample2x(ch, out_ch, **rc))
                self.up_names.append(f"up{i}_upsample")
        self.conv_norm_out = nn.GroupNorm(gn, ch, eps=1e-6)
        self.conv_out = TimeConv(ch, out_channels * p, 3, groups=p, **tc)

    def forward(self, z, frame_id: int | None = None):
        x = self.conv_in(z, frame_id)
        x = self.mid_res0(x, frame_id)
        x = self.mid_res1(self.mid_attn(x), frame_id)
        for name in self.up_names:
            x = getattr(self, name)(x, frame_id)
        return self.conv_out(F.silu(self.conv_norm_out(x)), frame_id)


class VAEDecoder(TimeVAEDecoder):
    """The decoder without frames: the ``strategy='none'`` configuration of
    ``TimeVAEDecoder``, whose forward ignores ``frame_id``."""

    def __init__(self, in_channels: int = 8, out_channels: int = 16,
                 block_out_channels: Sequence[int] = (32, 32, 32, 32),
                 layers_per_block: int = 1, norm_num_groups: int = 32,
                 n_packs: int = 1, *, generator: torch.Generator):
        super().__init__(in_channels, out_channels, block_out_channels,
                         layers_per_block, norm_num_groups, n_packs=n_packs,
                         generator=generator)

    def forward(self, z, frame_id: int | None = None):
        return super().forward(z, None)


def _kernel_param(shape, generator: torch.Generator) -> nn.Parameter:
    """A bias-free conv kernel [O, I, *k], kaiming-normal fan_out:
    std = sqrt(2 / (prod(k) * O))."""
    fan_out = math.prod(shape[2:]) * shape[0]
    return nn.Parameter(torch.empty(shape).normal_(
        0.0, math.sqrt(2.0 / fan_out), generator=generator))


def _linear_resize(x: torch.Tensor, res: int) -> torch.Tensor:
    """Linear interpolation of [B, C, L] to length ``res``,
    align_corners=False, spelt out as the JAX package does: position
    (i + 0.5) L / res - 0.5, the two neighbours clipped into the line and
    the weight clipped to [0, 1]."""
    length = x.shape[-1]
    pos = (torch.arange(res, dtype=torch.float32, device=x.device) + 0.5) \
        * length / res - 0.5
    lo = torch.clamp(torch.floor(pos), 0, length - 1).to(torch.int64)
    hi = torch.clamp(lo + 1, 0, length - 1)
    f = torch.clamp(pos - lo, 0.0, 1.0)
    return x[..., lo] * (1 - f) + x[..., hi] * f


class Conv1DStack(nn.Module):
    """conv -> [conv, GroupNorm(16), SiLU, linear resize]* -> conv -> SiLU
    on [B, C, L] lines."""

    def __init__(self, in_channels: int = 8, out_channels: int = 16,
                 upsample_resolutions: Sequence[int] = (32, 64, 64, 128, 128,
                                                        256, 256),
                 block_channels: Sequence[int] = (128, 128, 128, 128, 64, 64,
                                                  32, 32), *,
                 generator: torch.Generator):
        super().__init__()
        self.resolutions = tuple(upsample_resolutions)
        chans = [in_channels, *block_channels[:len(self.resolutions) + 1]]
        self.conv_in_kernel = _kernel_param((chans[1], chans[0], 3), generator)
        for i in range(len(self.resolutions)):
            setattr(self, f"conv_{i}_kernel",
                    _kernel_param((chans[i + 2], chans[i + 1], 3), generator))
            self.add_module(f"norm_{i}", nn.GroupNorm(16, chans[i + 2],
                                                      eps=1e-6))
        self.conv_out_kernel = _kernel_param((out_channels, chans[-1], 3),
                                             generator)

    def forward(self, x):  # [B, C, L]
        x = F.conv1d(x, self.conv_in_kernel, padding=1)
        for i, res in enumerate(self.resolutions):
            x = F.conv1d(x, getattr(self, f"conv_{i}_kernel"), padding=1)
            x = F.silu(getattr(self, f"norm_{i}")(x))
            x = _linear_resize(x, res)
        return F.silu(F.conv1d(x, self.conv_out_kernel, padding=1))


class Conv3DStack(nn.Module):
    """conv -> [conv, GroupNorm(16), SiLU, nearest upsample]* -> conv ->
    SiLU on [B, C, D, H, W] grids; a stage upsamples by repeating each
    cell ``res // D`` times per axis where ``res`` differs from D."""

    def __init__(self, in_channels: int = 8, out_channels: int = 16,
                 upsample_resolutions: Sequence[int] = (4, 4, 8, 16, 32),
                 block_channels: Sequence[int] = (128, 128, 128, 64, 32, 32),
                 *, generator: torch.Generator):
        super().__init__()
        self.resolutions = tuple(upsample_resolutions)
        chans = [in_channels, *block_channels[:len(self.resolutions) + 1]]
        self.conv_in_kernel = _kernel_param((chans[1], chans[0], 3, 3, 3),
                                            generator)
        for i in range(len(self.resolutions)):
            setattr(self, f"conv_{i}_kernel", _kernel_param(
                (chans[i + 2], chans[i + 1], 3, 3, 3), generator))
            self.add_module(f"norm_{i}", nn.GroupNorm(16, chans[i + 2],
                                                      eps=1e-6))
        self.conv_out_kernel = _kernel_param(
            (out_channels, chans[-1], 3, 3, 3), generator)

    def forward(self, x):  # [B, C, D, H, W]
        x = F.conv3d(x, self.conv_in_kernel, padding=1)
        for i, res in enumerate(self.resolutions):
            x = F.conv3d(x, getattr(self, f"conv_{i}_kernel"), padding=1)
            x = F.silu(getattr(self, f"norm_{i}")(x))
            if res != x.shape[2]:
                rep = res // x.shape[2]
                for axis in (2, 3, 4):
                    x = x.repeat_interleave(rep, dim=axis)
        return F.silu(F.conv3d(x, self.conv_out_kernel, padding=1))


class Tensorial1D(nn.Module):
    """A frozen N(0, 1) noise line [1, noise_ch, r] decoded into a feature
    line [1, out_ch, 16r]."""

    def __init__(self, noise_ch: int = 8, out_ch: int = 16, noise_res: int = 8,
                 *, generator: torch.Generator):
        super().__init__()
        self.register_buffer("noise", torch.randn(
            1, noise_ch, noise_res, generator=generator))
        r = noise_res
        self.net = Conv1DStack(noise_ch, out_ch,
                               tuple(r * i for i in (2, 4, 8, 16, 16)),
                               (128, 128, 128, 64, 32, 32),
                               generator=generator)

    def forward(self):
        return self.net(self.noise)


class Tensorial3D(nn.Module):
    """A frozen N(0, 1) noise grid [1, noise_ch, r, r, r] decoded into a
    feature grid [1, out_ch, 8r, 8r, 8r]."""

    def __init__(self, noise_ch: int = 8, out_ch: int = 16, noise_res: int = 4,
                 *, generator: torch.Generator):
        super().__init__()
        self.register_buffer("noise", torch.randn(
            1, noise_ch, noise_res, noise_res, noise_res, generator=generator))
        r = noise_res
        self.net = Conv3DStack(noise_ch, out_ch,
                               tuple(r * i for i in (1, 1, 2, 4, 8)),
                               (128, 128, 128, 64, 32, 32),
                               generator=generator)

    def forward(self):
        return self.net(self.noise)


class Tensorial2D(nn.Module):
    """A frozen N(0, 1) noise buffer [1, P * noise_ch, r, r] decoded into
    P = ``n_packs`` feature planes [1, P * out_ch, 8r, 8r] (pack-major) on
    every call (at ``frame_id`` with per-frame conv deltas)."""

    def __init__(self, noise_ch: int = 8, out_ch: int = 16, noise_res: int = 20,
                 n_frames: int = 0, strategy: str = "none", n_packs: int = 1,
                 *, generator: torch.Generator):
        super().__init__()
        self.register_buffer("noise", torch.randn(
            1, n_packs * noise_ch, noise_res, noise_res, generator=generator))
        self.net = TimeVAEDecoder(noise_ch, out_ch, n_frames=n_frames,
                                  strategy=strategy, n_packs=n_packs,
                                  generator=generator)

    def forward(self, frame_id: int | None = None):
        return self.net(self.noise, frame_id)
