"""ResField Linear, the SIREN MLP and the head output activations
(counterpart of ``splatfields_tpu/models/resfields.py``).

``ResFieldLinear`` computes ``y = x (W + dW_t)^T + b`` for time ``t``. At
rank 0 (every static-scene head) it is a plain Linear. With a rank and a
capacity it holds a temporal residual of the reference's zoo
(``compression``):

- ``vm`` (the one the reference trains with): ``dW_f = (weights_t[f] @
  matrix_t).view(out, in)``, ``weights_t`` [capacity, rank], ``matrix_t``
  [rank, out * in] flattened in ``(out, in)`` order, the order of the
  port's own weight; modes ``lookup`` (by ``frame_id``),
  ``interpolation`` (coefficient rows interpolated at ``input_time`` in
  [-1, 1], per sample) and ``interpolation_siren`` (the rows from a SIREN
  of time); chunked with ``chunk_size`` and ``chunk_strategy`` shared /
  delta / both (lookup only);
- ``vm_cum`` (rows summed over frames; in the interpolation modes over
  the samples, the JAX package's reading), ``vm_cum_mat`` (selu of the
  full product, summed over frames), ``vm_noweight``, ``vm_attention``
  (a frame-frame softmax smooths the rows), ``loe`` (nearest of ``rank``
  expert matrices by time, interpolation modes), ``mm_tensor``, ``none``,
  ``none_cum``, ``resnet`` (the plain Linear, as upstream), ``cp`` and
  ``tucker`` (factors of the [capacity, out, in] stack), ``lora_3`` (a
  rank-R bottleneck sampled from a [capacity^3] grid at the point's
  coordinates) and ``lora_ngp`` (the same from two hash-grid heads,
  ``_NGPHead``).

``fuse_mode`` joins the delta to the base: ``add``, ``mul`` or ``none``
(the delta alone). ``coeff_ratio`` scales the coefficient rows' count
(indices past it read the last row, as JAX's gathers do),
``ignore_residuals`` keeps
the plain Linear, ``lock_weights`` stops the base weight's gradient in
the residual path. As in the JAX package, a lookup contracts only the
requested frame's coefficient row with ``matrix_t`` (cp and tucker their
frame factor row first); ``vm_cum_mat`` materialises its [capacity, out *
in] product, which its selu needs. Every parameter is named and laid out
as the flax one (only ``weight`` is transposed), so ``interop`` carries
them both ways.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from splatfields_torch.models.initializers import torch_linear_

COMPRESSIONS = (
    "vm", "vm_cum", "vm_cum_mat", "vm_noweight", "vm_attention", "loe",
    "mm_tensor", "none", "none_cum", "resnet", "cp", "tucker",
    "lora_3", "lora_ngp",
)


def _normal(gen, *shape, std=0.01):
    return nn.Parameter(std * torch.randn(*shape, generator=gen))


def trilinear_sample_border(vol: torch.Tensor, coords: torch.Tensor
                            ) -> torch.Tensor:
    """torch ``grid_sample`` 3-D, bilinear, border padding,
    ``align_corners=True``, written out as the JAX package's
    ``_trilinear_sample_border``: vol [C, D, H, W], coords [N, 3] in
    [-1, 1] ordered (x, y, z) = (W, H, D) -> [N, C]."""
    _, D, H, W = vol.shape

    def to_ix(c, size):
        return torch.clamp((c + 1.0) * 0.5 * (size - 1), 0.0, size - 1.0)

    x, y, z = (to_ix(coords[:, 0], W), to_ix(coords[:, 1], H),
               to_ix(coords[:, 2], D))
    x0, y0, z0 = (torch.floor(v).long() for v in (x, y, z))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)
    fx, fy, fz = ((v - v0)[:, None] for v, v0 in ((x, x0), (y, y0), (z, z0)))
    flat = vol.reshape(vol.shape[0], -1)

    def take(zi, yi, xi):
        return flat[:, (zi * H + yi) * W + xi].T

    c00 = take(z0, y0, x0) * (1 - fx) + take(z0, y0, x1) * fx
    c01 = take(z0, y1, x0) * (1 - fx) + take(z0, y1, x1) * fx
    c10 = take(z1, y0, x0) * (1 - fx) + take(z1, y0, x1) * fx
    c11 = take(z1, y1, x0) * (1 - fx) + take(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` as the JAX package's gather: an index past the last
    row (``coeff_ratio`` < 1) reads the last row, and no gradient flows
    back through it."""
    rows = table[idx.clamp(max=table.shape[0] - 1)]
    return torch.where((idx < table.shape[0])[:, None], rows, rows.detach())


class _NGPHead(nn.Module):
    """Hash grid (16 levels x 2 features, 2^18 rows, base 16, scale 1.5)
    and a 64-wide ReLU layer: the JAX package's stand-in for upstream's
    tinycudann nets. Module names are flax's."""

    def __init__(self, out_features: int, *, generator: torch.Generator):
        super().__init__()
        from splatfields_torch.models.encoders import HashGridEncoder
        self.HashGridEncoder_0 = HashGridEncoder(
            n_levels=16, n_features=2, base_resolution=16,
            per_level_scale=1.5, log2_hashmap_size=18, generator=generator)
        fin = self.HashGridEncoder_0.out_dim
        self.Dense_0 = nn.Linear(fin, 64)
        self.Dense_1 = nn.Linear(64, out_features)
        torch_linear_(self.Dense_0.weight, self.Dense_0.bias, fin, generator)
        torch_linear_(self.Dense_1.weight, self.Dense_1.bias, 64, generator)

    def forward(self, pts01: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(
            self.HashGridEncoder_0(pts01))))


def bf16_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """JAX's mixed-precision plain layer (``SPLATFIELDS_MLP_BF16``): the
    bf16 activations times the weight rounded to bf16, summed in f32,
    plus the f32 bias. The product runs in f32 on the bf16 values, where
    each product of two bf16 numbers is exact, so only the order of the
    f32 sum can differ from JAX's; the casts' backwards round the input's
    and the weight's gradients to bf16 where JAX's transposes do."""
    return F.linear(x.float(), weight.to(torch.bfloat16).float(), bias)


class ResFieldLinear(nn.Module):
    """y = x W^T + b plus a temporal residual; weight [out, in] (the JAX
    layout is [in, out])."""

    def __init__(self, in_features: int, out_features: int, rank: int = 0,
                 capacity: int = 0, mode: str = "lookup",
                 compression: str = "vm", fuse_mode: str = "add", *,
                 coeff_ratio: float = 1.0, chunk_size: int | None = None,
                 chunk_strategy: str = "both",
                 ignore_residuals: bool = False, lock_weights: bool = False,
                 generator: torch.Generator):
        super().__init__()
        if compression not in COMPRESSIONS:
            raise NotImplementedError(
                f"compression '{compression}' is not a member of the "
                "reference's zoo")
        self.in_features, self.out_features = in_features, out_features
        self.rank, self.capacity, self.mode = rank, capacity, mode
        self.compression, self.fuse_mode = compression, fuse_mode
        self.chunk_size, self.chunk_strategy = chunk_size, chunk_strategy
        self.ignore_residuals, self.lock_weights = (ignore_residuals,
                                                    lock_weights)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        torch_linear_(self.weight, self.bias, in_features, generator)
        self.active = bool(rank and rank > 0 and capacity and capacity > 0)
        if not self.active:
            return
        g = generator
        n_coefs = int(capacity * coeff_ratio)
        numel = in_features * out_features
        if compression == "vm" and chunk_size is not None:
            if chunk_strategy not in ("shared", "delta", "both"):
                raise ValueError(chunk_strategy)
            n_chunks = capacity // chunk_size
            if n_chunks <= 1:
                raise ValueError("chunk_size should be smaller than capacity")
            if n_chunks * chunk_size != capacity:
                raise ValueError(f"capacity {capacity} must be divisible by "
                                 f"chunk_size {chunk_size}")
            self.weights_t = _normal(g, n_coefs, rank)
            if chunk_strategy in ("shared", "both"):
                one = torch.empty(out_features, in_features)
                torch_linear_(one, None, in_features, g)
                self.chunk_weights = nn.Parameter(
                    0.01 * one[None].repeat(n_chunks, 1, 1))
            if chunk_strategy in ("delta", "both"):
                self.matrix_t = nn.Parameter(
                    _normal(g, rank, numel).data[None].repeat(n_chunks, 1, 1))
            else:
                self.matrix_t = _normal(g, rank, numel)
        elif compression in ("vm", "vm_cum", "vm_cum_mat", "vm_attention"):
            if compression == "vm_attention":
                self.attention_weight = nn.Parameter(torch.ones(n_coefs,
                                                                rank))
            # the coefficients are drawn before matrix_t, so a seed gives
            # the weights it gave before the rest of the zoo was ported
            if mode == "interpolation_siren" and compression != "vm_attention":
                self.weights_t_siren = SirenMLP(1, rank, 128, 2, generator=g)
            elif fuse_mode == "mul":
                self.weights_t = nn.Parameter(torch.full((n_coefs, rank),
                                                         1.0 / rank))
            else:
                self.weights_t = _normal(g, n_coefs, rank)
            if fuse_mode == "mul":
                self.matrix_t = nn.Parameter(torch.ones(rank, numel))
            else:
                self.matrix_t = _normal(g, rank, numel)
        elif compression == "loe":
            self.matrix_t = nn.Parameter(torch.zeros(rank, numel))
        elif compression == "mm_tensor":
            self.weights_t = _normal(g, n_coefs, out_features, rank)
            self.matrix_t = _normal(g, rank, in_features)
        elif compression == "vm_noweight":
            self.matrix_t = _normal(g, rank, numel, std=1e-6)
        elif compression in ("none", "none_cum"):
            self.matrix_t = nn.Parameter(torch.zeros(capacity, numel))
        elif compression == "resnet":
            self.resnet_vec = nn.Parameter(torch.zeros(capacity,
                                                       out_features))
        elif compression == "cp":
            self.lin_w = _normal(g, rank)
            self.lin_f1 = _normal(g, capacity, rank)
            self.lin_f2 = _normal(g, out_features, rank)
            self.lin_f3 = _normal(g, in_features, rank)
        elif compression == "tucker":
            r0, r1, r2 = (min(rank, capacity), min(rank, out_features),
                          min(rank, in_features))
            self.tucker_core = _normal(g, r0, r1, r2)
            self.tucker_f0 = _normal(g, capacity, r0)
            self.tucker_f1 = _normal(g, out_features, r1)
            self.tucker_f2 = _normal(g, in_features, r2)
        elif compression == "lora_3":
            n_ch = (out_features + in_features) * rank
            self.weights_t = _normal(g, 1, n_ch, capacity, capacity, capacity)
        else:  # lora_ngp
            self.ngp_coef = _NGPHead(in_features, generator=g)
            self.ngp_bases = _NGPHead(out_features, generator=g)

    def _base(self) -> torch.Tensor:
        """The base weight [out, in], detached with ``lock_weights``."""
        return self.weight.detach() if self.lock_weights else self.weight

    def _fuse(self, delta: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
        if self.fuse_mode == "add":
            return delta + base
        if self.fuse_mode == "mul":
            return delta * base
        return delta  # 'none'

    def _fused(self, delta_flat: torch.Tensor, base=None) -> torch.Tensor:
        """An (out * in) delta fused with the base -> the [out, in]
        weight."""
        base = self._base() if base is None else base
        return self._fuse(delta_flat, base.reshape(-1)).view(
            self.out_features, self.in_features)

    @staticmethod
    def _row(table: torch.Tensor, frame_id: int) -> torch.Tensor:
        return table[min(int(frame_id), table.shape[0] - 1)]

    def _coefs(self, input_time, frame_id) -> torch.Tensor:
        """The vm family's coefficient row [R] (lookup) or rows [N, R]."""
        if self.mode == "interpolation":
            t = (input_time.reshape(-1) + 1.0) / 2.0 * (self.capacity - 1)
            t = torch.clamp(t, 0.0, self.capacity - 1)
            t0 = torch.floor(t).long()
            t1 = torch.clamp(t0 + 1, max=self.capacity - 1)
            f = (t - t0)[:, None]
            wt = (_gather(self.weights_t, t0) * (1 - f)
                  + _gather(self.weights_t, t1) * f)
        elif self.mode == "interpolation_siren":
            wt = self.weights_t_siren(input_time.reshape(-1, 1))
        else:
            table = self.weights_t
            if self.compression == "vm_cum":
                table = torch.cumsum(table, dim=0)
            return self._row(table, frame_id)
        if self.compression == "vm_cum":
            wt = torch.cumsum(wt, dim=0)
        return wt

    def _weight(self, input_time=None, frame_id=None) -> torch.Tensor:
        """The effective weight [out, in], or [N, out, in] per sample."""
        c, base = self.compression, self._base()
        out, fin = self.out_features, self.in_features
        if c == "vm" and self.chunk_size is not None:
            if frame_id is None:
                raise NotImplementedError(
                    "chunked vm supports lookup mode only (frame_id "
                    "required): the reference indexes its chunk tables by "
                    "integer frame_id")
            wt = self._row(self.weights_t, frame_id)
            ch = int(frame_id) // self.chunk_size
            if self.chunk_strategy == "shared":
                mat = wt @ self.matrix_t
            else:
                mat = wt @ self.matrix_t[ch]
            if self.chunk_strategy != "delta":
                base = self.chunk_weights[ch] + base
            return self._fused(mat, base)
        if c in ("vm", "vm_cum"):
            wt = self._coefs(input_time, frame_id)
            delta = wt @ self.matrix_t
            if delta.ndim == 1:
                return self._fused(delta)
            return self._fuse(delta.view(-1, out, fin), base[None])
        if c == "vm_attention":
            a = self.attention_weight
            attn = torch.softmax(a @ a.T / self.rank, dim=0)
            return self._fused(self._row(attn @ self.weights_t, frame_id)
                               @ self.matrix_t)
        if c == "vm_cum_mat":
            m = F.selu(self.weights_t @ self.matrix_t)      # [C, out * in]
            mask = (torch.arange(m.shape[0], device=m.device)
                    <= int(frame_id)).to(m.dtype)
            return self._fused(mask @ m)
        if c == "loe":
            if input_time is None:
                raise NotImplementedError(
                    "compression='loe' requires input_time (nearest-expert "
                    "lookup)")
            if self.mode == "lookup":
                raise NotImplementedError(
                    "compression='loe' supports the interpolation modes "
                    "only: the reference's lookup path indexes its "
                    "per-sample weight stack by frame_id")
            t = (input_time.reshape(-1) + 1.0) / 2.0 * (self.rank - 1)
            r = torch.clamp(torch.round(t), 0, self.rank - 1).long()
            return self.matrix_t[r].view(-1, out, fin)     # no fuse
        if c == "mm_tensor":
            return self._fused((self._row(self.weights_t, frame_id)
                                @ self.matrix_t).reshape(-1))
        if c == "cp":
            w = self.lin_w * self._row(self.lin_f1, frame_id)
            return self._fused(torch.einsum(
                "r,or,ir->oi", w, self.lin_f2, self.lin_f3).reshape(-1))
        if c == "tucker":
            g = torch.einsum("abc,a->bc", self.tucker_core,
                             self._row(self.tucker_f0, frame_id))
            return self._fused(torch.einsum(
                "bc,ob,ic->oi", g, self.tucker_f1, self.tucker_f2
            ).reshape(-1))
        if c == "vm_noweight":
            # the reference fuses the base into every rank column before
            # the sum over rank ('add': rank W + sum(matrix_t))
            fused = self._fuse(self.matrix_t.T, base.reshape(-1, 1))
            return fused.sum(dim=1).view(out, fin)
        if c == "none":
            return self._fused(self._row(self.matrix_t, frame_id))
        if c == "none_cum":
            # deltas / 250, the base as frame 0, summed over frames
            mat = torch.cat([torch.zeros_like(self.matrix_t[:1]),
                             self.matrix_t[1:] / 250.0])
            cum = self._row(torch.cumsum(mat, dim=0), frame_id)
            return (base.reshape(-1) + cum).view(out, fin)
        raise AssertionError(c)

    def _query_lora(self, x: torch.Tensor, coords: torch.Tensor
                    ) -> torch.Tensor:
        """The coordinate-conditioned rank-R path plus the shared Linear;
        coords [N, 3] in [-1, 1]."""
        if self.compression == "lora_3":
            w = trilinear_sample_border(self.weights_t[0], coords)
            r, fo, fi = self.rank, self.out_features, self.in_features
            w_out = w[:, :r * fo].reshape(-1, r, fo)
            w_in = w[:, r * fo:].reshape(-1, r, fi)
            xr = torch.einsum("nri,ni->nr", w_in, x)
            out = torch.einsum("nro,nr->no", w_out, xr)
        else:
            pts01 = coords * 0.5 + 0.5
            out = ((x * self.ngp_coef(pts01)).sum(-1, keepdim=True)
                   * self.ngp_bases(pts01))
        return F.linear(x, self.weight, self.bias) + out

    def forward(self, x: torch.Tensor, frame_id: int | None = None,
                input_time: torch.Tensor | None = None,
                coordinates: torch.Tensor | None = None) -> torch.Tensor:
        """``frame_id``: the frame (a host int) of a lookup;
        ``input_time`` [N] or [N, 1] in [-1, 1] for the interpolation
        modes and ``loe``; ``coordinates`` [N, 3] in [-1, 1] for the lora
        members. Neither time (or an inactive layer, ``resnet``,
        ``ignore_residuals``) is the plain Linear."""
        plain = (self.ignore_residuals or not self.active
                 or self.compression == "resnet")
        if plain or (frame_id is None and input_time is None
                     and not self.compression.startswith("lora")):
            if x.dtype == torch.bfloat16:
                return bf16_linear(x, self.weight, self.bias)
            return F.linear(x, self.weight, self.bias)
        if x.dtype == torch.bfloat16:
            # a residual path reads bf16 activations promoted to f32, as
            # JAX's type promotion does
            x = x.float()
        if self.compression.startswith("lora"):
            if coordinates is None:
                raise ValueError("coordinates must be provided for lora "
                                 "compressions")
            return self._query_lora(x, coordinates)
        w = self._weight(input_time, frame_id)
        if w.ndim == 2:
            return F.linear(x, w, self.bias)
        return torch.einsum("ni,noi->no", x, w) + self.bias


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
