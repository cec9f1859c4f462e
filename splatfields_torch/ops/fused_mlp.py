"""All rank-0 MLP heads of a field in one pass (counterpart of
``splatfields_tpu/ops/fused_mlp.py``).

Semantics are GeneralMLP's, quirks kept: each head reads a prefix of one
shared positional embedding plus the feature block (``h_in``); a skip
concatenates ``h_in`` in front (``h = [h_in, h]``); leaky_relu(0.01)
follows every layer, the last included (the caller applies
``out_activation``).

A ``Plan`` lays the heads' weights out as the JAX package does: layer
``i`` of a head is a block of ``_round8(fin)`` rows of one [R, 128] matrix
(``weight.T``, zero-padded) and one row of a [L, 128] bias matrix.
``pack_params`` builds both with one ``torch.cat`` from the heads'
``nn.Parameter``s, so autograd carries dW and db back to them.

``fused_heads(plan, emb, feat, w, b, compute_dtype)``: on CUDA tensors
an ``autograd.Function`` whose forward launches ``csrc/fused_mlp_fwd.cu``
and whose backward launches the three kernels of
``csrc/fused_mlp_bwd.cu`` in order: the backward (recompute, d_emb,
d_feat, per-CTA db partials, and every layer's rounded input X_l and
cotangent G_l written to a scratch buffer), ``fused_mlp_dw`` (dW_l =
X_lᵀ G_l, split over N into slice partials) and the fixed-order
reduction of both partials; only the inputs are saved. In bf16 the
forward's and the backward's products run on the tensor cores
(``csrc/fused_mlp_mma.cuh``) from one bf16 copy of the packed weights
(``kernel_weights``), with the shared-memory layouts of ``fwd_layout``
and ``bwd_layout``; in f32 they are exact FMAs on the CUDA cores. On CPU
tensors it runs ``fused_heads_plain``, an autograd graph with the same
rounding points. Matrix operands go to ``compute_dtype`` (bf16 or f32)
and every product sums in f32:

- forward: every layer input and weight block is rounded, the bias is
  added in f32;
- backward: the cotangent ``g`` is rounded before both the dW and the dX
  product, db sums the unrounded ``g``, and the leaky_relu mask is the
  sign of the layer's output.

``fused_heads.launches``, ``fused_heads_bwd.launches``,
``fused_dw.launches`` and ``reduce_partials.launches`` count kernel
launches, and nothing else.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from splatfields_torch.ops.cuda_build import check, run

ALPHA = 0.01   # GeneralMLP's leaky_relu slope
COLS = 128     # columns of the packed weight and bias matrices
# limits of the kernels' plan table (csrc/fused_mlp_*.cu kMaxHeads/Layers)
MAX_HEADS, MAX_LAYERS = 8, 48
POINTS_FWD = 32          # kPoints in csrc/fused_mlp_fwd.cu, f32 path
THREADS_BWD = 256        # kThreads in csrc/fused_mlp_bwd.cu, f32 path
THREADS_MMA = 512        # kMmaThreads in csrc/fused_mlp_mma.cuh, bf16
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on sm_90
# bf16 (tensor-core) paths: points a chunk, a multiple of 16 (the mma's
# rows) dividing ROW_ALIGN
POINTS_MMA = 64
LD_G = COLS + 8          # kLdG in csrc/fused_mlp_bwd.cu
# csrc/fused_mlp_bwd.cu's fused_mlp_dw: rows of N per slice come in
# multiples of ROW_ALIGN (a multiple of its K step, 32; every chunk size of
# the backward divides it), output tiles are DW_TILE packed rows by all 128
# columns
ROW_ALIGN = 64
DW_TILE = 128


class LayerSpec(NamedTuple):
    fin: int
    fout: int
    row_off: int      # row offset into the packed [R, 128] weight matrix
    bias_idx: int     # row into the packed [L, 128] bias matrix
    skip_after: bool  # concat the embedded input after this layer


class HeadSpec(NamedTuple):
    name: str         # the head's module name, e.g. "mlp_deform"
    emb_cols: int     # prefix of the shared embedding this head consumes
    layers: tuple     # tuple[LayerSpec]
    out_dim: int


class Plan(NamedTuple):
    heads: tuple      # tuple[HeadSpec]
    n_rows: int       # packed weight rows (multiple of 8 per block)
    n_bias: int
    emb_dim: int
    feat_dim: int


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _ld16(cols: int) -> int:
    """Shared-memory row stride, in bf16 values, of a row of ``cols``
    values in the tensor-core kernels (``ld_bf16``): padded to the mma
    depth of 16, plus 8, an odd multiple of 16 bytes (ldmatrix reads eight
    rows in eight different banks)."""
    return _round16(cols) + 8


def build_plan(head_cfgs: Sequence[dict], emb_dim: int, feat_dim: int) -> Plan:
    """head_cfgs: dicts with name, emb_cols, hidden, depth, skips, out.

    Layers as GeneralMLP's at rank 0: net_0: h_in -> W; net_{1+i}: W (+h_in
    after a skip) -> W; net_last: W -> out; the skip after layer s for s in
    skips, never after the last layer."""
    heads = []
    row = bias = 0
    for cfg in head_cfgs:
        h_in = cfg["emb_cols"] + feat_dim
        width, depth, out = cfg["hidden"], cfg["depth"], cfg["out"]
        skips = set(cfg["skips"])
        dims = [(h_in, width)]
        for i in range(depth):
            dims.append((width + (h_in if i in skips else 0), width))
        dims.append((width, out))
        if max(fout for _, fout in dims) > COLS:
            raise ValueError(f"{cfg['name']}: a layer wider than {COLS}")
        layers = []
        for i, (fin, fout) in enumerate(dims):
            skip_after = i in skips and i != len(dims) - 1
            layers.append(LayerSpec(fin, fout, row, bias, skip_after))
            row += _round8(fin)
            bias += 1
        heads.append(HeadSpec(cfg["name"], cfg["emb_cols"], tuple(layers),
                              dims[-1][1]))
    return Plan(tuple(heads), row, bias, emb_dim, feat_dim)


def _head_cfg(name: str, mlp) -> dict:
    """A GeneralMLP's shape as ``build_plan`` reads it."""
    from splatfields_torch.models.mlp import embed_dim
    return dict(name=name, emb_cols=embed_dim(mlp.multires),
                hidden=mlp.net_0.weight.shape[0], depth=mlp.n_layers - 2,
                skips=mlp.skips,
                out=getattr(mlp, f"net_{mlp.n_layers - 1}").weight.shape[0])


def plan_from_module(net, mode: str) -> Plan:
    """The fused plan of a SplatFields module. mode: 'deform' (the
    canonicalization head, on pe(xyz_in)) or 'downstream' (rgb and the
    geometry heads, on pe(xyz_can) at the largest multires)."""
    from splatfields_torch.models.mlp import embed_dim
    if mode == "deform":
        cfg = _head_cfg("mlp_deform", net.mlp_deform)
        return build_plan([cfg], cfg["emb_cols"], net.feat_dim)
    if mode != "downstream":
        raise ValueError(f"mode {mode!r}: 'deform' or 'downstream'")
    names = ("mlp_rgb", "mlp_scale", "mlp_opacity", "mlp_rotation")
    return build_plan([_head_cfg(n, getattr(net, n)) for n in names],
                      embed_dim(net.max_multires), net.feat_dim)


def pack_params(net, plan: Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """The heads of ``net`` (modules named as the plan's heads, layers
    ``net_i`` with ``weight`` [out, in]) -> packed [R, 128] weights
    (``weight.T``, zero-padded) and [L, 128] biases, each one
    ``torch.cat``: differentiable in every head parameter."""
    w_parts, b_parts = [], []
    for head in plan.heads:
        mlp = getattr(net, head.name)
        for i, L in enumerate(head.layers):
            layer = getattr(mlp, f"net_{i}")
            w_parts.append(F.pad(layer.weight.t(), (
                0, COLS - L.fout, 0, _round8(L.fin) - L.fin)))
            b_parts.append(F.pad(layer.bias, (0, COLS - L.fout))[None])
    return torch.cat(w_parts, 0), torch.cat(b_parts, 0)


def unpack_grads(dw: torch.Tensor, db: torch.Tensor, plan: Plan) -> dict:
    """Packed [R, 128] / [L, 128] gradients -> ``{"<head>.net_<i>.weight":
    [out, in], "<head>.net_<i>.bias": [out]}`` in the port's layout."""
    out = {}
    for head in plan.heads:
        for i, L in enumerate(head.layers):
            key = f"{head.name}.net_{i}"
            out[f"{key}.weight"] = dw[L.row_off:L.row_off + L.fin, :L.fout].t()
            out[f"{key}.bias"] = db[L.bias_idx, :L.fout]
    return out


# --- the plain version ----------------------------------------------------

class _Round(torch.autograd.Function):
    """Round to ``dtype`` and back to f32; the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Identity; the gradient is rounded to ``dtype`` (and back to f32)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(torch.float32), None


def _leaky(x):
    # the gradient's mask is x >= 0, the sign of the layer's output
    return torch.where(x >= 0, x, ALPHA * x)


def _plain_graph(plan: Plan, emb, feat, w, b, compute_dtype):
    """The heads as an autograd graph with the kernels' rounding points:
    (per-head outputs, per-layer (rounded input X_l, product X_l W_l)).
    The gradient reaching a product is the layer's rounded cotangent G_l."""
    rounding = compute_dtype != torch.float32

    def rnd(x):
        return _Round.apply(x, compute_dtype) if rounding else x

    outs, layers = [], []
    for head in plan.heads:
        h_in = emb[:, :head.emb_cols]
        if plan.feat_dim:
            h_in = torch.cat([h_in, feat], 1)
        h = h_in
        for L in head.layers:
            x = rnd(h)
            prod = x @ rnd(w[L.row_off:L.row_off + L.fin, :L.fout])
            layers.append((x, prod))
            y = _RoundGrad.apply(prod, compute_dtype) if rounding else prod
            h = _leaky(y + b[L.bias_idx, :L.fout])
            if L.skip_after:
                h = torch.cat([h_in, h], 1)
        outs.append(h)
    return tuple(outs), layers


def fused_heads_plain(plan: Plan, emb, feat, w, b,
                      compute_dtype=torch.float32) -> tuple:
    """The plain version of both kernels: every head of ``plan`` on [N, E]
    embeddings and [N, F] features, as an autograd graph of matmuls with
    the kernels' rounding points. Returns the per-head outputs [N, out]
    (after the last leaky_relu)."""
    return _plain_graph(plan, emb, feat, w, b, compute_dtype)[0]


def fused_heads_bwd_plain(plan: Plan, emb, feat, w, b, gs,
                          compute_dtype=torch.float32):
    """The plain version of the backward kernel: (d_emb, d_feat, dw, db)
    for the cotangents ``gs`` of the heads' outputs."""
    xs = [x.detach().requires_grad_(True) for x in (emb, feat, w, b)]
    with torch.enable_grad():
        outs = fused_heads_plain(plan, *xs, compute_dtype)
        grads = torch.autograd.grad(outs, xs, gs, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads))


# --- the weight gradient's scratch and split-K product ---------------------

class ScratchLayout(NamedTuple):
    n_pad: int        # rows of every block: N rounded up to ROW_ALIGN
    x_off: tuple      # per layer (plan order), element offset of X_l
    g_off: tuple      # per layer, element offset of G_l
    size: int         # elements of the whole buffer


def _layers(plan: Plan) -> list:
    return [L for h in plan.heads for L in h.layers]


def dw_scratch_layout(plan: Plan, n: int) -> ScratchLayout:
    """Where the backward kernel writes, for every layer l, X_l [n_pad,
    round8(fin)] (its rounded input) and then G_l [n_pad, round8(fout)]
    (its rounded cotangent), row-major, in the compute type. Every block
    holds a multiple of 256 elements, so every offset is 512-byte aligned
    (bf16) and every row 16-byte aligned."""
    n_pad = -(-n // ROW_ALIGN) * ROW_ALIGN
    x_off, g_off, pos = [], [], 0
    for L in _layers(plan):
        x_off.append(pos)
        pos += n_pad * _round8(L.fin)
        g_off.append(pos)
        pos += n_pad * _round8(L.fout)
    return ScratchLayout(n_pad, tuple(x_off), tuple(g_off), pos)


def dw_tiles(plan: Plan) -> list[tuple[int, int]]:
    """fused_mlp_dw's output tiles, (layer index, first row within the
    layer's block): DW_TILE rows of round8(fin) by all 128 columns."""
    return [(i, m0) for i, L in enumerate(_layers(plan))
            for m0 in range(0, _round8(L.fin), DW_TILE)]


def dw_slice_rows(n_pad: int, slices: int) -> int:
    """Rows of N per slice (the last may be shorter): a multiple of
    ROW_ALIGN."""
    return -(-n_pad // (slices * ROW_ALIGN)) * ROW_ALIGN


def dw_slices(plan: Plan, n: int, sms: int) -> int:
    """The slice count S of fused_mlp_dw: tiles x S fill, without
    exceeding, two CTAs on each of ``sms`` multiprocessors (the kernel's
    occupancy), and no slice is empty. A function of the shapes and the
    SM count only, so two launches sum alike."""
    n_pad = dw_scratch_layout(plan, n).n_pad
    want = max(1, 2 * sms // len(dw_tiles(plan)))
    return max(1, -(-n_pad // dw_slice_rows(n_pad, want)))


def scratch_blocks(plan: Plan, scratch: torch.Tensor, n: int) -> list:
    """Per layer, in plan order, the views (X_l [n_pad, round8(fin)],
    G_l [n_pad, round8(fout)]) of a scratch buffer for N points."""
    lay = dw_scratch_layout(plan, n)
    return [(scratch[xo:xo + lay.n_pad * _round8(L.fin)].view(lay.n_pad, -1),
             scratch[go:go + lay.n_pad * _round8(L.fout)].view(lay.n_pad, -1))
            for L, xo, go in zip(_layers(plan), lay.x_off, lay.g_off)]


def dw_scratch_plain(plan: Plan, emb, feat, w, b, gs,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The scratch buffer exactly as the backward kernel writes it,
    padding included: a flat ``compute_dtype`` tensor laid out by
    ``dw_scratch_layout``. Plain version, for tests."""
    n = emb.shape[0]
    xs = [x.detach().requires_grad_(True) for x in (emb, feat, w, b)]
    with torch.enable_grad():
        outs, layers = _plain_graph(plan, *xs, compute_dtype)
        cots = torch.autograd.grad(outs, [p for _, p in layers], gs)
    out = torch.zeros(dw_scratch_layout(plan, n).size, dtype=compute_dtype,
                      device=emb.device)
    for (x, _), g, (xb, gb) in zip(layers, cots,
                                   scratch_blocks(plan, out, n)):
        xb[:n, :x.shape[1]] = x.detach()
        gb[:n, :g.shape[1]] = g
    return out


def fused_dw_plain(plan: Plan, scratch: torch.Tensor, n: int,
                   slices: int) -> torch.Tensor:
    """dW [R, 128] from a scratch buffer: per layer X_lᵀ G_l in f32 over
    each slice of N, the slices summed in order (fused_mlp_dw's split, its
    sum in another order). Plain version of fused_mlp_dw and its
    reduction."""
    rows = dw_slice_rows(dw_scratch_layout(plan, n).n_pad, slices)
    dw = torch.zeros(plan.n_rows, COLS, device=scratch.device)
    for L, (x, g) in zip(_layers(plan), scratch_blocks(plan, scratch, n)):
        x, g = x.float(), g.float()
        acc = torch.zeros(x.shape[1], g.shape[1], device=scratch.device)
        for s0 in range(0, x.shape[0], rows):
            acc = acc + x[s0:s0 + rows].t() @ g[s0:s0 + rows]
        dw[L.row_off:L.row_off + x.shape[1], :g.shape[1]] = acc
    return dw


# --- the kernels ----------------------------------------------------------

def plan_table(plan: Plan) -> torch.Tensor:
    """The plan as the kernels read it, an int32 CPU tensor: n_heads,
    emb_dim, feat_dim, then per head emb_cols, out_dim, n_layers and per
    layer fin, fout, row_off, bias_idx, skip_after."""
    n_layers = sum(len(h.layers) for h in plan.heads)
    if len(plan.heads) > MAX_HEADS or n_layers > MAX_LAYERS:
        raise ValueError(f"{len(plan.heads)} heads, {n_layers} layers: the "
                         f"kernels take {MAX_HEADS} and {MAX_LAYERS}")
    vals = [len(plan.heads), plan.emb_dim, plan.feat_dim]
    for h in plan.heads:
        vals += [h.emb_cols, h.out_dim, len(h.layers)]
        for L in h.layers:
            vals += [L.fin, L.fout, L.row_off, L.bias_idx, int(L.skip_after)]
    return torch.tensor(vals, dtype=torch.int32)


def _widths(plan: Plan):
    """(widest h_in, widest layer input or output, widest sum of a head's
    layer inputs), the kernels' shared-memory strides."""
    hin = max(h.emb_cols + plan.feat_dim for h in plan.heads)
    width = max(max(L.fin, L.fout + (h.emb_cols + plan.feat_dim
                                     if L.skip_after else 0))
                for h in plan.heads for L in h.layers)
    inputs = max(sum(L.fin for L in h.layers) for h in plan.heads)
    return hin, width, inputs


class KernelLayout(NamedTuple):
    """Shared memory of one CTA of a fused kernel (csrc/fused_mlp_*.cu).
    Row strides in floats on the f32 paths, in values (bf16 rows, or the
    bf16 backward's f32 dX rows) on the bf16 paths."""
    points: int         # points a chunk
    hin_stride: int     # a row of h_in (f32 backward: of d_h_in)
    width_stride: int   # a row of activations (backward: also of dX)
    inputs_stride: int  # f32 backward: every layer input of a head
    w_region: int       # bf16: the weight ring, in bf16 values (else 0)
    smem: int           # dynamic shared memory, bytes


def mma_tile(L: LayerSpec) -> tuple[int, int, int]:
    """(K, N, row stride) of a layer's bf16 weight tile in the tensor-core
    kernels' shared memory (``w_tile_elems``): rows [0, round16(fin)) and
    columns [0, round16(fout)) of its packed block; rows past
    round8(fin), the next layer's, are zeroed there."""
    return _round16(L.fin), _round16(L.fout), _ld16(L.fout)


def weight_schedule(plan: Plan, backward: bool) -> list[int]:
    """The order in which the bf16 kernels stage the layers' weight tiles
    (indices in plan order), once a chunk: every layer in order (forward),
    or per head its layers in order, for the recompute, then in reverse,
    for dX (backward)."""
    sched, first = [], 0
    for h in plan.heads:
        ids = list(range(first, first + len(h.layers)))
        sched += ids + ids[::-1] if backward else ids
        first += len(h.layers)
    return sched


def ring_elems(plan: Plan, backward: bool) -> int:
    """bf16 values of the weight ring: tile s sits at one end or the other
    by the parity of s, so the ring holds any two consecutive tiles of the
    cyclic schedule (``ring_elems`` in csrc/fused_mlp_mma.cuh)."""
    layers = _layers(plan)
    sizes = [mma_tile(layers[i])[0] * mma_tile(layers[i])[2]
             for i in weight_schedule(plan, backward)]
    return max(a + b for a, b in zip(sizes, sizes[1:] + sizes[:1]))


def fwd_layout(plan: Plan, compute_dtype=torch.float32) -> KernelLayout:
    """csrc/fused_mlp_fwd.cu's shared memory. f32: 32 points, h_in and two
    activation buffers of floats. bf16: the weight ring, the chunk's f32
    inputs, h_in and two activation buffers as bf16 rows, POINTS_MMA
    points."""
    hin, width, _ = _widths(plan)
    if not _dtype_flag(compute_dtype):
        return KernelLayout(POINTS_FWD, hin, width, 0, 0,
                            POINTS_FWD * (hin + 2 * width) * 4)
    hs = _ld16(hin)
    ws = _ld16(max(L.fin for L in _layers(plan)))
    ring, points = ring_elems(plan, backward=False), POINTS_MMA
    smem = (2 * (ring + points * (hs + 2 * ws))
            + 4 * points * (plan.emb_dim + plan.feat_dim))
    return _fits(KernelLayout(points, hs, ws, 0, ring, smem))


def bwd_layout(plan: Plan, compute_dtype=torch.float32) -> KernelLayout:
    """csrc/fused_mlp_bwd.cu's shared memory, at the largest chunk that
    fits. f32: per point every layer input of the widest head, the
    cotangent [128], the dX buffer, d_h_in, d_emb and d_feat, in floats;
    32, 16, 8 or 4 points. bf16 (POINTS_MMA points, or 32 or 16 where the
    plan needs the room: a view-dependent ``mlp_rgb`` of 128 outputs
    doubles both the ring's largest tiles and the last output's rows):
    the weight ring;
    the recompute's h_in and two activation buffers as bf16 rows, in a
    union with the backward's f32 dX and bf16 rounded cotangent [LD_G];
    the leaky masks of every layer output but the last, a bit a value;
    the last output, the db part sums, d_emb, d_feat and the chunk's
    inputs in f32."""
    hin, width, inputs = _widths(plan)
    if not _dtype_flag(compute_dtype):
        per_point = (inputs + COLS + width + hin + plan.emb_dim
                     + plan.feat_dim) * 4
        for points in (32, 16, 8, 4):
            if points * per_point <= SMEM_LIMIT:
                return KernelLayout(points, hin, width, inputs, 0,
                                    points * per_point)
        raise ValueError(f"plan needs {4 * per_point} bytes of shared "
                         "memory for 4 points")
    hs, ws = _ld16(hin), _ld16(max(L.fin for L in _layers(plan)))
    words = max(sum(-(-L.fout // 32) for L in h.layers[:-1])
                for h in plan.heads)
    last = max(h.layers[-1].fout for h in plan.heads)
    ring = ring_elems(plan, backward=True)
    for points in (POINTS_MMA, POINTS_MMA // 2, POINTS_MMA // 4):
        union = max(points * (hs + 2 * ws), points * (2 * ws + LD_G))
        smem = (2 * (ring + union) + 4 * THREADS_MMA
                + 4 * points * (words + last + 2 * (plan.emb_dim
                                                     + plan.feat_dim)))
        if smem <= SMEM_LIMIT:
            break
    return _fits(KernelLayout(points, hs, ws, 0, ring, smem))


def _fits(lay: KernelLayout) -> KernelLayout:
    if lay.smem > SMEM_LIMIT:
        raise ValueError(f"plan needs {lay.smem} bytes of shared memory for "
                         f"{lay.points} points")
    return lay


def kernel_weights(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The packed weights as the kernels read them: ``w`` itself in f32,
    one bf16 copy in bf16 (made once a call, so no kernel converts in its
    inner loop)."""
    return w.to(torch.bfloat16) if _dtype_flag(compute_dtype) else w


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_ctas(device: torch.device, smem: int, threads: int) -> int:
    """CTAs of a kernel of ``threads`` threads and ``smem`` bytes of
    dynamic shared memory that fit on the card at once (by shared memory
    and threads): the persistent grids of the fused kernels, whose CTAs
    walk the chunks c, c + grid, ...; each backward CTA owns one db
    partial."""
    per_sm = max(1, min(228 * 1024 // (smem + 1024), 2048 // threads))
    return _sm_count(device) * per_sm


def _dtype_flag(compute_dtype) -> int:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
    return int(compute_dtype == torch.bfloat16)


def _check_inputs(plan, emb, feat, w, b):
    dev, n = emb.device, emb.shape[0]
    check("emb", emb, torch.float32, (n, plan.emb_dim), dev)
    check("feat", feat, torch.float32, (n, plan.feat_dim), dev)
    check("w", w, torch.float32, (plan.n_rows, COLS), dev)
    check("b", b, torch.float32, (plan.n_bias, COLS), dev)
    if n >= 2 ** 31 // COLS:
        raise ValueError(f"{n} points: offsets must fit in int32")
    return dev, n


def _launch_fwd(plan, emb, feat, w, b, compute_dtype):
    dev, n = _check_inputs(plan, emb, feat, w, b)
    lay = fwd_layout(plan, compute_dtype)
    outs = [torch.empty(n, h.out_dim, device=dev) for h in plan.heads]
    ptrs = torch.tensor([o.data_ptr() for o in outs], dtype=torch.int64)
    chunks = -(-n // lay.points)
    # f32: a CTA a chunk; bf16: as many CTAs as fit, each walking chunks
    ctas = (min(chunks, resident_ctas(dev, lay.smem, THREADS_MMA))
            if _dtype_flag(compute_dtype) else chunks)
    if n:
        run("fused_mlp_fwd", emb, feat, kernel_weights(w, compute_dtype), b,
            plan_table(plan), ptrs, n, lay.hin_stride, lay.width_stride,
            lay.w_region, lay.points, lay.smem, ctas,
            _dtype_flag(compute_dtype))
        fused_heads.launches += 1
    return tuple(outs)


def reduce_partials(w_parts: torch.Tensor, b_parts: torch.Tensor):
    """The fixed-order sums over the first axis of two [G, M] f32 partials
    (M a multiple of 4) -> ([M_w], [M_b]), in one launch of
    csrc/fused_mlp_bwd.cu's ``fused_mlp_reduce``; CUDA tensors only.
    ``parts.sum(0)`` is its plain version."""
    dev = w_parts.device
    for name, p in (("w_parts", w_parts), ("b_parts", b_parts)):
        check(name, p, torch.float32, tuple(p.shape), dev)
        if p.dim() != 2 or p.shape[1] % 4:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, [G, M] with "
                             "M a multiple of 4 expected")
    (gw, mw), (gb, mb) = w_parts.shape, b_parts.shape
    out = torch.empty(mw + mb, device=dev)
    run("fused_mlp_reduce", w_parts, out, gw, mw, b_parts, out[mw:], gb, mb,
        _sm_count(dev))
    reduce_partials.launches += 1
    return out[:mw], out[mw:]


def launch_bwd(plan: Plan, emb, feat, w, b, gs, compute_dtype):
    """The backward kernel alone: (d_emb [N, E], d_feat [N, F], scratch,
    db partials [G, L 128]): the scratch as ``dw_scratch_layout`` lays it
    out in ``compute_dtype``, one db partial per CTA. CUDA tensors
    only."""
    dev, n = _check_inputs(plan, emb, feat, w, b)
    for h, g in zip(plan.heads, gs, strict=True):
        check(f"g[{h.name}]", g, torch.float32, (n, h.out_dim), dev)
    kl = bwd_layout(plan, compute_dtype)
    lay = dw_scratch_layout(plan, n)
    d_emb = torch.empty(n, plan.emb_dim, device=dev)
    d_feat = torch.empty(n, plan.feat_dim, device=dev)
    # every element is written by the kernel, padding included
    scratch = torch.empty(lay.size, dtype=compute_dtype, device=dev)
    threads = THREADS_MMA if _dtype_flag(compute_dtype) else THREADS_BWD
    ctas = min(resident_ctas(dev, kl.smem, threads),
               max(1, lay.n_pad // kl.points))
    # zeros: each CTA adds its chunks' sums into its own partial
    b_parts = torch.zeros(ctas, plan.n_bias * COLS, device=dev)
    ptrs = torch.tensor([g.data_ptr() for g in gs], dtype=torch.int64)
    offs = torch.tensor([o for pair in zip(lay.x_off, lay.g_off)
                         for o in pair], dtype=torch.int64)
    if n:
        run("fused_mlp_bwd", emb, feat, kernel_weights(w, compute_dtype), b,
            plan_table(plan), ptrs, d_emb, d_feat, scratch, offs, b_parts, n,
            lay.n_pad, kl.hin_stride, kl.width_stride, kl.inputs_stride,
            kl.w_region, kl.points, kl.smem, ctas,
            _dtype_flag(compute_dtype))
        fused_heads_bwd.launches += 1
    return d_emb, d_feat, scratch, b_parts


def fused_dw(plan: Plan, scratch: torch.Tensor, n: int) -> torch.Tensor:
    """``fused_mlp_dw`` on a scratch buffer of N points (its dtype, bf16
    or f32, selects the tensor-core or the CUDA-core path): the slice
    partials [S, R 128] of dW, S = ``dw_slices``. CUDA tensors only;
    ``fused_dw_plain`` is its plain version (with the sum over S)."""
    dev, lay = scratch.device, dw_scratch_layout(plan, n)
    check("scratch", scratch, scratch.dtype, (lay.size,), dev)
    flag = _dtype_flag(scratch.dtype)
    slices = dw_slices(plan, n, _sm_count(dev))
    parts = torch.empty(slices, plan.n_rows * COLS, device=dev)
    offs = torch.tensor([o for pair in zip(lay.x_off, lay.g_off)
                         for o in pair], dtype=torch.int64)
    tiles = torch.tensor(dw_tiles(plan), dtype=torch.int32)
    run("fused_mlp_dw", scratch, parts, plan_table(plan), offs, tiles,
        tiles.shape[0], lay.n_pad, dw_slice_rows(lay.n_pad, slices), slices,
        flag)
    fused_dw.launches += 1
    return parts


def fused_heads_bwd(plan: Plan, emb, feat, w, b, gs,
                    compute_dtype=torch.float32):
    """The backward's three kernels in order (backward, dW, reduction):
    (d_emb [N, E], d_feat [N, F], dw [R, 128], db [L, 128]) for the
    cotangents ``gs`` [N, out] of the heads' outputs. CUDA tensors only;
    ``fused_heads_bwd_plain`` is its plain version. Deterministic: each
    backward CTA sums its fixed share of the points into its own db
    partial, each dW CTA its slice of N; the partials are summed in
    order."""
    n = emb.shape[0]
    d_emb, d_feat, scratch, b_parts = launch_bwd(plan, emb, feat, w, b, gs,
                                                 compute_dtype)
    if not n:
        return (d_emb, d_feat, torch.zeros_like(w), torch.zeros_like(b))
    dw, db = reduce_partials(fused_dw(plan, scratch, n), b_parts)
    return (d_emb, d_feat, dw.view(plan.n_rows, COLS),
            db.view(plan.n_bias, COLS))


class _FusedHeads(torch.autograd.Function):
    """The kernels: forward on the inputs, backward recomputing from them
    (only the inputs are saved)."""

    @staticmethod
    def forward(ctx, plan, compute_dtype, emb, feat, w, b):
        ctx.plan, ctx.compute_dtype = plan, compute_dtype
        ctx.save_for_backward(emb, feat, w, b)
        return _launch_fwd(plan, emb, feat, w, b, compute_dtype)

    @staticmethod
    def backward(ctx, *gs):
        emb, feat, w, b = ctx.saved_tensors
        gs = [torch.zeros(emb.shape[0], h.out_dim, device=emb.device)
              if g is None else g.contiguous()
              for h, g in zip(ctx.plan.heads, gs)]
        grads = fused_heads_bwd(ctx.plan, emb, feat, w, b, gs,
                                ctx.compute_dtype)
        return (None, None, *grads)


def fused_heads(plan: Plan, emb, feat, w, b,
                compute_dtype=torch.float32) -> tuple:
    """Every head of ``plan`` on [N, E] embeddings and [N, F] features
    (F = 0 without an encoder) with packed weights ``w`` [R, 128] and
    biases ``b`` [L, 128]: a tuple of per-head outputs [N, out], after the
    last leaky_relu and before the head's out_activation. The kernels for
    CUDA tensors, the plain version for CPU tensors; differentiable in
    all four inputs."""
    if emb.is_cuda:
        return _FusedHeads.apply(plan, compute_dtype, emb.contiguous(),
                                 feat.contiguous(), w.contiguous(),
                                 b.contiguous())
    return fused_heads_plain(plan, emb, feat, w, b, compute_dtype)


fused_heads.launches = 0
fused_heads_bwd.launches = 0
fused_dw.launches = 0
reduce_partials.launches = 0
