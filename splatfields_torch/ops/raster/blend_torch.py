"""Front-to-back tile alpha blending in plain PyTorch (counterpart of
``splatfields_tpu/ops/raster/blend_jax.py``).

Per pixel, over the depth-sorted instances of its tile:

    C = sum_i c_i * alpha_i * T_i,   T_i = prod_{j<i} (1 - alpha_j)

with the CUDA rasterizer's rules: alpha = min(0.99, op * exp(power));
skip a splat when ``power > 0`` or ``alpha < 1/255``; a pixel is done when
``T_i * (1 - alpha_i) < 1e-4``, and that splat is not applied. Depth
accumulates alpha-weighted view depth without normalization.

This is the plain version of the hand-written CUDA kernel
(``blend_cuda.blend_fwd``): the CPU path runs it, and the GPU checks
compare the kernel with it on the same tensors. It takes the kernel's
contract: one depth-sorted packed row per instance ([D, 10] =
mx, my, conic a/b/c, opacity, r, g, b, z) plus per-tile ranges.

It works in K-sized chunks of every tile at once. Early termination is in
closed form (``blend_jax._blend_chunk``): with s_i the inclusive
cumulative transmittance, splat i is applied iff ``s_i >= 1e-4``, and the
pixel's final T is the smallest such s_i. That is exact because s is
monotone and skipped splats (alpha = 0) leave it unchanged.

``blend_bwd_plain`` is the plain version of the backward kernel
(``blend_cuda.blend_bwd``): the closed-form VJP of the Pallas backward
(``blend_pallas._bwd_one_tile``), chunk by chunk over all tiles at once,
not autograd.
"""
from __future__ import annotations

import torch

_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
PACK_WIDTH = 10  # mean_x, mean_y, con_a, con_b, con_c, opacity, r, g, b, depth


def pack_attributes(means2d, conics, rgb, opacity, depths) -> torch.Tensor:
    """[N] per-splat render attributes -> one [N, 10] row matrix."""
    return torch.cat([means2d, conics, opacity.reshape(-1, 1), rgb,
                      depths.reshape(-1, 1)], dim=1)


def pixel_coords(tile_ids: torch.Tensor, tiles_x: int, tile_size: int):
    """[T] global tile ids -> (px, py) [T, P] float pixel coordinates,
    pixels row-major inside a tile."""
    lin = torch.arange(tile_size * tile_size, device=tile_ids.device)
    px = (tile_ids % tiles_x)[:, None] * tile_size + lin[None] % tile_size
    py = (tile_ids // tiles_x)[:, None] * tile_size + lin[None] // tile_size
    return px.to(torch.float32), py.to(torch.float32)


def _chunks(sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
            tile_cap, k_chunk):
    """Yield, per K-chunk of every tile's instance list, the chunk's rows
    [T, K, 10] (zero past the tile's count), which rows are real [T, K]
    and their alphas [T, K, P] with the skip rules applied."""
    num_tiles = counts.shape[0]
    d_rows = sorted_pack.shape[0]
    px, py = pixel_coords(tile_ids.to(torch.int64), tiles_x, tile_size)
    starts = tile_start[:num_tiles].to(torch.int64)
    n_rows = torch.clamp(torch.minimum(counts.to(torch.int64),
                                       torch.full_like(starts, tile_cap)),
                         min=0)
    n_rows = torch.minimum(n_rows, torch.clamp_min(d_rows - starts, 0))
    # chunks past the longest tile hold no rows: stop there
    max_rows = int(n_rows.max()) if num_tiles else 0
    for c0 in range(0, max_rows, k_chunk):
        pos = c0 + torch.arange(k_chunk, device=sorted_pack.device)
        valid = pos[None, :] < n_rows[:, None]                    # [T, K]
        idx = torch.clamp(starts[:, None] + pos[None, :], max=max(d_rows - 1, 0))
        rows = torch.where(valid[..., None], sorted_pack[idx], 0.0)  # [T,K,10]
        dx = rows[..., 0, None] - px[:, None, :]                  # [T, K, P]
        dy = rows[..., 1, None] - py[:, None, :]
        power = (-0.5 * (rows[..., 2, None] * dx * dx
                         + rows[..., 4, None] * dy * dy)
                 - rows[..., 3, None] * dx * dy)
        alpha = torch.clamp_max(rows[..., 5, None] * torch.exp(power), 0.99)
        skip = (power > 0.0) | (alpha < _ALPHA_MIN) | ~valid[..., None]
        yield rows, valid, torch.where(skip, 0.0, alpha)


def _default_tile_ids(counts: torch.Tensor, tile_ids):
    if tile_ids is None:
        return torch.arange(counts.shape[0], device=counts.device,
                            dtype=torch.int32)
    return tile_ids


def blend_sorted_plain(sorted_pack, tile_start, counts, tiles_x: int,
                       tiles_y: int, tile_size: int, tile_cap: int,
                       k_chunk: int, tile_ids=None):
    """[D, 10] sorted pack -> (color [T,3,P], depth [T,P], final_t [T,P]).

    ``tile_ids`` ([T] int32) maps row t of ``tile_start``/``counts`` to a
    global tile id; the default is the whole grid in order."""
    del tiles_y
    num_tiles = counts.shape[0]
    p = tile_size * tile_size
    dev = sorted_pack.device
    tile_ids = _default_tile_ids(counts, tile_ids)
    color = torch.zeros(num_tiles, 3, p, device=dev)
    depth = torch.zeros(num_tiles, p, device=dev)
    t_true = torch.ones(num_tiles, p, device=dev)
    t_full = torch.ones(num_tiles, p, device=dev)
    for rows, _, alpha in _chunks(sorted_pack, tile_start, counts, tile_ids,
                                  tiles_x, tile_size, tile_cap, k_chunk):
        s = t_full[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)  # [T,K,P]
        t_excl = torch.cat([t_full[:, None, :], s[:, :-1, :]], dim=1)
        live = s >= _T_EPS
        w = alpha * t_excl * live
        color = color + torch.einsum("tkp,tkc->tcp", w, rows[..., 6:9])
        depth = depth + (w * rows[..., 9, None]).sum(dim=1)
        t_cand = torch.where(live, s, t_true[:, None, :])
        t_true = torch.minimum(t_cand.amin(dim=1), t_true)
        t_full = s[:, -1, :]
    return color, depth, t_true


def blend_bwd_plain(sorted_pack, tile_start, counts, tile_ids, g_color,
                    g_depth, g_tfinal, color, depth, final_t, tiles_x: int,
                    tile_size: int, tile_cap: int, k_chunk: int):
    """dL/d(sorted_pack) [D, 10] from the upstream gradients of the blend's
    outputs (``g_color`` [T,3,P], ``g_depth`` and ``g_tfinal`` [T,P]) and
    the saved outputs ``color``, ``depth``, ``final_t``.

    Per pixel, with w_i = alpha_i T_i over the applied splats (live_i):

        dL/dalpha_i = live_i [T_i (c_i.gC + z_i gD)
                      - (S_c,i + S_d,i + T_final gT) / (1 - alpha_i)]

    where S_*,i sum w_j (c_j.gC) and w_j z_j gD over applied j > i. They
    are the totals, in closed form from the saved outputs (C.gC and D gD),
    minus running prefix sums. The chain through alpha = op exp(power)
    takes d alpha / d(op exp(power)) = 1 even where the 0.99 clamp
    applies, and op = max(op, 1e-9), as the Pallas kernel and the
    reference CUDA rasterizer do. Rows no pixel reaches (past the tile's
    stop or ``tile_cap``, and padding) get zeros."""
    d_rows = sorted_pack.shape[0]
    dev = sorted_pack.device
    p = tile_size * tile_size
    grad = torch.zeros(d_rows, PACK_WIDTH, device=dev)
    g_depth = g_depth[:, None, :]                                  # [T,1,P]
    tot_c = (color * g_color).sum(dim=1)[:, None, :]               # [T,1,P]
    tot_d = depth[:, None, :] * g_depth
    t_gt = (final_t * g_tfinal)[:, None, :]
    t_full = torch.ones(counts.shape[0], p, device=dev)
    pre_c = torch.zeros(counts.shape[0], 1, p, device=dev)
    pre_d = torch.zeros_like(pre_c)
    px, py = pixel_coords(tile_ids.to(torch.int64), tiles_x, tile_size)
    starts = tile_start[:counts.shape[0]].to(torch.int64)
    for chunk, (rows, valid, alpha) in enumerate(_chunks(
            sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
            tile_cap, k_chunk)):
        s = t_full[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)  # [T,K,P]
        t_excl = torch.cat([t_full[:, None, :], s[:, :-1, :]], dim=1)
        live = s >= _T_EPS
        w = alpha * t_excl * live
        cdot = torch.einsum("tkc,tcp->tkp", rows[..., 6:9], g_color)
        zdot = rows[..., 9, None] * g_depth
        contrib_c = w * cdot
        contrib_d = w * zdot
        suf_c = tot_c - (pre_c + torch.cumsum(contrib_c, dim=1))
        suf_d = tot_d - (pre_d + torch.cumsum(contrib_d, dim=1))
        g_alpha = live * (t_excl * (cdot + zdot) - (suf_c + suf_d + t_gt)
                          / torch.clamp_min(1.0 - alpha, 1e-6))
        dx = rows[..., 0, None] - px[:, None, :]
        dy = rows[..., 1, None] - py[:, None, :]
        ca, cb, cc = (rows[..., i, None] for i in (2, 3, 4))
        op = torch.clamp_min(rows[..., 5, None], 1e-9)
        ga = g_alpha * alpha
        g_rows = torch.cat([
            torch.stack([
                (ga * -(ca * dx + cb * dy)).sum(-1),
                (ga * -(cc * dy + cb * dx)).sum(-1),
                (ga * (-0.5 * dx * dx)).sum(-1),
                (ga * (-dx * dy)).sum(-1),
                (ga * (-0.5 * dy * dy)).sum(-1),
                (g_alpha * alpha / op).sum(-1)], dim=-1),
            torch.einsum("tkp,tcp->tkc", w, g_color),
            (w * g_depth).sum(-1)[..., None]], dim=-1)           # [T,K,10]
        pos = (starts[:, None] + chunk * k_chunk
               + torch.arange(k_chunk, device=dev))
        grad[pos[valid]] = g_rows[valid]
        pre_c = pre_c + contrib_c.sum(dim=1, keepdim=True)
        pre_d = pre_d + contrib_d.sum(dim=1, keepdim=True)
        t_full = s[:, -1, :]
    return grad


def blend_work(sorted_pack, tile_start, counts, tiles_x: int, tile_size: int,
               tile_cap: int, k_chunk: int, tile_ids=None):
    """(pairs evaluated, pairs applied) by a per-pixel sequential blend
    that stops at the first splat driving T below 1e-4: the work these
    inputs need, for a kernel's bound. A pixel evaluates instance i iff it
    was not done before i, i.e. iff the inclusive transmittance through
    i - 1 is still >= 1e-4."""
    tile_ids = _default_tile_ids(counts, tile_ids)
    p = tile_size * tile_size
    t_full = torch.ones(counts.shape[0], p, device=sorted_pack.device)
    evaluated = torch.zeros((), dtype=torch.int64, device=sorted_pack.device)
    applied = torch.zeros_like(evaluated)
    for _, valid, alpha in _chunks(sorted_pack, tile_start, counts, tile_ids,
                                   tiles_x, tile_size, tile_cap, k_chunk):
        s = t_full[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([t_full[:, None, :], s[:, :-1, :]], dim=1)
        evaluated += ((t_excl >= _T_EPS) & valid[..., None]).sum()
        applied += ((s >= _T_EPS) & (alpha > 0)).sum()
        t_full = s[:, -1, :]
    return int(evaluated), int(applied)


def tiles_to_image(tile_buf: torch.Tensor, tiles_x: int, tiles_y: int,
                   tile_size: int, height: int, width: int) -> torch.Tensor:
    """[T, P(, C)] tile pixel buffers -> [H, W(, C)] image (crop padding)."""
    c_shape = tile_buf.shape[2:]
    img = tile_buf.reshape(tiles_y, tiles_x, tile_size, tile_size, *c_shape)
    img = img.movedim(2, 1).reshape(tiles_y * tile_size,
                                    tiles_x * tile_size, *c_shape)
    return img[:height, :width]
