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

Two shortcuts of the kernels skip pairs before the exact test, and only
pairs the exact test skips: ``row_threshold`` gives each row a level
below which ``op * exp(power) < 1/255`` whatever ``expf`` rounds, so a
pixel skips the row on ``power > 0 or power < thr`` without the exp; and
``tile_cull`` drops, for a whole tile, a row whose ellipse at that level
misses every pixel centre of the tile. Both are here as plain functions
that the kernels mirror; ``cull=True`` makes the plain blends skip those
pairs too, which must leave every output bitwise unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_ALPHA_MIN = 1.0 / 255.0
_T_EPS = 1e-4
PACK_WIDTH = 10  # mean_x, mean_y, con_a, con_b, con_c, opacity, r, g, b, depth
WARP = 32        # pixels of a warp in the kernels: 32 consecutive of a tile
# the pre-test's margin in power units, far above the few-ulp errors of
# expf, logf and the products (~1e-6 relative)
PRE_DELTA = 1e-3
# the tile cull: the float power differs from the exact quadratic form by
# at most ~8 ulp (1e-6) of its terms' magnitudes; CULL_GAMMA bounds that
# tenfold. CULL_DET widens a x c - b^2 against its rounding, CULL_WIDEN the
# half-widths and CULL_GAP the gap to the tile against theirs. Rows with a
# value outside CULL_SANE (conic) or CULL_SANE_MEAN (mean) are never
# culled: there a power could overflow.
CULL_GAMMA = 1e-5
CULL_DET = 1e-6
CULL_WIDEN = 1.001
CULL_GAP = 1.0 - 1e-5
CULL_SANE, CULL_SANE_MEAN = 1e10, 1e9


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


def row_threshold(opacity: torch.Tensor) -> torch.Tensor:
    """Each row's pre-test level, f32: ``log(1/(255 op)) - PRE_DELTA``,
    and -inf where ``op <= 0`` or NaN (no pre-skip). A pair with ``power
    < thr`` has ``op * expf(power) < 1/255``, so the exact test skips it
    too (the kernels: ``row_threshold`` in ``csrc/blend_rows.cuh``)."""
    op = opacity.to(torch.float32)
    thr = torch.log(1.0 / (255.0 * op)) - PRE_DELTA
    return torch.where(op > 0, thr, torch.full_like(thr, float("-inf")))


def pre_skip(power: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The kernels' test before the exp: skip on ``power > 0`` (the exact
    rule) or ``power < thr``. NaN powers are never pre-skipped."""
    return (power > 0.0) | (power < thr)


def tile_cull(rows: torch.Tensor, thr: torch.Tensor, x0, y0,
              tile_size: int) -> torch.Tensor:
    """Rows [..., 10] a tile whose first pixel centre is (x0, y0) can
    drop: every one of its pixels pre-skips them (``pre_skip``).

    The float power is at most ``-0.5 Q'(d)``, where Q' is the conic with
    ``CULL_GAMMA (|a| + |b|)`` and ``CULL_GAMMA (|c| + |b|)`` taken off
    its diagonal (its rounding bound). Where Q' is positive definite, a
    pixel with ``power >= thr`` lies in the ellipse ``Q'(d) <= -2 thr``,
    inside the box of half-widths ``sqrt(-2 thr c' / det')`` and
    ``sqrt(-2 thr a' / det')``: a row whose box misses the tile's pixel
    centres is culled. ``det'`` is taken low (CULL_DET), the half-widths
    wide (CULL_WIDEN) and the gaps short (CULL_GAP) against their own
    rounding. A row whose opacity is below the 1/255 level (``thr >
    0``) is culled whatever its shape: every power is then > 0 or below
    thr. Never culled: non-finite or out-of-range rows, and (unless faint)
    conics with ``det' <= 0``. ``x0``, ``y0`` broadcast against ``thr``."""
    mx, my, a, b, c = (rows[..., i] for i in range(5))
    x1, y1 = x0 + (tile_size - 1), y0 + (tile_size - 1)
    conic = torch.stack([a, b, c])
    sane = (torch.isfinite(conic).all(0) & torch.isfinite(mx)
            & torch.isfinite(my) & (conic.abs() <= CULL_SANE).all(0)
            & (mx.abs() <= CULL_SANE_MEAN) & (my.abs() <= CULL_SANE_MEAN))
    ap = a - CULL_GAMMA * (a.abs() + b.abs())
    cp = c - CULL_GAMMA * (c.abs() + b.abs())
    det = ap * cp * (1.0 - CULL_DET) - b * b * (1.0 + CULL_DET)
    k = -2.0 * thr
    hx = torch.sqrt(k * cp / det) * CULL_WIDEN
    hy = torch.sqrt(k * ap / det) * CULL_WIDEN
    gx = torch.maximum(x0 - mx, mx - x1) * CULL_GAP
    gy = torch.maximum(y0 - my, my - y1) * CULL_GAP
    miss = (ap > 0) & (cp > 0) & (det > 0) & ((gx > hx) | (gy > hy))
    return sane & ((thr > 0) | miss)


def _chunks(sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
            tile_cap, k_chunk, cull=False, want_cull=False):
    """Yield, per K-chunk of every tile's instance list, the chunk's rows
    [T, K, 10] (zero past the tile's count), which rows are real [T, K],
    their alphas [T, K, P] with the skip rules applied, and which real
    rows the tile cull drops [T, K] (None unless ``cull`` or
    ``want_cull``). ``cull`` also skips the pairs the kernels' pre-test
    and tile cull drop (alpha 0)."""
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
        culled = None
        if cull or want_cull:
            thr = row_threshold(rows[..., 5])                     # [T, K]
            culled = valid & tile_cull(rows, thr, px[:, :1], py[:, :1],
                                       tile_size)
        if cull:
            skip = (skip | pre_skip(power, thr[..., None])
                    | culled[..., None])
        yield rows, valid, torch.where(skip, 0.0, alpha), culled


def _default_tile_ids(counts: torch.Tensor, tile_ids):
    if tile_ids is None:
        return torch.arange(counts.shape[0], device=counts.device,
                            dtype=torch.int32)
    return tile_ids


def blend_sorted_plain(sorted_pack, tile_start, counts, tiles_x: int,
                       tiles_y: int, tile_size: int, tile_cap: int,
                       k_chunk: int, tile_ids=None, cull: bool = False):
    """[D, 10] sorted pack -> (color [T,3,P], depth [T,P], final_t [T,P]).

    ``tile_ids`` ([T] int32) maps row t of ``tile_start``/``counts`` to a
    global tile id; the default is the whole grid in order. ``cull``: see
    ``_chunks``."""
    del tiles_y
    num_tiles = counts.shape[0]
    p = tile_size * tile_size
    dev = sorted_pack.device
    tile_ids = _default_tile_ids(counts, tile_ids)
    color = torch.zeros(num_tiles, 3, p, device=dev)
    depth = torch.zeros(num_tiles, p, device=dev)
    t_true = torch.ones(num_tiles, p, device=dev)
    t_full = torch.ones(num_tiles, p, device=dev)
    for rows, _, alpha, _ in _chunks(sorted_pack, tile_start, counts,
                                     tile_ids, tiles_x, tile_size, tile_cap,
                                     k_chunk, cull):
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
                    tile_size: int, tile_cap: int, k_chunk: int,
                    cull: bool = False):
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
    stop or ``tile_cap``, and padding) get zeros. ``cull``: see
    ``_chunks``."""
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
    for chunk, (rows, valid, alpha, _) in enumerate(_chunks(
            sorted_pack, tile_start, counts, tile_ids, tiles_x, tile_size,
            tile_cap, k_chunk, cull)):
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


class BlendWork(NamedTuple):
    evaluated: int   # (pixel, row) pairs a per-pixel blend evaluates
    applied: int     # of which applied
    warp_rows: int   # (warp, row) pairs with an applied lane
    culled: int      # (tile, row) pairs the tile cull drops


def blend_work(sorted_pack, tile_start, counts, tiles_x: int, tile_size: int,
               tile_cap: int, k_chunk: int, tile_ids=None) -> BlendWork:
    """The work these inputs need, for a kernel's bound: the pairs a
    per-pixel sequential blend that stops at the first splat driving T
    below 1e-4 evaluates and applies, the (warp, row) pairs in which at
    least one of the warp's 32 pixels (``WARP`` consecutive pixels of the
    tile) applies the row (what the backward's row sums cost), and the
    tile's rows ``tile_cull`` drops. A pixel evaluates instance i iff it
    was not done before i, i.e. iff the inclusive transmittance through
    i - 1 is still >= 1e-4. Counts ignore the cull, as the bounds do."""
    tile_ids = _default_tile_ids(counts, tile_ids)
    p = tile_size * tile_size
    t_full = torch.ones(counts.shape[0], p, device=sorted_pack.device)
    zero = torch.zeros((), dtype=torch.int64, device=sorted_pack.device)
    evaluated, applied, warp_rows, culled = zero, zero, zero, zero
    pad = -p % WARP
    for _, valid, alpha, cut in _chunks(sorted_pack, tile_start, counts,
                                        tile_ids, tiles_x, tile_size,
                                        tile_cap, k_chunk,
                                        want_cull=True):
        s = t_full[:, None, :] * torch.cumprod(1.0 - alpha, dim=1)
        t_excl = torch.cat([t_full[:, None, :], s[:, :-1, :]], dim=1)
        evaluated = evaluated + ((t_excl >= _T_EPS) & valid[..., None]).sum()
        hit = (s >= _T_EPS) & (alpha > 0)
        applied = applied + hit.sum()
        hit = torch.nn.functional.pad(hit, (0, pad))
        warp_rows = warp_rows + hit.reshape(*hit.shape[:2], -1,
                                            WARP).any(-1).sum()
        culled = culled + cut.sum()
        t_full = s[:, -1, :]
    return BlendWork(int(evaluated), int(applied), int(warp_rows),
                     int(culled))


def tiles_to_image(tile_buf: torch.Tensor, tiles_x: int, tiles_y: int,
                   tile_size: int, height: int, width: int) -> torch.Tensor:
    """[T, P(, C)] tile pixel buffers -> [H, W(, C)] image (crop padding)."""
    c_shape = tile_buf.shape[2:]
    img = tile_buf.reshape(tiles_y, tiles_x, tile_size, tile_size, *c_shape)
    img = img.movedim(2, 1).reshape(tiles_y * tile_size,
                                    tiles_x * tile_size, *c_shape)
    return img[:height, :width]
