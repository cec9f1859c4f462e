"""The blend kernels' shortcuts before the exact skip test, on the CPU.

``blend_torch.row_threshold`` / ``pre_skip`` (the test before the expf) and
``blend_torch.tile_cull`` (rows a whole tile drops), which
``csrc/blend_rows.cuh`` mirrors, may skip only pairs that the exact rule
(``power > 0`` or ``min(0.99, op exp(power)) < 1/255``) skips. Seeded
sweeps over opacities (0, 1e-6, at and around 1/255, 0.5, 1), conics
(round, thin, rotated, degenerate) and pixels at and around each ellipse's
1/255 edge check that, and that the shortcuts are not vacuous; the plain
blends give bitwise the same outputs and gradients with the skipped pairs
removed (``cull=True``); ``blend_work``'s counts match a sequential loop.
No JAX, no GPU.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from splatfields_torch.ops.raster import blend_torch as bt

LVL = np.float32(1 / 255)
OPACITIES = np.array(
    [0.0, 1e-6, 1e-3, LVL, np.nextafter(LVL, np.float32(0)),
     np.nextafter(LVL, np.float32(1)), LVL * (1 - 1e-4), LVL * (1 + 1e-4),
     LVL * np.exp(-1e-3), LVL * np.exp(1e-3), LVL * np.exp(2e-3), 0.01, 0.5,
     0.99, 1.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conics(rng, n, kind):
    """[n, 3] conics (a, b, c): inverse covariances of the given shape."""
    th = rng.uniform(0, np.pi, n)
    if kind == "round":
        s1 = rng.uniform(0.5, 20, n)
        s2 = s1
    elif kind == "thin":
        s1, s2 = rng.uniform(5, 60, n), rng.uniform(0.3, 1.0, n)
    else:   # rotated, moderate
        s1, s2 = rng.uniform(1, 20, n), rng.uniform(0.5, 5, n)
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    cos, sin = np.cos(th), np.sin(th)
    return np.stack([cos * cos * i1 + sin * sin * i2, cos * sin * (i1 - i2),
                     sin * sin * i1 + cos * cos * i2], 1)


def _degenerate(rng, n):
    """Conics with det = ac - b^2 <= 0 (and some negative diagonals)."""
    a, c = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    b = np.sqrt(np.abs(a * c)) * rng.uniform(1.0, 3.0, n)
    b[::3] = np.sqrt(np.abs(a * c))[::3]   # det exactly 0 up to rounding
    return np.stack([a, b, c], 1)


def _exact(rows, px, py):
    """The plain blend's power and exact skip (f32, as in ``_chunks``)."""
    dx = rows[:, 0, None] - px
    dy = rows[:, 1, None] - py
    power = (-0.5 * (rows[:, 2, None] * dx * dx + rows[:, 4, None] * dy * dy)
             - rows[:, 3, None] * dx * dy)
    alpha = torch.clamp_max(rows[:, 5, None] * torch.exp(power), 0.99)
    return power, (power > 0.0) | (alpha < 1.0 / 255.0)


def _edge_pixels(rng, conic, op, k):
    """[n, k, 2] offsets d on and around the ellipse where op exp(power) =
    1/255 (or random offsets where there is none)."""
    n = conic.shape[0]
    ang = rng.uniform(0, 2 * np.pi, (n, k))
    u = np.stack([np.cos(ang), np.sin(ang)], -1)
    q = (conic[:, None, 0] * u[..., 0] ** 2 + 2 * conic[:, None, 1]
         * u[..., 0] * u[..., 1] + conic[:, None, 2] * u[..., 1] ** 2)
    level = np.log(np.maximum(op, 1e-30) * 255.0)[:, None]   # -power at edge
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.sqrt(2 * level / q)
    r = np.where(np.isfinite(r) & (r < 1e4), r, rng.uniform(0, 50, (n, k)))
    r = r * (1 + rng.choice([0, 1e-7, -1e-7, 1e-5, -1e-5, 1e-3, -1e-3, 0.1,
                             -0.1], (n, k)))
    return u * r[..., None]


def _rows(conic, op, mean):
    rows = np.zeros((conic.shape[0], 10), np.float32)
    rows[:, :2], rows[:, 2:5], rows[:, 5] = mean, conic, op
    return torch.as_tensor(rows)


@pytest.mark.parametrize("kind", ["round", "thin", "rotated", "degenerate"])
def test_pre_test_skips_only_skipped_pairs(kind):
    """Each row's mean sits at a pixel centre plus an offset on or near
    its ellipse's 1/255 edge; that pixel and its eight neighbours."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    n, k = 2000, 16
    conic = (_degenerate(rng, n) if kind == "degenerate"
             else _conics(rng, n, kind))
    op = rng.choice(OPACITIES, n)
    d = _edge_pixels(rng, conic, op, k).reshape(n * k, 2)
    pix = rng.randint(0, 800, (n * k, 2)).astype(np.float32)
    rows = _rows(np.repeat(conic, k, 0), np.repeat(op, k),
                 (pix + d).astype(np.float32))
    off = torch.tensor([-1.0, 0.0, 1.0])
    px = (torch.as_tensor(pix[:, 0])[:, None, None] + off[None, :, None]
          ).expand(-1, 3, 3).reshape(n * k, 9)
    py = (torch.as_tensor(pix[:, 1])[:, None, None] + off[None, None, :]
          ).expand(-1, 3, 3).reshape(n * k, 9)
    power, skip = _exact(rows, px, py)
    pre = bt.pre_skip(power, bt.row_threshold(rows[:, 5])[:, None])
    assert not bool((pre & ~skip).any())
    assert int((~skip).sum()) > 0
    # not vacuous: most skipped pairs never reach the exp
    if kind != "degenerate":
        assert int(pre.sum()) > 0.5 * int(skip.sum())


def test_pre_test_sweeps_every_opacity_near_the_level():
    """Pixels on a fine grid through the 1/255 edge of a round splat, for
    every opacity of the sweep: no applied pair is pre-skipped."""
    r = np.linspace(0, 12, 4001, dtype=np.float32)
    for op in OPACITIES:
        rows = _rows(np.array([[0.25, 0.0, 0.25]], np.float32),
                     np.array([op], np.float32),
                     np.array([[0.0, 0.0]], np.float32))
        power, skip = _exact(rows, torch.as_tensor(r)[None],
                             torch.zeros(1, r.size))
        pre = bt.pre_skip(power, bt.row_threshold(rows[:, 5])[:, None])
        assert not bool((pre & ~skip).any()), op


def test_row_threshold_special_values():
    op = torch.tensor([0.0, -1.0, float("nan"), float("inf"), 1e-45, 1.0])
    thr = bt.row_threshold(op)
    assert thr[:3].tolist() == [float("-inf")] * 3   # no pre-skip
    assert thr[3] == float("-inf")
    assert thr[4] == float("inf")    # every power skips: op exp <= op
    assert abs(float(thr[5]) - (np.log(1 / 255) - 1e-3)) < 1e-6


def _tile_pixels(x0, y0, ts=16):
    lin = torch.arange(ts * ts)
    return (x0 + (lin % ts)).float(), (y0 + (lin // ts)).float()


@pytest.mark.parametrize("kind", ["round", "thin", "rotated", "degenerate"])
def test_tile_cull_drops_only_skipped_rows(kind):
    """Rows around one tile, their ellipses' edges near it: a culled row
    is pre-skipped (so skipped) by every pixel of the tile."""
    rng = np.random.RandomState(7 + sum(map(ord, kind)))
    n, ts, x0, y0 = 4000, 16, 160.0, 96.0
    conic = (_degenerate(rng, n) if kind == "degenerate"
             else _conics(rng, n, kind))
    op = rng.choice(OPACITIES, n)
    # centres so that the ellipse's edge passes near a tile corner or edge
    d = _edge_pixels(rng, conic, op, 1)[:, 0]
    anchor = np.stack([x0 + rng.choice([0, 7.5, 15], n) + rng.uniform(
        -1, 1, n), y0 + rng.choice([0, 7.5, 15], n) + rng.uniform(-1, 1, n)],
        1)
    rows = _rows(conic, op, (anchor + d).astype(np.float32))
    thr = bt.row_threshold(rows[:, 5])
    culled = bt.tile_cull(rows, thr, x0, y0, ts)
    px, py = _tile_pixels(x0, y0, ts)
    power, skip = _exact(rows, px[None], py[None])
    pre = bt.pre_skip(power, thr[:, None])
    assert bool(pre[culled].all()) and bool(skip[culled].all())
    if kind == "degenerate":
        # never culled unless faint (thr > 0)
        assert not bool((culled & (thr <= 0)).any())
    else:
        # not vacuous: a good share of the rows no pixel applies is culled
        unused = skip.all(1) & (thr <= 0)
        assert int((culled & unused).sum()) > 0.2 * int(unused.sum())


def test_tile_cull_bad_rows():
    """Non-finite or out-of-range rows are never culled; faint rows are."""
    good = [5.0, 5.0, 0.1, 0.0, 0.1, 0.5, 0, 0, 0, 1]
    far = [500.0, 500.0, 0.1, 0.0, 0.1, 0.5, 0, 0, 0, 1]
    rows = torch.tensor([
        far,
        [500.0, 500.0, 0.1, 0.0, 0.1, 1e-4, 0, 0, 0, 1],     # faint
        [float("nan"), 500.0, 0.1, 0.0, 0.1, 0.5, 0, 0, 0, 1],
        [500.0, 500.0, float("inf"), 0.0, 0.1, 0.5, 0, 0, 0, 1],
        [500.0, 500.0, 1e11, 0.0, 0.1, 0.5, 0, 0, 0, 1],
        [2e9, 500.0, 0.1, 0.0, 0.1, 0.5, 0, 0, 0, 1],
        [500.0, 500.0, 0.1, 0.2, 0.1, 0.5, 0, 0, 0, 1],      # det < 0
        [500.0, 500.0, 0.1, 0.0, 0.1, float("nan"), 0, 0, 0, 1],
        good,
    ])
    culled = bt.tile_cull(rows, bt.row_threshold(rows[:, 5]), 0.0, 0.0, 16)
    assert culled.tolist() == [True, True] + [False] * 7


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _cases():
    for rows, op in ((600, 0.9), (1500, 0.005), (300, 0.3)):
        (pack, start, counts), tx, ty = cs.synthetic_pack(
            "cpu", rows, op, tiles_x=4, tiles_y=3)
        yield (f"synthetic {rows}", pack, start, counts,
               torch.arange(tx * ty, dtype=torch.int32), tx, ty)
    for kind in cs.BLEND_KINDS:
        (pack, start, counts, ids), tx, ty = cs.blend_case(kind, "cpu")
        yield kind, pack, start, counts, ids, tx, ty


@pytest.fixture(scope="module")
def rendered():
    """One small rendered frame's blend inputs (chip_smoke's serving scene
    at 2,000 splats, 64x64, on the CPU)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "N_SPLATS", 2000)
    mp.setattr(cs, "RES", 64)
    mp.setattr(cs, "N_FRAMES", 1)
    try:
        sc = cs.serving_scene(torch.device("cpu"))
        args = cs.serving_blend_args(sc)
    finally:
        mp.undo()
    pack, start, counts, tx, ty = args[:5]
    return ("rendered", pack.detach(), start, counts,
            torch.arange(counts.shape[0], dtype=torch.int32), tx, ty)


def test_plain_blends_unchanged_by_the_skips(rendered):
    culled_any = False
    for name, pack, start, counts, ids, tx, ty in [*_cases(), rendered]:
        fwd = (pack, start, counts, tx, ty, 16, 1024, 128, ids)
        out = bt.blend_sorted_plain(*fwd)
        assert _equal(out, bt.blend_sorted_plain(*fwd, cull=True)), name
        rng = np.random.RandomState(5)
        gs = [torch.as_tensor(rng.rand(*o.shape).astype(np.float32))
              for o in out]
        bwd = (pack, start, counts, ids, *gs, *out, tx, 16, 1024, 128)
        assert torch.equal(bt.blend_bwd_plain(*bwd),
                           bt.blend_bwd_plain(*bwd, cull=True)), name
        work = bt.blend_work(pack, start, counts, tx, 16, 1024, 128, ids)
        culled_any |= work.culled > 0
    assert culled_any


def _work_loop(pack, start, counts, ids, tiles_x, ts, tile_cap):
    """blend_work by a sequential loop: each tile's rows one at a time,
    every pixel with its own T, in f32."""
    evaluated = applied = warp_rows = culled = 0
    for t in range(counts.shape[0]):
        gid = int(ids[t])
        x0, y0 = (gid % tiles_x) * ts, (gid // tiles_x) * ts
        px, py = _tile_pixels(x0, y0, ts)
        T = torch.ones(ts * ts)
        done = torch.zeros(ts * ts, dtype=torch.bool)
        for i in range(int(start[t]), int(start[t]) + min(int(counts[t]),
                                                          tile_cap)):
            row = pack[i:i + 1]
            culled += int(bt.tile_cull(row, bt.row_threshold(row[:, 5]),
                                       float(x0), float(y0), ts))
            evaluated += int((~done).sum())
            power, skip = _exact(row, px[None], py[None])
            alpha = torch.clamp_max(row[:, 5, None] * torch.exp(power),
                                    0.99)[0]
            hit = ~done & ~skip[0]
            test_t = T * (1.0 - alpha)
            stop = hit & (test_t < 1e-4)
            hit = hit & ~stop
            applied += int(hit.sum())
            warp_rows += int(hit.reshape(-1, 32).any(1).sum())
            T = torch.where(hit, test_t, T)
            done = done | stop
    return evaluated, applied, warp_rows, culled


@pytest.mark.parametrize("kind", ["ragged", "miss", "synthetic"])
def test_blend_work_counts(kind):
    if kind == "synthetic":
        (pack, start, counts), tx, _ = cs.synthetic_pack(
            "cpu", 90, 0.9, tiles_x=2, tiles_y=1)
        ids = torch.arange(2, dtype=torch.int32)
    else:
        (pack, start, counts, ids), tx, _ = cs.blend_case(
            kind, "cpu", tiles_x=2, tiles_y=2, rows=40)
        if kind == "ragged":   # keep the loop short: cap the long tiles
            counts = counts.clamp(max=80)
    # one chunk (k_chunk > tile_cap): the plain's cumprod is then the
    # loop's product bit for bit
    work = bt.blend_work(pack, start, counts, tx, 16, 70, 128, ids)
    assert tuple(work) == _work_loop(pack, start, counts, ids, tx, 16, 70)
    assert work.applied > 0 and work.warp_rows > 0
