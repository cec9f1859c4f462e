"""The CUDA blend kernels, forward and backward, against their plain
PyTorch versions, on the GPU.

Needs a CUDA card (and nvcc to build the kernels); skips elsewhere. Imports
no JAX, so on the GPU machine it runs without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_blend_cuda.py -q

Forward tolerance: both compute each alpha with the same f32 operations
(the kernel is built with --fmad=false); they differ in how the
transmittance product is associated (a sequential product against a
chunked cumprod), ~1e-7 relative. A pixel whose T crosses the 1e-4 stop
between the two can differ by one splat's weight, < 1e-4: colour and T
2e-4, depth (z up to 5) 1e-3.

Backward tolerance: per column, over the column's max abs, 1e-3
(chip_smoke.TOL_BWD: sums over pixels in another order, suffix sums as
total minus prefix, and the same stop-crossing pixels).
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    BLEND_KINDS,
    TOL,
    TOL_BWD,
    blend_case,
    column_errs,
    synthetic_pack,
)
from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
from splatfields_torch.ops.raster.blend_torch import (
    blend_bwd_plain,
    blend_sorted_plain,
)

TS = 16

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


CASES = {
    # rows per tile, opacity, tile_cap
    "early_termination": (600, 0.9, 1024),
    "tile_cap_overflow": (1500, 0.005, 1024),
    "mixed": (300, 0.3, 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    rows, opacity, tile_cap = CASES[case]
    (pack, tile_start, counts), tiles_x, tiles_y = synthetic_pack(
        cuda, rows, opacity, tiles_x=4, tiles_y=3)
    before = blend_fwd.launches
    got = blend_fwd(pack, tile_start, counts, tiles_x, tiles_y, TS, tile_cap,
                    128)
    torch.cuda.synchronize()
    assert blend_fwd.launches == before + 1
    want = blend_sorted_plain(pack, tile_start, counts, tiles_x, tiles_y, TS,
                              tile_cap, 128)
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 2e-4)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
    if case == "early_termination":
        assert float(got[2].max()) < 1e-2   # every pixel saturates
    if case == "tile_cap_overflow":
        # no pixel stops early, so the cap decides what is blended
        assert float(got[2].min()) > 1e-4


def _upstream(out, seed):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.rand(*o.shape).astype(np.float32),
                            device=o.device) for o in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(cuda, case):
    rows, opacity, tile_cap = CASES[case]
    (pack, tile_start, counts), tiles_x, tiles_y = synthetic_pack(
        cuda, rows, opacity, tiles_x=4, tiles_y=3)
    tile_ids = torch.arange(tiles_x * tiles_y, device=cuda,
                            dtype=torch.int32)
    out = blend_fwd(pack, tile_start, counts, tiles_x, tiles_y, TS, tile_cap,
                    128)
    args = (pack, tile_start, counts, tile_ids, *_upstream(out, rows), *out)
    before = blend_bwd.launches
    got = blend_bwd(*args, tiles_x, TS, tile_cap)
    torch.cuda.synchronize()
    assert blend_bwd.launches == before + 1
    want = blend_bwd_plain(*args, tiles_x, TS, tile_cap, 128)
    assert got.shape == want.shape == pack.shape
    errs, _ = column_errs(got, want)
    assert float(errs.max()) <= TOL_BWD, errs
    # rows past the cap are never reached, so they stay zero
    if case == "tile_cap_overflow":
        past = torch.cat([torch.arange(s + tile_cap, s + rows, device=cuda)
                          for s in tile_start[:-1].tolist()])
        assert not bool(got[past].any())


def test_autograd_launches_backward_once(cuda):
    """``blend_fwd``'s autograd function on CUDA tensors: one backward
    kernel launch per backward(), and its gradient is the plain VJP's."""
    (pack, tile_start, counts), tiles_x, tiles_y = synthetic_pack(
        cuda, 300, 0.3, tiles_x=4, tiles_y=3)
    pack = pack.requires_grad_(True)
    out = blend_fwd(pack, tile_start, counts, tiles_x, tiles_y, TS, 1024, 128)
    gs = _upstream(out, 7)
    # the image path hands in a strided colour gradient
    gs[0] = gs[0].transpose(1, 2).contiguous().transpose(1, 2)
    loss = sum((o * g).sum() for o, g in zip(out, gs))
    before = blend_bwd.launches
    (grad,) = torch.autograd.grad(loss, pack)
    torch.cuda.synchronize()
    assert blend_bwd.launches == before + 1
    tile_ids = torch.arange(tiles_x * tiles_y, device=cuda,
                            dtype=torch.int32)
    want = blend_bwd_plain(pack.detach(), tile_start, counts, tile_ids, *gs,
                           *[o.detach() for o in out], tiles_x, TS, 1024, 128)
    errs, _ = column_errs(grad, want)
    assert float(errs.max()) <= TOL_BWD, errs


@pytest.mark.parametrize("kind", BLEND_KINDS)
def test_skip_rule_edges(cuda, kind):
    """The pre-test and the tile cull against the exact rules: thin
    rotated ellipses, rows whose bin box covers a tile their ellipse
    misses, alpha at 1/255 across many pixels, ragged counts (0, 1, 31,
    33, 257, 1,025) in a permuted tile_ids. Forward within TOL, backward
    within TOL_BWD, two backward launches bitwise equal."""
    (pack, start, counts, ids), tx, ty = blend_case(kind, cuda)
    args = (pack, start, counts, tx, ty, TS, 1024, 128, ids)
    out = blend_fwd(*args)
    want = blend_sorted_plain(*args)
    for name, g, w in zip(TOL, out, want):
        torch.testing.assert_close(g, w, atol=TOL[name], rtol=0)
    bargs = (pack, start, counts, ids, *_upstream(out, 3), *out)
    got = blend_bwd(*bargs, tx, TS, 1024)
    errs, _ = column_errs(got, blend_bwd_plain(*bargs, tx, TS, 1024, 128))
    assert float(errs.max()) <= TOL_BWD, errs
    assert torch.equal(blend_bwd(*bargs, tx, TS, 1024), got)


@pytest.mark.parametrize("ts", [4, 8, 32])
def test_other_tile_sizes(cuda, ts):
    """Tile sizes whose pixel count is not a warp (4: 16 pixels, the
    forward rounds its threads up) or needs more than 48 KB of shared
    memory (32: 1,024 pixels); the backward takes multiples of 32."""
    (pack, start, counts), tx, ty = synthetic_pack(cuda, 300, 0.3,
                                                   tiles_x=4, tiles_y=3)
    args = (pack, start, counts, tx, ty, ts, 1024, 128)
    out = blend_fwd(*args)
    for name, g, w in zip(TOL, out, blend_sorted_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL[name], rtol=0)
    if ts * ts % 32:
        return
    ids = torch.arange(tx * ty, device=cuda, dtype=torch.int32)
    bargs = (pack, start, counts, ids, *_upstream(out, ts), *out)
    got = blend_bwd(*bargs, tx, ts, 1024)
    errs, _ = column_errs(got, blend_bwd_plain(*bargs, tx, ts, 1024, 128))
    assert float(errs.max()) <= TOL_BWD, errs
