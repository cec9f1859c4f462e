"""The blend backward's plain version (``blend_torch.blend_bwd_plain``, the
CUDA kernel's reference) against the Pallas backward and against autograd,
on the CPU.

Blend inputs come from test_torch_raster's scenes through the JAX
preprocess and binning, as in tests/test_blend_pallas.py; upstream
gradients from a numpy seed. Cases: a random scene, heavy overlap (most
pixels stop early), counts > tile_cap, and depth ties.

Tolerances, per column of the [D, 10] gradient over the column's max abs
(as tests/test_blend_pallas.py normalises):
- vs ``_blend_bwd_pallas(interpret=True)``, the same closed form in other
  sum orders: 1e-5 (observed ~3e-7) on all rows but at most 1% of them,
  and 1e-3 on every row. The two replay the transmittance with different
  product associations (``torch.cumprod`` vs the kernel's log-step scan),
  so a pixel whose T lands within rounding of the 1e-4 stop may stop one
  row apart in the two; that moves only the rows at its stop, by that
  pixel's share, T ~ 1e-4 of a row's weight;
- vs autograd through ``blend_sorted_plain``, on scenes whose opacity stays
  below the 0.99 alpha clamp (asserted), where the closed form's
  ``d alpha / d(op G) = 1`` is exact: 1e-4; the closed form takes suffix
  sums as total minus prefix, which cancels where T is small.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu.ops.raster import blend_jax
from splatfields_tpu.ops.raster.binning import bin_gaussians as jax_bin
from splatfields_tpu.ops.raster.blend_pallas import (
    _blend_bwd_pallas,
    blend_sorted_pallas,
)
from splatfields_torch.ops.raster.blend_cuda import blend_bwd, blend_fwd
from splatfields_torch.ops.raster.blend_torch import (
    blend_bwd_plain,
    blend_sorted_plain,
)
from tests.test_torch_raster import BLEND_CASES, SCENES, _jax_pre, _t, _tiles


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(case):
    scene, tile_cap, k_chunk = BLEND_CASES[case]
    s = SCENES[scene]()
    assert s["opacities"].max() < 0.99   # below the alpha clamp
    tx, ty = _tiles(s)
    pre = _jax_pre(s)
    b = jax_bin(pre.means2d, pre.depths, pre.radii, tx, ty, 16,
                tile_cap=tile_cap, dup_cap=4096)
    pack = blend_jax.pack_attributes(pre.means2d, pre.conics, pre.rgb,
                                     pre.opacity, pre.depths)
    sorted_pack = pack[jnp.maximum(b.sorted_id, 0)]
    rng = np.random.RandomState(1)
    t = b.counts.shape[0]
    g = (rng.rand(t, 3, 256).astype(np.float32),
         rng.rand(t, 256).astype(np.float32) * 0.1,
         rng.rand(t, 256).astype(np.float32) * 0.1)
    return sorted_pack, b, tx, ty, tile_cap, k_chunk, g


def _row_err(got, want):
    """Per row: the max over columns of |got - want| / the column's max."""
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    return (np.abs(got - want) / scale).max(axis=1)


def _col_err(got, want):
    return _row_err(got, want).max()


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_bwd_plain_matches_pallas(case):
    sorted_pack, b, tx, ty, tile_cap, k, g = _case(case)
    tile_ids = jnp.arange(b.counts.shape[0], dtype=jnp.int32)
    color, depth, final_t = blend_sorted_pallas(
        sorted_pack, b.tile_start, b.counts, tx, ty, 16, tile_cap, k, True)
    want = np.asarray(_blend_bwd_pallas(
        sorted_pack, b.tile_start, b.counts, tile_ids, *map(jnp.asarray, g),
        final_t, color, depth, tx, ty, 16, tile_cap, k, True))
    got = blend_bwd_plain(
        _t(sorted_pack), _t(b.tile_start), _t(b.counts), _t(tile_ids),
        *map(torch.as_tensor, g), _t(color), _t(depth), _t(final_t), tx, 16,
        tile_cap, k).numpy()
    assert got.shape == want.shape == sorted_pack.shape
    err = _row_err(got, want)
    loose = err > 1e-5
    assert err.max() <= 1e-3, err.max()
    assert loose.sum() <= 0.01 * len(err), (loose.sum(), len(err))
    # rows no pixel reaches are zero in both
    np.testing.assert_array_equal(got[~loose] == 0, want[~loose] == 0)
    if case == "tile_cap_overflow":
        starts = np.asarray(b.tile_start)[:-1]
        counts = np.asarray(b.counts)
        over = [s + np.arange(tile_cap, c)
                for s, c in zip(starts, counts) if c > tile_cap]
        assert over and not got[np.concatenate(over)].any()


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_bwd_plain_matches_autograd(case):
    sorted_pack, b, tx, ty, tile_cap, k, g = _case(case)
    g = [torch.as_tensor(x) for x in g]
    sp = _t(sorted_pack).requires_grad_(True)
    args = (_t(b.tile_start), _t(b.counts), tx, ty, 16, tile_cap, k)
    out = blend_sorted_plain(sp, *args)
    (want,) = torch.autograd.grad(sum((o * x).sum() for o, x in zip(out, g)),
                                  sp)
    tile_ids = torch.arange(b.counts.shape[0], dtype=torch.int32)
    got = blend_bwd_plain(sp.detach(), _t(b.tile_start), _t(b.counts),
                          tile_ids, *g, *[o.detach() for o in out], tx, 16,
                          tile_cap, k)
    err = _col_err(got.numpy(), want.numpy())
    assert err <= 1e-4, err
    if case == "early_termination":
        assert float(out[2].detach().min()) < 1e-3   # pixels did stop early


def test_blend_autograd_on_cpu_is_the_plain_vjp():
    """``blend_fwd`` on CPU tensors: one autograd function with the plain
    forward and ``blend_bwd_plain``, no kernel launch; a strided colour
    gradient (as ``tiles_to_image``'s transpose hands it in) is taken
    as is."""
    sorted_pack, b, tx, ty, tile_cap, k, g = _case("plain")
    g = [torch.as_tensor(x) for x in g]
    g[0] = g[0].transpose(1, 2).contiguous().transpose(1, 2)
    sp = _t(sorted_pack).requires_grad_(True)
    launches = (blend_fwd.launches, blend_bwd.launches)
    out = blend_fwd(sp, _t(b.tile_start), _t(b.counts), tx, ty, 16, tile_cap,
                    k)
    (got,) = torch.autograd.grad(sum((o * x).sum() for o, x in zip(out, g)),
                                 sp)
    assert (blend_fwd.launches, blend_bwd.launches) == launches
    tile_ids = torch.arange(b.counts.shape[0], dtype=torch.int32)
    want = blend_bwd_plain(sp.detach(), _t(b.tile_start), _t(b.counts),
                           tile_ids, *g, *[o.detach() for o in out], tx, 16,
                           tile_cap, k)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
