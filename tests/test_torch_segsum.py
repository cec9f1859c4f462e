"""The port's ``sorted_segment_sum`` (its plain version, which CPU tensors
take) against the JAX package's Pallas kernel in interpret mode, on the
cases of tests/test_segsum_pallas.py: several blocks and chunks, a
non-128 feature width with ragged N, mostly-empty rows, the NGP shape
(D = 2), a hot segment spanning many chunks, and out-of-range ids.
Tolerances are that file's own: the two sum each row in another order
(MXU chunk sums against one sequential ``index_add_``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch.ops.segsum import (
    sorted_segment_sum,
    sorted_segment_sum_plain,
)
from splatfields_tpu.ops.segsum_pallas import sorted_segment_sum as jax_segsum


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(sidx, vals, n_rows, **kernel_args):
    want = jax_segsum(jnp.asarray(sidx), jnp.asarray(vals), n_rows,
                      interpret=True, **kernel_args)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(torch.as_tensor(sidx), torch.as_tensor(vals),
                             n_rows)
    assert sorted_segment_sum.launches == before   # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == (n_rows, vals.shape[1])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,n_rows,d,k,r_block", [
    (1000, 256, 64, 128, 128),   # several blocks, several chunks
    (700, 384, 20, 256, 128),    # non-128 feature width, ragged N
    (50, 1024, 64, 128, 128),    # mostly-empty rows
    (900, 700, 2, 512, 256),     # wide output block (NGP shape), d=2
])
def test_matches_pallas(n, n_rows, d, k, r_block):
    rng = np.random.RandomState(3 + n)
    sidx = np.sort(rng.randint(0, n_rows, n)).astype(np.int32)
    vals = rng.randn(n, d).astype(np.float32)
    got, want = _both(sidx, vals, n_rows, k=k, r_block=r_block)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    empty = np.setdiff1d(np.arange(n_rows), sidx)
    assert not got[empty].any()


def test_hot_segment_many_chunks():
    """All updates in one row, which the Pallas kernel reaches over every
    chunk of its block."""
    rng = np.random.RandomState(7)
    n, n_rows, d = 2000, 256, 64
    sidx = np.full(n, 129, np.int32)
    vals = rng.randn(n, d).astype(np.float32)
    got, want = _both(sidx, vals, n_rows, k=128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert not got[:129].any() and not got[130:].any()


def test_out_of_range_ids_dropped():
    rng = np.random.RandomState(11)
    n_rows, d = 128, 8
    sidx = np.array([-3, -1, 0, 5, 5, 127, 128, 400], np.int32)
    vals = rng.randn(len(sidx), d).astype(np.float32)
    got, want = _both(sidx, vals, n_rows)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[5], vals[3] + vals[4])


def test_plain_is_exact_per_row_sum():
    """The plain version against a float64 sum, with no slots at all and
    with every id out of range."""
    rng = np.random.RandomState(5)
    sidx = np.sort(rng.randint(-20, 60, 500)).astype(np.int32)
    vals = rng.randn(500, 3).astype(np.float32)
    want = np.zeros((40, 3))
    for i, v in zip(sidx, vals.astype(np.float64)):
        if 0 <= i < 40:
            want[i] += v
    got = sorted_segment_sum_plain(torch.as_tensor(sidx),
                                   torch.as_tensor(vals), 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for ids in (np.zeros(0, np.int32), np.array([-1, 40, 41], np.int32)):
        out = sorted_segment_sum_plain(
            torch.as_tensor(ids), torch.ones(len(ids), 3), 40)
        assert out.shape == (40, 3) and not out.any()
