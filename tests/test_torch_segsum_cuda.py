"""The CUDA segment-sum kernel against its plain PyTorch version, on the
GPU, and the hash grid's table gradient through it.

Needs a CUDA card (and nvcc to build the kernel); skips elsewhere. Imports
no JAX, so on the GPU machine it runs without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_segsum_cuda.py -q

Tolerance: per column, max abs error over the column's max abs, 1e-5
(chip_smoke.TOL_SEGSUM): the kernel sums each row in slot order, the plain
version's ``index_add_`` with atomics in another order. Two launches of
the kernel on the same inputs are bitwise equal.
"""
import numpy as np
import pytest
import torch

from chip_smoke import TOL_SEGSUM, segsum_case, segsum_err
from splatfields_torch.models.encoders import HashGridEncoder
from splatfields_torch.ops.segsum import (
    sorted_segment_sum,
    sorted_segment_sum_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [1, 2, 16])
@pytest.mark.parametrize("kind", ["random", "hot", "out_of_range", "empty"])
def test_kernel_matches_plain(cuda, kind, d):
    sidx, vals, n_rows = segsum_case(kind, cuda, d=d, seed=d)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(sidx, vals, n_rows)
    torch.cuda.synchronize()
    assert sorted_segment_sum.launches == before + 1
    want = sorted_segment_sum_plain(sidx, vals, n_rows)
    assert got.shape == want.shape == (n_rows, d)
    assert segsum_err(got, want) <= TOL_SEGSUM
    # rows no in-range id names are exactly zero
    hit = torch.zeros(n_rows, dtype=torch.bool, device=cuda)
    keep = (sidx >= 0) & (sidx < n_rows)
    hit[sidx[keep].long()] = True
    assert not bool(got[~hit].any())


def test_kernel_is_deterministic(cuda):
    sidx, vals, n_rows = segsum_case("hot", cuda, d=2)
    first = sorted_segment_sum(sidx, vals, n_rows)
    for _ in range(3):
        assert torch.equal(sorted_segment_sum(sidx, vals, n_rows), first)


def test_wrapper_refuses_bad_inputs(cuda):
    sidx, vals, n_rows = segsum_case("random", cuda, d=2)
    with pytest.raises(TypeError):
        sorted_segment_sum(sidx.long(), vals, n_rows)
    with pytest.raises(ValueError):
        sorted_segment_sum(sidx[:-1], vals, n_rows)
    with pytest.raises(ValueError):
        sorted_segment_sum(sidx.cpu(), vals, n_rows)


def test_table_grad_through_kernel(cuda):
    """The hash grid's table gradient on the card: one kernel launch per
    backward, and the CPU's plain gradient on the same weights."""
    pts = np.random.RandomState(3).rand(500, 3).astype(np.float32)
    w = np.random.RandomState(4).randn(500, 32).astype(np.float32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        enc = HashGridEncoder(log2_hashmap_size=12,
                              generator=torch.Generator().manual_seed(0))
        enc = enc.to(dev)
        out = (enc(torch.as_tensor(pts, device=dev))
               * torch.as_tensor(w, device=dev)).sum()
        before = sorted_segment_sum.launches
        (grads[dev.type],) = torch.autograd.grad(out, enc.table)
        torch.cuda.synchronize()
        assert sorted_segment_sum.launches == before + (dev.type == "cuda")
    got, want = grads["cuda"].cpu(), grads["cpu"]
    assert got.shape == want.shape == (16, 2 ** 12, 2)
    assert float(want.abs().max()) > 0
    assert segsum_err(got.reshape(-1, 2), want.reshape(-1, 2)) <= 1e-5
