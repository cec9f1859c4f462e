"""The CUDA segment-sum kernel against its plain PyTorch version, on the
GPU, and the hash grid's table gradient through it.

Needs a CUDA card (and nvcc to build the kernel); skips elsewhere. Imports
no JAX, so on the GPU machine it runs without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_segsum_cuda.py -q

Tolerance: per column, max abs error over the column's max abs, 1e-5
(chip_smoke.TOL_SEGSUM): the kernel sums each row in an order fixed by the
slots' positions, the plain version's ``index_add_`` with atomics in
another order; rows over 2,048 slots (chip_smoke.LONG_ROW) are held
against the plain version run in float64. Two launches of the kernel on
the same inputs are bitwise equal.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    SEGSUM_KINDS,
    TOL_SEGSUM,
    check_segsum,
    segsum_case,
    segsum_err,
)
from splatfields_torch.models.encoders import HashGridEncoder
from splatfields_torch.ops.cuda_build import run
from splatfields_torch.ops.segsum import (
    block_ranges,
    items_per_block,
    sorted_segment_sum,
    sorted_segment_sum_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    # the checks here are f32: the JAX package's bf16 defaults, on for
    # CUDA tensors under "auto", stay off
    monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "off")
    monkeypatch.setenv("SPLATFIELDS_NGP_BF16_TABLE", "off")
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


@pytest.mark.parametrize("kind", SEGSUM_KINDS)
def test_kernel_edges(cuda, kind):
    """Every segsum_case kind at D = 2: within TOL_SEGSUM of the plain
    version (float64 for long rows), finite, twice bitwise equal, rows no
    id names exactly 0; one launch a call."""
    sidx, vals, n_rows = segsum_case(kind, cuda, seed=5)
    before = sorted_segment_sum.launches
    check_segsum(kind, sidx, vals, n_rows)
    assert sorted_segment_sum.launches == before + 2


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 16])
@pytest.mark.parametrize("kind", ["ngp", "ragged", "unaligned", "long_row_20k",
                                  "edge_hot"])
def test_kernel_widths(cuda, kind, d):
    """Row widths through each load path: D float4 a thread (D <= 4), one
    float4 a slot (D = 16), scalars (D = 5 and the unaligned views), and
    the passes of four columns for D > 4."""
    check_segsum(f"{kind}, D {d}", *segsum_case(kind, cuda, d=d, seed=d))


@pytest.mark.parametrize("items", [64, 4096, items_per_block(2)])
@pytest.mark.parametrize("kind", ["ngp", "edge_hot", "out_of_range",
                                  "ragged_rows"])
def test_kernel_edges_match_block_ranges(cuda, kind, items):
    """The block edges the kernel's first phase finds on the card (left
    in its scratch) are ``block_ranges``'s, and its sums at other items a
    block are the wrapper's within TOL_SEGSUM."""
    sidx, vals, n_rows = segsum_case(kind, cuda)
    m, d = vals.shape
    n_blocks = -(-(n_rows + m) // items)
    edges = torch.full((2 * (n_blocks + 1),), -7, dtype=torch.int32,
                       device=cuda)
    out = torch.empty(n_rows, d, device=cuda)
    run("segsum", sidx, vals, out, edges, m, n_rows, d, items)
    r0, r1, s0, s1 = block_ranges(sidx, n_rows, items)
    assert torch.equal(edges[0::2].long(), torch.cat([r0, r1[-1:]]))
    assert torch.equal(edges[1::2].long(), torch.cat([s0, s1[-1:]]))
    want = sorted_segment_sum(sidx, vals, n_rows)
    assert segsum_err(out, want) <= TOL_SEGSUM
    if items == items_per_block(d):
        assert torch.equal(out, want)


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
