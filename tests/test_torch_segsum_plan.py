"""The segment-sum kernel's partition and cases, on the CPU (no JAX).

``ops/segsum.block_ranges`` is the plain mirror of the search each block
of ``csrc/segsum.cu`` runs (merge path over the output rows and the
slots); it is held here to a plain walk of the merged order, and its
blocks to the contract the kernel's row image relies on: they split the
rows and the in-range slots, hold at most ``items`` rows, and summing
each block's slots alone gives the plain version bit for bit.
``chip_smoke.segsum_case`` kinds are checked for the properties they
claim, and ``segsum_reference`` for the rows it takes in float64.
"""
import numpy as np
import pytest
import torch

from chip_smoke import LONG_ROW, SEGSUM_KINDS, segsum_case, segsum_reference
from splatfields_torch.ops.segsum import (
    BUFFER_FLOATS,
    COLS_PER_PASS,
    block_ranges,
    items_per_block,
    sorted_segment_sum,
    sorted_segment_sum_plain,
)


def merge_walk(sidx, n_rows, items):
    """(rows, first slot of that row) at every multiple of ``items`` of the
    merged order, by walking it one item at a time."""
    m, total = len(sidx), n_rows + len(sidx)
    r = j = 0
    edges = []
    for pos in range(total + 1):
        if pos % items == 0 or pos == total:
            edges.append(r)
        if pos == total:
            break
        if j < m and (r == n_rows or sidx[j] <= r):
            j += 1      # the slot comes before the end of row r
        else:
            r += 1
    first = [next((j for j in range(m) if sidx[j] >= e), m) for e in edges]
    return edges, first


def _ids(rng, lo, hi, n):
    return np.sort(rng.randint(lo, hi, n)).astype(np.int32)


CASES = [
    (_ids(np.random.RandomState(0), 0, 300, 500), 300, 64),
    (_ids(np.random.RandomState(1), -40, 340, 500), 300, 50),
    (np.sort(np.concatenate([_ids(np.random.RandomState(2), 0, 60, 40),
                             np.full(300, 17, np.int32)])), 61, 32),
    (_ids(np.random.RandomState(3), 0, 5000, 7), 5000, 256),
    (np.zeros(0, np.int32), 90, 16),
    (np.full(25, -1, np.int32), 10, 8),
    (np.full(25, 10, np.int32), 10, 8),
]


@pytest.mark.parametrize("sidx,n_rows,items", CASES)
def test_block_ranges_match_merge_walk(sidx, n_rows, items):
    r0, r1, s0, s1 = block_ranges(torch.as_tensor(sidx), n_rows, items)
    edges, first = merge_walk(sidx, n_rows, items)
    assert r0.tolist() + r1[-1:].tolist() == edges
    assert s0.tolist() + s1[-1:].tolist() == first


@pytest.mark.parametrize("kind", SEGSUM_KINDS)
def test_blocks_split_rows_and_slots(kind):
    """On every chip_smoke case: the blocks' rows tile [0, n_rows), their
    slots tile the in-range slots, every slot's id lies in its block's
    rows, no block holds more than ``items`` rows, and per-block plain
    sums give the plain version bit for bit."""
    sidx, vals, n_rows = segsum_case(kind, "cpu")
    items = items_per_block(vals.shape[1])
    r0, r1, s0, s1 = block_ranges(sidx, n_rows, items)
    assert r0[0] == 0 and r1[-1] == n_rows and torch.equal(r1[:-1], r0[1:])
    assert torch.equal(s1[:-1], s0[1:])
    keep = (sidx >= 0) & (sidx < n_rows)
    assert int(s1[-1] - s0[0]) == int(keep.sum())
    assert int((r1 - r0).max()) <= items
    assert -(-(n_rows + sidx.shape[0]) // items) == r0.shape[0]
    want = sorted_segment_sum_plain(sidx, vals, n_rows)
    got = torch.empty_like(want)
    for a, b, s, t in zip(r0.tolist(), r1.tolist(), s0.tolist(),
                          s1.tolist()):
        ids = sidx[s:t]
        assert bool(((ids >= a) & (ids < b)).all())
        got[a:b] = sorted_segment_sum_plain(ids - a, vals[s:t], b - a)
    assert torch.equal(got, want)


def test_items_per_block_fits_the_row_image():
    for d in (1, 2, 3, 4, 5, 16, 64, 1000):
        items = items_per_block(d)
        assert 1 <= items <= 8192
        # the image (W floats a row) and 8 floats of padding in 64 KB
        assert (items * min(d, COLS_PER_PASS) + 8) * 4 <= 65536 + 32
        assert items * min(d, COLS_PER_PASS) <= BUFFER_FLOATS
    assert items_per_block(2) == 8192 and items_per_block(16) == 4096


def test_cases_are_what_they_claim():
    cases = {k: segsum_case(k, "cpu") for k in SEGSUM_KINDS}
    for kind, (sidx, vals, n_rows) in cases.items():
        assert sidx.dtype == torch.int32 and vals.dtype == torch.float32
        assert bool((sidx[1:] >= sidx[:-1]).all()), kind
        assert vals.shape == (sidx.shape[0], 2) and vals.is_contiguous()
    runs = {k: torch.unique_consecutive(s, return_counts=True)[1].max()
            for k, (s, _, _) in cases.items()}
    assert runs["long_row_20k"] >= 20_000 and runs["long_row_200k"] >= 200_000
    sidx, _, n_rows = cases["edge_hot"]
    counts = torch.bincount(sidx.long(), minlength=n_rows)
    assert bool((counts[2047:2050] > items_per_block(2)).all())
    sidx, _, _ = cases["ngp"]
    counts = torch.bincount(sidx.long())
    assert 150 < float(counts[:1000].float().mean()) < 170
    hashed = counts[1 << 16:]
    assert 1.3 < float(hashed[hashed > 0].float().mean()) < 1.5
    assert cases["ragged"][0].shape[0] == 100_003
    sidx, vals, _ = cases["unaligned"]
    assert sidx.data_ptr() % 16 and vals.data_ptr() % 16
    sidx, _, n_rows = cases["all_out"]
    assert not bool(((sidx >= 0) & (sidx < n_rows)).any())
    assert cases["ragged_rows"][2] % items_per_block(2)


def test_reference_takes_long_rows_in_float64():
    sidx, vals, n_rows = segsum_case("long_row_20k", "cpu")
    want, longest = segsum_reference(sidx, vals, n_rows)
    assert longest > LONG_ROW and want.dtype == torch.float32
    exact = torch.zeros(n_rows, 2, dtype=torch.float64).index_add_(
        0, sidx.long(), vals.double())
    assert torch.equal(want, exact.float())
    # "hot": 2,048 slots on row 1,234 plus the random ids that land there
    assert segsum_reference(*segsum_case("hot", "cpu"))[1] == 2053
    sidx, vals, n_rows = segsum_case("ngp", "cpu")
    want, longest = segsum_reference(sidx, vals, n_rows)
    assert 160 < longest <= LONG_ROW
    assert torch.equal(want, sorted_segment_sum_plain(sidx, vals, n_rows))
    before = sorted_segment_sum.launches
    assert torch.equal(sorted_segment_sum(sidx, vals, n_rows), want)
    assert sorted_segment_sum.launches == before
