"""Segment sum of sorted rows (counterpart of
``splatfields_tpu/ops/segsum_pallas.py``).

``sorted_segment_sum(sidx, vals, n_rows)``: ``sidx`` [M] int32 ascending,
``vals`` [M, D] f32 -> ``out`` [n_rows, D] f32 with ``out[r]`` the sum of
``vals[j]`` over ``sidx[j] == r``. Ids below 0 or at or above ``n_rows``
are dropped; rows that receive nothing are 0. The kernel's result is
deterministic, bit for bit, and adds nothing atomically.

On CUDA tensors it launches ``csrc/segsum.cu`` (built with the port's other
kernels by ``ops/cuda_build.py``) on PyTorch's current stream, or raises:
one launch a call, which finds its own blocks' edges (merge path; its
plain mirror is ``block_ranges``) into a scratch of ints. On CPU tensors it runs
``sorted_segment_sum_plain``. The Pallas kernel's float-coded row ids, its
HIGHEST-precision mask matmul, its ``n_rows <= 2^24`` guard and its tiling
knobs ``k`` and ``r_block`` work around the TPU and have no counterpart:
the ids stay int32. ``sorted_segment_sum.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import torch

from splatfields_torch.ops.cuda_build import check, run

# csrc/segsum.cu: a block holds `items` merge-path items (output rows plus
# slots) and an image of its rows in shared memory, COLS_PER_PASS columns
# a pass; BUFFER_FLOATS keeps that image at 64 KB (three blocks an SM).
# On the NGP step 8,192 items a block beat 4,096 and 6,144 (PERF.md)
COLS_PER_PASS = 4
BUFFER_FLOATS = 16384
MAX_ITEMS = 8192


def items_per_block(d: int) -> int:
    """Merge-path items (output rows + slots) a block of the kernel takes
    for rows of ``d`` columns."""
    return min(MAX_ITEMS, BUFFER_FLOATS // min(d, COLS_PER_PASS))


def block_ranges(sidx: torch.Tensor, n_rows: int, items: int):
    """The kernel's partition, computed as plain tensor code: block b takes
    the items [b items, (b + 1) items) of the merge of the row ends and the
    slots (slot j before the end of row r iff ``sidx[j] <= r``), owns the
    rows ``[r0[b], r1[b])`` whose ends lie there and the slots
    ``[s0[b], s1[b])`` whose ids lie in those rows. Returns the four int64
    tensors (one entry a block)."""
    m = sidx.shape[0]
    total = n_rows + m
    n_blocks = -(-total // items)
    k = torch.clamp_max(torch.arange(n_blocks + 1, dtype=torch.int64,
                                     device=sidx.device) * items, total)
    # a slot's place in the merge: strictly increasing in j
    place = (torch.arange(m, dtype=torch.int64, device=sidx.device)
             + sidx.to(torch.int64).clamp(0, n_rows))
    j = torch.searchsorted(place, k)          # slots among the first k items
    rows = k - j
    slots = torch.searchsorted(sidx.to(torch.int64), rows)
    return rows[:-1], rows[1:], slots[:-1], slots[1:]


def sorted_segment_sum_plain(sidx: torch.Tensor, vals: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """The plain version: ``index_add_`` of the in-range rows (in the
    values' dtype)."""
    keep = (sidx >= 0) & (sidx < n_rows)
    out = torch.zeros(n_rows, vals.shape[1], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, sidx[keep].to(torch.int64), vals[keep])


def _launch(sidx, vals, n_rows):
    dev = vals.device
    m, d = vals.shape
    check("sidx", sidx, torch.int32, (m,), dev)
    check("vals", vals, torch.float32, (m, d), dev)
    if not 0 <= n_rows < 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"n_rows {n_rows} and {m} slots must fit in int32")
    out = torch.empty(n_rows, d, dtype=torch.float32, device=dev)
    if n_rows == 0 or d == 0:
        return out
    items = items_per_block(d)
    edges = torch.empty(2 * (-(-(n_rows + m) // items) + 1),
                        dtype=torch.int32, device=dev)
    run("segsum", sidx, vals, out, edges, m, n_rows, d, items)
    sorted_segment_sum.launches += 1
    return out


def sorted_segment_sum(sidx: torch.Tensor, vals: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Sum the rows ``vals`` [M, D] into ``n_rows`` segments given the
    ascending int32 ids ``sidx`` [M]: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if vals.is_cuda:
        return _launch(sidx, vals, n_rows)
    return sorted_segment_sum_plain(sidx, vals, n_rows)


sorted_segment_sum.launches = 0
