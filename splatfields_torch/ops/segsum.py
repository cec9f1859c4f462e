"""Segment sum of sorted rows (counterpart of
``splatfields_tpu/ops/segsum_pallas.py``).

``sorted_segment_sum(sidx, vals, n_rows)``: ``sidx`` [M] int32 ascending,
``vals`` [M, D] f32 -> ``out`` [n_rows, D] f32 with ``out[r]`` the sum of
``vals[j]`` over ``sidx[j] == r``. Ids below 0 or at or above ``n_rows``
are dropped; rows that receive nothing are 0.

On CUDA tensors it launches ``csrc/segsum.cu`` (built with the port's other
kernels by ``ops/cuda_build.py``) on PyTorch's current stream, or raises.
On CPU tensors it runs ``sorted_segment_sum_plain``. The Pallas kernel's
float-coded row ids, its HIGHEST-precision mask matmul, its ``n_rows <=
2^24`` guard and its tiling knobs ``k`` and ``r_block`` work around the
TPU and have no counterpart: the ids stay int32.
``sorted_segment_sum.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from splatfields_torch.ops.cuda_build import check, run

ROWS_PER_BLOCK = 256   # kRows in csrc/segsum.cu


def sorted_segment_sum_plain(sidx: torch.Tensor, vals: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """The plain version: ``index_add_`` of the in-range rows."""
    keep = (sidx >= 0) & (sidx < n_rows)
    out = torch.zeros(n_rows, vals.shape[1], dtype=torch.float32,
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
    # the first slot of each block of ROWS_PER_BLOCK rows; the last edge is
    # n_rows, so ids at or above it fall past every block
    n_blocks = -(-n_rows // ROWS_PER_BLOCK)
    edges = torch.clamp_max(torch.arange(n_blocks + 1, dtype=torch.int32,
                                         device=dev) * ROWS_PER_BLOCK, n_rows)
    bounds = torch.searchsorted(sidx, edges, out_int32=True)
    run("segsum", sidx, vals, bounds, out, n_rows, d)
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
