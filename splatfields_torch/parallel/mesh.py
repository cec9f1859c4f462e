"""The device mesh on ``torch.distributed`` (counterpart of
``splatfields_tpu/parallel/mesh.py``).

A 2-D grid of ranks, one rank a device, with axes

- ``data``: view parallelism; each data row trains on its share of the
  same-fid view batch, gradients averaged over the column;
- ``model``: splat and tile parallelism; each rank runs the field on its
  chunk of the splats, the attributes are gathered, and each rank blends
  its slice of the tile grid.

Rank ``r`` sits at ``(r // n_model, r % n_model)``: a row holds the ranks
of one data index (the ``model`` group), a column those of one model index
(the ``data`` group).

Collectives: ``all_gather`` (concatenated along dim 0) and ``sum_scatter``
(the sum over the group, this rank's equal slice of dim 0) are each
other's transposes, and ``gather`` is the autograd-aware all-gather whose
backward is the sum-scatter. NCCL runs them as ``all_gather_into_tensor``
and ``reduce_scatter_tensor``. Gloo runs both through ``all_reduce``, the
one of these collectives it implements for CUDA tensors as well as CPU
ones: the gather sums a zero buffer that holds each rank's rows in its
slot (adding zeros is exact), the scatter sums the whole tensor and keeps
this rank's slice.
"""
from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0   # every rendezvous and collective fails after this


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int = 0, backend: str = "gloo",
                           init_method: str | None = None,
                           timeout_s: float = TIMEOUT_S):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, by ``init_method`` or else TCP at
    ``coordinator_address`` (``host:port`` of rank 0). One process drives
    one device: the caller chooses ``backend``, ``"nccl"`` when each rank
    has a card of its own, ``"gloo"`` otherwise; nothing falls back from
    one to the other."""
    if init_method is None:
        if not coordinator_address:
            raise ValueError("a process group needs --coordinator_address "
                             "(host:port of rank 0) or an init_method")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes or 1,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass
class Mesh:
    """The [data, model] grid of the ranks of the default process group,
    this rank's coordinates and one process group per row and column."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    model_group: object     # this rank's row: its data index, every model
    data_group: object      # this rank's column: its model index

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    def model_rank(self, model_index: int) -> int:
        """The global rank of ``model_index`` in this rank's row."""
        return self.data_index * self.n_model + model_index


def make_mesh(n_devices: int | None = None, data: int | None = None) -> Mesh:
    """The ('data', 'model') grid over the ``n_devices`` ranks of the
    process group (default all of them; ``data`` default 1, pure model
    parallelism). Every rank must call it: the groups are made in one
    order everywhere."""
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    data = 1 if data is None else data
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"ranks, one a device; the process group has "
                         f"{world}")
    if n_devices % data:
        raise ValueError(f"{n_devices} devices do not divide into {data} "
                         "data rows")
    n_model = n_devices // data
    rank = dist.get_rank()
    groups = {}
    for d in range(data):
        groups["model", d] = dist.new_group(
            [d * n_model + m for m in range(n_model)])
    for m in range(n_model):
        groups["data", m] = dist.new_group(
            [d * n_model + m for d in range(data)])
    d, m = divmod(rank, n_model)
    return Mesh(data, n_model, d, m, groups["model", d], groups["data", m])


def _size(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] from every rank of ``group`` -> [size * n, ...], in rank
    order."""
    size = _size(group)
    if size == 1:
        return x
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    me = dist.get_group_rank(group, dist.get_rank())
    wide = x.dtype == torch.bool
    src = x.to(torch.uint8) if wide else x
    out = src.new_zeros((size * x.shape[0],) + tuple(x.shape[1:]))
    out[me * x.shape[0]:(me + 1) * x.shape[0]] = src
    dist.all_reduce(out, group=group)
    return out.bool() if wide else out


def sum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of [size * n, ...] over ``group``, this rank's rows
    [rank * n, (rank + 1) * n)."""
    size = _size(group)
    if size == 1:
        return x
    n = x.shape[0] // size
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    me = dist.get_group_rank(group, dist.get_rank())
    total = x.clone()
    dist.all_reduce(total, group=group)
    return total[me * n:(me + 1) * n]


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of ``x`` over ``group``."""
    out = x.detach().clone()
    if _size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def mean(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce(x, group) / _size(group)


class _Gather(torch.autograd.Function):
    """``all_gather`` whose backward is ``sum_scatter``: every rank's
    cotangent of the gathered tensor, summed, this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_scatter(g, ctx.group), None


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """The autograd-aware all-gather along dim 0 (JAX's ``all_gather(...,
    tiled=True)``); tensors without gradient go straight to
    ``all_gather``."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather(x, group)
    return _Gather.apply(x, group)
