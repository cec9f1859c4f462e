"""Nearest-neighbour distances for splat scale init (counterpart of
``splatfields_tpu/ops/knn.py::mean_sq_dist_knn3``; the Moran's-I KNN comes
with the analysis slice)."""
from __future__ import annotations

import torch


def mean_sq_dist_knn3(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest other points,
    clamped at 1e-7 (``distCUDA2`` of simple-knn). Exact: row chunks of the
    pairwise squared distances |a|^2 + |b|^2 - 2 a.b (the JAX formula),
    each reduced with ``topk``."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = (pts * pts).sum(dim=-1)
    out = torch.empty(n, device=pts.device)
    for r0 in range(0, n, chunk):
        rows = pts[r0:r0 + chunk]
        m = rows.shape[0]
        d = sq[r0:r0 + m, None] + sq[None, :] - 2.0 * (rows @ pts.T)
        d[torch.arange(m, device=pts.device),
          torch.arange(r0, r0 + m, device=pts.device)] = float("inf")
        out[r0:r0 + m] = d.topk(3, dim=1, largest=False).values.mean(dim=1)
    return torch.clamp_min(out, 1e-7)
