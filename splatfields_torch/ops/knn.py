"""K-nearest-neighbour queries and Moran's I (counterpart of
``splatfields_tpu/ops/knn.py``).

Exact KNN as the JAX package computes it: row chunks of the pairwise
squared distances |a|^2 + |b|^2 - 2 a.b in f32, self pairs set to
``inf``, then ``topk(largest=False, sorted=True)``. The formula is kept
on purpose, not ``torch.cdist``: the Moran term parks invalid splats far
away (``train_lib.corr_term``) and relies on the same arithmetic as the
reference. a.b (one matmul a chunk) and |a|^2 are formed in float64 from
the f32 coordinates, where the products are exact, and rounded once to
f32: so the card and the CPU get the same bits whatever order their
matmuls sum in. The formula's cancellation rounds distances to steps of
an ulp of |a|^2, so equal distances are common in a dense cloud; they
are broken by index, as ``lax.top_k`` breaks them (the lower index
first), not by ``topk``'s device-dependent order, so both devices pick
the same neighbours.

- ``mean_sq_dist_knn3``: ``distCUDA2`` of simple-knn, the splat scale
  init (f32 throughout, as before the Moran slice);
- ``knn_self`` / ``knn_points``: the ``pytorch3d.ops.knn_points`` shapes
  of the problem (self excluded / cross-set);
- ``query_nn``, ``morans_measure``, ``morans_loss``: the reference's
  Moran's-I analysis (``extract_geo.py:100-143``).
"""
from __future__ import annotations

import torch


def _sq_norms(x64: torch.Tensor) -> torch.Tensor:
    """|x|^2 of float64 rows, summed in a fixed order, rounded to f32."""
    return ((x64[:, 0] * x64[:, 0] + x64[:, 1] * x64[:, 1])
            + x64[:, 2] * x64[:, 2]).to(torch.float32)


def _lex_sort(vals: torch.Tensor, idx: torch.Tensor):
    """Each row's (value, index) pairs ordered by value, then index."""
    o = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, o), idx.gather(1, o)
    o = torch.argsort(vals, dim=1, stable=True)
    return vals.gather(1, o), idx.gather(1, o)


def _topk_rows(queries: torch.Tensor, points: torch.Tensor, k: int,
               chunk: int, exclude_self: bool):
    """(dists [M, k], idx [M, k] int64) of the ``k`` smallest squared
    distances from each query row to ``points``, ascending, equal
    distances in index order; where equal distances straddle the k-th
    place, the lowest indices win, as in ``lax.top_k``."""
    pts = points.to(torch.float32).to(torch.float64)
    qs = queries.to(torch.float32).to(torch.float64)
    m, n, dev = qs.shape[0], pts.shape[0], qs.device
    sq = _sq_norms(pts)
    q_sq = sq if exclude_self else _sq_norms(qs)

    def dist(rows: torch.Tensor) -> torch.Tensor:
        """[len(rows), n] f32 squared distances of the query rows."""
        dot = (qs[rows] @ pts.T).to(torch.float32)
        d = q_sq[rows, None] + sq[None, :] - 2.0 * dot
        if exclude_self:
            d[torch.arange(len(rows), device=dev), rows] = float("inf")
        return d

    kk = min(k + 1, n)   # one more, to see a tie across the k-th place
    dists = torch.empty(m, kk, device=dev)
    idx = torch.empty(m, kk, dtype=torch.int64, device=dev)
    for r0 in range(0, m, chunk):
        rows = torch.arange(r0, min(r0 + chunk, m), device=dev)
        top = dist(rows).topk(kk, dim=1, largest=False, sorted=True)
        dists[rows], idx[rows] = top.values, top.indices
    if kk > k:
        ties = torch.nonzero(dists[:, k - 1] == dists[:, k]).flatten()
        cols = torch.arange(n, device=dev)
        for r0 in range(0, len(ties), chunk):
            rows = ties[r0:r0 + chunk]
            d, v = dist(rows), dists[rows, k - 1:k]
            key = torch.where(d < v, -1, torch.where(d == v, cols, n))
            sel = key.topk(k, dim=1, largest=False).indices
            idx[rows, :k], dists[rows, :k] = sel, d.gather(1, sel)
    return _lex_sort(dists[:, :k], idx[:, :k])


def knn_self(points: torch.Tensor, k: int = 5, chunk: int = 1024):
    """Exact ``k`` nearest neighbours of each point among the same set,
    self excluded -> (squared dists [N, k] ascending, idx [N, k])."""
    return _topk_rows(points, points, k, chunk, exclude_self=True)


def knn_points(queries: torch.Tensor, points: torch.Tensor, k: int = 8,
               chunk: int = 1024):
    """Exact ``k`` nearest ``points`` of each query -> (squared dists
    [M, k] ascending, clamped at 0; idx [M, k] into ``points``)."""
    d, idx = _topk_rows(queries, points, k, chunk, exclude_self=False)
    return torch.clamp_min(d, 0.0), idx


def mean_sq_dist_knn3(points: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest other points,
    clamped at 1e-7 (``distCUDA2`` of simple-knn). The same formula in f32
    throughout, a.b from an f32 matmul: the splat scale init, held to the
    JAX package's through the training loop (tests/test_torch_train_loop
    .py), needs no neighbours, only their distances, and stays as it was
    before ``knn_self``'s float64 a.b."""
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


def query_nn(points: torch.Tensor, n_neighbors: int = 5, eps: float = 1e-5):
    """Neighbourhood weights for Moran's I (reference ``extract_geo.py:
    100-109``): self first, then its ``n_neighbors - 1`` nearest; inverse
    pairwise distances within each neighbourhood, ``eps`` (not 1/eps) for
    the diagonal and coincident pairs, normalised by the neighbourhood's
    total -> (weights [N, K, K], idx [N, K])."""
    _, idx = knn_self(points, k=n_neighbors - 1)
    self_idx = torch.arange(points.shape[0], device=idx.device)[:, None]
    idx = torch.cat([self_idx, idx], dim=-1)
    return neighbourhood_weights(points, idx, eps), idx


def neighbourhood_weights(points: torch.Tensor, idx: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """``query_nn``'s weights of the neighbourhoods ``idx`` [N, K] of
    ``points`` [N, 3] -> [N, K, K]."""
    nbr = points[idx]                                        # [N, K, 3]
    diff = nbr[:, :, None, :] - nbr[:, None, :, :]
    cross = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=-1), 0.0))
    weights = torch.where(cross > eps, 1.0 / torch.clamp_min(cross, eps),
                          torch.full_like(cross, eps))
    norm = torch.clamp_min(weights.sum(dim=(1, 2), keepdim=True), 1e-5)
    return weights / norm


def neighborhood_morans(weights: torch.Tensor, feats_nn: torch.Tensor,
                        w_floor: float | None = None) -> torch.Tensor:
    """Moran's I of each neighbourhood, averaged over the channels:
    (K / W_b) sum_ij w_ij x_i x_j / (sum_i x_i^2 + 1e-4) for weights
    [N, K, K] and un-centred features [N, K, F] -> [N]. ``w_floor`` clamps
    W_b from below (the training loss's guard)."""
    k = feats_nn.shape[1]
    w_total = weights.sum(dim=(1, 2))[:, None, None]
    if w_floor is not None:
        w_total = torch.clamp_min(w_total, w_floor)
    w_ij = (k / w_total) * weights
    denom = (feats_nn ** 2).sum(dim=1)                        # [N, F]
    nom = (feats_nn * torch.einsum("bij,bjf->bif", w_ij, feats_nn)).sum(1)
    return (nom / (denom + 1e-4)).mean(dim=-1)


def morans_measure(weights: torch.Tensor, feats_nn: torch.Tensor):
    """Moran's I over all neighbourhoods and channels (reference
    ``extract_geo.py:111-137``): the unmasked global mean."""
    return neighborhood_morans(weights, feats_nn).mean()


def morans_loss(weights: torch.Tensor, feats_nn: torch.Tensor):
    """1 - clamp(Moran's I, 0, 1) (reference ``extract_geo.py:140-143``)."""
    return 1.0 - torch.clamp(morans_measure(weights, feats_nn), 0.0, 1.0)
