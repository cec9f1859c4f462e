"""The port's KNN and Moran's I (``splatfields_torch/ops/knn.py``) against
``splatfields_tpu/ops/knn.py`` on the CPU.

Both packages compute the same f32 formula (|a|^2 + |b|^2 - 2 a.b in row
chunks, then a top-k); the port forms a.b and |a|^2 in float64 and rounds
them once (so its card and CPU agree bit for bit), the JAX package sums
rounded f32 products, and the formula cancels: a distance is off by a
few ulps of |a|^2 + |b|^2 (up to 3 here), so rtol 1e-5 with an absolute
1e-6.
Neighbours are compared as sets, and only on rows whose k-th and
(k+1)-th distances (the JAX package's) are apart by more than 1e-5: a
near-tie at the boundary may pick either candidate. Exact ties go to the
lower index in both packages: on a grid, where every distance is exact,
the neighbours are the JAX package's, index for index.

The tie case is densify's clone: splats copied exactly (position and
features), so a neighbourhood holds exact ties at distance 0 and pairs of
equal distances. Moran's I does not change when a neighbourhood is
reordered, or when one clone stands in for another, so its value is held
to 1e-6 relative on every case; the weights of ``query_nn`` are
compared after sorting each neighbourhood's rows and columns by distance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch.ops import knn as tknn
from splatfields_tpu.ops import knn as jknn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(kind, n=700, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if kind == "clones":
        # a third of the points copied once, a tenth twice more
        src = rng.choice(n, n // 3, replace=False)
        pts = np.concatenate([pts, pts[src], pts[src[: n // 10]]])
        pts = pts[rng.permutation(len(pts))]
    return pts


def _sets_where_separated(got_idx, want_idx, want_d_next, k):
    """Row-wise set equality where the boundary is not a (near) tie."""
    gap = want_d_next[:, k] - want_d_next[:, k - 1]
    sep = gap > 1e-5
    assert sep.mean() > 0.5
    for g, w in zip(np.sort(got_idx[sep], 1), np.sort(want_idx[sep], 1)):
        np.testing.assert_array_equal(g, w)
    return sep


def test_ties_break_by_index_as_lax_top_k():
    """Points on a 1/8 grid: every distance is exact in both packages, so
    ties are everywhere, and the neighbours must be the JAX package's
    exactly (the lower index first, ``lax.top_k``'s rule), whatever the
    chunking."""
    rng = np.random.RandomState(5)
    pts = (np.round(rng.uniform(-1, 1, (900, 3)) * 8) / 8).astype(np.float32)
    want_d, want = jknn.knn_self(jnp.asarray(pts), k=4, chunk=256)
    for chunk in (256, 100):
        d, idx = tknn.knn_self(torch.as_tensor(pts), k=4, chunk=chunk)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    d, idx = tknn.knn_points(torch.as_tensor(pts[:50] + 0.0625),
                             torch.as_tensor(pts), k=8)
    _, want = jknn.knn_points(jnp.asarray(pts[:50] + 0.0625),
                              jnp.asarray(pts), k=8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "clones"])
def test_knn_self(kind, k=4):
    pts = _points(kind)
    d, idx = tknn.knn_self(torch.as_tensor(pts), k=k, chunk=256)
    jd, jidx = jknn.knn_self(jnp.asarray(pts), k=k, chunk=256)
    jd_next, _ = jknn.knn_self(jnp.asarray(pts), k=k + 1, chunk=256)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    assert (idx.numpy() != np.arange(len(pts))[:, None]).all()
    _sets_where_separated(idx.numpy(), np.asarray(jidx),
                          np.asarray(jd_next), k)
    if kind == "clones":
        # exact ties inside k: a zero-distance copy among the neighbours
        assert (d.numpy()[:, 0] <= 1e-6).sum() > len(pts) // 4


def test_knn_points():
    rng = np.random.RandomState(1)
    q = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    pts = _points("clones", n=500, seed=2)
    d, idx = tknn.knn_points(torch.as_tensor(q), torch.as_tensor(pts), k=8,
                             chunk=128)
    jd, jidx = jknn.knn_points(jnp.asarray(q), jnp.asarray(pts), k=8,
                               chunk=128)
    jd_next, _ = jknn.knn_points(jnp.asarray(q), jnp.asarray(pts), k=9,
                                 chunk=128)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    assert float(d.min()) >= 0.0
    _sets_where_separated(idx.numpy(), np.asarray(jidx),
                          np.asarray(jd_next), 8)


def test_mean_sq_dist_knn3():
    pts = _points("random", n=1500)
    np.testing.assert_allclose(
        tknn.mean_sq_dist_knn3(torch.as_tensor(pts)).numpy(),
        np.asarray(jknn.mean_sq_dist_knn3(jnp.asarray(pts))), rtol=1e-5,
        atol=1e-6)


def _sorted_weights(w, idx, pts):
    """Each neighbourhood's weights with rows and columns in the order of
    the neighbours' distances to self (self first)."""
    d = ((pts[idx] - pts[idx[:, :1]]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    w = np.take_along_axis(w, order[:, :, None], 1)
    return np.take_along_axis(w, order[:, None, :], 2)


@pytest.mark.parametrize("kind", ["random", "clones"])
def test_query_nn_and_morans(kind):
    pts = _points(kind, n=600, seed=3)
    rng = np.random.RandomState(4)
    # clones carry their source's features, as densify's clone does
    feats = {}
    for name, f in (("scale", 3), ("opacity", 1), ("rgb", 48)):
        base = rng.randn(len(pts), f).astype(np.float32)
        key = np.unique(pts, axis=0, return_inverse=True)[1].reshape(-1)
        feats[name] = base[key] + 0.5
    w, idx = tknn.query_nn(torch.as_tensor(pts))
    jw, jidx = jknn.query_nn(jnp.asarray(pts))
    w, idx, jw, jidx = w.numpy(), idx.numpy(), np.asarray(jw), np.asarray(
        jidx)
    assert w.shape == jw.shape == (len(pts), 5, 5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(len(pts)))
    np.testing.assert_allclose(_sorted_weights(w, idx, pts),
                               _sorted_weights(jw, jidx, pts), rtol=1e-5,
                               atol=1e-7)
    if kind == "clones":
        # coincident pairs off the diagonal get eps, as the diagonal
        # does, not 1/eps
        off = ~np.eye(5, dtype=bool)[None]
        same = np.isclose(w, w[:, :1, :1], rtol=1e-6) & off
        assert same.any((1, 2)).sum() > len(pts) // 4
    for name, f in feats.items():
        got = tknn.morans_measure(torch.as_tensor(w),
                                  torch.as_tensor(f)[torch.as_tensor(idx)])
        want = jknn.morans_measure(jnp.asarray(jw), jnp.asarray(f)[jidx])
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(
            float(tknn.morans_loss(torch.as_tensor(w),
                                   torch.as_tensor(f)[torch.as_tensor(idx)])),
            float(jknn.morans_loss(jnp.asarray(jw), jnp.asarray(f)[jidx])),
            rtol=1e-6, atol=1e-7, err_msg=name)
