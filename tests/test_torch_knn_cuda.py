"""The Moran terms' KNN on the card against the same call on the CPU:
bit for bit, neighbours and distances (``ops/knn.py`` forms a.b and |a|^2
in float64, rounds them once, and breaks equal distances by index), on
random points, densify-style clones and a grid where every distance
ties with others.

Needs a CUDA card; skips elsewhere. Imports no JAX:

    python -m pytest --noconftest tests/test_torch_knn_cuda.py -q
"""
import numpy as np
import pytest
import torch

from splatfields_torch.ops import knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _points(kind, n=30_000, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3))
    if kind == "grid":
        pts = np.round(pts * 16) / 16
    elif kind == "clones":
        pts = np.concatenate([pts, pts[: n // 3]])
    return pts.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "clones", "grid"])
def test_card_equals_cpu(cuda, kind):
    pts = torch.as_tensor(_points(kind))
    d_cpu, i_cpu = knn.knn_self(pts, k=4)
    d_gpu, i_gpu = knn.knn_self(pts.to(cuda), k=4)
    assert torch.equal(i_gpu.cpu(), i_cpu)
    assert torch.equal(d_gpu.cpu(), d_cpu)
    q = torch.as_tensor(_points("random", n=5_000, seed=1))
    d_cpu, i_cpu = knn.knn_points(q, pts, k=8)
    d_gpu, i_gpu = knn.knn_points(q.to(cuda), pts.to(cuda), k=8)
    assert torch.equal(i_gpu.cpu(), i_cpu)
    assert torch.equal(d_gpu.cpu(), d_cpu)
