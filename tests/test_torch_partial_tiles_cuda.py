"""The blend kernels on frames whose size is not a multiple of the tile:
DTU's 1600x1200 at ``-r 2`` (800x600: the bottom row of tiles is half off
the image) and an odd 797x603, against their plain versions, on the GPU.

A seeded 20,000-splat scene rendered through ``rasterize`` on the card,
once without grad and once with a backward from random upstream image
gradients; ``chip_smoke.LoopBlends`` captures the kernels' arguments.
Both kernels against their plain versions on the whole frame
(``chip_smoke.check_loop_blends``: TOL, TOL_BWD, the backward repeated
bitwise) and on its partial tiles alone, where the upstream gradient the
backward reads must be 0 on every off-image pixel
(``chip_smoke.check_partial_tiles``).

Needs a CUDA card (and nvcc); skips elsewhere. Imports no JAX:

    python -m pytest --noconftest tests/test_torch_partial_tiles_cuda.py -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import LoopBlends, check_loop_blends, check_partial_tiles
from splatfields_torch.data.cameras import camera_matrices
from splatfields_torch.ops.raster.api import rasterize

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("size", [(800, 600), (797, 603)])
def test_partial_tiles(cuda, size):
    w, h = size
    rng = np.random.RandomState(w)
    n = 20_000

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=cuda)

    means, rots, cols = (t(rng.uniform(-1, 1, (n, 3))), t(rng.randn(n, 4)),
                         t(rng.rand(n, 3)))
    scales = t(0.01 + 0.03 * rng.rand(n, 3))
    opac = t(rng.uniform(0.2, 0.9, n)).requires_grad_(True)
    fovx = 2 * np.arctan(0.45)
    fovy = 2 * np.arctan(0.45 * h / w)
    view, full, _, center = (torch.as_tensor(m, device=cuda) for m in
                             camera_matrices(np.eye(3),
                                             np.array([0.0, 0.0, 3.0]),
                                             fovx, fovy))
    args = (means, scales, rots, opac, view, full, center,
            torch.ones(3, device=cuda), 0.45, 0.45 * h / w, w, h)
    with LoopBlends() as cap:
        with torch.no_grad():
            rasterize(*args, colors_precomp=cols)
        out = rasterize(*args, colors_precomp=cols)
        assert out.color.shape == (3, h, w)
        assert bool(torch.isfinite(out.color).all())
        g = t(rng.randn(3, h, w))
        (out.color * g).sum().add(out.alpha.sum()).backward()
    torch.cuda.synchronize()
    assert float(opac.grad.abs().max()) > 0
    check_loop_blends(f"{w}x{h}", cap)
    check_partial_tiles(f"{w}x{h}", cap, w, h)
