"""The CUDA blend kernel against its plain PyTorch version, on the GPU.

Needs a CUDA card (and nvcc to build the kernel); skips elsewhere. Imports
no JAX, so on the GPU machine it runs without this directory's conftest:

    python -m pytest --noconftest tests/test_torch_blend_cuda.py -q

Tolerance: both compute each alpha with the same f32 operations (the
kernel is built with --fmad=false); they differ in how the transmittance
product is associated (a sequential product against a chunked cumprod),
~1e-7 relative. A pixel whose T crosses the 1e-4 stop between the two can
differ by one splat's weight, < 1e-4: colour and T 2e-4, depth (z up to 5)
1e-3.
"""
import pytest
import torch

from chip_smoke import synthetic_pack
from splatfields_torch.ops.raster.blend_cuda import blend_fwd
from splatfields_torch.ops.raster.blend_torch import blend_sorted_plain

TS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


CASES = {
    # rows per tile, opacity, tile_cap
    "early_termination": (600, 0.9, 1024),
    "tile_cap_overflow": (1500, 0.005, 1024),
    "mixed": (300, 0.3, 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    rows, opacity, tile_cap = CASES[case]
    (pack, tile_start, counts), tiles_x, tiles_y = synthetic_pack(
        cuda, rows, opacity, tiles_x=4, tiles_y=3)
    before = blend_fwd.launches
    got = blend_fwd(pack, tile_start, counts, tiles_x, tiles_y, TS, tile_cap,
                    128)
    torch.cuda.synchronize()
    assert blend_fwd.launches == before + 1
    want = blend_sorted_plain(pack, tile_start, counts, tiles_x, tiles_y, TS,
                              tile_cap, 128)
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 2e-4)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=atol, rtol=0)
    if case == "early_termination":
        assert float(got[2].max()) < 1e-2   # every pixel saturates
    if case == "tile_cap_overflow":
        # no pixel stops early, so the cap decides what is blended
        assert float(got[2].min()) > 1e-4
