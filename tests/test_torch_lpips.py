"""The port's VGG16-LPIPS (``splatfields_torch/ops/lpips.py``) and the
metrics around it against the JAX package's, on the CPU.

No VGG weights exist here, so both load one seeded random ``.npz`` in
the weight file's layout (``chip_smoke.write_lpips_weights``: He-scaled
convs, positive ``lins``). At 64x64
both compute the same f32 convolutions in another order; the distance
agrees within 1e-5 relative. ``metrics.eval_all`` of both packages over
one render directory: ``results.yaml``'s lpips within 1e-5 relative of
each other (the port hands LPIPS the BGR images, as cv2.imread does in
the JAX package and the reference), psnr and ssim as before.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import metrics as tmetrics
from splatfields_torch.data import png
from splatfields_torch.ops import lpips as tlpips
from splatfields_tpu import metrics as jmetrics
from splatfields_tpu.ops import lpips as jlpips

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return chip_smoke.write_lpips_weights(
        tmp_path_factory.mktemp("lpips") / "vgg.npz")


def test_distance_matches_jax(weights):
    rng = np.random.RandomState(1)
    a = rng.rand(64, 64, 3).astype(np.float32)
    b = np.clip(a + rng.randn(64, 64, 3).astype(np.float32) * 0.1, 0, 1)
    got = tlpips.load_lpips(weights, device="cpu")
    want = jlpips.load_lpips(weights)
    for x, y in ((a, b), (b, a), (a, a)):
        gv, wv = got(x, y), want(x, y)
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-7)
    assert got(a, b) > 0 and got(a, a) == 0.0


def test_missing_or_malformed_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("SPLATFIELDS_LPIPS", raising=False)
    # no weight file ships: the path, the variable and weights/ all miss
    assert tlpips.find_weights(str(tmp_path / "none.npz")) is None
    assert tlpips.load_lpips(str(tmp_path / "none.npz")) is None
    bad = tmp_path / "bad.npz"
    np.savez(bad, x=np.zeros(3))
    assert tlpips.load_lpips(str(bad), device="cpu") is None
    monkeypatch.setenv("SPLATFIELDS_LPIPS", str(bad))
    assert tlpips.find_weights() == str(bad)


def test_eval_all_matches_jax(weights, tmp_path):
    rng = np.random.RandomState(2)
    for sub in ("gt", "renders"):
        os.makedirs(tmp_path / sub)
    for i in range(2):
        gt = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        noisy = np.clip(gt + rng.randint(-40, 40, gt.shape), 0, 255)
        png.write(str(tmp_path / "gt" / f"{i:05d}.png"), gt)
        png.write(str(tmp_path / "renders" / f"{i:05d}.png"),
                  noisy.astype(np.uint8))
    want = jmetrics.eval_all(str(tmp_path), lpips_weights_path=weights)
    want_yaml = tmetrics.read_results(str(tmp_path / "results.yaml"))
    got = tmetrics.eval_all(str(tmp_path), lpips_weights_path=weights,
                            device="cpu")
    got_yaml = tmetrics.read_results(str(tmp_path / "results.yaml"))
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got_yaml[k], want_yaml[k], rtol=1e-5)
    # the channel order matters to LPIPS: RGB input gives another value
    fn = tlpips.load_lpips(weights, device="cpu")
    a = png.read(str(tmp_path / "renders" / "00000.png")) / np.float32(255)
    b = png.read(str(tmp_path / "gt" / "00000.png")) / np.float32(255)
    assert abs(fn(a, b) - fn(a[..., ::-1], b[..., ::-1])) > 1e-6
