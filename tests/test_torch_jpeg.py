"""The port's baseline JPEG decoder (``native/jpeg.cpp``, ``data/jpeg.py``)
and the readers and metrics on JPEG files, against PIL and the JAX
package on the CPU.

Held exactly (0 levels of difference): the decode of PIL-written files
at quality 50, 75 and 95 with 4:4:4, 4:2:2 and 4:2:0 chroma, grayscale,
``optimize=True`` (optimized Huffman tables), restart intervals
(``restart_marker_blocks`` / ``_rows``) and odd sizes (53x37, 17x3,
1x1), and a cv2-written 4:4:0 file, each against PIL's
``Image.open(p).convert("RGB")`` (cv2's ``imread`` agrees with PIL on
each); ``chip_smoke.encode_jpeg``'s files (the card's JPEG capture)
decoded by PIL and by the port; the NeuS, nerfies, Colmap and Blender
readers on JPEG frames against the JAX readers; ``metrics.eval_all``
over ``*.jpg`` against the JAX ``eval_all``. A progressive file, and a
file that is neither PNG nor JPEG, raise NotImplementedError naming the
file.
"""
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import metrics
from splatfields_torch.data import images, jpeg
from splatfields_torch.data.readers import blender as tblender
from splatfields_torch.data.readers import colmap as tcolmap
from splatfields_torch.data.readers import neus as tneus
from splatfields_torch.data.readers import nerfies as tnerfies
from splatfields_tpu import metrics as jax_metrics
from splatfields_tpu.data.readers import colmap as jcolmap
from splatfields_tpu.data.readers import neus as jneus
from splatfields_tpu.data.readers import nerfies as jnerfies

PIL = pytest.importorskip("PIL.Image")

W, H = 53, 37


def _frame(h=H, w=W, seed=0, noise=20.0):
    """Smooth colour ramps with noise: every DCT band in use."""
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / 5.0) * 100 + 128, np.cos(y / 7.0) * 100 + 128,
                  (x + y) % 256], -1)
    a = a + np.random.RandomState(seed).randn(h, w, 3) * noise
    return np.clip(a, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.array(PIL.open(io.BytesIO(data)).convert("RGB"))


CASES = ([(f"q{q}-{s}", dict(quality=q, subsampling=i))
          for q in (50, 75, 95)
          for i, s in enumerate(("444", "422", "420"))]
         + [("optimize", dict(quality=80, optimize=True)),
            ("restart_blocks", dict(quality=80, restart_marker_blocks=3)),
            ("restart_rows", dict(quality=80, restart_marker_rows=1,
                                  subsampling=2))])


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_decode_equals_pil(name, kw):
    data = _pil_jpeg(_frame(), **kw)
    got = jpeg.decode(data)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("size", [(3, 17), (1, 1), (16, 16)])
def test_decode_odd_sizes_and_gray(size, tmp_path):
    for sub in (0, 2):
        data = _pil_jpeg(_frame(*size), quality=85, subsampling=sub)
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
    data = _pil_jpeg(_frame(*size)[..., 1], quality=85)
    gray = jpeg.decode(data)
    assert gray.shape == size + (1,)
    np.testing.assert_array_equal(gray[..., 0],
                                  np.array(PIL.open(io.BytesIO(data))))
    path = tmp_path / "gray.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(images.read_color(str(path)),
                                  _pil_rgb(data))


def test_cv2_sampling_factors():
    cv2 = pytest.importorskip("cv2")
    img = _frame()
    for name in ("IMWRITE_JPEG_SAMPLING_FACTOR_440",
                 "IMWRITE_JPEG_SAMPLING_FACTOR_422"):
        if not hasattr(cv2, name):
            pytest.skip(f"cv2 has no {name}")
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, name),
            cv2.IMWRITE_JPEG_QUALITY, 85])
        data = enc.tobytes()
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
        np.testing.assert_array_equal(
            cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1], _pil_rgb(data))


def test_refusals_name_the_file(tmp_path):
    path = tmp_path / "prog.jpg"
    path.write_bytes(_pil_jpeg(_frame(), progressive=True))
    with pytest.raises(NotImplementedError,
                       match="prog.jpg: progressive JPEG .SOF2 marker."):
        images.read(str(path))
    other = tmp_path / "frame.png"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(NotImplementedError, match="frame.png: neither"):
        images.read(str(other))
    with pytest.raises(ValueError, match="truncated|end of file"):
        jpeg.decode(_pil_jpeg(_frame())[:200])


def test_chip_smoke_encoder_decodes_as_pil():
    """The card's JPEG capture comes from ``chip_smoke.encode_jpeg`` (the
    GPU machine has no PIL): PIL decodes its files as the port does, and
    they hold the frame."""
    for h, w in ((H, W), (48, 64), (1, 1)):
        for noise in (20.0, 2.0):
            img = _frame(h, w, seed=2, noise=noise)
            data = chip_smoke.encode_jpeg(img, quality=90)
            got = jpeg.decode(data)
            np.testing.assert_array_equal(got, _pil_rgb(data))
        # the near-smooth frame survives 4:2:0 at quality 90
        assert np.abs(got.astype(int) - img).mean() < 6


def _same_infos(got, want, skip=()):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            if f.name in skip:
                continue
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


def test_neus_reader_on_rgb_jpg(tmp_path):
    """A ResFields camera directory with ``rgb/*.jpg`` frames (the glob
    both readers take) and PNG masks: the port's frames equal cv2's."""
    cam_dir = tmp_path / "cam_train_0"
    for sub in ("rgb", "mask"):
        (cam_dir / sub).mkdir(parents=True)
    wm = chip_smoke.dtu_world_mat(0.4, W, H, 1.1 * W, 4.0)
    np.savez(cam_dir / "cameras_sphere.npz", **{
        f"{k}_{f}": v for f in range(2) for k, v in (
            ("world_mat", wm), ("scale_mat", np.eye(4, dtype=np.float32)))})
    for f in range(2):
        (cam_dir / "rgb" / f"{f:03d}.jpg").write_bytes(
            _pil_jpeg(_frame(seed=f), quality=90, subsampling=2))
        mask = (_frame(seed=5 + f)[..., 0] > 128).astype(np.uint8) * 255
        PIL.fromarray(mask).save(cam_dir / "mask" / f"{f:03d}.png")
    got, _ = tneus.read_cameras_from_neus(str(cam_dir), True)
    want, _ = jneus.read_cameras_from_neus(str(cam_dir), True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("image", "mask"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_nerfies_reader_on_jpeg_frames(tmp_path, one_thread):
    """The nerfies capture with every frame re-encoded as JPEG under its
    ``.png`` name (the readers go by the first bytes, as PIL does)."""
    scene = chip_smoke.write_nerfies_scene(tmp_path, 32, 18, 2, "cpu",
                                           n_splats=200, n_points=300)
    rgb_dir = os.path.join(scene, "rgb", "1x")
    for name in os.listdir(rgb_dir):
        path = os.path.join(rgb_dir, name)
        img = np.array(PIL.open(path).convert("RGB"))
        with open(path, "wb") as f:
            f.write(_pil_jpeg(img, quality=90))
    got = tnerfies.read_nerfies_cameras_mv(scene)[0]
    want = jnerfies.read_nerfies_cameras_mv(scene)[0]
    assert jpeg.SIGNATURE == open(got[0].image_path, "rb").read(3)
    _same_infos(got, want, skip=("R", "T"))


def test_colmap_and_blender_frames(tmp_path):
    """Colmap's ``read_image_rgba`` and the Blender readers' RGBA read of
    a JPEG: PIL's ``convert("RGBA")``, alpha 255; the Colmap cameras of a
    JPEG ``images/`` folder equal the JAX reader's."""
    data = _pil_jpeg(_frame(), quality=70)
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    want = np.array(PIL.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(tcolmap.read_image_rgba(str(path)), want)
    np.testing.assert_array_equal(tblender._read_rgba(str(path)),
                                  want.astype(np.float32) / 255.0)
    scan = chip_smoke.write_colmap_scene(tmp_path, 32, 24, "cpu",
                                         n_splats=200, n_points=50,
                                         jpeg=True)
    got = tcolmap._load_colmap_model(scan, "images", True)
    assert got[0].image_path.endswith(".jpg")
    assert (got[0].mask == 1).all() and got[0].image.max() > 0
    _same_infos(got, jcolmap._load_colmap_model(scan, "images", True))


def test_eval_all_on_jpg(tmp_path):
    """``metrics.eval_all`` over ``gt/*.jpg`` and ``renders/*.jpg`` equals
    the JAX function (cv2's decode)."""
    pytest.importorskip("cv2")
    for sub, seed in (("gt", 0), ("renders", 7)):
        os.makedirs(tmp_path / sub)
        for i in range(2):
            img = _frame(seed=i)
            if sub == "renders":
                img = np.clip(img.astype(int) + np.random.RandomState(
                    seed + i).randint(-9, 10, img.shape), 0, 255).astype(
                        np.uint8)
            (tmp_path / sub / f"{i:05d}.jpg").write_bytes(
                _pil_jpeg(img, quality=90))
    got = metrics.eval_all(str(tmp_path), device="cpu")
    want = jax_metrics.eval_all(str(tmp_path))
    assert set(got) == set(want) and got["psnr"] < 60
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
