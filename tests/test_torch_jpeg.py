"""The port's JPEG decoder (``native/jpeg.cpp``, ``data/jpeg.py``) and
the readers and metrics on JPEG files, against PIL and the JAX package on
the CPU.

Held exactly (0 levels of difference) against PIL's
``Image.open(p).convert("RGB")``, baseline and progressive (SOF2): files
PIL writes at quality 50, 75 and 95 with 4:4:4, 4:2:2 and 4:2:0 chroma,
grayscale, ``optimize=True`` (optimized Huffman tables), restart
intervals (``restart_marker_blocks`` / ``_rows``) and odd sizes (53x37,
17x3, 1x1); cv2-written 4:4:0, 4:2:2 and 4:1:1 files (cv2's ``imread``
agrees with PIL on each); RGB files (``keep_rgb=True``: an Adobe marker
with transform 0, and the same without the marker: component ids R, G,
B); ``chip_smoke.encode_jpeg``'s files (the card's JPEG capture: 4:2:0
and 4:1:1, baseline and progressive, the progressive one the baseline's
pixels); files whose scan script stops early, which libjpeg-turbo
smooths (``encode_jpeg`` scripts, and PIL's progressive files cut after
each scan). The NeuS, nerfies, Colmap and Blender readers and
``metrics.eval_all`` on baseline and progressive JPEG frames (and Adam7
and 4-bit palette PNG frames) equal the JAX readers and ``eval_all``.
CMYK, arithmetic-coded, 12-bit, lossless and hierarchical files, and a
file that is neither PNG nor JPEG, raise NotImplementedError naming the
file and the marker.
"""
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import metrics
from tests.test_torch_png import _write as _write_png
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


# the frame kinds of the reader tests: JPEG by PIL, and two PNG kinds
# (Adam7 RGB, Adam7 4-bit palette)
FRAME_KINDS = ["baseline", "progressive", "adam7-rgb", "adam7-palette4"]


def _frame_bytes(img, kind, **kw):
    """uint8 RGB ``img`` as a file of ``kind`` (JPEG options ``kw``, which
    a PNG kind ignores)."""
    if kind in ("baseline", "progressive"):
        return _pil_jpeg(img, progressive=kind == "progressive", **kw)
    if kind == "adam7-rgb":
        return _write_png(img, 8, 2, interlace=True, ftype=4)
    p = PIL.fromarray(img).quantize(16)
    pal = np.array(p.getpalette()[:48]).reshape(16, 3)
    return _write_png(np.array(p)[..., None], 4, 3, interlace=True,
                      ftype=4, palette=pal)


CASES = ([(f"q{q}-{s}", dict(quality=q, subsampling=i))
          for q in (50, 75, 95)
          for i, s in enumerate(("444", "422", "420"))]
         + [("optimize", dict(quality=80, optimize=True)),
            ("restart_blocks", dict(quality=80, restart_marker_blocks=3)),
            ("restart_rows", dict(quality=80, restart_marker_rows=1,
                                  subsampling=2))])


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_decode_equals_pil(name, kw, progressive):
    data = _pil_jpeg(_frame(), progressive=progressive, **kw)
    got = jpeg.decode(data)
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("size", [(3, 17), (1, 1), (16, 16)])
def test_decode_odd_sizes_and_gray(size, progressive, tmp_path):
    for sub in (0, 2):
        data = _pil_jpeg(_frame(*size), quality=85, subsampling=sub,
                         progressive=progressive)
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
    data = _pil_jpeg(_frame(*size)[..., 1], quality=85,
                     progressive=progressive)
    gray = jpeg.decode(data)
    assert gray.shape == size + (1,)
    np.testing.assert_array_equal(gray[..., 0],
                                  np.array(PIL.open(io.BytesIO(data))))
    path = tmp_path / "gray.jpg"
    path.write_bytes(data)
    np.testing.assert_array_equal(images.read_color(str(path)),
                                  _pil_rgb(data))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_cv2_sampling_factors(progressive):
    """4:4:0, 4:2:2 and 4:1:1 (luma 4x1: chroma replicated 4 times
    across, libjpeg-turbo's int_upsample) at odd sizes."""
    cv2 = pytest.importorskip("cv2")
    for name in ("IMWRITE_JPEG_SAMPLING_FACTOR_440",
                 "IMWRITE_JPEG_SAMPLING_FACTOR_422",
                 "IMWRITE_JPEG_SAMPLING_FACTOR_411"):
        if not hasattr(cv2, name):
            pytest.skip(f"cv2 has no {name}")
        img = _frame(*((H, W) if name[-1] != "1" else (9, 70)))
        ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, name),
            cv2.IMWRITE_JPEG_QUALITY, 85,
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
        data = enc.tobytes()
        assert (b"\xff\xc2" in data) == progressive
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
        np.testing.assert_array_equal(
            cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1], _pil_rgb(data))


def _patch_sof(data, marker=None, precision=None):
    """A copy of a baseline file with its SOF0 marker or precision byte
    replaced (the decoder refuses it at the frame header)."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


REFUSED = {   # kind: (file bytes, the message naming the marker)
    "cmyk": (lambda: _pil_cmyk(),
             "CMYK / YCCK JPEG .4 components, SOF0 marker"),
    "arithmetic": (lambda: _patch_sof(_pil_jpeg(_frame()), 0xC9),
                   "arithmetic-coded JPEG .SOF9-15"),
    "12-bit": (lambda: _patch_sof(_pil_jpeg(_frame()), precision=12),
               "12-bit JPEG .SOF0 marker"),
    "lossless": (lambda: _patch_sof(_pil_jpeg(_frame()), 0xC3),
                 "lossless JPEG .SOF3 marker"),
    "hierarchical": (lambda: _patch_sof(_pil_jpeg(_frame()), 0xC5),
                     "hierarchical JPEG .SOF5-7 markers"),
}


def _pil_cmyk():
    buf = io.BytesIO()
    PIL.fromarray(_frame()).convert("CMYK").save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refusals_name_the_file(kind, tmp_path):
    """What the decoder still refuses raises NotImplementedError naming
    the file and the marker."""
    make, marker = REFUSED[kind]
    path = tmp_path / "frame.jpg"
    path.write_bytes(make())
    with pytest.raises(NotImplementedError, match=f"frame.jpg: {marker}"):
        images.read(str(path))
    other = tmp_path / "frame.png"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(NotImplementedError, match="frame.png: neither"):
        images.read(str(other))
    with pytest.raises(ValueError, match="truncated|end of file"):
        jpeg.decode(_pil_jpeg(_frame())[:200])


def _segments(data):
    """[(marker, start, end)] of a JPEG's segments after SOI, each SOS
    with the entropy-coded data after it."""
    out, pos = [], 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            return out + [(m, pos, pos + 2)]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        out.append((m, pos, end))
        pos = end
    return out


def _first_scans(data, n):
    """The file cut after its ``n``-th scan (then EOI)."""
    out, seen = [data[:2]], 0
    for m, a, b in _segments(data):
        seen += m == 0xDA
        if seen <= n or m == 0xD9:
            out.append(data[a:b] if not (m == 0xDA and seen > n) else b"")
    return b"".join(out)


def _eob_runs(data):
    """The EOBn symbols (a run of 2^n blocks, n >= 1) of the file's AC
    Huffman tables."""
    runs = set()
    for m, a, b in _segments(data):
        if m != 0xC4:
            continue
        body, i = data[a + 4:b], 0
        while i < len(body):
            n = sum(body[i + 1:i + 17])
            if body[i] >> 4:
                runs |= {s >> 4 for s in body[i + 17:i + 17 + n]
                         if s & 15 == 0 and 0 < s >> 4 < 15}
            i += 17 + n
    return runs


@pytest.mark.parametrize("sampling", ["420", "411"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_chip_smoke_encoder_decodes_as_pil(sampling, progressive):
    """The card's JPEG capture comes from ``chip_smoke.encode_jpeg`` (the
    GPU machine has no PIL): PIL decodes its files as the port does, they
    hold the frame, and a progressive file (``jpeg_simple_progression``,
    Huffman tables from each scan's counts, EOB runs over many blocks)
    holds the baseline file's coefficients: the same pixels."""
    runs = set()
    for h, w in ((H, W), (48, 64), (40, 8), (1, 1)):
        for noise in (20.0, 2.0):
            img = _frame(h, w, seed=2, noise=noise)
            data = chip_smoke.encode_jpeg(
                img, quality=90, sampling=sampling,
                scans=chip_smoke.JPEG_SIMPLE_PROGRESSION if progressive
                else None)
            assert (b"\xff\xc2" in data) == progressive
            got = jpeg.decode(data)
            np.testing.assert_array_equal(got, _pil_rgb(data))
            if progressive:
                base = chip_smoke.encode_jpeg(img, quality=90,
                                              sampling=sampling)
                np.testing.assert_array_equal(got, jpeg.decode(base))
                runs |= _eob_runs(data)
        # the near-smooth frame survives the chroma cut at quality 90 (4:1:1
        # halves 4:2:0's chroma across)
        assert np.abs(got.astype(int) - img).mean() < (
            6 if sampling == "420" else 8)
    assert bool(runs) == progressive   # EOBn, n >= 1: runs of 2+ blocks


SCRIPTS = {   # name: an encode_jpeg scan script that stops early
    "dc-only": chip_smoke.JPEG_SIMPLE_PROGRESSION[:1],
    "dc-full-precision": (((0, 1, 2), 0, 0, 0, 0),),
    "first-six-scans": chip_smoke.JPEG_SIMPLE_PROGRESSION[:6],
    "luma-bit-missing": chip_smoke.JPEG_SIMPLE_PROGRESSION[:9],
    "bands-cut": (((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 2, 0, 0),
                  ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)),
    "coarse-ac": (((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 3),
                  ((1,), 1, 63, 0, 2), ((2,), 1, 63, 0, 1)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_incomplete_scan_scripts_smooth_as_libjpeg(name):
    """A file whose coefficients 1-9 are not all complete after its last
    scan: libjpeg-turbo's block smoothing (the 5x5 DC window, and DC
    interpolation when no AC coefficient came), against PIL and cv2."""
    cv2 = pytest.importorskip("cv2")
    for h, w in ((H, W), (1, 1), (3, 17), (17, 33), (40, 8), (120, 97)):
        for sampling in ("420", "411"):
            data = chip_smoke.encode_jpeg(_frame(h, w, seed=2), quality=75,
                                          sampling=sampling,
                                          scans=SCRIPTS[name])
            got = jpeg.decode(data)
            np.testing.assert_array_equal(got, _pil_rgb(data))
            np.testing.assert_array_equal(got, cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("mode", ["gray", "444", "420"])
def test_pil_progressive_cut_after_each_scan(mode):
    """PIL's progressive files cut after each of their scans (all but the
    last smooth), at odd sizes."""
    for h, w in ((H, W), (9, 70), (64, 64)):
        img = _frame(h, w, seed=1)
        if mode == "gray":
            data = _pil_jpeg(img[..., 0], quality=80, progressive=True)
        else:
            data = _pil_jpeg(img, quality=80, progressive=True,
                             subsampling=0 if mode == "444" else 2)
        n_scans = sum(m == 0xDA for m, _, _ in _segments(data))
        assert n_scans >= 6
        for n in range(1, n_scans + 1):
            cut = _first_scans(data, n)
            got = jpeg.decode(cut)
            np.testing.assert_array_equal(
                got if got.shape[-1] == 3 else np.repeat(got, 3, -1),
                _pil_rgb(cut))


def test_quant_tables_latch_at_a_components_first_scan():
    """A DQT between progressive scans (every component's first scan is
    the interleaved DC scan, before it) changes nothing: libjpeg-turbo
    keeps each component's table from its first scan. A scan with Ss 0
    and Se > 0 is malformed."""
    data = _pil_jpeg(_frame(), quality=80, progressive=True)
    sos = [a for m, a, _ in _segments(data) if m == 0xDA]
    dqt = bytes([0xFF, 0xDB, 0, 67, 0]) + bytes([1] * 64)   # table 0: 1s
    moved = data[:sos[2]] + dqt + data[sos[2]:]
    np.testing.assert_array_equal(jpeg.decode(moved), _pil_rgb(moved))
    np.testing.assert_array_equal(jpeg.decode(moved), jpeg.decode(data))
    first = data.index(b"\xff\xda")
    ns = data[first + 4]
    bad = bytearray(data)
    bad[first + 5 + 2 * ns + 1] = 5   # the DC scan's Se
    with pytest.raises(ValueError, match="bad progression .Ss 0, Se 5"):
        jpeg.decode(bytes(bad))


@pytest.mark.parametrize("kind", ["adobe", "rgb-ids"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_rgb_files(kind, progressive):
    """PIL's ``keep_rgb=True`` files (no JFIF marker, an Adobe marker with
    transform 0, ids R, G, B) and the same without the Adobe marker:
    libjpeg-turbo reads both as RGB, no YCbCr tables."""
    data = _pil_jpeg(_frame(), quality=85, keep_rgb=True,
                     progressive=progressive)
    assert b"JFIF" not in data[:40]
    if kind == "rgb-ids":
        (_, a, b), = [s for s in _segments(data) if s[0] == 0xEE]
        data = data[:a] + data[b:]
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))


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


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_neus_reader_on_rgb_jpg(kind, tmp_path):
    """A ResFields camera directory with ``rgb/*.jpg`` frames (``rgb/*.png``
    for the PNG kinds: the globs both readers take) and PNG masks: the
    port's frames equal cv2's."""
    cam_dir = tmp_path / "cam_train_0"
    for sub in ("rgb", "mask"):
        (cam_dir / sub).mkdir(parents=True)
    wm = chip_smoke.dtu_world_mat(0.4, W, H, 1.1 * W, 4.0)
    np.savez(cam_dir / "cameras_sphere.npz", **{
        f"{k}_{f}": v for f in range(2) for k, v in (
            ("world_mat", wm), ("scale_mat", np.eye(4, dtype=np.float32)))})
    for f in range(2):
        ext = "png" if "adam7" in kind else "jpg"
        (cam_dir / "rgb" / f"{f:03d}.{ext}").write_bytes(
            _frame_bytes(_frame(seed=f), kind, quality=90, subsampling=2))
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


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_nerfies_reader_on_jpeg_frames(kind, tmp_path, one_thread):
    """The nerfies capture with every frame re-encoded as ``kind`` under
    its ``.png`` name (the readers go by the first bytes, as PIL does; a
    palette frame is its indices in both)."""
    scene = chip_smoke.write_nerfies_scene(tmp_path, 32, 18, 2, "cpu",
                                           n_splats=200, n_points=300)
    rgb_dir = os.path.join(scene, "rgb", "1x")
    for name in os.listdir(rgb_dir):
        path = os.path.join(rgb_dir, name)
        img = np.array(PIL.open(path).convert("RGB"))
        with open(path, "wb") as f:
            f.write(_frame_bytes(img, kind, quality=90))
    got = tnerfies.read_nerfies_cameras_mv(scene)[0]
    want = jnerfies.read_nerfies_cameras_mv(scene)[0]
    assert (jpeg.SIGNATURE == open(got[0].image_path, "rb").read(3)) == (
        "adam7" not in kind)
    _same_infos(got, want, skip=("R", "T"))


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_colmap_and_blender_frames(kind, tmp_path):
    """Colmap's ``read_image_rgba`` and the Blender readers' RGBA read of
    a frame: PIL's ``convert("RGBA")``, alpha 255; the Colmap cameras of
    an ``images/`` folder of such frames equal the JAX reader's."""
    data = _frame_bytes(_frame(), kind, quality=70)
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    want = np.array(PIL.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(tcolmap.read_image_rgba(str(path)), want)
    np.testing.assert_array_equal(tblender._read_rgba(str(path)),
                                  want.astype(np.float32) / 255.0)
    scan = chip_smoke.write_colmap_scene(tmp_path, 32, 24, "cpu",
                                         n_splats=200, n_points=50,
                                         jpeg=True)
    for name in os.listdir(os.path.join(scan, "images")):
        path = os.path.join(scan, "images", name)
        img = jpeg.decode(open(path, "rb").read())
        with open(path, "wb") as f:
            f.write(_frame_bytes(img, kind, quality=90))
    got = tcolmap._load_colmap_model(scan, "images", True)
    assert got[0].image_path.endswith(".jpg")
    assert (got[0].mask == 1).all() and got[0].image.max() > 0
    _same_infos(got, jcolmap._load_colmap_model(scan, "images", True))


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_eval_all_on_jpg(kind, tmp_path):
    """``metrics.eval_all`` over ``gt/*.jpg`` and ``renders/*.jpg`` (of
    ``kind``: cv2 reads by content) equals the JAX function (cv2's
    decode)."""
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
                _frame_bytes(img, kind, quality=90))
    got = metrics.eval_all(str(tmp_path), device="cpu")
    want = jax_metrics.eval_all(str(tmp_path))
    assert set(got) == set(want) and got["psnr"] < 60
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
