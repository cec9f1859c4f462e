"""The port's PNG codec (``splatfields_torch/data/png.py``) against PIL:
seeded images of every colour type written by PIL and by the port's
encoder with each of the five row filters forced, round trips, the
anti-diagonal unfilter against a row-by-row loop, and the synthetic
Blender scene's frames. Adam7-interlaced files and 1-, 2- and 4-bit gray
and palette files (written here: neither PIL nor the port's encoder
writes Adam7 or 2- and 4-bit gray; PIL's own 1-bit gray and ``bits=``
palette files too) decode as PIL opens them (``decode_pil`` against
``np.array(PIL.Image.open(p))``), as PIL's ``convert`` and cv2's
``imread`` see them (``decode``), 0 levels of difference; each port
reader's view of such a file equals the library call its JAX counterpart
makes. No JAX."""
import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from splatfields_torch.data import images, png
from splatfields_torch.data.readers import blender, colmap, nerfies, neus

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(shape, seed):
    """Noise plus a ramp, so every filter sees both smooth and rough
    rows."""
    rng = np.random.RandomState(seed)
    h, w, c = shape
    ramp = (np.arange(w)[None, :, None] * 7 + np.arange(h)[:, None, None] * 3)
    return ((rng.randint(0, 256, shape) // 3 + ramp) % 256).astype(np.uint8)


def _pil_bytes(img, mode, **kw):
    buf = io.BytesIO()
    PIL.Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(
        buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ftype", range(5))
def test_port_encoder_read_by_pil_and_back(mode, ftype):
    img = _image((23, 41, MODES[mode]), seed=ftype)
    data = png.encode(img, ftype)
    pil = np.array(PIL.Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("mode", MODES)
def test_pil_written_files_decode(mode):
    img = _image((64, 48, MODES[mode]), seed=7)
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        got = png.decode(_pil_bytes(img, mode, **kw))
        np.testing.assert_array_equal(got.reshape(img.shape), img)
        # the reader's view of the file: PIL's convert("RGBA")
        want = np.array(PIL.Image.open(io.BytesIO(
            _pil_bytes(img, mode, **kw))).convert("RGBA"))
        np.testing.assert_array_equal(png.to_rgba(got), want)


def test_palette_with_and_without_transparency():
    rgb = _image((30, 20, 3), seed=3)
    p = PIL.Image.fromarray(rgb).convert("P", palette=PIL.Image.ADAPTIVE)
    for kw in ({}, {"transparency": 5}):
        buf = io.BytesIO()
        p.save(buf, "PNG", **kw)
        want = PIL.Image.open(io.BytesIO(buf.getvalue()))
        want = np.array(want.convert("RGBA" if kw else "RGB"))
        np.testing.assert_array_equal(png.decode(buf.getvalue()), want)


def test_mixed_row_filters_match_a_row_loop():
    """Rows with all five filters in one file: the anti-diagonal unfilter
    against the PNG specification's byte loop."""
    img = _image((17, 13, 4), seed=11)
    h, w, c = img.shape
    ftypes = np.arange(h) % 5
    rows = [png._filter(img, int(f))[y] for y, f in enumerate(ftypes)]
    raw = np.stack(rows)
    got = png._unfilter_diagonal(raw, ftypes)
    out = np.zeros((h, w, c), np.int64)
    for y in range(h):
        for x in range(w):
            for ch in range(c):
                a = out[y, x - 1, ch] if x else 0
                b = out[y - 1, x, ch] if y else 0
                cc = out[y - 1, x - 1, ch] if x and y else 0
                p = a + b - cc
                paeth = min((abs(p - a), 0, a), (abs(p - b), 1, b),
                            (abs(p - cc), 2, cc))[2]
                pred = (0, a, b, (a + b) // 2, paeth)[ftypes[y]]
                out[y, x, ch] = (int(raw[y, x, ch]) + pred) % 256
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(out, img)


def test_rejects_what_it_does_not_read():
    # 16-bit grey is read (the ResFields depth maps), and every depth PNG
    # allows; a depth the colour type does not allow is not
    buf = io.BytesIO()
    gray16 = np.arange(16, dtype=np.uint16).reshape(4, 4) * 4099
    PIL.Image.fromarray(gray16).save(buf, "PNG")
    np.testing.assert_array_equal(png.decode(buf.getvalue())[..., 0], gray16)
    rgb4 = _write(np.zeros((4, 4, 3), np.uint8), 8, 2)
    rgb4 = rgb4[:24] + bytes([4]) + rgb4[25:]   # IHDR's depth byte
    with pytest.raises(ValueError, match="bit depth 4, colour type 2"):
        png.decode(rgb4)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
    with pytest.raises(TypeError):
        png.encode(np.zeros((2, 2), np.float32))


def test_blender_scene_frames(tmp_path):
    import torch

    import chip_smoke
    root = chip_smoke.write_blender_scene(tmp_path, 32, 3, [0.3],
                                          torch.device("cpu"))
    for name in ("train/r_0", "train/r_2", "test/r_0"):
        path = f"{root}/{name}.png"
        want = np.array(PIL.Image.open(path).convert("RGBA"))
        np.testing.assert_array_equal(png.to_rgba(png.read(path)), want)
        assert want[..., 3].min() < 255 and want[..., 3].max() > 0


def _write(samples, depth, ctype, interlace=False, ftype=0, palette=None):
    """A PNG of ``samples`` [H, W, C] at the file's own depth (values not
    scaled), every row of every pass with filter ``ftype``; with
    ``interlace`` the seven Adam7 passes, an empty one without bytes."""
    samples = np.asarray(samples)
    ch = samples.shape[-1]

    def rows(img):
        h, w = img.shape[:2]
        if depth == 16:
            b = img.astype(">u2").view(np.uint8).reshape(h, w * 2 * ch)
        elif depth == 8:
            b = img.astype(np.uint8).reshape(h, w * ch)
        else:
            bits = (img[..., :1] >> np.arange(depth - 1, -1, -1)) & 1
            b = np.packbits(bits.astype(np.uint8).reshape(h, w * depth), 1)
        nb = max(1, ch * depth // 8)
        f = png._filter(b.reshape(h, -1, nb), ftype).reshape(h, -1)
        return np.concatenate([np.full((h, 1), ftype, np.uint8), f],
                              1).tobytes()

    h, w = samples.shape[:2]
    if interlace:
        body = b"".join(rows(samples[y0::dy, x0::dx])
                        for x0, y0, dx, dy in png._ADAM7
                        if w > x0 and h > y0)
    else:
        body = rows(samples)
    out = png.SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += png._chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + png._chunk(b"IDAT", zlib.compress(body)) + png._chunk(
        b"IEND", b"")


# (colour type, depth) of every kind PNG allows
KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(3, d) for d in (1, 2, 4, 8)] \
    + [(c, d) for c in (2, 4, 6) for d in (8, 16)]


def _samples(ctype, depth, shape, seed):
    rng = np.random.RandomState(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = rng.randint(0, 2 ** depth, shape + (ch,))
    pal = rng.randint(0, 256, (2 ** depth, 3)) if ctype == 3 else None
    return s, pal


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["rows", "adam7"])
@pytest.mark.parametrize("ctype,depth", KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in KINDS])
def test_every_depth_and_adam7_decode_as_pil_and_cv2(ctype, depth, interlace,
                                                     tmp_path):
    """Sizes from 1x1 (Adam7's empty passes) up, each of the five filters:
    ``decode_pil`` equals PIL's array, ``decode`` PIL's ``convert`` (16-bit
    colour: its high byte; PIL clips 16-bit gray) and cv2's ``imread``."""
    cv2 = pytest.importorskip("cv2")
    for shape in ((1, 1), (3, 5), (17, 13), (23, 41)):
        for ftype in range(5):
            s, pal = _samples(ctype, depth, shape, seed=ftype)
            data = _write(s, depth, ctype, interlace, ftype, pal)
            pil = PIL.Image.open(io.BytesIO(data))
            want = np.array(pil)
            got = png.decode_pil(data)
            assert got.dtype == want.dtype or want.dtype == bool
            np.testing.assert_array_equal(got.reshape(want.shape), want)
            img = png.decode(data)
            if not (ctype == 0 and depth == 16):
                mode = "RGBA" if ctype in (4, 6) else "RGB"
                conv = png.to_rgba(img) if mode == "RGBA" else img
                if conv.dtype == np.uint16:
                    conv = (conv >> 8).astype(np.uint8)
                if conv.shape[-1] == 1:
                    conv = np.repeat(conv, 3, -1)
                np.testing.assert_array_equal(conv,
                                              np.array(pil.convert(mode)))
            path = str(tmp_path / "f.png")
            with open(path, "wb") as f:
                f.write(data)
            np.testing.assert_array_equal(
                images.read_color(path), cv2.imread(path)[..., ::-1])
            unchanged = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(neus._imread_unchanged(path),
                                          unchanged)


PIL_KINDS = ["gray1", "palette1", "palette2", "palette4"]


@pytest.mark.parametrize("kind", PIL_KINDS)
def test_pil_written_sub_byte_files(kind):
    """PIL's own 1-bit gray (mode "1") and ``bits=`` palette files."""
    rng = np.random.RandomState(3)
    buf = io.BytesIO()
    if kind == "gray1":
        PIL.Image.fromarray(rng.rand(19, 27) > 0.5).save(buf, "PNG")
    else:
        bits = int(kind[-1])
        p = PIL.Image.fromarray(rng.randint(0, 2 ** bits, (19, 27)).astype(
            np.uint8), "P")
        p.putpalette(list(rng.randint(0, 256, 3 * 2 ** bits)))
        p.save(buf, "PNG", bits=bits)
    data = buf.getvalue()
    assert data[24] == int(kind[-1])   # IHDR's depth byte
    pil = PIL.Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(png.decode_pil(data)[..., 0],
                                  np.array(pil))
    np.testing.assert_array_equal(png.decode(data) if kind != "gray1"
                                  else np.repeat(png.decode(data), 3, -1),
                                  np.array(pil.convert("RGB")))


READER_KINDS = {   # name: (colour type, depth, interlace)
    "adam7-rgba8": (6, 8, True), "adam7-gray_alpha8": (4, 8, True),
    "gray1": (0, 1, False), "adam7-gray2": (0, 2, True),
    "gray4": (0, 4, False), "palette1": (3, 1, False),
    "adam7-palette4": (3, 4, True), "adam7-palette8": (3, 8, True)}


@pytest.mark.parametrize("kind", list(READER_KINDS))
def test_readers_see_the_jax_readers_libraries(kind, tmp_path):
    """Each port reader's read of an Adam7 or sub-byte frame equals the
    library call of its JAX counterpart on the same file: Blender and
    Colmap ``np.array(PIL.Image.open(p).convert("RGBA"))``, nerfies and a
    DTU scan's images ``np.array(PIL.Image.open(p))``, a DTU scan's masks
    ``imageio.imread``, the ResFields frames, masks and depths and
    ``metrics.eval_all`` ``cv2.imread`` (colour and IMREAD_UNCHANGED)."""
    cv2 = pytest.importorskip("cv2")
    imageio = pytest.importorskip("imageio.v2")
    ctype, depth, interlace = READER_KINDS[kind]
    s, pal = _samples(ctype, depth, (21, 34), seed=5)
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(_write(s, depth, ctype, interlace, 4, pal))
    pil = PIL.Image.open(path)
    rgba = np.array(pil.convert("RGBA"))
    np.testing.assert_array_equal(colmap.read_image_rgba(path), rgba)
    np.testing.assert_array_equal(blender._read_rgba(path),
                                  rgba.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        nerfies._read_image(path),
        np.array(PIL.Image.open(path), np.float32) / 255.0)
    want = np.array(PIL.Image.open(path))
    np.testing.assert_array_equal(images.read_pil(path).reshape(want.shape),
                                  want)
    want = np.array(imageio.imread(path))
    np.testing.assert_array_equal(
        images.read_pil(path, palette=True).reshape(want.shape), want)
    np.testing.assert_array_equal(images.read_color(path),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(neus._imread_unchanged(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
