"""The port's PNG codec (``splatfields_torch/data/png.py``) against PIL:
seeded images of every colour type written by PIL and by the port's
encoder with each of the five row filters forced, round trips, the
anti-diagonal unfilter against a row-by-row loop, and the synthetic
Blender scene's frames. No JAX."""
import io

import numpy as np
import PIL.Image
import pytest

from splatfields_torch.data import png

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
    # 16-bit grey is read now (the ResFields depth maps); 1-bit is not
    buf = io.BytesIO()
    gray16 = np.arange(16, dtype=np.uint16).reshape(4, 4) * 4099
    PIL.Image.fromarray(gray16).save(buf, "PNG")
    np.testing.assert_array_equal(png.decode(buf.getvalue())[..., 0], gray16)
    buf = io.BytesIO()
    PIL.Image.fromarray(np.zeros((4, 4), bool)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth"):
        png.decode(buf.getvalue())
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
