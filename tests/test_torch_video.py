"""The render CLI's ``video.gif`` writer and reader (``native/gif.cpp``,
``data/gif.py``) against PIL on the CPU.

PIL reads the port's file back with the right frame count, size, 50 ms
a frame and ``loop`` 0; each frame's mean absolute error against its
source (levels a channel) is at most PIL's own GIF's error on the same
frames plus 1.0, and at most ``chip_smoke.fixed_palette_mae`` (the bound
the card's phase 38 holds, where PIL is absent). A frame of 256 colours
or fewer comes back exactly. ``gif.read``, the card's reader, decodes the
port's and PIL's files exactly as PIL does, delays and loop count
included.
"""
import io

import numpy as np
import pytest

import chip_smoke
from splatfields_torch.data import gif

PIL = pytest.importorskip("PIL.Image")
MAE_OVER_PIL = 1.0


def _frames():
    """Render-like frames (smooth colour over a white background), one
    with noise, one 160x120 so that the LZW table fills and restarts."""
    out = []
    for t in range(5):
        y, x = np.mgrid[0:54, 0:96]
        a = np.stack([np.sin(x / 9.0 + t) * 100 + 128,
                      np.cos(y / 13.0 - t) * 100 + 128, (x + y + 10 * t) % 256],
                     -1)
        inside = ((x - 48) ** 2 + (y - 27) ** 2 < 18 ** 2)[..., None]
        a = np.where(inside, a, 255.0)
        if t == 4:
            a = a + np.random.RandomState(t).randn(*a.shape) * 3
        out.append(np.clip(a, 0, 255).astype(np.uint8))
    return out


def _pil_frames(data):
    im = PIL.open(io.BytesIO(data))
    frames, delays = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.array(im.convert("RGB")))
        delays.append(im.info.get("duration"))
    return im, np.stack(frames), delays


def _mae(a, b):
    return np.abs(a.astype(np.int64) - b).mean(axis=(1, 2, 3))


def test_gif_reads_back_in_pil(tmp_path):
    frames = _frames()
    path = tmp_path / "video.gif"
    gif.write(str(path), frames)
    im, got, delays = _pil_frames(path.read_bytes())
    assert im.n_frames == len(frames) and im.size == (96, 54)
    assert delays == [50] * len(frames) and im.info["loop"] == 0
    ims = [PIL.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "GIF", save_all=True, append_images=ims[1:],
                duration=50, loop=0)
    _, pil, _ = _pil_frames(buf.getvalue())
    src = np.stack(frames)
    assert (_mae(got, src) <= _mae(pil, src) + MAE_OVER_PIL).all()
    assert (_mae(got, src) <= [chip_smoke.fixed_palette_mae(f)
                               for f in frames]).all()
    # the card's reader: PIL's decode of both files, delays and loop
    for data_path, want in ((path, got), (None, pil)):
        if data_path is None:
            data_path = tmp_path / "pil.gif"
            data_path.write_bytes(buf.getvalue())
        frames_r, delays_r, loop = gif.read(str(data_path))
        np.testing.assert_array_equal(frames_r, want)
        assert list(delays_r) == [50] * len(frames) and loop == 0


def test_large_frame_and_few_colours(tmp_path):
    rng = np.random.RandomState(1)
    noisy = rng.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    few = rng.randint(0, 256, (200, 3)).astype(np.uint8)[
        rng.randint(0, 200, (120, 160))]
    path = tmp_path / "v.gif"
    gif.write(str(path), [noisy, few])
    _, got, _ = _pil_frames(path.read_bytes())
    np.testing.assert_array_equal(got[1], few)     # 200 colours: exact
    np.testing.assert_array_equal(gif.read(str(path))[0], got)
    assert _mae(got[:1], noisy[None])[0] <= chip_smoke.fixed_palette_mae(
        noisy)


def test_write_refuses_mixed_sizes(tmp_path):
    with pytest.raises(ValueError, match="shape"):
        gif.write(str(tmp_path / "x.gif"), [np.zeros((4, 4, 3), np.uint8),
                                           np.zeros((4, 5, 3), np.uint8)])
    with pytest.raises(ValueError, match="no frames"):
        gif.write(str(tmp_path / "x.gif"), [])
