"""PNG codec on ``zlib`` and NumPy (no counterpart in the JAX package,
which reads and writes images through PIL and cv2; the GPU machine has
neither).

Decoding takes the five colour types (gray, gray+alpha, RGB, RGBA,
palette, with a ``tRNS`` chunk) at every bit depth PNG allows (1, 2, 4
and 8 for gray and palette, 8 and 16 for the rest), non-interlaced or
Adam7-interlaced, and all five row filters. Each of the seven Adam7
passes is a small image of its own, unfiltered alone and scattered to
its pixels; samples under 8 bits are unpacked with ``np.unpackbits``. A
file whose rows use only None, Sub and Up unfilters row by row with
vector ops (Sub as a cumulative sum mod 256 along the row). Average and
Paeth depend on the reconstructed pixel to the left, so a file with such
rows unfilters along anti-diagonals: every pixel of diagonal y + x = d
depends only on diagonals d - 1 and d - 2, so H + W - 1 vector steps
rebuild the image, each row with its own filter.

The readers see a file as the library their JAX counterpart calls sees
it. ``decode`` is libpng's expansion, what cv2's ``imread`` and PIL's
``convert`` give: gray under 8 bits scaled to 0-255, a palette looked
up, ``tRNS`` as alpha, 16 bits as uint16 (what ``cv2.imread(...,
IMREAD_UNCHANGED)`` gives for a 16-bit depth map, channels in the file's
order). ``decode_pil`` is ``np.array(PIL.Image.open(p))``: palette
indices, 1-bit gray as 0 / 1, 2- and 4-bit gray scaled, no ``tRNS``,
16-bit colour to its high byte (gray+alpha as RGBA).

Encoding takes uint8 (bit depth 8) or uint16 (bit depth 16) images,
writes one filter for every row (0, None, by default; the others exist so
tests can exercise the decoder) and no ancillary chunks. A filter works on
bytes, so a 16-bit pixel is two bytes per channel: the rows are filtered
as 8-bit rows of twice the channels.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """None / Sub / Up rows, one vector op each: raw [H, W, C] uint8."""
    out = np.empty_like(raw)
    prev = np.zeros_like(raw[0])
    for y in range(raw.shape[0]):
        f = ftype[y]
        if f == 0:
            out[y] = raw[y]
        elif f == 1:
            out[y] = np.cumsum(raw[y], axis=0, dtype=np.uint8)
        else:  # f == 2
            out[y] = raw[y] + prev
        prev = out[y]
    return out


def _unfilter_diagonal(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any filters, one anti-diagonal at a time."""
    h, w, _ = raw.shape
    rec = np.zeros((h + 1, w + 1, raw.shape[2]), np.int32)  # zero pad row/col
    rawi = raw.astype(np.int32)
    fy = ftype.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a = rec[y + 1, x]        # left
        b = rec[y, x + 1]        # up
        c = rec[y, x]            # up-left
        f = fy[y][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        rec[y + 1, x + 1] = (rawi[y, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


# Adam7's passes: (x0, y0, dx, dy) of each pass's pixels
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Filtered rows [h, 1 + row bytes] -> samples [h, w, ch] at the
    file's depth (uint8 under 16 bits, values unscaled)."""
    h = rows.shape[0]
    nb = max(1, ch * depth // 8)   # the filters' left neighbour, in bytes
    ftype, raw = rows[:, 0], rows[:, 1:].reshape(h, -1, nb)
    if ftype.max(initial=0) > 4:
        raise ValueError("bad PNG row filter")
    unfilter = _unfilter_rows if ftype.max(initial=0) <= 2 \
        else _unfilter_diagonal
    img = unfilter(raw, ftype).reshape(h, -1)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        bits = np.unpackbits(img, axis=1)[:, :w * depth].reshape(h, w, depth)
        img = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)
    return img.reshape(h, w, ch)


class Raw:
    """A PNG's samples at its own depth ([H, W, C], uint8 or uint16, not
    scaled), its colour type, depth, palette [N, 3] and ``tRNS`` bytes."""

    def __init__(self, data: bytes):
        if data[:8] != SIGNATURE:
            raise ValueError("not a PNG file")
        pos, idat, self.palette, self.trns, hdr = 8, [], None, None, None
        while pos < len(data):
            (length,) = struct.unpack(">I", data[pos:pos + 4])
            kind = data[pos + 4:pos + 8]
            body = data[pos + 8:pos + 8 + length]
            pos += 12 + length
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"tRNS":
                self.trns = body
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        if hdr is None:
            raise ValueError("PNG without IHDR")
        w, h, depth, ctype, _, _, interlace = hdr
        depths = (1, 2, 4, 8, 16) if ctype == 0 else (
            (1, 2, 4, 8) if ctype == 3 else (8, 16))
        if ctype not in _CHANNELS or depth not in depths or interlace > 1:
            raise ValueError(f"bad PNG header: bit depth {depth}, colour "
                             f"type {ctype}, interlace {interlace}")
        self.ctype, self.depth = ctype, depth
        ch = _CHANNELS[ctype]
        stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
        self.samples = np.zeros((h, w, ch), np.uint16 if depth == 16
                                else np.uint8)
        pos = 0
        for x0, y0, dx, dy in passes:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue   # an empty pass has no bytes, not even filters
            n = ph * (1 + (pw * ch * depth + 7) // 8)
            if pos + n > len(stream):
                raise ValueError("truncated PNG image data")
            rows = stream[pos:pos + n].reshape(ph, -1)
            self.samples[y0::dy, x0::dx] = _unfilter(rows, pw, ch, depth)
            pos += n


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] (uint16 at bit depth 16): C = 1 (gray),
    2 (gray+alpha), 3 (RGB) or 4 (RGBA); gray under 8 bits scaled to
    0-255; a palette image comes back as RGB, or RGBA when it has a
    ``tRNS`` chunk; gray or RGB with ``tRNS`` gains an alpha channel."""
    return _expand(Raw(data))


def _expand(raw: Raw) -> np.ndarray:
    """``decode``'s expansion of a parsed file."""
    img, ctype, trns = raw.samples, raw.ctype, raw.trns
    if ctype == 3:
        idx = img[..., 0]
        rgb = raw.palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    clear = None
    if trns is not None and ctype in (0, 2):
        key = np.array(struct.unpack(f">{img.shape[-1]}H", trns), np.uint16)
        clear = (img == key).all(-1)
    if raw.depth < 8:   # libpng's expansion: the bits repeated
        img = img * np.uint8(255 // (2 ** raw.depth - 1))
    if clear is not None:
        alpha = np.where(clear, 0, np.iinfo(img.dtype).max)
        img = np.concatenate([img, alpha.astype(img.dtype)[..., None]], -1)
    return img


def decode_pil(data: bytes, palette: bool = False) -> np.ndarray:
    """PNG bytes -> [H, W, C] as ``np.array(PIL.Image.open(...))`` gives
    it (one channel kept): palette indices (uint8), 1-bit gray as 0 / 1,
    2- and 4-bit gray scaled to 0-255, 16-bit gray as uint16, 16-bit
    colour to its high byte (gray+alpha as RGBA), ``tRNS`` ignored. With
    ``palette``, a palette image as RGB, as imageio's PIL plugin gives
    it."""
    raw = Raw(data)
    img = raw.samples
    if raw.ctype == 3 and palette:
        return raw.palette[img[..., 0]]
    if raw.ctype == 3 or raw.depth == 1:
        return img
    if raw.depth < 8:
        return img * np.uint8(255 // (2 ** raw.depth - 1))
    if raw.depth == 16 and raw.ctype != 0:
        img = (img >> 8).astype(np.uint8)
        if raw.ctype == 4:   # PIL opens 16-bit gray+alpha as RGBA
            img = img[..., [0, 0, 0, 1]]
    return img


def decode_rgba(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 RGBA [H, W, 4] as PIL's ``convert("RGBA")`` gives
    it: below 16 bits ``decode``'s expansion (``tRNS`` as alpha), but for
    2- and 4-bit gray PIL holds the unscaled key against the scaled
    samples; at 16 bits ``tRNS`` ignored, gray clipped at 255 and every
    other sample (gray+alpha, RGB, RGBA) to its high byte."""
    raw = Raw(data)
    if raw.depth != 16:
        img = _expand(raw)
        if raw.ctype == 0 and raw.depth in (2, 4) and raw.trns is not None:
            key = struct.unpack(">H", raw.trns[:2])[0]
            img[..., 1] = np.where(img[..., 0] == key, 0, 255)
        return to_rgba(img)
    img = raw.samples
    img = np.minimum(img, 255) if raw.ctype == 0 else img >> 8
    return to_rgba(img.astype(np.uint8))


def to_rgba(img: np.ndarray) -> np.ndarray:
    """A decoded image as RGBA, as PIL's ``convert("RGBA")`` gives it."""
    ch = img.shape[-1]
    if ch == 4:
        return img
    if ch == 3:
        return np.concatenate([img, np.full_like(img[..., :1], 255)], -1)
    gray = np.repeat(img[..., :1], 3, -1)
    alpha = img[..., 1:] if ch == 2 else np.full_like(img[..., :1], 255)
    return np.concatenate([gray, alpha], -1)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter(img: np.ndarray, ftype: int) -> np.ndarray:
    """Filtered bytes of every row with one filter: [H, W, C] uint8."""
    if ftype == 0:
        return img
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = {1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 255).astype(np.uint8)


def encode(img: np.ndarray, ftype: int = 0, level: int = 6) -> bytes:
    """uint8 or uint16 [H, W] or [H, W, C] (C = 1, 2, 3, 4) -> PNG bytes
    at bit depth 8 or 16, every row with filter ``ftype`` (0-4), zlib
    level ``level``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG encode takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    if depth == 16:     # big-endian samples, filtered as bytes
        img = img.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
    nb = img.shape[2]
    rows = np.empty((h, w * nb + 1), np.uint8)
    rows[:, 0] = ftype
    rows[:, 1:] = _filter(img, ftype).reshape(h, w * nb)
    return b"".join((
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                    0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)),
        _chunk(b"IEND", b"")))


def write(path: str, img: np.ndarray, ftype: int = 0, level: int = 6):
    with open(path, "wb") as f:
        f.write(encode(img, ftype, level))
