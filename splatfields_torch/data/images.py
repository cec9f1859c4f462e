"""Image files by their first bytes, as PIL and cv2 choose a decoder:
the PNG signature goes to ``data/png.py``, ``FF D8 FF`` to the JPEG
decoder (``data/jpeg.py``); anything else raises NotImplementedError
naming the file, whatever its extension. ``read`` and ``read_color``
give what cv2's ``imread`` and PIL's ``convert`` see, ``read_rgba`` what
PIL's ``convert("RGBA")`` gives, ``read_pil`` what
``np.array(PIL.Image.open(path))`` holds."""
from __future__ import annotations

import numpy as np

from splatfields_torch.data import jpeg, png


def decode(data: bytes, where: str = "image data") -> np.ndarray:
    """PNG or JPEG bytes -> [H, W, C] as the format's decoder gives it
    (PNG: uint8, or uint16 at 16 bits, C = 1-4; JPEG: uint8, C = 1 or
    3)."""
    if data[:8] == png.SIGNATURE:
        return png.decode(data)
    if data[:3] == jpeg.SIGNATURE:
        return jpeg.decode(data, where)
    raise NotImplementedError(f"{where}: neither a PNG nor a JPEG file "
                              "(only these formats are read)")


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read(), path)


def read_pil(path: str, palette: bool = False) -> np.ndarray:
    """[H, W, C] as ``np.array(PIL.Image.open(path))`` holds it: a PNG by
    ``png.decode_pil`` (palette indices, 1-bit gray as 0 / 1; ``palette``:
    looked up, as imageio gives it), a JPEG as ``read``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == png.SIGNATURE:
        return png.decode_pil(data, palette)
    return decode(data, path)


def read_color(path: str) -> np.ndarray:
    """uint8 RGB [H, W, 3] as ``cv2.imread(path)[..., ::-1]`` gives it:
    grey replicated, alpha dropped, 16-bit samples to their high byte."""
    img = read(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[-1] <= 2:
        return np.repeat(img[..., :1], 3, -1)
    return img[..., :3]


def read_rgba(path: str) -> np.ndarray:
    """uint8 RGBA [H, W, 4] as ``PIL.Image.open(path).convert("RGBA")``
    gives it: a PNG by ``png.decode_rgba`` (16-bit gray clipped at 255,
    other 16-bit samples to their high byte), a JPEG with alpha 255. Its
    first three channels are ``convert("RGB")``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == png.SIGNATURE:
        return png.decode_rgba(data)
    return png.to_rgba(decode(data, path))
