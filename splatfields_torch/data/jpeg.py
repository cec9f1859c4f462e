"""JPEG decoding for the readers, in the port's host library
(``native/jpeg.cpp``).

``decode`` gives what PIL's ``np.array(Image.open(p))`` (and cv2, which
shares libjpeg-turbo's defaults) gives, pixel for pixel: 8-bit Huffman
frames, sequential (SOF0 / SOF1) or progressive (SOF2, with
libjpeg-turbo's block smoothing of a file whose scans leave coefficients
incomplete); 1 component, or 3 as YCbCr or RGB (an Adobe marker with
transform 0, or ids R, G, B without JFIF / Adobe markers); sampling
factors 1-4 with integral ratios (4:1:1 included), restart intervals;
the ISLOW IDCT, fancy upsampling and the YCbCr tables of libjpeg-turbo.
CMYK / YCCK, arithmetic-coded, 12-bit, lossless and hierarchical files
raise NotImplementedError naming the file and the marker.
"""
from __future__ import annotations

import ctypes

import numpy as np

from splatfields_torch import native

SIGNATURE = b"\xff\xd8\xff"

_P = ctypes.POINTER
_SIGNATURES = {
    "jpeg_header": ([ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_int32),
                     _P(ctypes.c_int32), _P(ctypes.c_int32), ctypes.c_char_p,
                     ctypes.c_int32], ctypes.c_int),
    "jpeg_decode": ([ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_uint8),
                     ctypes.c_char_p, ctypes.c_int32], ctypes.c_int),
}


def _raise(status: int, err, where: str):
    msg = f"{where}: {err.value.decode()}"
    raise NotImplementedError(msg) if status == 1 else ValueError(msg)


def decode(data: bytes, where: str = "JPEG data") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, C], C = 1 (grayscale) or 3 (RGB).
    ``where`` names the source in errors."""
    lib = native.library("jpeg", _SIGNATURES)
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    status = lib.jpeg_header(data, len(data), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(c), err, 256)
    if status:
        _raise(status, err, where)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    status = lib.jpeg_decode(data, len(data), out.ctypes.data_as(
        _P(ctypes.c_uint8)), err, 256)
    if status:
        _raise(status, err, where)
    return out
