"""Animated GIFs in the port's host library (``native/gif.cpp``): the
render CLI's ``video.gif``, as the JAX CLI writes it when no mp4 encoder
is present (PIL's ``save_all``: 50 ms a frame, ``loop=0``).

``write`` reduces each frame to its own adaptive palette of at most 256
colours (median cut, nearest colour per pixel) and LZW-codes it, frames
in parallel on every core; ``read`` decodes a GIF back to RGB frames, to
check a written file on a machine without PIL.
"""
from __future__ import annotations

import ctypes

import numpy as np

from splatfields_torch import native

DELAY_MS, LOOP = 50, 0   # the JAX CLI's: 50 ms a frame, looping for ever
_P = ctypes.POINTER
_I32 = ctypes.c_int32
_SIGNATURES = {
    "gif_write": ([ctypes.c_char_p, _P(ctypes.c_void_p), _I32, _I32, _I32,
                   _I32, _I32, _I32, ctypes.c_char_p, _I32], ctypes.c_int),
    "gif_info": ([ctypes.c_char_p, ctypes.c_int64, _P(_I32), _P(_I32),
                  _P(_I32), _P(_I32), ctypes.c_char_p, _I32], ctypes.c_int),
    "gif_decode": ([ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_uint8),
                    _P(_I32), ctypes.c_char_p, _I32], ctypes.c_int),
}


def _lib():
    return native.library("gif", _SIGNATURES)


def write(path: str, frames: list):
    """Write uint8 RGB frames, each [H, W, 3] of one size, as an animated
    GIF of ``DELAY_MS`` a frame, looping for ever."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected "
                             f"{(h, w, 3)}")
    ptrs = (ctypes.c_void_p * len(frames))(*[f.ctypes.data for f in frames])
    err = ctypes.create_string_buffer(256)
    if _lib().gif_write(str(path).encode(), ptrs, len(frames), w, h,
                        DELAY_MS, LOOP, 0, err, 256):
        raise OSError(f"{path}: {err.value.decode()}")


def read(path: str):
    """-> (uint8 frames [N, H, W, 3], delays in ms [N], loop count or -1
    without a NETSCAPE2.0 block)."""
    with open(path, "rb") as f:
        return decode(f.read(), path)


def decode(data: bytes, where: str = "GIF data"):
    """``read`` of the file's bytes; ``where`` names it in errors."""
    err = ctypes.create_string_buffer(256)
    n, w, h, loop = (_I32() for _ in range(4))
    lib = _lib()
    if lib.gif_info(data, len(data), ctypes.byref(n), ctypes.byref(w),
                    ctypes.byref(h), ctypes.byref(loop), err, 256):
        raise ValueError(f"{where}: {err.value.decode()}")
    out = np.empty((n.value, h.value, w.value, 3), np.uint8)
    delays = np.empty(n.value, np.int32)
    if lib.gif_decode(data, len(data), out.ctypes.data_as(_P(ctypes.c_uint8)),
                      delays.ctypes.data_as(_P(_I32)), err, 256):
        raise ValueError(f"{where}: {err.value.decode()}")
    return out, delays, loop.value
