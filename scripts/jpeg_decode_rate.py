"""The host JPEG decoder's rate (``splatfields_torch/native/jpeg.cpp``)
against another checkout's, in one call:

    python3 scripts/jpeg_decode_rate.py --parent DIR

The frames are 20 of ``chip_smoke.encode_jpeg``'s files at phase 37's
capture size (800x600, quality 90, 4:2:0) of seeded smooth ramps with
noise, each baseline and as its progressive twin (the same coefficients;
``JPEG_SIMPLE_PROGRESSION``). Each decoder is built with ``g++`` as
``native.library`` builds it, into ``build/jpeg_decode_rate/``, and the
versions decode each frame in turns (parent, this checkout, this
checkout, parent), frame after frame, for 5 rounds; the parent decodes
the baseline frames only. Prints one JSON line: the host's core count,
the card's name and power limit where ``nvidia-smi`` answers, and ms a
megapixel of each version and kind (the median over rounds), and checks
that every version and kind decodes each frame to the same pixels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def build(src: pathlib.Path, name: str) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from splatfields_torch import native
    out = ROOT / "build" / "jpeg_decode_rate" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", *native.GXX_FLAGS, str(src), "-o", str(out)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    from splatfields_torch.data.jpeg import _SIGNATURES
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def decode(lib, data: bytes):
    import numpy as np
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.jpeg_header(data, len(data), ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(c), err, 256):
        raise RuntimeError(err.value.decode())
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), err, 256):
        raise RuntimeError(err.value.decode())
    return out


FRAMES = 20
SIZE = (800, 600)   # width, height: phase 37's capture
ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="another checkout's root")
    args = ap.parse_args()
    import numpy as np
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    w, h = SIZE
    y, x = np.mgrid[0:h, 0:w]
    frames = {"baseline": [], "progressive": []}
    for i in range(FRAMES):
        img = np.stack([np.sin(x / (5.0 + i)) * 100 + 128,
                        np.cos(y / 7.0) * 100 + 128, (x + y + i) % 256], -1)
        img = img + np.random.RandomState(i).randn(h, w, 3) * 4.0
        img = np.clip(img, 0, 255).astype(np.uint8)
        frames["baseline"].append(cs.encode_jpeg(img, 90))
        frames["progressive"].append(
            cs.encode_jpeg(img, 90, scans=cs.JPEG_SIMPLE_PROGRESSION))
    libs = {"change": build(ROOT / "splatfields_torch" / "native" /
                            "jpeg.cpp", "change"),
            "parent": build(pathlib.Path(args.parent) / "splatfields_torch"
                            / "native" / "jpeg.cpp", "parent")}
    order = ["parent", "change", "change", "parent"]
    kinds = [(v, k) for v in libs for k in frames
             if not (v == "parent" and k == "progressive")]  # refused there
    # seconds [round, frame] of each (version, kind), its decodes in turns
    # frame by frame, so a drift of the host's speed falls on all alike
    runs = {vk: np.zeros((ROUNDS, FRAMES)) for vk in kinds}
    for r in range(ROUNDS):
        for i in range(FRAMES):
            ref = None
            for v in order:
                for kind in frames:
                    if (v, kind) not in runs:
                        continue
                    t0 = time.perf_counter()
                    pix = decode(libs[v], frames[kind][i])
                    runs[(v, kind)][r, i] += time.perf_counter() - t0
                    ref = pix if ref is None else ref
                    if not np.array_equal(pix, ref):
                        raise AssertionError(f"{v} {kind}: other pixels")
    mpix = FRAMES * w * h / 1e6
    per = order.count("change")   # each version's decodes a frame a round
    rate = {f"{v} {k}": float(np.median(s.sum(1))) / per * 1e3 / mpix
            for (v, k), s in runs.items()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    print(json.dumps({"host_cores": os.cpu_count(), "card": smi,
                      "frames": FRAMES, "size": f"{w}x{h}",
                      "ms_per_megapixel": rate}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
