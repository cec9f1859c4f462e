"""GPU smoke run of the PyTorch port (``splatfields_torch``) on one card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Device: the card's name and power limit; build the blend kernel from
   ``splatfields_torch/csrc`` with nvcc (sm_90a).
2. Kernel vs plain on the card: the serving scene at full width (100,000
   splats from ``create_from_pcd``, VarTriPlane field model from seed 0,
   800x800, tile 16, tile_cap 1024, k_chunk 128, dup_factor 5); the
   kernel and the plain blend on one frame's own blend inputs, plus a
   heavy-overlap early-termination case and a counts > tile_cap case.
3. The slice at full width: 8 orbit frames through
   ``render_lib.render_cameras_batched``; finite outputs, the kernel's
   launch count over that run, ms/frame, the kernel's and the plain
   blend's ms and the kernel's bound.
4. A small frame rendered on the card (kernel) and on the CPU (plain
   blend) with the same weights must agree.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np

N_SPLATS = 100_000
RES = 800
N_FRAMES = 8
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float operations per (pixel, splat) pair: ~20 to evaluate alpha and the
# skip tests (the expf counted as one), 8 more when the splat is applied
OPS_EVALUATED, OPS_APPLIED = 20, 8
# kernel vs plain blend: same alphas, differently associated T products; a
# pixel whose T crosses the 1e-4 stop differently moves by < 1e-4 (times
# z <= ~5 for depth)
TOL = {"color": 2e-4, "depth": 1e-3, "final_t": 2e-4}


@dataclasses.dataclass
class Cam:
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray
    camera_center: np.ndarray
    tanfovx: float
    tanfovy: float
    image_width: int
    image_height: int
    fid: float = 0.0


def make_views(num_views, res, fov=0.8):
    """bench.py's orbit cameras."""
    from splatfields_torch.utils import camera_math as cm
    proj = cm.get_projection_matrix(0.01, 100.0, fov, fov).T
    cams = []
    for v in range(num_views):
        th = 0.25 * v
        c, s = math.cos(th), math.sin(th)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        w2v = cm.get_world2view(R, np.array([0.1 * v, 0, 4.0], np.float32)).T
        cams.append(Cam(w2v, (w2v @ proj).astype(np.float32),
                        np.linalg.inv(w2v.T)[:3, 3].astype(np.float32),
                        math.tan(fov / 2), math.tan(fov / 2), res, res))
    return cams


def cuda_ms(fn, iters):
    """Mean device ms of ``fn`` over ``iters`` calls, after one warm-up."""
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_errs(got, want):
    return {k: float((g - w).abs().max())
            for k, g, w in zip(TOL, got, want)}


def check_close(label, got, want):
    errs = max_errs(got, want)
    print(f"{label}: max abs err {errs}")
    for k, e in errs.items():
        if not e <= TOL[k]:
            raise AssertionError(f"{label}: {k} max abs err {e} > {TOL[k]}")
    return errs


def synthetic_pack(device, rows_per_tile, opacity, tiles_x=8, tiles_y=4,
                   seed=0):
    """Wide splats centred in each tile, ``rows_per_tile`` per tile."""
    import torch
    rng = np.random.RandomState(seed)
    t = tiles_x * tiles_y
    tile = np.repeat(np.arange(t), rows_per_tile)
    d = tile.size
    pack = np.zeros((d, 10), np.float32)
    pack[:, 0] = (tile % tiles_x) * 16 + rng.uniform(0, 16, d)
    pack[:, 1] = (tile // tiles_x) * 16 + rng.uniform(0, 16, d)
    pack[:, 2] = rng.uniform(0.005, 0.05, d)
    pack[:, 3] = rng.uniform(-0.002, 0.002, d)
    pack[:, 4] = rng.uniform(0.005, 0.05, d)
    pack[:, 5] = opacity
    pack[:, 6:9] = rng.rand(d, 3)
    pack[:, 9] = np.tile(np.linspace(0.5, 5.0, rows_per_tile), t)
    tile_start = (np.arange(t + 1) * rows_per_tile).astype(np.int32)
    counts = np.full(t, rows_per_tile, np.int32)
    return ((torch.as_tensor(pack, device=device),
             torch.as_tensor(tile_start, device=device),
             torch.as_tensor(counts, device=device)), tiles_x, tiles_y)


def serving_scene(device=None):
    """The README's serving configuration (``bench.py --render_only``):
    100,000 points uniform in [-0.9, 0.9]^3 from numpy seed 0, splats from
    ``create_from_pcd``, the default VarTriPlane field model from seed 0,
    tile 16 / tile_cap 1024 / k_chunk 128 / dup_factor 5, and the first
    ``N_FRAMES`` orbit cameras at RES x RES."""
    from types import SimpleNamespace

    from splatfields_torch import config
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N_SPLATS, 3)).astype(np.float32)
    cols = rng.rand(N_SPLATS, 3).astype(np.float32)
    params, stats = splats.create_from_pcd(pts, cols, 0, capacity=N_SPLATS,
                                           device=device)
    hidden = config.HiddenConfig(encoder_type="VarTriPlaneEncoder",
                                 composition_rank=0, n_frames=0)
    return SimpleNamespace(
        pts=pts, cols=cols, params=params, stats=stats, hidden=hidden,
        deform=DeformModel(hidden, radius=1.0, seed=0, device=device),
        pipe=config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128),
        bg=np.ones(3, np.float32), cams=make_views(N_FRAMES, RES))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the reference numbers are f32: keep cuDNN convs and matmuls off TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.raster import api, blend_cuda
    from splatfields_torch.ops.raster.blend_cuda import blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        blend_sorted_plain,
        blend_work,
    )
    from splatfields_torch.render_lib import (
        render_camera,
        render_cameras_batched,
    )

    dev = torch.device("cuda")
    # --- 1. device and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    lib_path, build_s = blend_cuda.build()
    print(f"blend_fwd built in {build_s:.2f} s: {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # --- 2. kernel vs plain at the serving shape ---------------------------
    sc = serving_scene()
    params, stats, deform, pipe, bg, cams = (
        sc.params, sc.stats, sc.deform, sc.pipe, sc.bg, sc.cams)

    # the blend's inputs exactly as the serving path hands them over
    captured = []

    def spy(*args):
        captured.append(args)
        return blend_fwd(*args)

    api.blend_fwd = spy
    try:
        render_camera(cams[0], params, stats, deform, pipe, bg)
    finally:
        api.blend_fwd = blend_fwd
    (args,) = captured
    sorted_pack, tile_start, counts = args[:3]
    print(f"blend inputs: sorted_pack {tuple(sorted_pack.shape)}, "
          f"{counts.shape[0]} tiles, max count {int(counts.max())}, "
          f"instances {int(counts.sum())}")
    got = blend_fwd(*args)
    want = blend_sorted_plain(*args)
    torch.cuda.synchronize()
    serving_err = max(check_close("serving frame", got, want).values())

    heavy, tx, ty = synthetic_pack(dev, 600, 0.9)
    got = blend_fwd(*heavy, tx, ty, 16, 1024, 128)
    check_close("early termination", got,
                blend_sorted_plain(*heavy, tx, ty, 16, 1024, 128))
    if not float(got[2].max()) < 1e-2:
        raise AssertionError("early-termination case did not saturate")
    over, tx, ty = synthetic_pack(dev, 1500, 0.005)
    got = blend_fwd(*over, tx, ty, 16, 1024, 128)
    check_close("counts > tile_cap", got,
                blend_sorted_plain(*over, tx, ty, 16, 1024, 128))
    if not float(got[2].min()) > 1e-4:
        raise AssertionError("tile_cap case stopped early: cap untested")

    # --- 3. the slice at full width ---------------------------------------
    torch.cuda.synchronize()
    blend_fwd.launches = 0
    frames = list(render_cameras_batched(cams, params, stats, deform, pipe,
                                         bg))
    torch.cuda.synchronize()
    launches = blend_fwd.launches
    if launches != N_FRAMES:
        raise AssertionError(f"blend_fwd launched {launches} times for "
                             f"{N_FRAMES} frames")
    for i, f in enumerate(frames):
        for key, shape in (("render", (3, RES, RES)), ("depth", (1, RES, RES)),
                           ("opacity", (1, RES, RES))):
            if tuple(f[key].shape) != shape or not bool(
                    torch.isfinite(f[key]).all()):
                raise AssertionError(f"frame {i} {key}: bad shape or values")
    print("n_dropped per frame:", [int(f["n_dropped"]) for f in frames])
    print("mean opacity per frame:",
          [round(float(f["opacity"].mean()), 4) for f in frames])

    def render_all():
        for cam in cams:
            render_camera(cam, params, stats, deform, pipe, bg)

    frame_ms = cuda_ms(render_all, 3) / N_FRAMES
    kernel_ms = cuda_ms(lambda: blend_fwd(*args), 50)
    plain_ms = cuda_ms(lambda: blend_sorted_plain(*args), 5)
    evaluated, applied = blend_work(sorted_pack, tile_start, counts,
                                    args[3], 16, 1024, 128)
    n_tiles, p = counts.shape[0], 16 * 16
    bytes_moved = (sorted_pack.numel() * 4 + (tile_start.numel()
                   + 2 * n_tiles) * 4 + n_tiles * 5 * p * 4)
    ops = OPS_EVALUATED * evaluated + OPS_APPLIED * applied
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    print(f"render ms/frame {frame_ms:.4f} ({RES}x{RES}, {N_SPLATS} splats)")
    print(f"blend work: {evaluated} pairs evaluated, {applied} applied; "
          f"{bytes_moved} bytes; bytes bound {bytes_ms:.5f} ms, ops bound "
          f"{ops_ms:.5f} ms")

    # --- 4. small frame: kernel on the card vs plain blend on the CPU -------
    small_cam = make_views(2, 64)[1]
    out = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        p_, s_ = splats.create_from_pcd(sc.pts[:2000], sc.cols[:2000], 0,
                                        device=device)
        d_ = DeformModel(sc.hidden, radius=1.0, seed=0, device=device)
        out[name] = render_camera(small_cam, p_, s_, d_, pipe, bg)
    if not torch.equal(out["cuda"]["radii"].cpu(), out["cpu"]["radii"]):
        raise AssertionError("small frame: radii differ between card and CPU")
    check_close("small frame, card vs CPU",
                [out["cuda"][k].cpu() for k in ("render", "depth", "opacity")],
                [out["cpu"][k] for k in ("render", "depth", "opacity")])

    kernels = [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "splatfields_torch/csrc/blend_fwd.cu",
        "replaces": "splatfields_tpu/ops/raster/blend_pallas.py:226",
        "launches": launches,
        "max_abs_err": serving_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
