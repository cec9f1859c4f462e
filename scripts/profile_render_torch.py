"""Where the time of one served frame goes, for the PyTorch port on a GPU.

    python3 scripts/profile_render_torch.py

Renders chip_smoke.py's serving scene (100,000 splats, VarTriPlane field,
800x800, 8 orbit frames) and prints:

1. per stage of ``render_camera``, the stream time between CUDA events
   placed at the stage boundaries, summed over the frames (it includes any
   time the GPU waits for the host inside the stage);
2. the wall time of the frames without the profiler, and from
   ``torch.profiler`` the device-side events (kernels, copies) by self
   time; their sum over that wall time gives the GPU's idle share.

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def staged_frame(cam, sc, mark):
    """render_camera's field-mode path, with ``mark(name)`` after each
    stage (same calls as render_lib.render_camera and api.rasterize)."""
    import numpy as np
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats as splats_lib
    from splatfields_torch.ops.raster.binning import bin_gaussians
    from splatfields_torch.ops.raster.blend_cuda import blend_fwd
    from splatfields_torch.ops.raster.blend_torch import (
        pack_attributes,
        tiles_to_image,
    )
    from splatfields_torch.ops.raster.preprocess import preprocess
    from splatfields_torch.render_lib import _f32

    dev, pipe = sc.params.xyz.device, sc.pipe
    w = h = cam.image_width
    mark("start")
    attrs = train_lib.field_attributes(
        sc.deform.net, sc.params.xyz, splats_lib.get_scaling(sc.params),
        sc.stats.valid, 0.0, 0)
    mark("field")
    pre = preprocess(
        attrs["means3d"], attrs["scales"], attrs["rotations"],
        attrs["opacity"], _f32(cam.world_view_transform, dev),
        _f32(cam.full_proj_transform, dev), w, h,
        float(np.float32(cam.tanfovx)), float(np.float32(cam.tanfovy)),
        colors_precomp=attrs["rgb"], valid_mask=attrs["valid"])
    mark("preprocess")
    tx = ty = -(-w // pipe.tile_size)
    b = bin_gaussians(pre.means2d, pre.depths, pre.radii, tx, ty,
                      pipe.tile_size,
                      dup_cap=pipe.dup_factor * attrs["means3d"].shape[0])
    mark("binning")
    pack = pack_attributes(pre.means2d, pre.conics, pre.rgb, pre.opacity,
                           pre.depths)
    sorted_pack = pack[torch.clamp_min(b.sorted_id, 0).to(torch.int64)]
    mark("pack_gather")
    color_t, depth_t, tfinal_t = blend_fwd(
        sorted_pack, b.tile_start, b.counts, tx, ty, pipe.tile_size,
        pipe.tile_cap, pipe.k_chunk)
    mark("blend_kernel")
    color = tiles_to_image(color_t.transpose(1, 2), tx, ty, pipe.tile_size,
                           h, w)
    final_t = tiles_to_image(tfinal_t, tx, ty, pipe.tile_size, h, w)
    tiles_to_image(depth_t, tx, ty, pipe.tile_size, h, w)
    color + final_t[..., None] * _f32(sc.bg, dev)[None, None, :]
    mark("compose")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_render_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import serving_scene
    from splatfields_torch.render_lib import render_camera

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    sc = serving_scene()
    with torch.no_grad():
        for cam in sc.cams[:2]:
            render_camera(cam, sc.params, sc.stats, sc.deform, sc.pipe, sc.bg)
        torch.cuda.synchronize()

        # 1. stages
        stage_ms = {}
        for cam in sc.cams:
            events = []

            def mark(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            staged_frame(cam, sc, mark)
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(events, events[1:]):
                stage_ms[name] = stage_ms.get(name, 0.0) + a.elapsed_time(b)
        n = len(sc.cams)
        print("stage ms/frame:", json.dumps(
            {k: v / n for k, v in stage_ms.items()}))
        print(f"sum of stages ms/frame: {sum(stage_ms.values()) / n:.4f}")

        # 2. wall time without the profiler, then the profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for cam in sc.cams:
            render_camera(cam, sc.params, sc.stats, sc.deform, sc.pipe, sc.bg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for cam in sc.cams:
                render_camera(cam, sc.params, sc.stats, sc.deform, sc.pipe,
                              sc.bg)
            torch.cuda.synchronize()
    # device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"{n} frames: wall {wall_ms:.4f} ms without the profiler, GPU "
          f"busy {busy_ms:.4f} ms (kernels and copies, profiled run), GPU "
          f"idle share {1 - busy_ms / wall_ms:.4f}")
    print("top device events by self time (ms over the frames, calls):")
    for dev_us, count, key in rows[:25]:
        print(f"  {dev_us / 1e3:10.4f}  {count:6d}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
