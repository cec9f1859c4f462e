"""Where the time of one served frame, or of one training step, goes, for
the PyTorch port on a GPU.

    python3 scripts/profile_render_torch.py           # serving frames
    python3 scripts/profile_render_torch.py --train   # training steps
    python3 scripts/profile_render_torch.py --train --variant ngp
    python3 scripts/profile_render_torch.py --train --fused

Serving: chip_smoke.py's serving scene (100,000 splats, VarTriPlane field,
800x800, 8 orbit frames). Training: chip_smoke.py's phase-6 step on the
same scene (one view per step, bench.py's loss and learning rates), 8
steps. ``--variant ngp`` swaps in bench.py --variant ngp's NGPMLP field
(chip_smoke.py phase 9). Prints:

1. per stage, the stream time between CUDA events placed at the stage
   boundaries, summed over the frames or steps (it includes any time the
   GPU waits for the host inside the stage). Serving stages follow
   ``render_camera``; training stages follow ``make_train_step``: field
   forward, render forward, loss, render + loss backward (with the blend
   backward kernel), field backward, the two Adam updates and the stats.
   With ``--variant ngp`` the field forward splits into the hash encode
   and the rest (NGP MLP, refiners, heads), and the field backward into
   the table VJP's sort + payload gather, the segment-sum kernel and the
   rest. ``--fused`` runs the heads through the fused CUDA kernels
   (``fused_pallas="on"``, bf16); in training the field forward and
   backward then split into the fused kernels' calls (both plans summed)
   and the rest ("field_fwd" and "field_bwd" are then what follows the
   last fused call);
2. the wall time without the profiler, and from ``torch.profiler`` the
   device-side events (kernels, copies) by self time; their sum over that
   wall time gives the GPU's idle share.

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def staged_frame(cam, sc, deform, mark):
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
        deform.net, sc.params.xyz, splats_lib.get_scaling(sc.params),
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


@contextlib.contextmanager
def ngp_marks(deform, mark):
    """Marks inside the NGP field: after the hash encode's forward, and
    around the table VJP's sort + payload gather and its segment sum."""
    from splatfields_torch.models import encoders
    sort_rows, segsum = encoders._sort_rows, encoders.sorted_segment_sum

    def sort_spy(*args):
        mark("field_bwd_rest")
        out = sort_rows(*args)
        mark("table_sort_gather")
        return out

    def segsum_spy(*args):
        out = segsum(*args)
        mark("segsum_kernel")
        return out

    handle = deform.net.encoder.encoding.register_forward_hook(
        lambda *_: mark("hash_encode_fwd"))
    encoders._sort_rows, encoders.sorted_segment_sum = sort_spy, segsum_spy
    try:
        yield
    finally:
        handle.remove()
        encoders._sort_rows, encoders.sorted_segment_sum = sort_rows, segsum


@contextlib.contextmanager
def fused_marks(mark):
    """Marks around each fused forward call (the kernel and its output
    allocation) and each fused backward (its three kernels: the backward,
    fused_mlp_dw and the reduction)."""
    import splatfields_torch.models.splatfields as sfm
    from splatfields_torch.ops import fused_mlp as fm
    fwd, bwd = sfm.fused_heads, fm.fused_heads_bwd

    def fwd_spy(*args):
        mark("field_fwd_before_fused")
        out = fwd(*args)
        mark("fused_fwd_kernel")
        return out

    def bwd_spy(*args):
        mark("field_bwd_before_fused")
        out = bwd(*args)
        mark("fused_bwd_kernel")
        return out

    # the wrappers count through their module-level names
    bwd_spy.launches = fm.fused_heads_bwd.launches
    sfm.fused_heads, fm.fused_heads_bwd = fwd_spy, bwd_spy
    try:
        yield
    finally:
        sfm.fused_heads, fm.fused_heads_bwd = fwd, bwd


def staged_train_step(sc, deform, ngp, state, batch, lrs, field_lr, mark):
    """make_train_step's field-mode body for one view (same calls), with
    ``mark(name)`` after each stage. The backward is one call, as in the
    step; hooks on the field's outputs record when their gradients are
    complete, which ends the render + loss backward (the autograd engine
    runs the later-created render nodes first)."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats as splats_lib
    sp, st, sopt, fp, fopt = state
    mark("start")
    fp_l = {k: v.detach().requires_grad_(True) for k, v in fp.items()}
    attrs = train_lib.field_attributes(
        deform.net, sp.xyz, splats_lib.get_scaling(sp), st.valid, 0.0, 0,
        params=fp_l)
    mark("heads" if ngp else "field_fwd")
    offset = torch.zeros(sp.capacity, 2, device=sp.xyz.device,
                         requires_grad=True)
    cam = {k: batch[k][0] for k in ("viewmatrix", "projmatrix", "campos",
                                    "tanfovx", "tanfovy")}
    res = batch["image"].shape[-1]
    out = train_lib.render_view(attrs, cam, batch["bg"], res, res, 0,
                                sc.pipe, screenspace_offset=offset)
    mark("render_fwd")
    opt = config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01)
    loss, _ = train_lib.compute_losses([out], batch, attrs, opt, st.valid)
    mark("loss_fwd")
    for k in ("means3d", "opacity", "scales", "rotations", "rgb"):
        attrs[k].register_hook(lambda _: mark("render_loss_bwd"))
    *g_fp, g_off = torch.autograd.grad(loss, list(fp_l.values()) + [offset],
                                       allow_unused=True)
    mark("field_bwd_rest" if ngp else "field_bwd")
    g_fp = {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(fp_l.items(), g_fp)}
    sp, sopt = splats_lib.adam_update(
        sp, splats_lib.tree_map(torch.zeros_like, sp), sopt, lrs)
    fp, fopt = splats_lib.adam_update(fp, g_fp, fopt, field_lr)
    st = splats_lib.add_densification_stats(
        splats_lib.update_max_radii(st, out.radii), g_off, out.radii)
    mark("adam_stats")
    return sp, st, sopt, fp, fopt


def profile_train(sc, deform, ngp: bool, fused: bool) -> None:
    import numpy as np
    import torch

    from chip_smoke import (
        FIELD_LR,
        RES,
        SPLAT_LRS,
        make_views,
        train_batch,
        train_step_fn,
    )
    from splatfields_torch.models import splats as splats_lib
    step = train_step_fn(deform, sc.pipe, RES)
    lrs = splats_lib.splat_lr_tree(*SPLAT_LRS)
    rng = np.random.RandomState(0)
    batches = [train_batch(c, rng, sc.params.xyz.device)
               for c in make_views(10, RES)]
    state = (sc.params, sc.stats, splats_lib.adam_init(sc.params),
             deform.params, deform.opt_state)

    def run(bs, state):
        for b in bs:
            sp, st, sopt, fp, fopt, _ = step(*state, b, lrs, FIELD_LR)
            state = (sp, st, sopt, fp, fopt)
        return state

    state = run(batches[:2], state)       # warm-up
    torch.cuda.synchronize()
    stage_ms = {}
    for b in batches[2:]:
        events = []

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        with contextlib.ExitStack() as marks:
            if ngp:
                marks.enter_context(ngp_marks(deform, mark))
            if fused:
                marks.enter_context(fused_marks(mark))
            state = staged_train_step(sc, deform, ngp, state, b, lrs,
                                      FIELD_LR, mark)
        torch.cuda.synchronize()
        for (_, a), (name, e) in zip(events, events[1:]):
            stage_ms[name] = stage_ms.get(name, 0.0) + a.elapsed_time(e)
    n = len(batches) - 2
    print("train stage ms/step:", json.dumps(
        {k: v / n for k, v in stage_ms.items()}))
    print(f"sum of stages ms/step: {sum(stage_ms.values()) / n:.4f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(batches[2:], state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(batches[2:], state)
        torch.cuda.synchronize()
    report(prof, wall_ms, n, "steps")


def report(prof, wall_ms, n, unit) -> None:
    """The device-side events of a profiled run: busy and idle share,
    top events by self time."""
    import torch
    # device-side events only (kernels, copies): an aten op's row repeats
    # the device time of the kernels it launched
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"{n} {unit}: wall {wall_ms:.4f} ms without the profiler, GPU "
          f"busy {busy_ms:.4f} ms (kernels and copies, profiled run), GPU "
          f"idle share {1 - busy_ms / wall_ms:.4f}")
    print(f"top device events by self time (ms over the {unit}, calls):")
    for dev_us, count, key in rows[:25]:
        print(f"  {dev_us / 1e3:10.4f}  {count:6d}  {key[:110]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_render_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import ngp_model, serving_scene
    from splatfields_torch.render_lib import render_camera

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of served frames")
    ap.add_argument("--variant", choices=("field", "ngp"), default="field",
                    help="the field model: VarTriPlane (bench.py's default) "
                         "or NGPMLP (bench.py --variant ngp)")
    ap.add_argument("--fused", action="store_true",
                    help='the heads through the fused CUDA kernels '
                         '(fused_pallas="on", bf16)')
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    sc = serving_scene()
    deform = ngp_model() if args.variant == "ngp" else sc.deform
    if args.fused:
        deform.net.fused_pallas = "on"
    if args.train:
        profile_train(sc, deform, args.variant == "ngp", args.fused)
        return 0
    with torch.no_grad():
        for cam in sc.cams[:2]:
            render_camera(cam, sc.params, sc.stats, deform, sc.pipe, sc.bg)
        torch.cuda.synchronize()

        # 1. stages
        stage_ms = {}
        for cam in sc.cams:
            events = []

            def mark(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append((name, ev))

            staged_frame(cam, sc, deform, mark)
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
            render_camera(cam, sc.params, sc.stats, deform, sc.pipe, sc.bg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for cam in sc.cams:
                render_camera(cam, sc.params, sc.stats, deform, sc.pipe,
                              sc.bg)
            torch.cuda.synchronize()
    report(prof, wall_ms, n, "frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
