"""Rendering and evaluation entry point — ``python -m splatfields_torch.
render`` (counterpart of ``splatfields_tpu/render.py``).

Reloads a run directory (``cfg_args``, the iteration's PLY and, in field
mode, ``deform.msgpack``; written by either package), renders the train,
test and (``--render_pred``) pred cameras, each at its own fid, to PNGs through ``data/png.py``, with
depth maps coloured by cv2's ``COLORMAP_JET`` on request, and writes
PSNR, SSIM and (given VGG weights, ``--lpips_weights``) LPIPS into
``results.yaml`` (``metrics.eval_all``). Every rendered set also goes
into ``video.gif`` (``data/gif.py``: 50 ms a frame, looping), what the
JAX CLI writes when no mp4 encoder is present, as on the GPU machine.
The parser takes every flag of the JAX CLI; ``--render_batch`` has no
effect (it batches frames into one TPU dispatch).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from splatfields_torch import config as cfg_lib
from splatfields_torch import metrics
from splatfields_torch.data import gif, png
from splatfields_torch.device import full_f32_math, resolve_device
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.render_lib import render_cameras_batched
from splatfields_torch.scene import Scene
from splatfields_torch.utils.system import mkdir_p

DEPTH_MIN = 9.0
VIDEO_NOTE = ("mp4 export unavailable (no video encoder on this machine); "
              "wrote video.gif")


def _to_png(img_chw: torch.Tensor) -> np.ndarray:
    img = torch.clamp(img_chw, 0, 1).cpu().numpy()
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


# cv2's COLORMAP_JET lookup table in RGB order, 256 x 3 bytes
JET_LUT = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"),
    np.uint8).reshape(256, 3)


def jet(x: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> uint8 [H, W, 3] RGB: the value quantized as
    ``(x * 255).astype(uint8)``, then cv2's ``COLORMAP_JET``, as the JAX
    CLI colours depth (``cv2.applyColorMap``; it writes the BGR result
    with ``cv2.imwrite``, so the file holds these RGB bytes)."""
    return JET_LUT[(x * 255).astype(np.uint8)]


def render_set(model_path, name, iteration, views, params, stats, deform,
               pipe_cfg, bg, field_mode, n_frames, sh_degree,
               render_depth=False, lpips_weights=None):
    """Render ``views`` into ``model_path/name/ours_<iteration>/`` (PNGs
    and ``video.gif``) and evaluate against their images -> the metrics
    summary ({} when the views have no images)."""
    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_path = os.path.join(base, "renders")
    gts_path = os.path.join(base, "gt")
    depth_path = os.path.join(base, "depth")
    mkdir_p(render_path)
    mkdir_p(gts_path)
    if render_depth:
        mkdir_p(depth_path)
    dropped_views = 0
    frames = []
    outs = render_cameras_batched(views, params, stats, deform, pipe_cfg, bg,
                                  field_mode=field_mode, n_frames=n_frames,
                                  sh_degree=sh_degree)
    for idx, (view, out) in enumerate(zip(views, outs)):
        n_dropped = int(out["n_dropped"])
        if n_dropped > 0:
            dropped_views += 1
            if dropped_views <= 3:
                print(f"[render] warning: view {idx} dropped {n_dropped} "
                      f"instances beyond the dup budget (dup_factor="
                      f"{pipe_cfg.dup_factor}); increase --dup_factor to "
                      "render all splats")
        frames.append(_to_png(out["render"]))
        png.write(os.path.join(render_path, f"{idx:05d}.png"), frames[-1])
        if view.image is not None:
            png.write(os.path.join(gts_path, f"{idx:05d}.png"),
                      _to_png(view.image))
        if render_depth:
            depth = out["depth"][0].cpu().numpy()
            dmax = max(float(depth.max()), DEPTH_MIN + 1e-3)
            dvis = np.clip((depth - DEPTH_MIN) / (dmax - DEPTH_MIN), 0, 1)
            png.write(os.path.join(depth_path, f"{idx:05d}.png"), jet(dvis))
    if frames:
        gif.write(os.path.join(base, "video.gif"), frames)
        print(VIDEO_NOTE)
    if any(v.image is not None for v in views):
        return metrics.eval_all(base, lpips_weights_path=lpips_weights,
                                device=params.xyz.device)
    return {}


@torch.no_grad()
def render_sets(model_cfg, hidden_cfg, pipe_cfg, iteration, skip_train=False,
                skip_test=False, skip_pred=True, render_depth=False,
                lpips_weights=None, device=None):
    """Load the run at ``iteration`` (-1: the latest) and render the
    chosen camera sets -> {set name: metrics summary}. ``device=None``
    means the GPU."""
    dev = resolve_device(device)
    # the frame count only reaches a field: a static run (run_dtu.sh's
    # 3DGS lines keep the default --load_time_step 100) ignores it; a
    # field run renders each camera at its own fid
    n_frames = (model_cfg.load_time_step if model_cfg.load_time_step > 1
                and not model_cfg.is_static else 0)
    hidden_cfg.n_frames = n_frames
    scene = Scene(model_cfg, load_iteration=iteration, shuffle=False,
                  device=dev)
    params, stats = scene.splats, scene.splat_stats
    is_static = model_cfg.is_static
    deform = None
    if not is_static:
        deform = DeformModel(hidden_cfg, radius=scene.cameras_extent,
                             device=dev)
        deform.load_weights(model_cfg.model_path, iteration)
    sh_degree = (scene.loaded_sh_degree if scene.loaded_sh_degree is not None
                 else model_cfg.sh_degree)
    bg = np.array([1, 1, 1] if model_cfg.white_background else [0, 0, 0],
                  np.float32)
    it = scene.loaded_iter or iteration
    results = {}
    for name, skip, cams in (("train", skip_train, scene.get_train_cameras),
                             ("test", skip_test, scene.get_test_cameras),
                             ("pred", skip_pred, scene.get_pred_cameras)):
        if not skip:
            results[name] = render_set(
                model_cfg.model_path, name, it, cams(), params, stats,
                deform, pipe_cfg, bg, not is_static, n_frames, sh_degree,
                render_depth, lpips_weights)
    return results


def build_render_parser():
    parser = cfg_lib.build_parser("SplatFields (PyTorch) rendering",
                                  sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--render_pred", action="store_true")
    parser.add_argument("--render_depth", action="store_true")
    parser.add_argument("--lpips_weights", default=None, type=str,
                        help="local VGG-LPIPS .npz (see ops/lpips.py); "
                             "defaults to $SPLATFIELDS_LPIPS or "
                             "weights/lpips_vgg.npz")
    parser.add_argument("--render_batch", default=8, type=int,
                        help="accepted with no effect: it batches frames "
                             "into one TPU dispatch")
    return parser


def main(argv=None, device=None):
    full_f32_math()
    args = cfg_lib.get_combined_args(
        build_render_parser(), argv if argv is not None else sys.argv[1:])
    model_cfg, pipe_cfg, hidden_cfg, _ = cfg_lib.extract_configs(args)
    print("Rendering " + model_cfg.model_path)
    return render_sets(model_cfg, hidden_cfg, pipe_cfg, args.iteration,
                       skip_train=args.skip_train, skip_test=args.skip_test,
                       skip_pred=not args.render_pred,
                       render_depth=args.render_depth,
                       lpips_weights=getattr(args, "lpips_weights", None),
                       device=device)


if __name__ == "__main__":
    main()
