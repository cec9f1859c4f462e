"""Rendering and evaluation entry point — ``python -m splatfields_torch.
render`` (counterpart of ``splatfields_tpu/render.py``).

Reloads a run directory (``cfg_args``, the iteration's PLY and, in field
mode, ``deform.msgpack``; written by either package), renders the train,
test and (optionally) pred cameras to PNGs through ``data/png.py``, with
JET-coloured depth maps on request, and writes PSNR and SSIM into
``results.yaml`` (``metrics.eval_all``). The JAX CLI also writes
``video.mp4`` (or ``video.gif``); the GPU machine has no video encoder,
so this one writes none and says so (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from splatfields_torch import config as cfg_lib
from splatfields_torch import metrics
from splatfields_torch.data import png
from splatfields_torch.device import resolve_device
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.render_lib import render_cameras_batched
from splatfields_torch.scene import Scene
from splatfields_torch.utils.system import mkdir_p

DEPTH_MIN = 9.0
NO_VIDEO = ("no video.mp4 / video.gif: no video encoder on this machine "
            "(ROADMAP Queue 1 item 5)")


def _to_png(img_chw: torch.Tensor) -> np.ndarray:
    img = torch.clamp(img_chw, 0, 1).cpu().numpy()
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def jet(x: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> uint8 [H, W, 3] RGB, the classic JET ramp
    (dark blue, blue, cyan, yellow, red, dark red), where the JAX CLI
    writes cv2's ``COLORMAP_JET``."""
    x = np.clip(x, 0.0, 1.0)[..., None]
    rgb = np.clip(1.5 - np.abs(4.0 * x - np.array([3.0, 2.0, 1.0])), 0, 1)
    return (rgb * 255).astype(np.uint8)


def render_set(model_path, name, iteration, views, params, stats, deform,
               pipe_cfg, bg, field_mode, n_frames, sh_degree,
               render_depth=False):
    """Render ``views`` into ``model_path/name/ours_<iteration>/`` and
    evaluate against their images -> the metrics summary ({} when the
    views have no images)."""
    base = os.path.join(model_path, name, f"ours_{iteration}")
    render_path = os.path.join(base, "renders")
    gts_path = os.path.join(base, "gt")
    depth_path = os.path.join(base, "depth")
    mkdir_p(render_path)
    mkdir_p(gts_path)
    if render_depth:
        mkdir_p(depth_path)
    dropped_views = 0
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
        png.write(os.path.join(render_path, f"{idx:05d}.png"),
                  _to_png(out["render"]))
        if view.image is not None:
            png.write(os.path.join(gts_path, f"{idx:05d}.png"),
                      _to_png(view.image))
        if render_depth:
            depth = out["depth"][0].cpu().numpy()
            dmax = max(float(depth.max()), DEPTH_MIN + 1e-3)
            png.write(os.path.join(depth_path, f"{idx:05d}.png"),
                      jet((depth - DEPTH_MIN) / (dmax - DEPTH_MIN)))
    if views:
        print(NO_VIDEO)
    if any(v.image is not None for v in views):
        return metrics.eval_all(base)
    return {}


@torch.no_grad()
def render_sets(model_cfg, hidden_cfg, pipe_cfg, iteration, skip_train=False,
                skip_test=False, skip_pred=True, render_depth=False,
                device=None):
    """Load the run at ``iteration`` (-1: the latest) and render the
    chosen camera sets -> {set name: metrics summary}. ``device=None``
    means the GPU."""
    dev = resolve_device(device)
    n_frames = model_cfg.load_time_step if model_cfg.load_time_step > 1 else 0
    if n_frames:
        raise NotImplementedError(
            "4-D rendering (--load_time_step > 1): ROADMAP Queue 1 item 6")
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
                render_depth)
    return results


def build_render_parser():
    parser = cfg_lib.build_parser("SplatFields (PyTorch) rendering",
                                  sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--render_pred", action="store_true")
    parser.add_argument("--render_depth", action="store_true")
    return parser


def main(argv=None, device=None):
    args = cfg_lib.get_combined_args(
        build_render_parser(), argv if argv is not None else sys.argv[1:])
    model_cfg, pipe_cfg, hidden_cfg, _ = cfg_lib.extract_configs(args)
    print("Rendering " + model_cfg.model_path)
    return render_sets(model_cfg, hidden_cfg, pipe_cfg, args.iteration,
                       skip_train=args.skip_train, skip_test=args.skip_test,
                       skip_pred=not args.render_pred,
                       render_depth=args.render_depth, device=device)


if __name__ == "__main__":
    main()
