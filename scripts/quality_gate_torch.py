"""The PSNR quality gate of ``scripts/quality_gate.py``, for the PyTorch
port on a CUDA card: the same synthetic protocol, no JAX, no dataset.

1. A "true" scene of 3,000 Gaussians with a smooth colour field, rendered
   from 10 orbit views (8 train, 2 held out) at 400x400 with the port's
   plain blend (``blend_torch.blend_sorted_plain``), so the ground truth
   does not depend on the CUDA kernels or on a numerics option.
2. The trainee: the field variant (VarTriPlane + MLP heads) or ``--variant
   ngp`` (hash grid + MLP), 20,000 splats from a random cloud, trained for
   300 iterations through the default path (the blend kernels), one view
   a step, ``lambda_norm`` 0.01.
3. PSNR on the two held-out views through ``render_lib.render_camera``.

``--ab`` trains, at each seed of ``--seeds`` (the scene, the initial
cloud and the net's weights), once with every bf16 option off and once
with each of the variant's bf16 options on alone (the field:
``SPLATFIELDS_MLP_BF16``, ``SPLATFIELDS_CNN_BF16``,
``SPLATFIELDS_PLANE_BF16``; NGP: ``SPLATFIELDS_NGP_BF16_TABLE``), all
in one process. It prints each seed's pair, and per option the mean of
on - off over the seeds, their spread (sample standard deviation) and the
standard error, against the JAX gate's epsilon of 0.3 dB. One pair says
little: the card's atomics make two runs of one seed differ.

If ``SPLATFIELDS_MLP_BF16``'s mean lies more than 0.3 dB below 0 and one
spread above the mean stays below 0, the script trains once more at each
seed with one head at a time in bf16 (the option on inside that head's
forward only) and reports each head's mean gap: which head's rounding
costs the PSNR.

Without ``--ab`` the options stay as the environment sets them (``auto``
where unset), so the gate measures what the port ships.

The script prints one JSON line with the card's name and power limit and
writes no file (the JAX records ``quality_gate*.json`` stay the JAX
package's).

    python3 scripts/quality_gate_torch.py [--variant ngp] [--ab]
        [--seeds 0,1,2,3,4]

It needs a CUDA card and exits non-zero without one.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EPSILON_DB = 0.3
OPTIONS = {"field": ("SPLATFIELDS_MLP_BF16", "SPLATFIELDS_CNN_BF16",
                     "SPLATFIELDS_PLANE_BF16"),
           "ngp": ("SPLATFIELDS_NGP_BF16_TABLE",)}
ALL_OPTIONS = tuple(o for opts in OPTIONS.values() for o in opts)
HEADS = ("mlp_deform", "mlp_rgb", "mlp_scale", "mlp_opacity", "mlp_rotation")


class OrbitCam:
    """A camera on the JAX gate's orbit (3DGS conventions), with the
    attributes ``render_lib.render_camera`` reads."""

    def __init__(self, azimuth, elevation, radius, fov, width, height):
        from splatfields_torch.utils import camera_math as cm
        p = np.array([radius * math.cos(elevation) * math.sin(azimuth),
                      radius * math.sin(elevation),
                      radius * math.cos(elevation) * math.cos(azimuth)],
                     np.float32)
        fwd = -p / np.linalg.norm(p)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1).astype(
            np.float32)
        w2v = cm.get_world2view(R, (-R.T @ p).astype(np.float32)).T
        proj = cm.get_projection_matrix(0.01, 100.0, fov, fov).T
        self.world_view_transform = w2v.astype(np.float32)
        self.full_proj_transform = (w2v @ proj).astype(np.float32)
        self.camera_center = np.linalg.inv(w2v.T)[:3, 3].astype(np.float32)
        self.tanfovx = self.tanfovy = math.tan(fov / 2)
        self.image_width, self.image_height = width, height
        self.fid = 0.0


def render_plain(pts, scales, rots, opac, cols, cam, dev):
    """The ground truth: ``api.rasterize``'s pipeline with the plain blend
    in place of the kernels (black background)."""
    import torch

    from splatfields_torch.ops.raster.binning import bin_gaussians
    from splatfields_torch.ops.raster.blend_torch import (
        blend_sorted_plain,
        pack_attributes,
        tiles_to_image,
    )
    from splatfields_torch.ops.raster.preprocess import preprocess

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    w, h = cam.image_width, cam.image_height
    pre = preprocess(t(pts), t(scales), t(rots), t(opac),
                     t(cam.world_view_transform), t(cam.full_proj_transform),
                     w, h, cam.tanfovx, cam.tanfovy, colors_precomp=t(cols),
                     campos=t(cam.camera_center))
    tx, ty = -(-w // 16), -(-h // 16)
    b = bin_gaussians(pre.means2d, pre.depths, pre.radii, tx, ty, 16,
                      dup_cap=8 * len(pts))
    pack = pack_attributes(pre.means2d, pre.conics, pre.rgb, pre.opacity,
                           pre.depths)
    color, _, _ = blend_sorted_plain(
        pack[torch.clamp_min(b.sorted_id, 0).long()], b.tile_start, b.counts,
        tx, ty, 16, 1024, 128)
    return tiles_to_image(color.transpose(1, 2), tx, ty, 16, h, w).permute(
        2, 0, 1)


def bf16_head(net, name):
    """``SPLATFIELDS_MLP_BF16=on`` inside the forward of ``net``'s head
    ``name`` only (the rest of the net as the environment says)."""
    head = getattr(net, name)
    forward = head.forward

    def in_bf16(*args, **kw):
        saved = os.environ.get("SPLATFIELDS_MLP_BF16")
        os.environ["SPLATFIELDS_MLP_BF16"] = "on"
        try:
            return forward(*args, **kw)
        finally:
            if saved is None:
                del os.environ["SPLATFIELDS_MLP_BF16"]
            else:
                os.environ["SPLATFIELDS_MLP_BF16"] = saved

    head.forward = in_bf16


def train_and_eval(variant, seed, iters, dev, bf16_heads=()):
    """One gate run -> (held-out PSNR per view, final loss, train s);
    ``bf16_heads``: heads run with the bf16 MLP alone."""
    import torch

    from splatfields_torch import config, train_lib
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    from splatfields_torch.ops.ssim import psnr as psnr_fn
    from splatfields_torch.render_lib import render_camera
    rng = np.random.RandomState(seed)
    width = height = 400
    pts = rng.uniform(-0.7, 0.7, (3000, 3)).astype(np.float32)
    cols = (0.5 + 0.5 * np.sin(3.0 * pts + np.array(
        [0.0, 2.1, 4.2], np.float32))).astype(np.float32)
    scales = np.full((3000, 3), 0.035, np.float32)
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (3000, 1))
    opac = np.full((3000,), 0.8, np.float32)
    cams = [OrbitCam(2 * math.pi * v / 10, 0.35 * math.sin(2.0 * v), 4.0,
                     0.8, width, height) for v in range(10)]
    with torch.no_grad():
        gts = [render_plain(pts, scales, rots, opac, cols, c, dev)
               for c in cams]

    pts0 = rng.uniform(-0.8, 0.8, (20_000, 3)).astype(np.float32)
    params, stats = splats.create_from_pcd(pts0, np.abs(pts0), 0,
                                           capacity=20_000, device=dev)
    sopt = splats.adam_init(params)
    hidden = config.HiddenConfig(
        encoder_type="NGPMLP" if variant == "ngp" else "VarTriPlaneEncoder",
        composition_rank=0, n_frames=0)
    deform = DeformModel(hidden, radius=1.0, seed=seed, device=dev)
    for name in bf16_heads:
        bf16_head(deform.net, name)
    fp, fopt = deform.params, deform.opt_state
    pipe = config.PipelineConfig(tile_size=16, tile_cap=1024, k_chunk=128)
    step = train_lib.make_train_step(
        deform.net, config.OptimizationConfig(lambda_mask=0.0,
                                              lambda_norm=0.01),
        pipe, width, height, 1, True, 0, 0)
    lrs = splats.splat_lr_tree(1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)
    bg = torch.zeros(3, device=dev)

    def batch(v):
        c = cams[v]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return {"viewmatrix": f32(c.world_view_transform)[None],
                "projmatrix": f32(c.full_proj_transform)[None],
                "campos": f32(c.camera_center)[None],
                "tanfovx": [c.tanfovx], "tanfovy": [c.tanfovy], "fid": 0.0,
                "image": gts[v][None], "bg": bg}

    batches = {v: batch(v) for v in range(8)}
    torch.cuda.synchronize()
    t0 = time.time()
    for it in range(iters):
        params, stats, sopt, fp, fopt, out = step(
            params, stats, sopt, fp, fopt, batches[it % 8], lrs, 1e-3)
    final_loss = float(out.loss)
    train_s = time.time() - t0
    deform.params = fp
    psnrs = []
    for v in (8, 9):
        img = render_camera(cams[v], params, stats, deform, pipe,
                            np.zeros(3, np.float32))["render"]
        psnrs.append(float(psnr_fn(torch.clamp(img, 0, 1),
                                   torch.clamp(gts[v], 0, 1))))
    return psnrs, final_loss, train_s


def spread(gaps):
    """(mean, sample standard deviation, standard error) of on - off."""
    g = np.asarray(gaps, np.float64)
    sd = float(g.std(ddof=1)) if g.size > 1 else float("nan")
    return float(g.mean()), sd, sd / math.sqrt(g.size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=tuple(OPTIONS), default="field")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seeds", default="42",
                    help="comma-separated seeds, e.g. 0,1,2,3,4")
    ap.add_argument("--ab", action="store_true",
                    help="every bf16 option off, then each option on")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("quality_gate_torch: no CUDA device", file=sys.stderr)
        return 1
    from splatfields_torch.device import full_f32_math
    full_f32_math()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]

    def run(seed, on=None, heads=(), forced=True):
        """One gate run; ``forced``: every bf16 option off but ``on``."""
        if forced:
            for name in ALL_OPTIONS:
                os.environ[name] = "on" if name == on else "off"
        psnrs, loss, train_s = train_and_eval(args.variant, seed,
                                              args.iters, dev, heads)
        row = {"psnr_db": float(np.mean(psnrs)), "per_view": psnrs,
               "final_loss": loss, "train_s": train_s}
        print(json.dumps({"seed": seed, "on": on, "bf16_heads": heads,
                          **row}), flush=True)
        return row

    result = {"variant": args.variant, "iters": args.iters,
              "resolution": "400x400", "n_splats": 20_000, "seeds": seeds,
              "card": smi, "device": torch.cuda.get_device_name(0)}
    if not args.ab:
        result["runs"] = {s: run(s, forced=False) for s in seeds}
        result["options"] = {o: os.environ.get(o, "auto")
                             for o in OPTIONS[args.variant]}
        print(json.dumps(result))
        return 0
    off = {s: run(s) for s in seeds}
    result["off"] = off
    result["options"] = {}
    for name in OPTIONS[args.variant]:
        on = {s: run(s, name) for s in seeds}
        gaps = [on[s]["psnr_db"] - off[s]["psnr_db"] for s in seeds]
        mean, sd, se = spread(gaps)
        result["options"][name] = {
            "pairs": {s: [off[s]["psnr_db"], on[s]["psnr_db"]]
                      for s in seeds},
            "on_minus_off_db": gaps, "mean_db": mean, "spread_db": sd,
            "stderr_db": se,
            "within_epsilon": bool(mean >= -EPSILON_DB)}
    mlp = result["options"].get("SPLATFIELDS_MLP_BF16")
    if mlp and mlp["mean_db"] < -EPSILON_DB and (
            mlp["mean_db"] + mlp["spread_db"] < 0):
        study = {}
        for head in HEADS:
            gaps = [run(s, None, (head,))["psnr_db"] - off[s]["psnr_db"]
                    for s in seeds]
            mean, sd, se = spread(gaps)
            study[head] = {"on_minus_off_db": gaps, "mean_db": mean,
                           "spread_db": sd, "stderr_db": se}
        result["head_study"] = study
    result["epsilon_db"] = EPSILON_DB
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
