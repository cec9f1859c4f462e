"""The PSNR quality gate of ``scripts/quality_gate.py``, for the PyTorch
port on a CUDA card: the same synthetic protocol, no JAX, no dataset.

1. A "true" scene of 3,000 Gaussians with a smooth colour field, rendered
   from 10 orbit views (8 train, 2 held out) at 400x400 with the port's
   plain blend (``blend_torch.blend_sorted_plain``), so the ground truth
   does not depend on the CUDA kernels or on a numerics option.
2. The trainee: the field variant (VarTriPlane + MLP heads), ``--variant
   ngp`` (hash grid + MLP) or ``--variant owlii4d`` (the 4-D model:
   ResField rank 40, offset flow, 6 frames), 20,000 splats from a random
   cloud, trained for 300 iterations through the default path (the blend
   kernels), ``lambda_norm`` 0.01.
3. PSNR on the held-out views through ``render_lib.render_camera``.

``--variant owlii4d`` is the JAX gate's dynamic scene: view v sees the
cloud at time (v mod 6) / 5, rigidly rotated by 0.5 t about y and
bobbing by 0.15 sin(2 pi t). ``--num_views N`` trains N views a step:
groups of N consecutive train views in turn, or, with ``owlii4d``, 6 x N
views in same-time groups (N a frame) and two held-out views at the
first and last frame (JAX ``quality_gate.py:129-160``).

``--seeds`` varies the scene and the initial cloud. The net is drawn at
seed 0 for every scene seed (``NET_SEED``), as the JAX gate builds its net
at seed 0 whatever its ``--seed`` (``scripts/quality_gate.py``), so the
two gates' spreads come from the same source.

``--ab`` trains, at each seed of ``--seeds``, once with every bf16 option
off and once
with each of the variant's bf16 options on alone (the field:
``SPLATFIELDS_MLP_BF16``, ``SPLATFIELDS_CNN_BF16``,
``SPLATFIELDS_PLANE_BF16``; NGP: ``SPLATFIELDS_NGP_BF16_TABLE``;
``owlii4d``: ``SPLATFIELDS_MLP_BF16``, the JAX 4-D pair of
``scripts/longrun_4d_bf16.py``), all in one process. It prints each
seed's pair, and per option the mean of on - off over the seeds, their
spread (sample standard deviation) and the standard error, against the
JAX gate's epsilon of 0.3 dB. One pair says little: the card's atomics
make two runs of one seed differ.

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

    python3 scripts/quality_gate_torch.py [--variant ngp|owlii4d]
        [--num_views N] [--iters 300] [--ab] [--seeds 0,1,2,3,4]

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
           "ngp": ("SPLATFIELDS_NGP_BF16_TABLE",),
           "owlii4d": ("SPLATFIELDS_MLP_BF16",)}
ALL_OPTIONS = tuple(dict.fromkeys(o for opts in OPTIONS.values()
                                  for o in opts))
HEADS = ("mlp_deform", "mlp_rgb", "mlp_scale", "mlp_opacity", "mlp_rotation")
HEADS_4D = HEADS + ("mlp_flow",)
OWLII_FRAMES = 6
N_TRUE, N_SPLATS, RES, FOV = 3000, 20_000, 400, 0.8
NET_SEED = 0   # the JAX gate's DeformModel seed, for every scene seed
SPLAT_LRS = (1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)   # the gate's splat lrs
FIELD_LR = 1e-3


def hidden_kwargs(variant, noise_res=None):
    """The trainee's ``HiddenConfig`` fields (JAX
    ``quality_gate.py:185-197``), the same in both packages; ``noise_res``
    sets VarTriPlane's noise size (default: the encoder's own, the JAX
    gate's TPU size)."""
    if variant == "owlii4d":
        kw = dict(encoder_type="VarTriPlaneEncoder", composition_rank=40,
                  n_frames=OWLII_FRAMES, flow_model="offset")
    else:
        kw = dict(encoder_type="NGPMLP" if variant == "ngp"
                  else "VarTriPlaneEncoder", composition_rank=0, n_frames=0)
    if noise_res is not None and variant != "ngp":
        kw["encoder_args"] = {"noise_res": noise_res}
    return kw


def scene_spec(variant, num_views):
    """The JAX gate's cameras -> ([(azimuth, elevation, fid, split)],
    n_frames); split "train" or "test"."""
    n_frames = OWLII_FRAMES if variant == "owlii4d" else 0
    nv = max(1, num_views)
    specs = []
    if n_frames and nv > 1:
        # nv same-fid views a frame, a held-out view at the first and last
        for f in range(n_frames):
            t = f / (n_frames - 1)
            for j in range(nv):
                i = f * nv + j
                specs.append((2 * math.pi * i / (n_frames * nv),
                              0.35 * math.sin(2.0 * i), t, "train"))
        for f in (0, n_frames - 1):
            specs.append((1.7, -0.25, f / (n_frames - 1), "test"))
    else:
        for v in range(10):
            fid = (v % n_frames) / (n_frames - 1) if n_frames else 0.0
            specs.append((2 * math.pi * v / 10, 0.35 * math.sin(2.0 * v),
                          fid, "train" if v < 8 else "test"))
    return specs, n_frames


def cloud_at(pts, t, n_frames):
    """The true cloud at time ``t``: rotated by 0.5 t about y, lifted by
    0.15 sin(2 pi t) (the static cloud when ``n_frames`` is 0)."""
    if not n_frames:
        return pts
    th = 0.5 * t
    c, s = math.cos(th), math.sin(th)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    off = np.array([0.0, 0.15 * math.sin(2 * math.pi * t), 0.0], np.float32)
    return pts @ R.T + off


def view_groups(specs, n_frames, num_views):
    """The train views of each step, in turn: one view; ``num_views``
    consecutive views; with frames, the ``num_views`` views of a frame."""
    train_v = [v for v, s in enumerate(specs) if s[3] == "train"]
    nv = max(1, num_views)
    if nv > 1 and n_frames:
        return [train_v[f * nv:(f + 1) * nv] for f in range(n_frames)]
    if nv > 1:
        return [[train_v[(g + j) % len(train_v)] for j in range(nv)]
                for g in range(len(train_v))]
    return [[v] for v in train_v]


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


def render_plain(pts, scales, rots, opac, cols, cam, dev, bg=(0, 0, 0)):
    """The ground truth: ``api.rasterize``'s pipeline with the plain blend
    in place of the kernels -> (colour [3, H, W] over ``bg``, alpha [H, W]);
    every instance fits its budget."""
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
                      dup_cap=16 * len(pts))
    pack = pack_attributes(pre.means2d, pre.conics, pre.rgb, pre.opacity,
                           pre.depths)
    if int(b.n_dropped):
        raise AssertionError(f"{int(b.n_dropped)} instances past dup_cap")
    color, _, final_t = blend_sorted_plain(
        pack[torch.clamp_min(b.sorted_id, 0).long()], b.tile_start, b.counts,
        tx, ty, 16, 1024, 128)
    final_t = tiles_to_image(final_t, tx, ty, 16, h, w)
    color = tiles_to_image(color.transpose(1, 2), tx, ty, 16, h, w) + \
        final_t[..., None] * t(bg)
    return color.permute(2, 0, 1), 1.0 - final_t


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


def launch_counts():
    """The hand-written kernels' launch counters, {name: count}."""
    from splatfields_torch.ops import segsum
    from splatfields_torch.ops.raster import blend_cuda
    return {"blend_fwd": blend_cuda.blend_fwd.launches,
            "blend_bwd": blend_cuda.blend_bwd.launches,
            "segsum": segsum.sorted_segment_sum.launches}


class Gate:
    """The gate's scene and trainee at one size (JAX
    ``quality_gate.py:101-210``): the true cloud, the cameras, the ground
    truth rendered on ``dev``, the train groups and held-out views, the
    initial cloud, and the trainee's configs. The card's gate, phase 47 of
    ``chip_smoke.py`` and ``scripts/gate_parity_cpu.py`` build from it.
    The defaults are the card's size; the JAX gate's CPU size is ``res``
    64, ``n_true`` 256, ``n_splats`` 512, ``noise_res`` 4, ``tile_cap``
    256."""

    def __init__(self, variant, seed, dev, res=RES, n_true=N_TRUE,
                 n_splats=N_SPLATS, noise_res=None, tile_cap=1024,
                 num_views=1):
        import torch

        from splatfields_torch import config
        self.variant, self.seed, self.res = variant, seed, res
        self.n_splats, self.noise_res = n_splats, noise_res
        rng = np.random.RandomState(seed)
        pts = rng.uniform(-0.7, 0.7, (n_true, 3)).astype(np.float32)
        cols = (0.5 + 0.5 * np.sin(3.0 * pts + np.array(
            [0.0, 2.1, 4.2], np.float32))).astype(np.float32)
        scales = np.full((n_true, 3), 0.035, np.float32)
        rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n_true, 1))
        opac = np.full((n_true,), 0.8, np.float32)
        self.specs, self.n_frames = scene_spec(variant, num_views)
        self.cams = []
        for az, el, fid, _ in self.specs:
            self.cams.append(OrbitCam(az, el, 4.0, FOV, res, res))
            self.cams[-1].fid = fid
        with torch.no_grad():
            self.gts = [render_plain(cloud_at(pts, c.fid, self.n_frames),
                                     scales, rots, opac, cols, c, dev)[0]
                        for c in self.cams]
        self.pts0 = rng.uniform(-0.8, 0.8, (n_splats, 3)).astype(np.float32)
        self.groups = view_groups(self.specs, self.n_frames, num_views)
        self.test_v = [v for v, s in enumerate(self.specs) if s[3] == "test"]
        self.pipe = config.PipelineConfig(   # dup_factor: the default 5
            tile_size=16, tile_cap=tile_cap, k_chunk=128)
        self.opt = config.OptimizationConfig(lambda_mask=0.0,
                                             lambda_norm=0.01)

    def hidden(self):
        """The trainee's ``HiddenConfig`` fields."""
        return hidden_kwargs(self.variant, self.noise_res)

    def trainee(self, dev):
        """The initial state on ``dev``: (splats, statistics, their Adam
        state, the ``DeformModel``, drawn at ``NET_SEED``)."""
        from splatfields_torch import config
        from splatfields_torch.models import splats
        from splatfields_torch.models.deform_model import DeformModel
        params, stats = splats.create_from_pcd(
            self.pts0, np.abs(self.pts0), 0, capacity=self.n_splats,
            device=dev)
        deform = DeformModel(config.HiddenConfig(**self.hidden()),
                             radius=1.0, seed=NET_SEED, device=dev)
        return params, stats, splats.adam_init(params), deform

    def train_step(self, net):
        """``train_lib.make_train_step`` for ``net`` at the gate's views."""
        from splatfields_torch import train_lib
        return train_lib.make_train_step(
            net, self.opt, self.pipe, self.res, self.res,
            len(self.groups[0]), True, self.n_frames, 0)

    def batch(self, views, dev):
        """The step's batch of ``views``, same-fid views in one step
        (reference train.py:157-163)."""
        import torch

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        sel = [self.cams[v] for v in views]
        return {"viewmatrix": f32([c.world_view_transform for c in sel]),
                "projmatrix": f32([c.full_proj_transform for c in sel]),
                "campos": f32([c.camera_center for c in sel]),
                "tanfovx": [c.tanfovx for c in sel],
                "tanfovy": [c.tanfovy for c in sel],
                "fid": float(np.float32(sel[0].fid)),
                "image": torch.stack([self.gts[v] for v in views]).to(dev),
                "bg": torch.zeros(3, device=dev)}


def train_and_eval(variant, seed, iters, dev, bf16_heads=(), num_views=1):
    """One gate run -> (held-out PSNR per view, final loss, train s, the
    kernels' launches over the training loop); ``bf16_heads``: heads run
    with the bf16 MLP alone."""
    import torch

    from splatfields_torch.models import splats
    from splatfields_torch.ops.ssim import psnr as psnr_fn
    from splatfields_torch.render_lib import render_camera
    gate = Gate(variant, seed, dev, num_views=num_views)
    params, stats, sopt, deform = gate.trainee(dev)
    for name in bf16_heads:
        bf16_head(deform.net, name)
    fp, fopt = deform.params, deform.opt_state
    step = gate.train_step(deform.net)
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    batches = [gate.batch(views, dev) for views in gate.groups]
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.time()
    for it in range(iters):
        params, stats, sopt, fp, fopt, out = step(
            params, stats, sopt, fp, fopt, batches[it % len(batches)], lrs,
            FIELD_LR)
    final_loss = float(out.loss)
    train_s = time.time() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    deform.params = fp
    psnrs = []
    for v in gate.test_v:
        img = render_camera(gate.cams[v], params, stats, deform, gate.pipe,
                            np.zeros(3, np.float32),
                            n_frames=gate.n_frames)["render"]
        psnrs.append(float(psnr_fn(torch.clamp(img, 0, 1),
                                   torch.clamp(gate.gts[v], 0, 1))))
    return psnrs, final_loss, train_s, launches


def spread(gaps):
    """(mean, sample standard deviation, standard error) of on - off."""
    g = np.asarray(gaps, np.float64)
    sd = float(g.std(ddof=1)) if g.size > 1 else float("nan")
    return float(g.mean()), sd, sd / math.sqrt(g.size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=tuple(OPTIONS), default="field")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--num_views", type=int, default=1,
                    help="views a train step (owlii4d: views a frame)")
    ap.add_argument("--seeds", default="42",
                    help="comma-separated scene seeds, e.g. 0,1,2,3,4 "
                         "(the net: seed 0)")
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
        psnrs, loss, train_s, launches = train_and_eval(
            args.variant, seed, args.iters, dev, heads, args.num_views)
        row = {"psnr_db": float(np.mean(psnrs)), "per_view": psnrs,
               "final_loss": loss, "train_s": train_s, "launches": launches}
        print(json.dumps({"seed": seed, "on": on, "bf16_heads": heads,
                          **row}), flush=True)
        return row

    result = {"variant": args.variant, "num_views": max(1, args.num_views),
              "iters": args.iters, "resolution": f"{RES}x{RES}",
              "n_splats": N_SPLATS, "seeds": seeds, "net_seed": NET_SEED,
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
        for head in HEADS_4D if args.variant == "owlii4d" else HEADS:
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
