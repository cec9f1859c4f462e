"""The protocol-length run of ``scripts/longrun_30k.py``, for the PyTorch
port on a CUDA card: the port's real training loop (``train.training``:
the densify cadence, the screen-size pruning after iteration 3,000,
capacity growth, the learning-rate tails, evaluation and checkpoints) for
30,000 iterations of the SplatFields3D protocol (field mode,
VarTriPlaneEncoder, ``lambda_norm`` 0.01) on a synthetic 400x400 Blender
scene.

The scene (``build_scene``) is the JAX script's: 3,000 true Gaussians of
the quality gate (seed 42) seen from 10 train and 2 held-out orbit views,
the frames rendered with the port's plain blend
(``quality_gate_torch.render_plain``, white background, alpha as
1 - final T), so the ground truth does not depend on the CUDA kernels,
and written as RGBA PNGs by ``data/png.py``. It is kept per resolution in
``.longrun_scene_<res>`` at the repository's root.

The run goes into ``.longrun_run`` with the JAX script's command line, flag
for flag (``train_argv``), through the port's ``config`` into
``train.training``: a test every ``--eval_every`` (1,000) iterations, a
save every ``--save_every`` (5,000). Further flags of the train CLI given
after these (for example ``--densify_from_iter 2``) are passed on.

Legs: ``--leg_until K`` stops the run after iteration K's save (K must be
a save iteration), and ``--resume`` continues from the latest saved
state. A leg's end changes nothing else: the learning rates and the
densify, pruning, test and save iterations stay those of the whole run,
so two legs give what one run gives. ``--profile_window A:B`` traces
iterations A to B with ``torch.profiler`` and reports the device's busy
time and the share of the pack gather's backward
(``indexing_backward_kernel*``).

The script prints one JSON line: the PSNR trajectory (from
``metrics.jsonl``), the final and best PSNR, ``stable`` (final >= best -
1 dB), the final point count and capacity, the ``dup_factor`` reached,
every leg so far (``legs.json`` in the run directory: iterations, ms/it,
step ms, ``dup_factor`` at its start and end, the view order's state
digests at its start and end, the kernels' launches, its profile), the
card's name and power limit. It writes no file outside the two
directories.

    python3 scripts/longrun_torch.py [--iters 30000] [--res 400]
        [--leg_until 10000] [--resume] [--profile_window 2001:2010]

It runs on the CUDA card (``--device cpu`` for a small check on the
host) and exits non-zero without one.
"""
import argparse
import hashlib
import json
import math
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

N_TRUE = 3000
FOV = 0.8


def make_pose(theta, phi, radius):
    """Blender (OpenGL) c2w on a sphere looking at the origin."""
    pos = np.array([radius * math.cos(phi) * math.sin(theta),
                    radius * math.cos(phi) * math.cos(theta),
                    radius * math.sin(phi)])
    forward = pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, 0.0, 1.0]), forward)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(forward, right)
    c2w[:3, 2] = forward
    c2w[:3, 3] = pos
    return c2w


def build_scene(root, res, device, seed=42, n_true=N_TRUE):
    """The JAX script's Blender-format scene under ``root``: transforms
    JSONs, then each frame rendered through the port's reader and camera
    (blank frames first, so the reader sizes the cameras)."""
    import torch

    from quality_gate_torch import render_plain
    from splatfields_torch.data import png
    from splatfields_torch.data.cameras import load_cam
    from splatfields_torch.data.readers.blender import (
        read_cameras_from_transforms_cv,
    )

    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split), exist_ok=True)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.7, 0.7, (n_true, 3)).astype(np.float32)
    cols = (0.5 + 0.5 * np.sin(
        3.0 * pts + np.array([0.0, 2.1, 4.2], np.float32))).astype(np.float32)
    scales = np.full((n_true, 3), 0.035, np.float32)
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n_true, 1))
    opac = np.full((n_true,), 0.8, np.float32)

    views = {"train": (np.linspace(0, 2 * np.pi, 10, endpoint=False),
                       0.35 * np.sin(2.0 * np.arange(10))),
             "test": ([0.3, 2.5], [0.2, -0.25])}
    blank = png.encode(np.zeros((res, res, 4), np.uint8))
    for name, (thetas, phis) in views.items():
        frames = [{"file_path": f"./{name}/r_{i}",
                   "transform_matrix": make_pose(th, ph, 4.0).tolist()}
                  for i, (th, ph) in enumerate(zip(thetas, phis))]
        with open(os.path.join(root, f"transforms_{name}.json"), "w") as f:
            json.dump({"camera_angle_x": FOV, "frames": frames}, f)
        for i in range(len(frames)):
            with open(os.path.join(root, name, f"r_{i}.png"), "wb") as f:
                f.write(blank)
    for name in views:
        infos, _ = read_cameras_from_transforms_cv(
            root, f"transforms_{name}.json", True)
        for i, info in enumerate(infos):
            cam = load_cam(info, -1, i, 1.0, max_resolution=res,
                           device=device)
            with torch.no_grad():
                color, alpha = render_plain(pts, scales, rots, opac, cols,
                                            cam, device, bg=(1, 1, 1))
            rgba = torch.cat([color.permute(1, 2, 0), alpha[..., None]], -1)
            png.write(os.path.join(root, name, f"r_{i}.png"),
                      (rgba.clamp(0, 1).cpu().numpy() * 255).astype(np.uint8))


def train_argv(scene_dir, run_dir, num_pts, dup_factor, iters):
    """``longrun_30k.py``'s command line (its lines 163-171)."""
    return ["-s", scene_dir, "-m", run_dir, "--white_background", "--eval",
            "--n_views", "10", "--pts_samples", "hull",
            "--num_pts", str(num_pts), "--max_num_pts", str(num_pts),
            "--encoder_type", "VarTriPlaneEncoder", "--lambda_norm", "0.01",
            "--load_time_step", "0", "--composition_rank", "0",
            "--dup_factor", str(dup_factor), "--iterations", str(iters)]


class ViewOrder(random.Random):
    """The loop's view order, ``random.Random(0)``, noting the state that
    ``--resume`` restores into it."""

    def __init__(self):
        super().__init__(0)
        self.restored = None

    def setstate(self, state):
        super().setstate(state)
        self.restored = state


def digest(state) -> str:
    """A short digest of a ``random.Random`` state (tuples as lists, as
    the checkpoint's JSON holds them)."""
    version, inner, gauss = state
    return hashlib.sha1(json.dumps([version, list(inner), gauss]).encode()
                        ).hexdigest()[:16]


class ProfileWindow:
    """A progress callback: ``torch.profiler`` (CPU and CUDA) over the
    whole iterations ``first`` to ``last`` (step, densify, evaluation) ->
    ``report``: wall and device-busy ms an iteration, the idle share, the
    pack gather's backward share of the busy time, the top device
    events."""

    GATHER_BWD = "indexing_backward"

    def __init__(self, first, last):
        self.first, self.last = first, last
        self.prof = self.t0 = self.report = None

    def __call__(self, it, loss, params, stats):
        import torch
        if it == self.first - 1:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif it == self.last and self.prof is not None:
            torch.cuda.synchronize()
            wall = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                           for e in self.prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA),
                          reverse=True)
            n = self.last - self.first + 1
            busy = sum(r[0] for r in rows)
            gather = sum(r[0] for r in rows if self.GATHER_BWD in r[2])
            self.report = {
                "iterations": [self.first, self.last],
                "wall_ms_per_it": wall / n, "busy_ms_per_it": busy / n,
                "idle": 1 - busy / wall,
                "gather_bwd_ms_per_it": gather / n,
                "gather_bwd_share": gather / busy if busy else None,
                "top": [[ms / n, count, key[:80]]
                        for ms, count, key in rows[:8]]}
            self.prof = None

    def close(self):
        """Drop a window the leg ended inside."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None


def trajectory(run_dir):
    """The test PSNR at every evaluation, from ``metrics.jsonl``."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "test/loss_viewpoint - psnr" in rec:
                out.append({"iter": rec["step"],
                            "psnr_db": rec["test/loss_viewpoint - psnr"]})
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--num_pts", type=int, default=20_000)
    ap.add_argument("--eval_every", type=int, default=1000)
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--dup_factor", type=int, default=64,
                    help="the instance budget to start from: the untrained "
                         "scale head makes ~1.2M instances at iteration 1")
    ap.add_argument("--leg_until", type=int, default=0,
                    help="stop after this save iteration (0: run to the end)")
    ap.add_argument("--resume", action="store_true",
                    help="continue the run directory's latest saved state")
    ap.add_argument("--profile_window", default="",
                    help="A:B, profile iterations A to B of this leg")
    ap.add_argument("--scene_dir", default="",
                    help="default .longrun_scene_<res> at the repo root")
    ap.add_argument("--run_dir", default="",
                    help="default .longrun_run at the repo root")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """One leg -> the printed summary (a dict)."""
    import torch

    from quality_gate_torch import launch_counts
    from splatfields_torch import config as cfg_lib
    from splatfields_torch import train
    from splatfields_torch.device import full_f32_math
    from splatfields_torch.utils.system import search_for_max_iteration

    args, extra = build_parser().parse_known_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("longrun_torch: no CUDA device")
    full_f32_math()
    smi = card_line() if dev.type == "cuda" else None
    scene_dir = args.scene_dir or os.path.join(REPO,
                                               f".longrun_scene_{args.res}")
    run_dir = args.run_dir or os.path.join(REPO, ".longrun_run")
    test_iters = list(range(args.eval_every, args.iters + 1, args.eval_every))
    save_iters = list(range(args.save_every, args.iters + 1,
                            args.save_every))
    until = args.leg_until or args.iters
    if until < args.iters and until not in save_iters:
        raise SystemExit(f"--leg_until {until} is not a save iteration "
                         f"(every {args.save_every})")
    if not os.path.exists(os.path.join(scene_dir, "transforms_test.json")):
        t0 = time.time()
        build_scene(scene_dir, args.res, dev)
        print(f"scene {args.res}x{args.res} written in "
              f"{time.time() - t0:.2f} s", flush=True)
    cli = cfg_lib.build_parser().parse_args(
        train_argv(scene_dir, run_dir, args.num_pts, args.dup_factor,
                   args.iters) + extra)
    model_cfg, pipe_cfg, hidden_cfg, opt_cfg = cfg_lib.extract_configs(cli)
    legs_path = os.path.join(run_dir, "legs.json")
    dup_start = pipe_cfg.dup_factor
    if args.resume:
        it0 = search_for_max_iteration(os.path.join(run_dir, "train_state"))
        if it0 is None:
            raise SystemExit(f"--resume: no saved state in {run_dir}")
        with open(os.path.join(run_dir, "train_state", f"iteration_{it0}",
                               "meta.json")) as f:
            dup_start = json.load(f)["dup_factor"]
    else:
        shutil.rmtree(run_dir, ignore_errors=True)
    legs = []
    if os.path.exists(legs_path):
        with open(legs_path) as f:
            legs = json.load(f)

    view_rng = ViewOrder()
    window = None
    if args.profile_window:
        window = ProfileWindow(*map(int, args.profile_window.split(":")))
    before = launch_counts()
    t0 = time.time()
    try:
        res = train.training(
            model_cfg, hidden_cfg, opt_cfg, pipe_cfg,
            test_iterations=test_iters, save_iterations=save_iters,
            args=cli, resume=args.resume, rng=view_rng, device=dev,
            progress_callback=window, until=until)
    finally:
        if window is not None:
            window.close()
    legs.append({
        "from": res.start_iteration, "until": until,
        "wall_s": time.time() - t0, "ms_per_it": res.ms_per_it,
        "step_ms": res.step_ms, "dup_factor_start": dup_start,
        "dup_factor_end": res.dup_factor, "dup_growth": res.dup_growth,
        "densify_passes": len(res.densified),
        "capacity_growths": sum(1 for d in res.densified if d[3] > 0),
        "view_rng_start": (digest(view_rng.restored)
                           if view_rng.restored is not None else None),
        "view_rng_end": digest(view_rng.getstate()),
        "profile": window.report if window is not None else None,
        "launches": {k: v - before[k] for k, v in launch_counts().items()},
        "card": smi})
    with open(legs_path, "w") as f:
        json.dump(legs, f)

    traj = trajectory(run_dir)
    final = traj[-1]["psnr_db"] if traj else None
    best = max(t["psnr_db"] for t in traj) if traj else None
    summary = {
        "protocol": {
            "iters": args.iters, "resolution": f"{args.res}x{args.res}",
            "init_pts": args.num_pts, "views": "10 train / 2 held-out",
            "model": "SplatFields3D (VarTriPlaneEncoder + lambda_norm .01)",
            "densify": (f"from {opt_cfg.densify_from_iter}, every "
                        f"{opt_cfg.densification_interval}, until "
                        f"{opt_cfg.densify_until_iter}; screen-size pruning "
                        f"after {opt_cfg.opacity_reset_interval}"),
            "extra_flags": extra},
        "iteration": until, "done": until == args.iters,
        "final_psnr_db": final, "best_psnr_db": best,
        "stable": final is not None and final >= best - 1.0,
        "final_points": int(res.stats.valid.sum()),
        "capacity": int(res.params.capacity),
        "dup_factor": res.dup_factor, "legs": legs, "trajectory": traj,
        "card": smi,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "env_knobs": {k: v for k, v in os.environ.items()
                      if k.startswith("SPLATFIELDS_")}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
