"""The multi-device path on several GPUs of one host: one process a GPU
over NCCL (``splatfields_torch/parallel``), against the single-device
step on GPU 0.

1. A world of ``--world`` spawned ranks runs phase 7's field step of
   ``chip_smoke.py`` (2,000 splats, VarTriPlane, 64x64, two views, Adam
   states with non-zero moments) sharded on a 1 x world mesh, on a
   2 x world/2 mesh and with the ring exchange, and the on-mesh densify;
   rank 0 gathers each result and holds it against the single-device
   step (and ``densify_and_prune``) on the same state at the JAX sharded
   tests' tolerances: loss within 1e-4, parameters within 2e-5 + 1e-4
   relative, ``max_radii2d`` equal with one data row, densify within
   1e-6.
2. The train CLI with ``--mesh_model <world>`` (it spawns the ranks) on
   a 64x64 Blender scene for 4 iterations, and the same line without a
   mesh: both finish, the mesh run's PLY is written once, the test PSNRs
   are printed.

    python3 scripts/mesh_check.py [--world 4] [--device cpu]

Needs ``--world`` CUDA GPUs; ``--device cpu`` runs the same on gloo CPU
ranks (a rehearsal, no card). Prints one JSON line with the cards' name
and power limit.
"""
import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name: (data rows, ring)
CASES = {"1xW": (1, False), "2xW/2": (2, False), "1xW ring": (1, True)}


def state_and_args(dev, mesh=None, data=1, ring=False):
    """Phase 7's field step with two views on ``dev``: ([state..., batch,
    lrs, lr], step arguments), sharded on ``mesh`` when given."""
    import chip_smoke as cs
    from splatfields_torch.parallel import step as pstep
    state, single_args = cs.world_case(dev, None, 0)
    if mesh is None:
        return state, single_args
    state[:3] = pstep.shard_train_state(*state[:3], mesh)
    net, opt, pipe, w, h, views, field, n_frames, sh = single_args
    return state, (net, opt, pipe, w, h, views // data, field, n_frames,
                   mesh, sh, True, ring)


def densify_state(dev):
    import dataclasses

    import torch

    import chip_smoke as cs
    from splatfields_torch.models import splats
    state, _ = cs.world_case(dev, None, 0)
    p, s, o = state[:3]
    rng = np.random.RandomState(3)
    n = p.capacity
    s = dataclasses.replace(
        s, xyz_gradient_accum=torch.as_tensor(
            rng.rand(n).astype(np.float32) * 6e-4, device=dev),
        denom=torch.ones(n, device=dev),
        valid=torch.as_tensor(rng.rand(n) > 0.1, device=dev))
    noise = torch.randn(n, 2, 3, generator=torch.Generator().manual_seed(5)
                        ).to(dev)
    return p, s, splats.adam_init(p), noise


def flat(tree):
    from splatfields_torch.models import splats
    return {k: v.detach() for k, v in splats.tree_items(tree).items()}


def rank_main(rank, world, init_method, out_path, device_type="cuda"):
    import torch
    import torch.distributed as dist

    from splatfields_torch.device import full_f32_math
    from splatfields_torch.models import splats
    from splatfields_torch.parallel import mesh as mesh_lib
    from splatfields_torch.parallel import step as pstep
    full_f32_math()
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    cpu = device_type == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
    if cpu:
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    mesh_lib.initialize_distributed(None, world, rank,
                                    backend="gloo" if cpu else "nccl",
                                    init_method=init_method,
                                    timeout_s=300)
    meshes = {d: mesh_lib.make_mesh(world, data=d) for d in (1, 2)}
    got = {}
    for name, (data, ring) in CASES.items():
        mesh = meshes[data]
        state, args = state_and_args(dev, mesh, data, ring)
        out = pstep.make_sharded_train_step(*args[:10], enable_gaussian_opt=
                                            args[10], ring=args[11])(*state)
        p, s, _ = pstep.unshard_train_state(*out[:3], mesh)
        got[name] = {"loss": float(out[5].loss), "params": flat(p),
                     "field": {k: v.detach() for k, v in out[3].items()},
                     "max_radii2d": s.max_radii2d}
    p, s, o, noise = densify_state(dev)
    p, s, o = pstep.shard_train_state(p, s, o, meshes[1])
    p, s, o, dropped = pstep.make_sharded_densify(meshes[1], 0.0, 0.01)(
        p, s, o, noise, 2e-4, 0.005, 1.5)
    p, s, o = pstep.unshard_train_state(p, s, o, meshes[1])
    got["densify"] = {"params": flat(p), "stats": flat(s),
                      "mu": flat(o.mu), "dropped": int(dropped)}
    dist.destroy_process_group()
    if rank == 0:
        torch.save(got, out_path)


def past_rtol(a, b):
    """Largest abs error past 1e-4 relative (JAX's sharded tests)."""
    if not b.numel():
        return 0.0
    return float(((a.float() - b.float()).abs() - 1e-4 * b.float().abs()
                  ).max())


def compare(got, dev):
    import torch

    from splatfields_torch import train_lib
    from splatfields_torch.models import splats
    report, ok = {}, True
    state, args = state_and_args(dev)
    want = train_lib.make_train_step(*args)(*state)
    for name, (data, _ring) in CASES.items():
        g = got[name]
        gaps = {k: past_rtol(v, getattr(want[0], k))
                for k, v in g["params"].items()}
        gaps["field"] = max(past_rtol(g["field"][k], v)
                            for k, v in want[3].items())
        loss_gap = abs(g["loss"] - float(want[5].loss))
        radii = (bool(torch.equal(g["max_radii2d"], want[1].max_radii2d))
                 if data == 1 else None)
        report[name] = {"loss_gap": loss_gap, "worst_past_rtol":
                        max(gaps.values()), "max_radii2d_equal": radii}
        ok &= loss_gap < 1e-4 and max(gaps.values()) <= 2e-5 \
            and radii is not False
    p, s, o, noise = densify_state(dev)
    hp, hs, ho, hdrop = splats.densify_and_prune(
        p, s, o, noise, 2e-4, 0.005, 1.5, 0.0, percent_dense=0.01)
    g = got["densify"]
    worst = max(
        float((g[tree][k].float() - v.float()).abs().max()) if v.numel()
        else 0.0 for tree, t in (("params", hp), ("stats", hs),
                                 ("mu", ho.mu))
        for k, v in flat(t).items())
    report["densify"] = {"dropped": [g["dropped"], int(hdrop)],
                         "worst_abs": worst}
    ok &= g["dropped"] == int(hdrop) and worst <= 1e-6
    return report, ok


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_runs(world, base, dev):
    """The train CLI with and without ``--mesh_model world`` -> {name:
    (seconds, test PSNR, PLY written)}."""
    import chip_smoke as cs
    scene = cs.write_blender_scene(base, 64, 12, [0.3], dev, n_splats=300)
    out = {}
    for name, extra in (("single", []), ("mesh", ["--mesh_model",
                                                  str(world)])):
        run = os.path.join(base, name)
        argv = ["-s", scene, "-m", run, "--white_background", "--eval",
                "--is_static", "--n_views", "8", "--pts_samples", "random",
                "--num_pts", "2000", "--load_time_step", "0",
                "--composition_rank", "0", "--iterations", "4",
                "--test_iterations", "4", "--quiet"] + extra
        t0 = time.time()
        if dev.type == "cuda":   # as a user runs it
            subprocess.run(
                [sys.executable, "-m", "splatfields_torch.train"] + argv,
                cwd=ROOT, check=True, timeout=600,
                env=dict(os.environ, SPLATFIELDS_MLP_BF16="off"))
        else:
            from splatfields_torch import train
            train.main(argv, device="cpu")
        seconds = time.time() - t0
        psnr = None
        with open(os.path.join(run, "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                psnr = rec.get("test/loss_viewpoint - psnr", psnr)
        ply = os.path.join(run, "point_cloud", "iteration_4",
                           "point_cloud.ply")
        out[name] = {"seconds": seconds, "test_psnr": psnr,
                     "ply": os.path.exists(ply)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device(
        "cpu")
    smi = ["no card: gloo CPU ranks"]
    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            print(f"mesh_check: needs {args.world} CUDA GPUs",
                  file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        from splatfields_torch.ops.raster import blend_cuda
        blend_cuda.build()
    from splatfields_torch.device import full_f32_math
    full_f32_math()
    os.environ["SPLATFIELDS_MLP_BF16"] = "off"
    base = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.time()
        out_path = os.path.join(base, "rank0.pt")
        mp.start_processes(rank_main, args=(args.world,
                                            f"tcp://127.0.0.1:{free_port()}",
                                            out_path, args.device),
                           nprocs=args.world, join=True,
                           start_method="spawn")
        world_s = time.time() - t0
        got = torch.load(out_path, map_location=dev)
        report, ok = compare(got, dev)
        cli = cli_runs(args.world, base, dev)
        ok &= cli["mesh"]["ply"] and cli["single"]["ply"]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"ok": bool(ok), "world": args.world,
                      "world_s": world_s, "cases": report, "cli": cli,
                      "cards": smi}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
