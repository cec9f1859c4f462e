"""Training entry point — ``python -m splatfields_torch.train`` (counterpart
of ``splatfields_tpu/train.py``).

The reference's ``training()`` loop around the port's step
(``train_lib.make_train_step``): a random view a step (``random.Random``
passed in, drawing what the JAX loop's global ``random`` draws after the
same seed), the all_training same-fid view batches (a 4-D run,
``--load_time_step > 1``, trains ``n_frames = load_time_step`` frames and
evaluates each test camera at its own fid), the xyz and field
learning-rate schedules, the warm-up field mode, SH-degree bumps every
1,000 iterations, ``overwrite_loc`` after 1,500, ``densify_and_prune``
on the reference's cadence (growing the capacity when splats drop),
periodic evaluation, PLY / field-weight / train-state saves, ``--resume``,
``--watchdog_min`` (``utils/system.StallWatchdog``: exit 114 when the loop
stalls) and ``--profile`` (a ``torch.profiler`` trace of iterations 20-30
into ``<model_path>/trace``, ``profile_callback``).

Every per-iteration decision is one pure function of the iteration and
the configs, ``iteration_events``; the loop reads it. The step is cached
by (field mode, SH degree, capacity, dup_factor), as the JAX loop caches
its jitted steps; eager PyTorch has no re-jit, but a grown capacity or
``dup_factor`` builds a new step. The loop reads the loss and the dropped
instance count once a step (one device sync), as the JAX loop does.

A device mesh (``--mesh_model``, ``--mesh_data``, ``--ring``) trains
with ``parallel/step.py``'s sharded step on ``torch.distributed``, one
process a device, as the JAX CLI does on its mesh: the splat state is
split over the model axis (the capacity rounded up to a multiple of it,
at the start and on growth), ``densify_and_prune`` runs on the mesh
(``make_sharded_densify``), rank 0 evaluates and writes the checkpoints,
the PLY, ``cfg_args`` and the metrics, and ``--resume`` re-shards the
saved state. ``--num_processes``/``--process_id``/
``--coordinator_address`` join one process of a multi-host world; without
them ``--mesh_model x --mesh_data > 1`` spawns that many local ranks, one a
GPU (gloo ranks on the CPU with ``device="cpu"``). The JAX CLI's refusals
stay: ``--n_splats`` on a mesh, a view batch that does not split over the
data axis. ``--scan_k`` is accepted and has no effect (it batches
iterations into one TPU dispatch).
"""
from __future__ import annotations

import dataclasses
import os
import random
import socket
import sys
import time
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from splatfields_torch import checkpointing
from splatfields_torch import config as cfg_lib
from splatfields_torch import train_lib
from splatfields_torch.device import full_f32_math, resolve_device
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.ops.ssim import psnr as psnr_fn
from splatfields_torch.parallel import mesh as mesh_lib
from splatfields_torch.parallel import step as pstep
from splatfields_torch.render_lib import render_camera
from splatfields_torch.scene import Scene
from splatfields_torch.utils.metrics_writer import MetricsWriter
from splatfields_torch.utils.schedules import expon_lr_func
from splatfields_torch.utils.system import StallWatchdog


@dataclasses.dataclass(frozen=True)
class IterationEvents:
    """What the loop does at one iteration besides the step."""
    field_mode: bool        # the field predicts the attributes (no warm-up)
    sh_bump: bool           # active SH degree + 1, before the step
    densify: bool           # densify_and_prune after the step
    size_threshold: float   # its max_screen_size: 20 after the opacity reset
    overwrite_loc: bool     # copy the field's means into the splats' xyz
    test: bool              # evaluate
    save: bool              # PLY, field weights and train state


def iteration_events(iteration: int, is_static: bool, opt_cfg,
                     test_iterations=(), save_iterations=()) -> IterationEvents:
    """The JAX loop's conditions (``splatfields_tpu/train.py``: warm-up
    :202-205, SH bump :301-302, overwrite_loc :390, densify :434-437,
    test and save :481-487) as one function of the iteration."""
    enable_g_opt = not opt_cfg.disable_gaussian_opt
    warm = (opt_cfg.warm_up is not None and 0 < opt_cfg.warm_up
            and iteration < opt_cfg.warm_up)
    field_mode = not is_static and not warm
    return IterationEvents(
        field_mode=field_mode,
        sh_bump=enable_g_opt and iteration % 1000 == 0,
        densify=(enable_g_opt and iteration < opt_cfg.densify_until_iter
                 and iteration > opt_cfg.densify_from_iter
                 and iteration % opt_cfg.densification_interval == 0),
        size_threshold=(20.0 if iteration > opt_cfg.opacity_reset_interval
                        else 0.0),
        overwrite_loc=(iteration > 1500 and opt_cfg.overwrite_loc
                       and field_mode),
        test=iteration in test_iterations,
        save=iteration in save_iterations)


@dataclasses.dataclass
class TrainResult:
    """What ``training`` returns: the final state, the best test PSNR and
    what the loop did on the way."""
    params: splats_lib.SplatParams
    stats: splats_lib.SplatStats
    deform: DeformModel | None
    best_psnr: float
    start_iteration: int    # 1, or the resumed iteration + 1
    ms_per_it: float        # loop wall time, evaluation and saves included
    # (iteration, instances dropped past dup_cap, the grown dup_factor)
    dup_growth: list = dataclasses.field(default_factory=list)
    # (iteration, valid splats before, after, splats dropped for capacity)
    densified: list = dataclasses.field(default_factory=list)
    step_ms: float = 0.0    # mean wall time of a step, its sync included
    dup_factor: int = 0     # the instance budget the loop ended with


def build_view_batch(cams, num_views, bg, with_mask, with_depth):
    """Stack up to ``num_views`` cameras (padded by repeating the last)
    into one batch on ``bg``'s device, from the cameras' device tensors."""
    sel = list(cams)
    while len(sel) < num_views:
        sel.append(sel[-1])
    sel = sel[:num_views]
    dev = bg.device
    h, w = sel[0].image_height, sel[0].image_width

    def stack(key, blank_shape, fill):
        return torch.stack([
            getattr(c, key) if getattr(c, key) is not None
            else torch.full(blank_shape, fill, device=dev) for c in sel])

    batch = {k: torch.stack([c.device_consts[k] for c in sel])
             for k in ("viewmatrix", "projmatrix", "campos")}
    batch.update(
        tanfovx=np.array([c.tanfovx for c in sel], np.float32),
        tanfovy=np.array([c.tanfovy for c in sel], np.float32),
        fid=float(np.float32(sel[0].fid)),
        image=stack("image", (3, h, w), 0.0), bg=bg,
        mask=(stack("mask", (1, h, w), 1.0) if with_mask
              else torch.zeros(num_views, 1, 1, 1, device=dev)),
        depth=(stack("depth", (h, w), 0.0) if with_depth
               else torch.zeros(num_views, 1, 1, device=dev)))
    return batch


def _rng_state(rng: random.Random) -> list:
    version, state, gauss = rng.getstate()
    return [version, list(state), gauss]


def _set_rng_state(rng: random.Random, saved: list):
    rng.setstate((saved[0], tuple(saved[1]), saved[2]))


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def training(model_cfg, hidden_cfg, opt_cfg, pipe_cfg, test_iterations,
             save_iterations, args=None, quiet=False,
             progress_callback=None, resume=False,
             rng: random.Random | None = None, device=None,
             watchdog_min: float = 0.0, mesh=None,
             ring: bool = False, until: int | None = None) -> TrainResult:
    """Train one scene.

    ``rng`` orders the views and shuffles the cameras (a fresh
    ``random.Random(0)`` when None); the field's weights and the densify
    noise (a ``torch.Generator`` on the device) come from seed 0, as the
    JAX loop's from its fixed key; ``device=None`` means the GPU.
    ``progress_callback(iteration, loss, params, stats)`` runs after
    every iteration. ``until``: stop after that iteration, a leg of the
    run that ``--resume`` continues; every schedule and event stays that
    of the whole ``opt_cfg.iterations``. With ``watchdog_min`` > 0 a
    ``StallWatchdog`` exits the process (code 114) when no iteration ends
    for that many minutes; it stops with the loop, also when the loop
    raises.

    ``mesh`` (``parallel.mesh.make_mesh``; every rank of its process group
    calls ``training``): the sharded step on this rank's chunk of the
    splat state (``ring``: the ring exchange). Rank 0 evaluates and
    writes; every rank returns the whole final state, and rank 0 the best
    PSNR."""
    dev = resolve_device(device)
    writer_rank = mesh is None or mesh.rank == 0
    quiet = quiet or not writer_rank
    rng = rng if rng is not None else random.Random(0)
    # the frame count only reaches a field: a static run (run_dtu.sh's
    # 3DGS lines keep the default --load_time_step 100) ignores it; a
    # field run with --load_time_step > 1 is 4-D (run_owlii.sh)
    n_frames = (model_cfg.load_time_step if model_cfg.load_time_step > 1
                and not model_cfg.is_static else 0)
    hidden_cfg.n_frames = n_frames
    is_static = model_cfg.is_static
    enable_g_opt = not opt_cfg.disable_gaussian_opt

    if model_cfg.model_path and writer_rank:
        os.makedirs(model_cfg.model_path, exist_ok=True)
        if args is not None:
            cfg_lib.save_cfg_args(model_cfg.model_path, args)

    t_scene = time.time()
    # only the writing rank's Scene writes cameras.json and input.ply
    scene = Scene(model_cfg if writer_rank
                  else dataclasses.replace(model_cfg, model_path=""),
                  rng=rng, device=dev)
    if not quiet:
        print(f"Scene: {len(scene.get_train_cameras())} train, "
              f"{len(scene.get_test_cameras())} test cameras, "
              f"{scene.splats.capacity} splats, "
              f"{time.time() - t_scene:.2f} s")
    deform = None
    if not is_static:
        deform = DeformModel(hidden_cfg, radius=scene.cameras_extent,
                             seed=0, device=dev)
        deform.train_setting(opt_cfg)

    params, stats = scene.splats, scene.splat_stats
    splat_opt = splats_lib.adam_init(params)
    n_model = mesh.n_model if mesh is not None else 1
    if mesh is not None:
        if opt_cfg.n_splats > 0:
            raise ValueError("--n_splats subsampling is not supported with "
                             "a device mesh (pass -1); see parallel/step.py")
        if deform:
            deform.params = pstep.replicate(deform.params)

    def shard(p, s, o):
        """The state as this rank holds it: the capacity rounded up to a
        multiple of the model axis, this rank's chunk."""
        if mesh is None:
            return p, s, o
        if p.capacity % n_model:
            p, s, o = splats_lib.grow_capacity(
                p, s, o, _round_up(p.capacity, n_model))
        return pstep.shard_train_state(p, s, o, mesh)

    def whole(p, s, o):
        """The whole state (a collective over the model row)."""
        if mesh is None:
            return p, s, o
        return pstep.unshard_train_state(p, s, o, mesh)

    def n_valid(s) -> int:
        n = s.valid.sum()
        return int(mesh_lib.all_reduce(n, mesh.model_group)
                   if mesh is not None else n)

    params, stats, splat_opt = shard(params, stats, splat_opt)
    xyz_sched = expon_lr_func(
        lr_init=opt_cfg.position_lr_init * 5.0,
        lr_final=opt_cfg.position_lr_final * 5.0,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps)
    bg_np = np.array([1, 1, 1] if model_cfg.white_background else [0, 0, 0],
                     np.float32)
    bg = torch.as_tensor(bg_np, device=dev)

    train_cams = scene.get_train_cameras()
    h, w = train_cams[0].image_height, train_cams[0].image_width
    with_mask = opt_cfg.lambda_mask > 0 and train_cams[0].mask is not None
    with_depth = (opt_cfg.lambda_depth > 0 or opt_cfg.lambda_depthl1 > 0) \
        and train_cams[0].depth is not None
    # the mask loss needs masks: off when the dataset has none
    opt_eff = (opt_cfg if with_mask or opt_cfg.lambda_mask <= 0
               else dataclasses.replace(opt_cfg, lambda_mask=0.0))
    by_fid = defaultdict(list)
    for c in train_cams:
        by_fid[c.fid].append(c)
    num_views = 1
    if opt_cfg.all_training:
        num_views = min(opt_cfg.num_views,
                        max(len(v) for v in by_fid.values()))

    writer = MetricsWriter(model_cfg.model_path if writer_rank else None)
    # the densify noise and the n_splats subsample's keys
    densify_gen = torch.Generator(device=dev).manual_seed(0)
    step_cache = {}

    if mesh is not None and num_views % mesh.n_data:
        raise ValueError(f"num_views {num_views} must divide by the data "
                         f"axis {mesh.n_data}")

    def get_step(field_mode, sh_deg):
        key = (field_mode, sh_deg, params.capacity, pipe_cfg.dup_factor)
        if key not in step_cache and mesh is not None:
            step_cache[key] = pstep.make_sharded_train_step(
                deform.net if deform else None, opt_eff, pipe_cfg, w, h,
                num_views // mesh.n_data, field_mode, n_frames, mesh, sh_deg,
                enable_gaussian_opt=enable_g_opt, ring=ring)
        if key not in step_cache:
            step_cache[key] = train_lib.make_train_step(
                deform.net if deform else None, opt_eff, pipe_cfg, w, h,
                num_views, field_mode, n_frames, sh_deg,
                n_splats=opt_cfg.n_splats, enable_gaussian_opt=enable_g_opt,
                generator=densify_gen)
        return step_cache[key]

    test_set, save_set = set(test_iterations), set(save_iterations)
    active_sh = 0
    ema_loss = 0.0
    best_psnr, best_iter = 0.0, 0
    t_start = time.time()
    times, dup_growth, densified = [], [], []
    start_iteration = 1

    if resume and model_cfg.model_path:
        restored = checkpointing.load_train_state(model_cfg.model_path, dev)
        if restored is not None:
            state, meta = restored
            params, stats, splat_opt = shard(
                state["splat_params"], state["splat_stats"],
                state["splat_opt"])
            if deform:
                deform.net.load_state_dict(state["field_state"])
                deform.opt_state = state["field_opt"]
            densify_gen.set_state(state["densify_rng"])
            pipe_cfg = dataclasses.replace(
                pipe_cfg, dup_factor=meta.get("dup_factor",
                                              pipe_cfg.dup_factor))
            if "view_rng" in meta:
                _set_rng_state(rng, meta["view_rng"])
            it0 = meta["iteration"]
            start_iteration = it0 + 1
            active_sh = (min(it0 // 1000, model_cfg.sh_degree)
                         if enable_g_opt else 0)
            print(f"Resumed training state at iteration {it0}")

    def next_batch(iteration):
        vp = train_cams[rng.randint(0, len(train_cams) - 1)]
        if opt_cfg.all_training:
            cam_list = list(by_fid[vp.fid])
            rng.shuffle(cam_list)
        else:
            cam_list = [vp]
        batch = build_view_batch(cam_list, num_views, bg, with_mask,
                                 with_depth)
        if opt_cfg.corr_interval > 1:
            # the Moran terms run on every corr_interval-th step only
            # (train_lib.compute_losses scales them by the interval)
            batch["corr_gate"] = iteration % opt_cfg.corr_interval == 0
        return batch

    # a hung device call cannot be interrupted: the watchdog exits 114
    # and a supervisor restarts with --resume
    watchdog = (StallWatchdog(watchdog_min).start()
                if watchdog_min and watchdog_min > 0 else None)
    try:
        last = opt_cfg.iterations if until is None else min(
            until, opt_cfg.iterations)
        for iteration in range(start_iteration, last + 1):
            if watchdog is not None:
                watchdog.beat()
            ev = iteration_events(iteration, is_static, opt_cfg, test_set,
                                  save_set)
            if ev.sh_bump:
                active_sh = min(active_sh + 1, model_cfg.sh_degree)
            batch = next_batch(iteration)
            lrs = splats_lib.splat_lr_tree(
                xyz_sched(iteration) / 5.0, opt_cfg.feature_lr,
                opt_cfg.opacity_lr, opt_cfg.scaling_lr, opt_cfg.rotation_lr)
            field_lr = deform.learning_rate(iteration) if deform else 0.0
            step = get_step(ev.field_mode,
                            active_sh if not ev.field_mode else 0)
            field_params = deform.params if (deform and ev.field_mode) else {}
            field_opt = (deform.opt_state if deform
                         else splats_lib.adam_init({}))

            t0 = time.time()
            params, stats, splat_opt, new_fp, new_fo, out = step(
                params, stats, splat_opt, field_params, field_opt, batch, lrs,
                field_lr)
            if deform and ev.field_mode:
                deform.params = new_fp
                deform.opt_state = new_fo
            out_loss = float(out.loss)
            dropped = int(out.loss_dict.get("bin_dropped", 0))
            times.append(time.time() - t0)

            if (ev.overwrite_loc
                    and out.means3d.shape[0] == params.xyz.shape[0]):
                # the field's means become the splats' xyz (reference
                # train.py:153-155); skipped for an n_splats subset, as in the
                # JAX loop
                params = dataclasses.replace(params, xyz=out.means3d)

            ema_loss = 0.4 * out_loss + 0.6 * ema_loss
            if iteration % 10 == 0:
                log = {"train_loss_patches/total_loss": out_loss,
                       "train_loss_patches/l1_loss": float(out.l1),
                       "iter_time": times[-1] * 1000.0,
                       "total_points": n_valid(stats)}
                for k, v in out.loss_dict.items():
                    if k != "l1":
                        log[f"train_loss_patches/{k}"] = v
                writer.scalars(iteration, log)
            if dropped > 0:
                # grow the duplicated-instance budget so no instance is lost
                new_factor = max(pipe_cfg.dup_factor + 1,
                                 int(pipe_cfg.dup_factor * 1.5))
                print(f"iter {iteration}: {dropped} rasterizer instances "
                      f"beyond dup budget — growing dup_factor "
                      f"{pipe_cfg.dup_factor} -> {new_factor}", flush=True)
                pipe_cfg = dataclasses.replace(pipe_cfg, dup_factor=new_factor)
                dup_growth.append((iteration, dropped, new_factor))
                step_cache.clear()
            if iteration % 100 == 0 and not quiet:
                print(f"iter {iteration}: loss {ema_loss:.5f} "
                      f"({np.mean(times[-50:]) * 1000:.1f} ms/it)", flush=True)

            if ev.densify:
                # every rank draws the whole capacity's noise: the same
                # draws, the same densify
                noise = torch.randn(params.capacity * n_model, 2, 3,
                                    generator=densify_gen, device=dev)
                n_before = n_valid(stats)
                if mesh is None:
                    params, stats, splat_opt, lost = \
                        splats_lib.densify_and_prune(
                            params, stats, splat_opt, noise,
                            opt_cfg.densify_grad_threshold, 0.005,
                            scene.cameras_extent, ev.size_threshold,
                            percent_dense=opt_cfg.percent_dense)
                else:
                    params, stats, splat_opt, lost = \
                        pstep.make_sharded_densify(
                            mesh, ev.size_threshold, opt_cfg.percent_dense)(
                            params, stats, splat_opt, noise,
                            opt_cfg.densify_grad_threshold, 0.005,
                            scene.cameras_extent)
                lost = int(lost)
                if lost > 0:
                    params, stats, splat_opt = whole(params, stats, splat_opt)
                    params, stats, splat_opt = shard(*splats_lib.grow_capacity(
                        params, stats, splat_opt,
                        _round_up(int(params.capacity * 1.5) + lost,
                                  n_model)))
                    step_cache.clear()
                densified.append((iteration, n_before, n_valid(stats), lost))
                if not quiet:
                    print(f"[ITER {iteration}] densify: {n_before} -> "
                          f"{densified[-1][2]} splats, {lost} dropped, "
                          f"capacity {params.capacity * n_model}", flush=True)

            if (ev.test or ev.save) and mesh is not None:
                full = whole(params, stats, splat_opt)
            else:
                full = (params, stats, splat_opt)
            if ev.test and writer_rank:
                cur = evaluate(scene, full[0], full[1], deform, pipe_cfg,
                               bg_np, active_sh, ev.field_mode, n_frames,
                               iteration, quiet=quiet, writer=writer)
                if cur > best_psnr:
                    best_psnr, best_iter = cur, iteration
            if ev.save and model_cfg.model_path and writer_rank:
                if not quiet:
                    print(f"[ITER {iteration}] saving")
                scene.save(iteration, full[0], full[1])
                if deform:
                    deform.save_weights(model_cfg.model_path, iteration)
                checkpointing.save_train_state(
                    model_cfg.model_path, iteration, *full,
                    deform.net.state_dict() if deform else {},
                    deform.opt_state if deform else splats_lib.adam_init({}),
                    densify_gen, extra={"dup_factor": pipe_cfg.dup_factor,
                                        "view_rng": _rng_state(rng)})
            if progress_callback:
                progress_callback(iteration, out_loss, params, stats)
    finally:
        if watchdog is not None:
            watchdog.stop()

    total = time.time() - t_start
    writer.close()
    params, stats, splat_opt = whole(params, stats, splat_opt)
    n_its = len(times)
    ms_per_it = total * 1000 / max(n_its, 1)
    if not quiet:
        print(f"Best PSNR = {best_psnr} at iteration {best_iter}")
        print(f"Loop: {n_its} iterations in {total:.3f} s, "
              f"{ms_per_it:.3f} ms/it (evaluation and saves included); "
              f"step {np.mean(times) * 1000:.3f} ms mean, "
              f"{np.median(times) * 1000:.3f} ms median")
    return TrainResult(params, stats, deform, best_psnr, start_iteration,
                       ms_per_it, dup_growth, densified,
                       float(np.mean(times)) * 1000 if times else 0.0,
                       pipe_cfg.dup_factor)


@torch.no_grad()
def evaluate(scene, params, stats, deform, pipe_cfg, bg, active_sh,
             field_mode, n_frames, iteration, quiet=False, writer=None):
    """In-training evaluation (reference ``training_report``): L1 and PSNR
    of the test cameras and the first 5 train cameras, render / gt / mask
    / depth panels of the first 5 views of each, the opacity histogram.
    Returns the test PSNR (the train PSNR when there is no test set)."""
    results = {}
    for name, cams in (("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:5])):
        if not cams:
            continue
        psnrs, l1s = [], []
        for idx, cam in enumerate(cams[:25]):
            out = render_camera(cam, params, stats, deform, pipe_cfg, bg,
                                field_mode=field_mode, n_frames=n_frames,
                                sh_degree=active_sh)
            img = torch.clamp(out["render"], 0, 1)
            gt = torch.clamp(cam.image, 0, 1)
            psnrs.append(float(psnr_fn(img, gt)))
            l1s.append(float(torch.mean(torch.abs(img - gt))))
            if writer is not None and idx < 5:
                img_np, gt_np = img.cpu().numpy(), gt.cpu().numpy()
                panels = {"render": img_np, "gt": gt_np}
                if cam.mask is not None:
                    panels["render_mask"] = img_np * cam.mask.cpu().numpy()
                depth = out["depth"][0].cpu().numpy()
                dmax = max(float(depth.max()), 9.0 + 1e-3)
                panels["depth"] = np.clip((depth - 9.0) / (dmax - 9.0), 0, 1)
                writer.images(iteration, f"{name}_view_{idx}", panels)
        results[name] = (np.mean(l1s), np.mean(psnrs))
        if writer is not None:
            writer.scalars(iteration, {
                f"{name}/loss_viewpoint - l1_loss": results[name][0],
                f"{name}/loss_viewpoint - psnr": results[name][1],
            })
        if not quiet:
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {results[name][0]:.5f} PSNR {results[name][1]:.3f}")
    if writer is not None:
        valid = stats.valid
        opac = splats_lib.get_opacity(params)[valid][:, 0].cpu().numpy()
        writer.histogram(iteration, "scene/opacity_histogram", opac)
        writer.scalars(iteration, {"total_points": float(valid.sum())})
    return results.get("test", results.get("train", (0, 0)))[1]


def build_train_parser():
    """The JAX CLI's parser, flag for flag."""
    parser = cfg_lib.build_parser("SplatFields (PyTorch) training")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[i * 1000 for i in range(0, 120)]
                        + [100_000, 200_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[100, 500, 1000, 7000, 10000, 20000, 30000,
                                 40000, 100_000, 200_000])
    parser.add_argument("--configs", type=str, default="")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest train_state ckpt")
    parser.add_argument("--profile", action="store_true",
                        help="capture a torch.profiler trace of iterations "
                             "20-30 into <model_path>/trace")
    parser.add_argument("--mesh_model", type=int, default=0,
                        help="model-axis size of the ('data','model') device "
                             "mesh; 0 = single-device step (default)")
    parser.add_argument("--mesh_data", type=int, default=1,
                        help="data-axis size of the device mesh")
    parser.add_argument("--ring", action="store_true",
                        help="ring-exchange Gaussian blocks over the model "
                             "axis instead of all_gathering attributes "
                             "(for splat counts too large to replicate)")
    parser.add_argument("--scan_k", type=int, default=None,
                        help="accepted with no effect: it batches "
                             "iterations into one TPU dispatch, and eager "
                             "PyTorch needs no twin (ROADMAP Queue 1 item 5)")
    parser.add_argument("--watchdog_min", type=float, default=0.0,
                        help="exit 114 if the training loop makes no "
                             "progress for this many minutes (supervisors "
                             "restart with --resume); 0 = off")
    parser.add_argument("--coordinator_address", type=str, default="",
                        help="host:port of process 0 (multi-host worlds)")
    parser.add_argument("--num_processes", type=int, default=1,
                        help="total processes, one a GPU (multi-host "
                             "worlds)")
    parser.add_argument("--process_id", type=int, default=0,
                        help="this process's index (multi-host worlds)")
    return parser


def mesh_shape(args) -> tuple[int, int] | None:
    """(data, model) of the mesh the flags ask for, or None (the
    single-device step): a mesh when ``--num_processes > 1`` or
    ``--mesh_model > 0``, the model axis ``--mesh_model`` or else the
    processes over ``--mesh_data``, as in the JAX CLI."""
    if args.num_processes <= 1 and args.mesh_model <= 0:
        return None
    n_model = args.mesh_model or args.num_processes // args.mesh_data
    if n_model < 1:
        raise ValueError(f"{args.num_processes} processes do not fill "
                         f"{args.mesh_data} data rows")
    return args.mesh_data, n_model


def check_mesh_flags(args):
    """The JAX CLI's refusals that the flags alone decide: ``--n_splats``
    on a mesh, and a view batch of one (no ``--all_training``) over more
    than one data row. A larger batch is checked against the data axis
    once the scene is read."""
    if mesh_shape(args) is None:
        return
    if args.n_splats > 0:
        raise ValueError("--n_splats subsampling is not supported with a "
                         "device mesh (pass -1); see parallel/step.py")
    if not args.all_training and args.mesh_data > 1:
        raise ValueError(f"num_views 1 must divide by the data axis "
                         f"{args.mesh_data}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def profile_callback(trace_dir: str):
    """``--profile``'s progress callback: a ``torch.profiler`` trace (CPU
    activity, and CUDA when a card is present) from the end of iteration
    20 to the end of iteration 30, written to ``trace_dir`` as a Chrome
    trace JSON."""
    prof = None

    def callback(it, loss, params, stats):
        nonlocal prof
        if it == 20:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        elif it == 30 and prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            prof = None
            print(f"profiler trace written to {trace_dir}")

    return callback


def _rank_main(rank: int, argv: list, device, world: int, init_method: str):
    """One spawned local rank: rank ``rank`` of ``world`` on GPU ``rank``
    (NCCL), or on the CPU over gloo when ``device`` is the CPU."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh_lib.initialize_distributed(
        None, world, rank, backend="gloo" if cpu else "nccl",
        init_method=init_method)
    try:
        main(argv, device="cpu" if cpu else f"cuda:{rank}")
    finally:
        dist.destroy_process_group()


def _spawn(argv: list, device, world: int):
    """``world`` local ranks (``torch.multiprocessing``, spawned), each
    running this CLI; a rank's failure stops the others and raises."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"a mesh of {world} devices needs {world} local GPUs, one a "
            f"rank; this host has {torch.cuda.device_count()}")
    import torch.multiprocessing as mp
    mp.start_processes(
        _rank_main, args=(argv, device, world,
                          f"tcp://127.0.0.1:{_free_port()}"),
        nprocs=world, join=True, start_method="spawn")


def main(argv=None, device=None):
    """The CLI -> ``training``'s ``TrainResult``. A mesh of several ranks
    without ``--num_processes`` spawns them here and returns None once
    they end."""
    full_f32_math()
    parser = build_train_parser()
    argv = list(argv if argv is not None else sys.argv[1:])
    args = parser.parse_args(argv)
    check_mesh_flags(args)
    shape = mesh_shape(args)
    mesh, own_group = None, False
    if shape is not None:
        world = shape[0] * shape[1]
        if not dist.is_initialized():
            if args.num_processes <= 1 and world > 1:
                return _spawn(argv, device, world)
            if device is None and torch.cuda.is_available():
                device = f"cuda:{args.process_id % torch.cuda.device_count()}"
            cpu = device is not None and torch.device(device).type == "cpu"
            init_method = (None if args.coordinator_address
                           else f"tcp://127.0.0.1:{_free_port()}")
            mesh_lib.initialize_distributed(
                args.coordinator_address or None, args.num_processes,
                args.process_id, backend="gloo" if cpu else "nccl",
                init_method=init_method)
            own_group = True
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = mesh_lib.make_mesh(world, data=shape[0])
        print(f"Device mesh: data={shape[0]} model={shape[1]} "
              f"({dist.get_world_size()} process(es), {dist.get_backend()})")
    args.save_iterations.append(args.iterations)
    if args.configs:
        args = cfg_lib.merge_yaml_config(args, args.configs)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    model_cfg, pipe_cfg, hidden_cfg, opt_cfg = cfg_lib.extract_configs(args)
    print("Optimizing " + model_cfg.model_path)
    callback = None
    if args.profile and model_cfg.model_path:
        callback = profile_callback(os.path.join(model_cfg.model_path,
                                                 "trace"))
    try:
        out = training(model_cfg, hidden_cfg, opt_cfg, pipe_cfg,
                       args.test_iterations, args.save_iterations, args=args,
                       quiet=args.quiet, resume=args.resume,
                       progress_callback=callback, device=device,
                       watchdog_min=args.watchdog_min, mesh=mesh,
                       ring=args.ring)
    finally:
        if own_group:
            dist.destroy_process_group()
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
